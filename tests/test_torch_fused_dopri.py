"""The fused adaptive dopri5 solve (kernel K2's module) against the JAX package.

On the CPU the port runs the plain PyTorch versions of the K2 kernels: the
PI-controlled solve of each chunk and group, and for gradients autograd
through a replay of its accepted-step mesh.  With one chunk and one group that
is the XLA dense-output loop of the JAX package, held here in float64.  The
replay is also held against the JAX kernel itself: run in interpret mode, its
realised mesh replayed by the port must give the kernel's outputs and
gradients.  The CUDA kernels are held against the plain versions on the card
by ``chip_smoke.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_dopri_pallas as fdp
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.integrate import select_initial_step as jax_initial_step
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu.solvers.terms import make_cde_rhs as jax_rhs
from torchcde_tpu_torch.solvers import fused_dopri
from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
from torchcde_tpu_torch.solvers.fused_fixed_kernel import pack_operands
from torchcde_tpu_torch.solvers.integrate import SolverConfig, select_initial_step
from torchcde_tpu_torch.solvers.terms import MLPVectorField, make_cde_rhs

torch.set_num_threads(1)

B, L, C, H, W = 5, 9, 3, 8, 16
T_OUT = np.array([0.0, 1.3, 4.75, 8.0])


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _problem(seed=1, batch=B, length=L, dtype=np.float64):
    # Paths linear in time keep the controller well conditioned (see
    # test_torch_adaptive.py).
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 1, C)) + rng.uniform(-1, 1, (batch, 1, C)) * np.arange(
        length)[None, :, None]
    p = dict(w1=rng.standard_normal((H, W)) * 0.5, b1=rng.standard_normal(W) * 0.1,
             w2=rng.standard_normal((W, H * C)) * 0.5, b2=rng.standard_normal(H * C) * 0.1,
             z0=rng.standard_normal((batch, H)))
    return x.astype(dtype), {k: v.astype(dtype) for k, v in p.items()}


def _field(p, dtype=torch.float64):
    field = MLPVectorField(H, C, W, dtype=dtype)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    return field


def _control(x):
    return tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        torch.as_tensor(x)))


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_plain_version_matches_the_xla_dense_loop(seed, monkeypatch):
    x, p = _problem(seed)

    def jax_run(x_, z0, w1, b1, w2, b2, stats=False):
        X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x_))
        return tc.cdeint(X, JaxField(w1, b1, w2, b2, H, C), z0, T_OUT, adjoint=False,
                         return_stats=stats)

    args = tuple(jnp.asarray(a) for a in (x, p["z0"], p["w1"], p["b1"], p["w2"], p["b2"]))
    out_j, stats_j = jax_run(*args, stats=True)
    proj = np.random.default_rng(5).standard_normal(out_j.shape)
    grads_j = jax.grad(lambda *a: jnp.sum(jax_run(*a) * proj), argnums=tuple(range(6)))(*args)

    meshes = []
    reference = k2.fused_dopri5_solve_reference

    def recording(*a):
        result = reference(*a)
        meshes.append(result[3])
        return result

    monkeypatch.setattr(k2, "fused_dopri5_solve_reference", recording)
    k2.reset_launch_counts()
    field = _field(p)
    xt = torch.from_numpy(x).requires_grad_()
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    out = tt.cdeint(_control(xt), field, z0, T_OUT, adjoint=False)
    (out * torch.from_numpy(proj)).sum().backward()

    assert len(meshes) == 1 and len(meshes[0].t) == int(stats_j["steps_accepted"])
    assert meshes[0].attempted == int(stats_j["steps_attempted"])
    assert (k2.FWD_LAUNCHES, k2.BWD_LAUNCHES) == (0, 0)  # the CPU runs the plain version
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-9,
                               atol=1e-10 * float(np.abs(out_j).max()))
    grads = [xt.grad, z0.grad, field.linear1.weight.grad.T, field.linear1.bias.grad,
             field.linear2.weight.grad.T, field.linear2.bias.grad]
    for name, got, expected in zip(["x", "z0", "w1", "b1", "w2", "b2"], grads, grads_j):
        expected = np.asarray(expected)
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-8,
                                   atol=1e-10 * float(np.abs(expected).max()), err_msg=name)


@pytest.mark.parametrize("grid, ts, max_intervals", [
    (np.arange(0.0, 100.0), np.array([0.0, 99.0]), 128),
    (np.arange(0.0, 300.0), np.array([0.0, 99.0]), 128),
    (np.arange(0.0, 300.0), np.array([0.0, 17.5, 128.0, 200.25, 299.0]), 128),
    (np.arange(0.0, 14.0), np.array([0.0, 3.3, 9.0, 13.0]), 4),
    (np.arange(0.0, 14.0) * 0.5, np.array([-1.0, 0.25, 2.0, 7.5]), 3),  # before/after the grid
    (np.arange(0.0, 14.0), np.array([2.5, 3.0, 11.0]), 4),  # starts and ends inside chunks
])
def test_chunk_plan_matches_jax(grid, ts, max_intervals):
    assert fused_dopri._chunk_plan(grid, ts, max_intervals) == fdp._chunk_plan(
        grid, ts, max_intervals)


def _packed(x, p, dtype=torch.float64):
    X = _control(torch.as_tensor(x, dtype=dtype))
    field = _field(p, dtype)
    z0 = torch.as_tensor(p["z0"], dtype=dtype)
    rhs = make_cde_rhs(field, X)
    t0 = torch.zeros((), dtype=dtype)
    dt0 = select_initial_step(rhs, t0, z0, 5, 1e-4, 1e-6, rhs(t0, z0)).reshape(1)
    return X, field, z0, pack_operands(X._b, X._two_c, X._three_d, z0, field), dt0


def _plan(t_start, t_end, out_ts, t0g=0.0, cap=256 + 64 * (L - 1), **kw):
    return k2.Plan(tuple(out_ts), t_start, t_end, t0g, 1.0, 1e-4, 1e-6, cap, **kw)


def test_groups_are_independent_solves(monkeypatch):
    # Batches beyond MAX_TILE lanes split into groups with their own
    # controllers, all starting from the whole batch's initial step.
    monkeypatch.setattr(k2, "MAX_TILE", 5)
    x, p = _problem(2, batch=13)
    X, field, z0, pk, dt0 = _packed(x, p)
    out = fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig())
    attempted = set()
    for g0 in (0, 5, 10):
        lanes = slice(g0, min(g0 + 5, 13))
        zout, _zfin, _dt, mesh = k2.fused_dopri5_solve_reference(
            pk.ct[..., lanes].contiguous(), pk.z0t[:, lanes], pk.w1t, pk.b1, pk.w2t, pk.b2, dt0,
            _plan(0.0, 8.0, T_OUT[1:]))
        assert torch.equal(out[1:, lanes], zout.transpose(1, 2))
        attempted.add((len(mesh.t), mesh.attempted))
    assert torch.equal(out[0], z0)
    assert len(attempted) > 1  # the groups' controllers took their own steps


def test_chunks_carry_state_step_and_poison(monkeypatch):
    monkeypatch.setattr(k2, "MAX_INTERVALS", 3)
    x, p = _problem(3)
    X, field, z0, pk, dt0 = _packed(x, p)
    out = fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig())
    # The chunks by hand: z and the step proposal carried across.
    z, dt, rows = pk.z0t, dt0, [pk.z0t]
    for j0, j1, out_ts in ((0, 3, (1.3,)), (3, 6, (4.75,)), (6, 8, (8.0,))):
        zout, z, dt, _mesh = k2.fused_dopri5_solve_reference(
            pk.ct[j0:j1], z, pk.w1t, pk.b1, pk.w2t, pk.b2, dt,
            _plan(float(j0), float(j1), out_ts, t0g=float(j0), cap=256 + 64 * (j1 - j0)))
        rows.append(zout[0])
    assert torch.equal(out, torch.stack(rows).transpose(1, 2))
    # Clamping steps to chunk boundaries changes the mesh, not the accuracy.
    monkeypatch.setattr(k2, "MAX_INTERVALS", 128)
    whole = fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig())
    exact = fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig(rtol=1e-8, atol=1e-10))
    assert (out - exact).abs().max() <= 1.5 * (whole - exact).abs().max()
    # An exhausted first chunk poisons every later output.
    monkeypatch.setattr(k2, "MAX_INTERVALS", 3)
    poisoned = fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig(max_steps=2))
    assert torch.equal(poisoned[0], z0) and torch.isnan(poisoned[1:]).all()


def test_replay_of_the_jax_kernels_mesh_matches_the_jax_kernel():
    """The JAX kernel in interpret mode realises a mesh; the port's replay of
    that mesh in float64 must give the kernel's outputs and gradients."""
    Bk, Lk, Ck, Hk, Wk = 3, 6, 2, 8, 8
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((Bk, Lk, Ck)), rng.standard_normal((Bk, Hk)),
              rng.standard_normal((Hk, Wk)) * 0.08, rng.standard_normal(Wk) * 0.08,
              rng.standard_normal((Wk, Hk * Ck)) * 0.08, rng.standard_normal(Hk * Ck) * 0.08]
    x, z0, w1, b1, w2, b2 = (jnp.asarray(a, jnp.float32) for a in arrays)
    ts = np.array([0.0, 5.0])
    rtol, atol = 1e-5, 1e-7

    def loss(args):
        co = tc.hermite_cubic_coefficients_with_backward_differences(args[0])
        out = tc.cdeint(tc.CubicSpline(co), JaxField(*args[2:], Hk, Ck), args[1],
                        jnp.asarray(ts, jnp.float32), adjoint=False, rtol=rtol, atol=atol)
        return jnp.sum(jnp.sin(out)), out

    fused_pallas.force_fused_pallas(True)
    (_, out_k), grads_k = jax.value_and_grad(loss, has_aux=True)((x, z0, w1, b1, w2, b2))

    # The kernel's realised mesh, from its forward call on the same operands.
    X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x))
    n, Bp, Hp, CHp = Lk - 1, 128, 8, fdp._round_up(Ck * Hk, 8)
    ct = jnp.concatenate([X._b, X._two_c, X._three_d,
                          jnp.zeros((Bk, n, fdp._SLAB - 3 * Ck), jnp.float32)], axis=-1)
    ct2 = jnp.pad(jnp.transpose(ct, (1, 2, 0)).reshape(n * fdp._SLAB, Bk), ((0, 0), (0, Bp - Bk)))
    w2t = jnp.pad(w2.reshape(Wk, Hk, Ck).transpose(0, 2, 1).reshape(Wk, Ck * Hk).T,
                  ((0, CHp - Ck * Hk), (0, 0)))
    b2c = jnp.pad(b2.reshape(Hk, Ck).T.reshape(Ck * Hk, 1), ((0, CHp - Ck * Hk), (0, 0)))
    rhs = jax_rhs(JaxField(w1, b1, w2, b2, Hk, Ck), X)
    dt0 = jax_initial_step(rhs, jnp.float32(0.0), z0, 5, rtol, atol, rhs(jnp.float32(0.0), z0))
    solve = fdp._make_fused_dopri(n, Bp, (5.0,), 0.0, 5.0, 0.0, 1.0, rtol, atol, 4096, 2048,
                                  Ck, Hk, Wk, CHp, Bk, 0.9, 10.0, 0.2, True)
    *_, tst, dtst, cnt = solve._fwd_call(ct2, jnp.pad(z0.T, ((0, Hp - Hk), (0, Bp - Bk))), w1.T,
                                         b1.reshape(Wk, 1), w2t, b2c,
                                         dt0.astype(jnp.float32).reshape(1, 1))
    cnt = int(cnt[0, 0])
    assert cnt > 3
    mesh = k2.Mesh(np.asarray(tst)[:cnt, 0], np.asarray(dtst)[:cnt, 0], cnt)
    fused_pallas.force_fused_pallas(None)

    leaves = [torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)
              for a in (x, z0, w1, b1, w2, b2)]
    field = MLPVectorField(Hk, Ck, Wk, dtype=torch.float64)
    for layer, weight, bias in ((field.linear1, leaves[2].T, leaves[3]),
                                (field.linear2, leaves[4].T, leaves[5])):
        del layer.weight, layer.bias  # the leaves themselves, so autograd reaches them
        layer.weight, layer.bias = weight, bias
    Xt = _control(leaves[0])
    pk = pack_operands(Xt._b, Xt._two_c, Xt._three_d, leaves[1], field)
    zout, _zfin = k2.fused_dopri5_replay(pk.ct, pk.z0t, pk.w1t, pk.b1, pk.w2t, pk.b2, mesh,
                                         k2.Plan((5.0,), 0.0, 5.0, 0.0, 1.0, rtol, atol, 2048))
    out = torch.stack([leaves[1], zout[0].T], dim=1)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_k), rtol=1e-4, atol=1e-5)
    for name, got, expected in zip(["x", "z0", "w1", "b1", "w2", "b2"], grads, grads_k):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_declines_where_jax_declines():
    x, p = _problem()
    X, field, z0, _pk, _dt0 = _packed(x, p)
    cfg = SolverConfig()
    assert fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, cfg) is not None
    assert fused_dopri.try_fused_dopri5(X, lambda t, z: field(t, z), z0, T_OUT, cfg) is None
    uneven = tt.CubicSpline(X._a.new_zeros((B, L - 1, 4 * C)),
                            np.array([0.0, 1.0, 2.5, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]))
    assert fused_dopri.try_fused_dopri5(uneven, field, z0, T_OUT, cfg) is None
    assert fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig(max_steps=2049)) is None
    # An explicit budget above a chunk's cap (256 + 64 * 8 = 768 here).
    assert fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig(max_steps=769)) is None
    assert fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig(max_steps=768)) is not None
    many = np.linspace(0.0, 8.0, 66)
    assert fused_dopri.try_fused_dopri5(X, field, z0, many, cfg) is None
    wide = MLPVectorField(H, C, 513, dtype=torch.float64)
    assert fused_dopri.try_fused_dopri5(X, wide, z0, T_OUT, cfg) is None
    # bfloat16 is upcast at the boundary (the controller runs in float32),
    # comes back bfloat16 and stays near the float32 solve of the same
    # quantized problem (tests/test_fused_dopri.py); mixed dtypes decline.
    bf = torch.bfloat16
    x16, field16 = torch.as_tensor(x).to(bf), _field(p).to(bf)
    out = fused_dopri.try_fused_dopri5(_control(x16), field16, z0.to(bf), T_OUT, cfg)
    ref = fused_dopri.try_fused_dopri5(_control(x16.float()), field16.float(), z0.to(bf).float(),
                                       T_OUT, cfg)
    assert out.dtype == bf and ref.dtype == torch.float32
    np.testing.assert_allclose(out.detach().float().numpy(), ref.detach().numpy(), rtol=0.06,
                               atol=0.06)
    assert fused_dopri.try_fused_dopri5(_control(x16), field16, z0.float(), T_OUT, cfg) is None
