"""K2's linear-control mode (the Neural RDE control) against the JAX package.

On the CPU the port runs K2's plain versions.  Over a ``LinearInterpolation``
the table holds one slope row per interval, and a stage exactly on a knot
reads the slope on its left; chunks after the first carry one extra interval
on their left (``lead``).  Held here in float64 against the JAX XLA loop, and
in float32 against the JAX kernel itself in interpret mode (its realised mesh
replayed by the port, and its chunked solve).  The CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``.
"""

from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_dopri_pallas as fdp
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.integrate import SolverConfig as JaxSolverConfig
from torchcde_tpu.solvers.integrate import select_initial_step as jax_initial_step
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu.solvers.terms import make_cde_rhs as jax_rhs
from torchcde_tpu_torch.solvers import fused_dopri
from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
from torchcde_tpu_torch.solvers import fused_fixed
from torchcde_tpu_torch.solvers.fused_fixed_kernel import pack_operands
from torchcde_tpu_torch.solvers.integrate import SolverConfig
from torchcde_tpu_torch.solvers.team import team_weights
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

B, L, H, W = 5, 9, 8, 16
T_OUT = np.array([0.0, 1.3, 4.75, 8.0])


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _problem(seed, C, batch=B, length=L):
    # Paths near-linear in time: the kinks at the knots are small, so the
    # two float64 controllers realise the same mesh (see
    # test_torch_fused_dopri.py).
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 1, C)) + rng.uniform(-1, 1, (batch, 1, C)) * np.arange(
        length)[None, :, None]
    x = x + 0.01 * rng.standard_normal((batch, length, C))
    p = dict(w1=rng.standard_normal((H, W)) * 0.5, b1=rng.standard_normal(W) * 0.1,
             w2=rng.standard_normal((W, H * C)) * 0.5 / C, b2=rng.standard_normal(H * C) * 0.1,
             z0=rng.standard_normal((batch, H)))
    return x, p


def _field(p, C, dtype=torch.float64):
    field = MLPVectorField(H, C, W, dtype=dtype)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    return field


def _control(x):
    return tt.LinearInterpolation(tt.linear_interpolation_coeffs(torch.as_tensor(x)))


@pytest.mark.parametrize("C, seed", [(2, 1), (2, 4), (14, 2)])  # 14: the depth-3 log-ODE control
def test_plain_version_matches_the_xla_dense_loop(C, seed, monkeypatch):
    x, p = _problem(seed, C)

    def jax_run(x_, z0, w1, b1, w2, b2, stats=False):
        X = tc.LinearInterpolation(tc.linear_interpolation_coeffs(x_))
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
    field = _field(p, C)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_field_reads_the_left_slope_at_knots_and_lead_keeps_it(dtype):
    """The plain version's interval rule: at an exact interior knot the
    slope on the left, bit for bit ``LinearInterpolation.derivative``; a
    chunk with ``lead`` gives the same field as the whole table at every
    time of its span, its first knot included."""
    x, p = _problem(3, 2, length=10)
    X = _control(torch.as_tensor(x, dtype=dtype))
    field = _field(p, 2, dtype)
    z0 = torch.as_tensor(p["z0"], dtype=dtype)
    pk = pack_operands(X._derivs, None, None, z0, field, linear=True)
    assert pk.ct.shape == (9, 1, 2, B)
    sc = k2.numpy_dtype(dtype).type
    whole = k2._field(pk.ct, pk.w1t, pk.b1, pk.w2t, pk.b2,
                      k2.Plan((), 0.0, 9.0, 0.0, 1.0, 1e-4, 1e-6, 8, linear=True), sc)
    chunk = k2._field(pk.ct[3:], pk.w1t, pk.b1, pk.w2t, pk.b2,
                      k2.Plan((), 4.0, 9.0, 4.0, 1.0, 1e-4, 1e-6, 8, linear=True, lead=True), sc)
    y = pk.z0f
    g = torch.tanh(torch.relu(y @ pk.w1t.t() + pk.b1) @ pk.w2t.t() + pk.b2).reshape(B, 2, H)
    for tau in (0.0, 1.0, 2.5, 4.0, 4.0 + 1e-6, 5.0, 8.0, 8.5, 9.0, 9.5):
        tv = sc(tau)
        expected = (g * X.derivative(torch.tensor(tv))[:, :, None]).sum(dim=1)
        torch.testing.assert_close(whole(y, tv), expected, rtol=0, atol=0)
        if tau >= 4.0:
            torch.testing.assert_close(chunk(y, tv), expected, rtol=0, atol=0)


def _kernel_problem(shape=(3, 6, 2, 8, 8)):
    Bk, Lk, Ck, Hk, Wk = shape
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((Bk, Lk, Ck)), rng.standard_normal((Bk, Hk)),
              rng.standard_normal((Hk, Wk)) * 0.3, rng.standard_normal(Wk) * 0.3,
              rng.standard_normal((Wk, Hk * Ck)) * 0.3 / np.sqrt(Wk / 8),
              rng.standard_normal(Hk * Ck) * 0.3]
    return (Bk, Lk, Ck, Hk, Wk), [jnp.asarray(a, jnp.float32) for a in arrays]


def _torch_leaves(arrays, Hk, Ck, Wk):
    leaves = [torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)
              for a in arrays]
    field = MLPVectorField(Hk, Ck, Wk, dtype=torch.float64)
    for layer, weight, bias in ((field.linear1, leaves[2].T, leaves[3]),
                                (field.linear2, leaves[4].T, leaves[5])):
        del layer.weight, layer.bias  # the leaves themselves, so autograd reaches them
        layer.weight, layer.bias = weight, bias
    return leaves, field


def test_replay_of_the_jax_linear_kernels_mesh_matches_the_jax_kernel():
    """The JAX kernel in its linear mode, in interpret mode, realises a mesh;
    the port's replay of that mesh in float64 must give the kernel's outputs
    and gradients."""
    _replay_matches_the_jax_kernel(_kernel_problem())


def test_replay_at_config4_widths_matches_the_jax_kernel():
    """As above at BASELINE config 4's widths (hidden 8, the depth-3
    logsignature's 14 channels, width 128), the shapes of the team backward
    kernel (K2's generic variant), at a small batch and length."""
    _replay_matches_the_jax_kernel(_kernel_problem((2, 6, 14, 8, 128)), scaled=True)


def _replay_matches_the_jax_kernel(problem, scaled=False):
    """The replay's outputs within rtol 1e-4 and atol 1e-5 of the kernel's,
    its gradients too, or with ``scaled`` within atol 1e-5 of each
    gradient's largest magnitude: the float32 kernel's sums over 128 rows
    and 112 outputs carry that much rounding."""
    (Bk, Lk, Ck, Hk, Wk), arrays = problem
    x, z0, w1, b1, w2, b2 = arrays
    ts = np.array([0.0, 5.0])
    rtol, atol = 1e-5, 1e-7

    def loss(args):
        X = tc.LinearInterpolation(tc.linear_interpolation_coeffs(args[0]))
        out = tc.cdeint(X, JaxField(*args[2:], Hk, Ck), args[1], jnp.asarray(ts, jnp.float32),
                        adjoint=False, rtol=rtol, atol=atol)
        return jnp.sum(jnp.sin(out)), out

    fused_pallas.force_fused_pallas(True)
    (_, out_k), grads_k = jax.value_and_grad(loss, has_aux=True)(tuple(arrays))

    # The kernel's realised mesh, from its forward call on the same operands.
    X = tc.LinearInterpolation(tc.linear_interpolation_coeffs(x))
    n, Bp, Hp, CHp = Lk - 1, 128, 8, fdp._round_up(Ck * Hk, 8)
    ct = jnp.concatenate([X._derivs, jnp.zeros((Bk, n, fdp._SLAB - Ck), jnp.float32)], axis=-1)
    ct2 = jnp.pad(jnp.transpose(ct, (1, 2, 0)).reshape(n * fdp._SLAB, Bk), ((0, 0), (0, Bp - Bk)))
    w2t = jnp.pad(w2.reshape(Wk, Hk, Ck).transpose(0, 2, 1).reshape(Wk, Ck * Hk).T,
                  ((0, CHp - Ck * Hk), (0, 0)))
    b2c = jnp.pad(b2.reshape(Hk, Ck).T.reshape(Ck * Hk, 1), ((0, CHp - Ck * Hk), (0, 0)))
    rhs = jax_rhs(JaxField(w1, b1, w2, b2, Hk, Ck), X)
    dt0 = jax_initial_step(rhs, jnp.float32(0.0), z0, 5, rtol, atol, rhs(jnp.float32(0.0), z0))
    solve = fdp._make_fused_dopri(n, Bp, (5.0,), 0.0, 5.0, 0.0, 1.0, rtol, atol, 4096, 2048,
                                  Ck, Hk, Wk, CHp, Bk, 0.9, 10.0, 0.2, True, True)
    *_, tst, dtst, cnt = solve._fwd_call(ct2, jnp.pad(z0.T, ((0, Hp - Hk), (0, Bp - Bk))), w1.T,
                                         b1.reshape(Wk, 1), w2t, b2c,
                                         dt0.astype(jnp.float32).reshape(1, 1))
    cnt = int(cnt[0, 0])
    assert cnt > 3
    mesh = k2.Mesh(np.asarray(tst)[:cnt, 0], np.asarray(dtst)[:cnt, 0], cnt)
    fused_pallas.force_fused_pallas(None)

    leaves, field = _torch_leaves(arrays, Hk, Ck, Wk)
    Xt = _control(leaves[0])
    pk = pack_operands(Xt._derivs, None, None, leaves[1], field, linear=True)
    plan = k2.Plan((5.0,), 0.0, 5.0, 0.0, 1.0, rtol, atol, 2048, linear=True)
    zout, _zfin = k2.fused_dopri5_replay(pk.ct, pk.z0t, pk.w1t, pk.b1, pk.w2t, pk.b2, mesh, plan)
    out = torch.stack([leaves[1], zout[0].T], dim=1)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_k), rtol=1e-4, atol=1e-5)
    for name, got, expected in zip(["x", "z0", "w1", "b1", "w2", "b2"], grads, grads_k):
        expected = np.asarray(expected)
        atol = 1e-5 * (max(1.0, float(np.abs(expected).max())) if scaled else 1.0)
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=atol, err_msg=name)


def test_chunked_solve_with_lead_matches_the_jax_chunked_solve(monkeypatch):
    """Chunks of 2 intervals, so that every chunk after the first runs with
    ``lead``: the port's plain version (float32) and the JAX kernel's
    chunked solve (interpret mode) at the same tolerances.  A linear
    control's kinks make the solution error ~1e-3 here, so each is held
    against a tight float64 solve, within twice the error of the JAX XLA
    loop's unchunked solve."""
    (Bk, Lk, Ck, Hk, Wk), arrays = _kernel_problem()
    ts = np.array([0.0, 1.5, 4.0, 5.0])  # 4.0 is a chunk-boundary knot
    rtol, atol = 1e-5, 1e-7
    monkeypatch.setattr(fdp, "MAX_INTERVALS", 2)
    monkeypatch.setattr(k2, "MAX_INTERVALS", 2)
    X = tc.LinearInterpolation(tc.linear_interpolation_coeffs(arrays[0]))
    jf = JaxField(*arrays[2:], Hk, Ck)
    xla = np.moveaxis(np.asarray(tc.cdeint(X, jf, arrays[1], ts, adjoint=False, rtol=rtol,
                                           atol=atol)), 1, 0)
    fused_pallas.force_fused_pallas(True)
    out_j = fdp.try_fused_dopri5(X, jf, arrays[1], ts, JaxSolverConfig(rtol=rtol, atol=atol))
    fused_pallas.force_fused_pallas(None)
    assert out_j is not None

    calls = []
    solve = k2.fused_dopri5_solve

    def record(ct, *args, **kwargs):
        calls.append((ct.shape[0], args[-1]))
        return solve(ct, *args, **kwargs)

    monkeypatch.setattr(k2, "fused_dopri5_solve", record)
    leaves, field = _torch_leaves(arrays, Hk, Ck, Wk)
    x32 = [a.detach().float() for a in leaves]
    f32 = MLPVectorField(Hk, Ck, Wk, dtype=torch.float32)
    with torch.no_grad():
        f32.linear1.weight.copy_(x32[2].T)
        f32.linear1.bias.copy_(x32[3])
        f32.linear2.weight.copy_(x32[4].T)
        f32.linear2.bias.copy_(x32[5])
        out = fused_dopri.try_fused_dopri5(_control(x32[0]), f32, x32[1], ts,
                                           SolverConfig(rtol=rtol, atol=atol))
    assert [(rows, plan.lead, plan.t0g) for rows, plan in calls] == [
        (2, False, 0.0), (3, True, 2.0), (2, True, 4.0)]
    monkeypatch.setattr(k2, "MAX_INTERVALS", 128)
    with torch.no_grad():
        exact = fused_dopri.try_fused_dopri5(_control(leaves[0]), field, leaves[1], ts,
                                             SolverConfig(rtol=1e-8, atol=1e-10)).numpy()
    limit = 2 * float(np.abs(xla - exact).max())
    assert float(np.abs(out.numpy() - exact).max()) <= limit
    assert float(np.abs(np.asarray(out_j) - exact).max()) <= limit


def test_declines_where_jax_declines():
    x, p = _problem(1, 2)
    field, z0 = _field(p, 2), torch.from_numpy(p["z0"])
    X = _control(x)
    cfg = SolverConfig()
    assert fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, cfg) is not None
    uneven = tt.LinearInterpolation(torch.from_numpy(x),
                                    np.array([0.0, 1.0, 2.5, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]))
    assert fused_dopri.try_fused_dopri5(uneven, field, z0, T_OUT, cfg) is None
    assert fused_dopri.try_fused_dopri5(X, field, z0, T_OUT, SolverConfig(max_steps=2049)) is None
    # C 16 packs (the cap), C 17 declines, as the JAX package's slope table does.
    for C, eligible in ((16, True), (17, False)):
        xc, pc = _problem(1, C)
        Xc, fc = _control(xc), _field(pc, C)
        assert (fused_dopri.try_fused_dopri5(Xc, fc, torch.from_numpy(pc["z0"]), T_OUT, cfg)
                is not None) == eligible
        f32 = {k: jnp.asarray(v, jnp.float32) for k, v in pc.items()}  # the kernel's dtype
        jax_X = tc.LinearInterpolation(jnp.asarray(xc, jnp.float32))
        jf = JaxField(f32["w1"], f32["b1"], f32["w2"], f32["b2"], H, C)
        assert (fused_pallas._pack_operands(jax_X._derivs, None, None, f32["z0"], jf, L - 1,
                                            linear=True) is not None) == eligible


def test_fixed_step_solves_decline_linear_controls():
    # As in the JAX package (fused_fixed.py:49-51): the knot-aligned
    # fixed-step plan is for cubic controls, so a linear control takes the
    # general integrator.
    x, p = _problem(1, 2)
    X, field, z0 = _control(x), _field(p, 2), torch.from_numpy(p["z0"])
    assert fused_fixed.plan_fixed_grid(X, X.grid_points, 1.0) is None
    assert fused_fixed.try_fused_fixed(X, field, z0, X.grid_points, "rk4", 1.0) is None
    out = tt.cdeint(X, field, z0, X.grid_points, adjoint=False, method="rk4", step_size=1.0)
    Xj = tc.LinearInterpolation(jnp.asarray(x))
    jf = JaxField(*(jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2")), H, 2)
    expected = tc.cdeint(Xj, jf, jnp.asarray(p["z0"]), Xj.grid_points, adjoint=False,
                         method="rk4", step_size=1.0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-10, atol=1e-12)


SLOTS, ROW, BLOCKS, SCRATCH = 3, 20, 2, 40  # the stand-ins' team plans; ROW is W's padded row


def _stand_ins(padded):
    """Stand-ins for K2's kernel launches, remembering each chunk's operands
    and mesh by its store.  The forward kernel's stand-in receives the
    solve's padded weights (``padded`` collects them) and the team plan's
    blocks and row; it runs the plain solve on the field (unpadded) and
    writes the kernel's outputs and store.  The backward kernel's stand-in replays the mesh lane
    by lane, writes dct and dz0, and adds lane l's weight gradients into
    team slot l % SLOTS in the kernel's partials layout (dW1 (H, S), dW2
    (C*H, S), rows padded to S), as the team kernel leaves them."""
    stores = {}

    def forward(lib, tensors, sizes, plan, layout):
        ct, z0t, w1, b1, w2, b2, dt0, zout, zfin, dtfin, zst, tst, dtst, stats, scratch = tensors
        B_, n, H_, C, W_ = sizes
        assert layout == (BLOCKS, ROW) and scratch.shape == (SCRATCH,)
        assert w1.shape == (H, ROW) and w2.shape == (C * H, ROW)  # padded
        padded.append(w1)
        field = tuple(t.contiguous() for t in (w1[:H, :W].t(), b1[:W], w2[:C * H, :W],
                                               b2[:C * H]))
        out, fin, dtf, mesh = k2.fused_dopri5_solve_reference(ct, z0t, *field, dt0, plan)
        cnt = len(mesh.t)
        zout.copy_(out)
        zfin.copy_(fin)
        dtfin.copy_(dtf)
        zst.zero_()
        tst[:cnt], dtst[:cnt] = torch.from_numpy(mesh.t), torch.from_numpy(mesh.dt)
        stats.copy_(torch.tensor([cnt, mesh.attempted], dtype=torch.int32))
        stores[id(tst)] = ((ct, z0t, *field), mesh)
        return 0

    def backward(lib, tensors, sizes, plan, layout):
        ct, _zst, tst, _dtst, gzout, gzfin, *_w, stats, dct, dz0, dw1p, db1p, dw2p, db2p = tensors
        (ct, z0t, *weights), mesh = stores[id(tst)]
        C = ct.shape[2]
        assert layout == (SLOTS, ROW)
        assert dw1p.shape == (SLOTS, H, ROW) and dw2p.shape == (SLOTS, C * H, ROW)
        assert tensors[6].shape == (H, ROW) and tensors[8].shape == (C * H, ROW)  # padded
        padded.append(tensors[6])
        dw1p, db1p, dw2p, db2p = dw1p[..., :W], db1p[..., :W], dw2p[..., :W], db2p[..., :C * H]
        for lane in range(ct.shape[-1]):
            sl = slice(lane, lane + 1)
            leaves = [t.detach().requires_grad_() for t in (ct[..., sl], z0t[:, sl], *weights)]
            with torch.enable_grad():
                outs = k2.fused_dopri5_replay(*leaves, mesh, plan)
                pairs = [(o, g) for o, g in zip(outs, (gzout[..., sl], gzfin[:, sl])) if o.numel()]
                g = torch.autograd.grad([o for o, _ in pairs], leaves, [c for _, c in pairs])
            dct[..., sl], dz0[:, sl] = g[0], g[1]
            dw1p[lane % SLOTS] += g[2].t()
            db1p[lane % SLOTS] += g[3]
            dw2p[lane % SLOTS] += g[4]
            db2p[lane % SLOTS] += g[5]
        return 0

    return forward, backward


def _routed(forward, backward, run):
    """run() on the kernel route, the launches replaced by the stand-ins:
    the team forward and backward for every C, the flagship's H 8, C 3
    included."""
    with mock.patch.object(k2, "_runs_kernel", lambda ct: True), \
            mock.patch.object(k2, "_forward_kernel", forward), \
            mock.patch.object(k2, "_backward_kernel", backward), \
            mock.patch.object(k2, "_library", SimpleNamespace), \
            mock.patch.object(k2, "team_forward_plan", lambda *a, **k: dict(
                blocks=BLOCKS, row=ROW, scratch_floats=SCRATCH)), \
            mock.patch.object(k2, "team_plan", lambda *a: dict(slots=SLOTS, row=ROW)), \
            mock.patch.object(k2, "check_operands", lambda *a: None):
        return run()


def _solve_and_grads(x, p, C):
    field = _field(p, C)
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = fused_dopri.try_fused_dopri5(_control(xt), field, z0, T_OUT, SolverConfig())
    out.sin().sum().backward()
    return [out.detach(), xt.grad, z0.grad] + [q.grad for q in field.parameters()]


@pytest.mark.parametrize("C", [3, 14])  # the flagship's H 8, C 3; the log-ODE control's C 14
def test_launch_wrappers_with_plain_stand_ins(C, monkeypatch):
    """K2's kernel route in linear mode, in chunks of 3 intervals, with the
    kernel launches replaced by plain stand-ins (``_stand_ins``): the
    wrappers' own code pads the weights, plans and sizes the launches, and
    sums the backward's team partials.  They give the plain route's values
    and gradients (float64; the sums run in another order), with one
    forward and one backward launch per chunk, all in linear mode."""
    monkeypatch.setattr(k2, "MAX_INTERVALS", 3)
    x, p = _problem(5, C)
    plain = _solve_and_grads(x, p, C)
    k2.reset_launch_counts()
    routed = _routed(*_stand_ins([]), lambda: _solve_and_grads(x, p, C))
    assert (k2.FWD_LAUNCHES, k2.BWD_LAUNCHES) == (3, 3)
    assert (k2.LINEAR_FWD_LAUNCHES, k2.LINEAR_BWD_LAUNCHES) == (3, 3)
    for a, b in zip(plain, routed):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("C", [3, 14])
def test_weights_are_padded_once_per_solve_for_both_directions(C, monkeypatch):
    """A solve of two groups in three chunks each pads the field once: every
    forward and every backward launch reads the same padded tensors, at the
    flagship's C 3 as at C 14."""
    monkeypatch.setattr(k2, "MAX_INTERVALS", 3)
    monkeypatch.setattr(k2, "MAX_TILE", 3)
    x, p = _problem(6, C)
    pads, seen = [], []

    def counted(*args):
        pads.append(team_weights(*args))
        return pads[-1]

    k2.reset_launch_counts()
    with mock.patch.object(k2, "team_weights", counted):
        _routed(*_stand_ins(seen), lambda: _solve_and_grads(x, p, C))
    assert (k2.FWD_LAUNCHES, k2.BWD_LAUNCHES) == (6, 6)
    assert len(pads) == 1
    assert len(seen) == 12
    assert all(w is pads[0].w1 for w in seen)
