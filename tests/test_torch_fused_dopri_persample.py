"""The fused per-sample dopri5 solve (kernel K9's modules) against the JAX package.

On the CPU the port runs the plain PyTorch versions of the K9 kernels: each
chunk's per-lane PI-controlled solve, the lanes in lockstep, and for
gradients autograd through a replay of each lane's accepted steps.  The
replay is held against the JAX kernel itself: run in interpret mode (float32),
its realised per-lane meshes replayed by the port must give the kernel's
outputs and gradients.  Beside it stand the host plan's pieces against the
JAX package's (chunks, initial steps, declines), the per-lane poison carried
across chunks, the left slope at a chunk-boundary knot, batched output rows,
and the launch wrappers driven with plain stand-ins.  The CUDA kernels are
held against the plain versions on the card by ``chip_smoke.py``.
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
from torchcde_tpu.solvers import fused_dopri_persample as jps
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.integrate import select_initial_step as jax_initial_step
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu.solvers.terms import make_cde_rhs as jax_rhs
from torchcde_tpu_torch.solvers import fused_dopri_persample as fdps
from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
from torchcde_tpu_torch.solvers.fused_fixed_kernel import pack_operands
from torchcde_tpu_torch.solvers.team import team_weights
from torchcde_tpu_torch.solvers.terms import MLPVectorField, make_cde_rhs

torch.set_num_threads(1)

B, L, C, H, W = 5, 9, 3, 8, 16
ROW = 20  # the team partials' padded row length for W


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _problem(seed=1, batch=B, length=L, dtype=np.float64, spread=0.5):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, 1, C))
         + rng.uniform(-1, 1, (batch, 1, C)) * np.arange(length)[None, :, None])
    x *= (10.0 ** np.linspace(-spread, spread, batch))[:, None, None] * 0.3
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


def _control(x, linear=False):
    x = torch.as_tensor(x)
    if linear:
        return tt.LinearInterpolation(tt.linear_interpolation_coeffs(x))
    return tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))


def _solve(X, field, z0, ts, t_rows=None, **kwargs):
    kwargs = dict(dict(rtol=1e-4, atol=1e-6, max_steps=None), **kwargs)
    return fdps.try_fused_dopri5_per_sample(X, field, z0, ts, t_rows=t_rows, **kwargs)


@pytest.mark.parametrize("grid, t_lo, t_hi, max_intervals", [
    (np.arange(0.0, 1024.0), 0.0, 1023.0, 128),
    (np.arange(0.0, 300.0), 0.0, 99.0, 128),
    (np.arange(0.0, 14.0), 0.0, 13.0, 4),
    (np.arange(0.0, 14.0) * 0.5, -1.0, 7.5, 3),
    (np.arange(0.0, 14.0), 2.5, 11.0, 4),
])
def test_chunk_plan_matches_jax(grid, t_lo, t_hi, max_intervals):
    assert fdps._ps_chunk_plan(grid, t_lo, t_hi, max_intervals) == jps._ps_chunk_plan(
        grid, t_lo, t_hi, max_intervals)


def test_initial_steps_match_jax():
    x, p = _problem(2)
    X, field = _control(x), _field(p)
    z0 = torch.from_numpy(p["z0"])
    Xj = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    fj = JaxField(*(jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2")), H, C)
    # Shared start: per-lane norms, the probe at t0 + min(h0) over the lanes.
    t0 = torch.tensor(0.0, dtype=torch.float64)
    got = fdps._per_lane_initial_step(make_cde_rhs(field, X), t0, z0, 5, 1e-4, 1e-6)
    expected = jps._per_lane_initial_step(jax_rhs(fj, Xj), jnp.asarray(0.0), jnp.asarray(p["z0"]),
                                          5, 1e-4, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12)
    # Batched rows: each lane's own heuristic at its own start.
    t0 = np.array([0.0, 1.5, 2.0, 0.25, 3.0])
    got = fdps._per_lane_initial_step_at(field, X, torch.from_numpy(t0), z0, 5, 1e-4, 1e-6)

    def one(X1, z01, t01):
        rhs1 = jax_rhs(fj, X1)
        return jax_initial_step(rhs1, t01, z01, 5, 1e-4, 1e-6, rhs1(t01, z01))

    axes = jax.tree_util.tree_map(lambda leaf: 0 if getattr(leaf, "ndim", 0) >= 3 else None, Xj)
    expected = jax.vmap(one, in_axes=(axes, 0, 0))(Xj, jnp.asarray(p["z0"]), jnp.asarray(t0))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12)


def _jax_mesh(x, p, ts, rtol, atol, linear):
    """The JAX K9 kernel's realised per-lane meshes (interpret mode, float32)
    for the one chunk of a per-sample solve, as its plan launches it, and the
    controller rows it starts from."""
    xj = jnp.asarray(x, jnp.float32)
    w1, b1, w2, b2 = (jnp.asarray(p[k], jnp.float32) for k in ("w1", "b1", "w2", "b2"))
    z0 = jnp.asarray(p["z0"], jnp.float32)
    field = JaxField(w1, b1, w2, b2, H, C)
    if linear:
        X = tc.LinearInterpolation(tc.linear_interpolation_coeffs(xj))
        rows = (X._derivs, None, None)
    else:
        X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(xj))
        rows = (X._b, X._two_c, X._three_d)
    n, Bk = x.shape[1] - 1, x.shape[0]
    pk = fused_pallas._pack_operands(*rows, z0, field, n, single_tile=128, linear=linear)
    dt0 = jps._per_lane_initial_step(jax_rhs(field, X), jnp.asarray(ts[0], jnp.float32), z0, 5,
                                     rtol, atol).astype(jnp.float32).reshape(1, -1)
    dt0 = jnp.pad(dt0, ((0, 0), (0, pk.Bp - Bk)), constant_values=1.0)
    n_out = len(ts)
    ts_rows = jnp.broadcast_to(jnp.asarray(ts, jnp.float32)[:, None], (n_out, pk.Bp))
    t_start = jnp.full((1, pk.Bp), jnp.float32(ts[0]))
    tend = jnp.pad(jnp.full((1, Bk), jnp.float32(ts[-1])), ((0, 0), (0, pk.Bp - Bk)),
                   constant_values=np.float32(ts[0]))
    ctl = jnp.concatenate([t_start, dt0, jnp.zeros_like(t_start), jnp.zeros_like(t_start)])
    cap = min(jps._PS_STORE_CAP, 256 + 64 * n)
    solve = jps._make_fused_dopri_ps(n, pk.Bp, n_out, float(ts[-1]), 0.0, 1.0, rtol, atol,
                                     1 << 30, cap, C, H, W, pk.CHp, 0.9, 10.0, 0.2, True, linear,
                                     False)
    *_, ctlout, _na, _nt, _zs, aux, cnt = solve._fwd_call(
        pk.ct2, pk.z0t, pk.w1t, pk.b1c, pk.w2t, pk.b2c, ctl, ts_rows, tend,
        jnp.concatenate([pk.z0t] * n_out, axis=0))
    aux = np.asarray(aux).reshape(cap, jps._AUX_ROWS, pk.Bp)[: int(cnt[0, 0]), :, :Bk]
    on = aux[:, 2] > 0.5
    counts = on.sum(axis=0)
    t, dt = np.zeros((counts.max(), Bk), np.float32), np.zeros((counts.max(), Bk), np.float32)
    for lane in range(Bk):
        t[: counts[lane], lane] = aux[on[:, lane], 0, lane]
        dt[: counts[lane], lane] = aux[on[:, lane], 1, lane]
    mesh = k9.PsMesh(t, dt, counts, np.asarray(ctlout)[3, :Bk] > 0.5)
    return mesh, np.asarray(ctl)[:, :Bk], cap


@pytest.mark.parametrize("linear", [False, True])
def test_replay_of_the_jax_kernels_mesh_matches_the_jax_kernel(linear):
    """The JAX kernel in interpret mode realises per-lane meshes; the port's
    replay of them in float64 must give the kernel's outputs and gradients."""
    x, p = _problem(3, batch=3, length=6, dtype=np.float32)
    ts = np.array([0.0, 2.0, 5.0])  # 2.0 is a knot: a linear control reads its left slope
    rtol, atol = 1e-5, 1e-7
    names = ("x", "z0", "w1", "b1", "w2", "b2")

    def loss(args):
        co = (tc.linear_interpolation_coeffs(args[0]) if linear
              else tc.hermite_cubic_coefficients_with_backward_differences(args[0]))
        X = tc.LinearInterpolation(co) if linear else tc.CubicSpline(co)
        out = tc.cdeint(X, JaxField(*args[2:], H, C), args[1], ts, adjoint=False, rtol=rtol,
                        atol=atol, options=dict(per_sample=True))
        return jnp.sum(jnp.sin(out)), out

    fused_pallas.force_fused_pallas(True)
    args = tuple(jnp.asarray(v, jnp.float32) for v in (x, p["z0"], p["w1"], p["b1"], p["w2"],
                                                       p["b2"]))
    (_, out_k), grads_k = jax.value_and_grad(loss, has_aux=True)(args)
    mesh, ctl, cap = _jax_mesh(x, p, ts, rtol, atol, linear)
    fused_pallas.force_fused_pallas(None)
    assert mesh.cnt.min() > 3 and not mesh.bad.any()

    leaves = [torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True) for a in args]
    field = MLPVectorField(H, C, W, dtype=torch.float64)
    for layer, weight, bias in ((field.linear1, leaves[2].T, leaves[3]),
                                (field.linear2, leaves[4].T, leaves[5])):
        del layer.weight, layer.bias  # the leaves themselves, so autograd reaches them
        layer.weight, layer.bias = weight, bias
    X = _control(leaves[0], linear)
    rows = (X._derivs, None, None) if linear else (X._b, X._two_c, X._three_d)
    pk = pack_operands(*rows, leaves[1], field, linear=linear)
    ts_rows = torch.tensor(ts, dtype=torch.float64)[:, None].expand(len(ts), 3)
    plan = k9.PsPlan(float(ts[-1]), 0.0, 1.0, rtol, atol, float(1 << 30), cap, linear=linear)
    zout, _zfin = k9.fused_dopri5_per_sample_replay(
        pk.ct, pk.z0t, pk.w1t, pk.b1, pk.w2t, pk.b2, torch.from_numpy(ctl).double(), ts_rows,
        pk.z0t.unsqueeze(0).expand(len(ts), H, 3), mesh, plan)
    out = zout.permute(2, 0, 1)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_k), rtol=1e-4, atol=1e-5)
    for name, got, expected in zip(names, grads, grads_k):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_lane_dx_lead_keeps_left_continuity_at_chunk_boundary():
    """A stage exactly on a chunk-boundary knot reads the slope on its left:
    chunks after the first carry one extra interval (``lead``); times inside
    the chunk still read their own interval (the port of
    ``tests/test_per_sample.py::test_lane_dx_lead_keeps_left_continuity_at_
    chunk_boundary``)."""
    lanes = 4

    def table(js):  # slope of global interval j is j + 1
        ct = torch.zeros(len(js), 1, 1, lanes)
        for row, j in enumerate(js):
            ct[row] = j + 1.0
        return ct

    def dx(ct, t, t0g, lead=False):
        plan = k9.PsPlan(4.0, t0g, 1.0, 1e-4, 1e-6, 1e9, 10, linear=True, lead=lead)
        return float(k9._lane_dx(ct, torch.full((lanes,), t), plan, torch.float32)[0][0, 0])

    assert dx(table([0, 1, 2, 3]), 2.0, 0.0) == 2.0  # unchunked: the left slope
    assert dx(table([2, 3]), 2.0, 2.0) == 3.0  # a chunk at knot 2 without lead: the right one
    assert dx(table([1, 2, 3]), 2.0, 2.0, lead=True) == 2.0
    assert dx(table([1, 2, 3]), 2.5, 2.0, lead=True) == 3.0


def test_poison_carries_across_chunks_and_spares_the_other_lanes(monkeypatch):
    monkeypatch.setattr(k9, "MAX_INTERVALS", 3)
    x, p = _problem(4, batch=6, length=10, spread=0.8)
    X, field, z0 = _control(x), _field(p), torch.from_numpy(p["z0"])
    ts = np.linspace(0.0, 9.0, 7)
    free = _solve(X, field, z0, ts)
    budget = _solve(X, field, z0, ts, max_steps=15)
    bad = torch.isnan(budget[-1]).any(dim=-1)
    assert 0 < int(bad.sum()) < 6  # some lanes ran out, not all
    assert torch.equal(budget[:, ~bad], free[:, ~bad])
    for lane in torch.nonzero(bad).flatten().tolist():
        rows = torch.isnan(budget[:, lane]).any(dim=-1)
        first = int(torch.nonzero(rows)[0])
        # Rows before the exhausted chunk's entry keep their values; every row
        # from there on is NaN, in every later chunk too.
        assert rows[first:].all() and torch.equal(budget[:first, lane], free[:first, lane])
        assert first > 0


@pytest.mark.parametrize("linear", [False, True])
def test_batched_rows_are_each_lanes_own_solve(linear, monkeypatch):
    monkeypatch.setattr(k9, "MAX_INTERVALS", 4)
    x, p = _problem(5, batch=4, length=12)
    X, field, z0 = _control(x, linear), _field(p), torch.from_numpy(p["z0"])
    rows = np.stack([np.linspace(t0, te, 5) for t0, te in
                     ((0.0, 6.0), (1.5, 11.0), (0.0, 11.0), (3.0, 8.0))])
    out = _solve(X, field, z0, None, t_rows=torch.from_numpy(rows))
    assert out.shape == (5, 4, H)
    for lane in range(4):
        Xl = _control(x[lane:lane + 1], linear)
        alone = _solve(Xl, field, z0[lane:lane + 1], rows[lane])
        # Batched and one-lane matrix products may round apart.
        torch.testing.assert_close(out[:, lane], alone[:, 0], rtol=1e-10, atol=1e-10)


def test_declines_where_jax_declines():
    x, p = _problem()
    X, field, z0 = _control(x), _field(p), torch.from_numpy(p["z0"])
    ts = np.array([0.0, 4.0, 8.0])
    assert _solve(X, field, z0, ts) is not None
    assert _solve(X, lambda t, z: field(t, z), z0, ts) is None
    uneven = tt.CubicSpline(X._a.new_zeros((B, L - 1, 4 * C)),
                            np.array([0.0, 1.0, 2.5, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]))
    assert _solve(uneven, field, z0, ts) is None
    assert _solve(X, field, z0, np.array([0.0, 9.0])) is None  # past the grid
    assert _solve(X, field, z0, ts, max_steps=2049) is None
    assert _solve(X, field, z0, ts, max_steps=769) is None  # above 256 + 64 * 8
    assert _solve(X, field, z0, ts, max_steps=768) is not None
    assert _solve(X, field, z0, np.linspace(0.0, 8.0, 65)) is None
    assert _solve(X, field, z0, np.linspace(0.0, 8.0, 64)) is not None
    assert _solve(X, field, z0, torch.tensor(ts, requires_grad=True)) is None
    assert _solve(X, field, z0, None, t_rows=torch.tensor(np.stack([ts] * B),
                                                          requires_grad=True)) is None
    wide = MLPVectorField(H, C, 513, dtype=torch.float64)
    assert _solve(X, wide, z0, ts) is None
    # bfloat16 is upcast at the boundary, comes back bfloat16 and stays near
    # the float32 solve of the same quantized problem; mixed dtypes decline.
    bf = torch.bfloat16
    x16, field16 = torch.as_tensor(x).to(bf), _field(p).to(bf)
    out = _solve(_control(x16), field16, z0.to(bf), ts)
    ref = _solve(_control(x16.float()), field16.float(), z0.to(bf).float(), ts)
    assert out.dtype == bf and ref.dtype == torch.float32
    np.testing.assert_allclose(out.detach().float().numpy(), ref.detach().numpy(), rtol=0.06,
                               atol=0.06)
    assert _solve(_control(x16), field16, z0.float(), ts) is None


BLOCKS = 2  # the stand-ins' forward plan


def _stand_ins(partials, padded=None):
    """Stand-ins for K9's kernel launches, remembering each chunk's operands
    and meshes by the store.  The forward kernel's stand-in receives the
    solve's padded weights (collected in ``padded``) and the team plan's
    blocks and row, runs the plain version on the field (unpadded) and
    writes the kernel's outputs and store; the backward kernel's stand-in
    replays the meshes, writes dct, dz0 and dzout_in, and hands the weight
    gradients to ``partials(grads, dw1p, db1p, dw2p, db2p, replay)``, which
    fills the team partials the wrapper sums (``replay(lane)`` gives a
    lane's own gradients), each cut to the field's widths."""
    stores = {}
    padded = [] if padded is None else padded

    def forward(lib, tensors, sizes, plan, layout):
        ct, z0t, w1, b1, w2, b2, ctl, ts_rows, tend, zout_in = tensors[:10]
        zout, zfin, ctlout, nacc, natt, zst, tst, dtst, cnt = tensors[10:]
        assert layout == (BLOCKS, ROW) and w1.shape == (H, ROW) and w2.shape == (C * H, ROW)
        padded.append(w1)
        field = tuple(t.contiguous() for t in (w1[:H, :W].t(), b1[:W], w2[:C * H, :W],
                                               b2[:C * H]))
        ops = [ct, z0t, *field, ctl, ts_rows, tend, zout_in]
        *outs, mesh = k9.fused_dopri5_per_sample_reference(*ops, plan)
        for out, value in zip((zout, zfin, ctlout, nacc, natt), outs):
            out.copy_(value)
        S = mesh.t.shape[0]
        zst.zero_()
        tst[:S], dtst[:S] = torch.from_numpy(mesh.t), torch.from_numpy(mesh.dt)
        cnt.copy_(torch.as_tensor(mesh.cnt))
        stores[id(tst)] = (ops, mesh)
        return 0

    def kernel(lib, tensors, sizes, plan, layout):
        ct, _zst, tst, _dtst, ts_rows, gzout, gzfin, *_w, cnt, dct, dz0, dzout_in = tensors[:15]
        assert layout == (tensors[15].shape[0], ROW)
        padded.append(tensors[7])
        ops, mesh = stores[id(tst)]

        def replay(lanes):
            sl = slice(lanes, lanes + 1) if isinstance(lanes, int) else slice(None)
            cols = [ops[0][..., sl], ops[1][:, sl], *ops[2:6], ops[9][..., sl]]
            leaves = [t.detach().requires_grad_() for t in cols]
            lane_mesh = k9.PsMesh(mesh.t[:, sl], mesh.dt[:, sl], mesh.cnt[sl], mesh.bad[sl])
            with torch.enable_grad():
                outs = k9.fused_dopri5_per_sample_replay(*leaves[:6], ops[6][:, sl], ts_rows[:, sl],
                                                         leaves[6], lane_mesh, plan)
                return torch.autograd.grad(outs, leaves, (gzout[..., sl], gzfin[:, sl]))

        grads = replay(None)
        for out, g in zip((dct, dz0, dzout_in), (grads[0], grads[1], grads[6])):
            out.copy_(g)
        dw1p, db1p, dw2p, db2p = tensors[15:]
        assert dw1p.shape[2] == db1p.shape[1] == dw2p.shape[2] == ROW
        partials(grads, dw1p[:, :, :W], db1p[:, :W], dw2p[:, :, :W], db2p[:, :C * H], replay)
        return 0

    return forward, kernel


def _route(x, p, linear, forward, kernel, slots):
    """The solve and its gradients on the kernel route, with the launches'
    stand-ins and a team plan of ``slots`` slots and rows padded to ROW."""
    k9.reset_launch_counts()
    with mock.patch.object(k9, "_runs_kernel", lambda ct: True), \
            mock.patch.object(k9, "_forward_kernel", forward), \
            mock.patch.object(k9, "_backward_kernel", kernel), \
            mock.patch.object(k9, "_library", lambda: None), \
            mock.patch.object(k9, "team_forward_plan",
                              lambda *a, **k: dict(blocks=BLOCKS, row=ROW)), \
            mock.patch.object(k9, "team_plan", lambda *a: dict(slots=slots, row=ROW)), \
            mock.patch.object(k9, "check_operands", lambda *a: None):
        return _run_solve(x, p, linear)


def _run_solve(x, p, linear):
    field = _field(p)
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = _solve(_control(xt, linear), field, z0, np.array([0.0, 3.5, 7.0]))
    (out.sin()).sum().backward()
    return [out.detach(), xt.grad, z0.grad] + [q.grad for q in field.parameters()]


@pytest.mark.parametrize("linear", [False, True])
def test_launch_wrappers_with_plain_stand_ins(linear, monkeypatch):
    """The autograd Function's kernel route, with the kernel launches
    replaced by plain stand-ins (the forward's receives the padded weights
    and the team plan's blocks and row), gives the plain route's values and
    gradients and counts one forward and one backward launch per chunk.  The
    backward stand-in writes the weight gradients into the first of three
    team slots in the kernel's partials layout (dW1 (H, S), dW2 (C*H, S),
    rows padded to S), which the wrapper sums over the slots, cuts and
    transposes back."""
    monkeypatch.setattr(k9, "MAX_INTERVALS", 3)
    x, p = _problem(6, batch=4, length=8)

    def first_slot(grads, dw1p, db1p, dw2p, db2p, replay):
        dw1p[0], db1p[0], dw2p[0], db2p[0] = grads[2].t(), grads[3], grads[4], grads[5]

    plain = _run_solve(x, p, linear)
    routed = _route(x, p, linear, *_stand_ins(first_slot), slots=3)
    assert (k9.FWD_LAUNCHES, k9.BWD_LAUNCHES) == (3, 3)
    assert (k9.LINEAR_FWD_LAUNCHES, k9.LINEAR_BWD_LAUNCHES) == ((3, 3) if linear else (0, 0))
    for a, b in zip(plain, routed):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("slots", [2, 5])
def test_team_partials_sum_to_the_replays_gradients(slots, monkeypatch):
    """As the team kernel leaves them: lane l's own weight gradients added
    into slot l % slots (teams stride over the lanes when there are fewer
    slots than lanes; a slot past the batch stays zero).  The wrapper's sums
    over the slots give the plain route's gradients (float64; the sums run
    in another order)."""
    monkeypatch.setattr(k9, "MAX_INTERVALS", 3)
    x, p = _problem(7, batch=4, length=8)

    def per_lane(grads, dw1p, db1p, dw2p, db2p, replay):
        for lane in range(grads[1].shape[1]):
            g, slot = replay(lane), lane % slots
            dw1p[slot] += g[2].t()
            db1p[slot] += g[3]
            dw2p[slot] += g[4]
            db2p[slot] += g[5]

    plain = _run_solve(x, p, False)
    routed = _route(x, p, False, *_stand_ins(per_lane), slots=slots)
    assert k9.BWD_LAUNCHES == 3
    for a, b in zip(plain, routed):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("linear", [False, True])
def test_weights_are_padded_once_per_solve_for_both_directions(linear, monkeypatch):
    """A solve in three chunks pads the field once: every forward and every
    backward launch reads the same padded tensors."""
    monkeypatch.setattr(k9, "MAX_INTERVALS", 3)
    x, p = _problem(8, batch=4, length=8)
    pads, seen = [], []

    def counted(*args):
        pads.append(team_weights(*args))
        return pads[-1]

    def first_slot(grads, dw1p, db1p, dw2p, db2p, replay):
        dw1p[0], db1p[0], dw2p[0], db2p[0] = grads[2].t(), grads[3], grads[4], grads[5]

    with mock.patch.object(k9, "team_weights", counted):
        _route(x, p, linear, *_stand_ins(first_slot, seen), slots=3)
    assert (k9.FWD_LAUNCHES, k9.BWD_LAUNCHES) == (3, 3)
    assert len(pads) == 1 and len(seen) == 6
    assert all(w is pads[0].w1 for w in seen)
