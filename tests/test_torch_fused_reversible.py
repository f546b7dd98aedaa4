"""The port's fused reversible-Heun solve (kernel K8's module) against the JAX package.

On the CPU the port's ``cdeint`` over an ``MLPVectorField`` runs the plain
PyTorch version of the K8 kernels.  It is held against the JAX K8 kernel run
in Pallas interpret mode (float32), and against the JAX package's XLA
reversible path (float64), from which it differs only in where it evaluates
dX/dt at a knot: the kernels read the next interval's rows at fraction 0, the
XLA path the left interval at its end, equal for a C1 control up to rounding.
The gradients compared are those to the raw data (through the Hermite
coefficients), z0 and the four weights, which both routings share.  The CUDA
kernels themselves are held against the plain version on the card by
``chip_smoke.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)


def _problem(B, L, C, H, W, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = dict(x=rng.standard_normal((B, L, C)), w1=rng.standard_normal((H, W)) * 0.2,
                  b1=rng.standard_normal(W) * 0.2, w2=rng.standard_normal((W, H * C)) * 0.2,
                  b2=rng.standard_normal(H * C) * 0.2, z0=rng.standard_normal((B, H)))
    return {k: v.astype(dtype) for k, v in arrays.items()}


NAMES = ("x", "z0", "w1", "b1", "w2", "b2")


def _jax_run(p, H, t, use_kernel, **kwargs):
    """Values and gradients of sum(sin(out)) through the JAX cdeint, with its
    K8 kernel in interpret mode or its XLA path."""
    C = p["x"].shape[-1]

    def run(x, z0, w1, b1, w2, b2):
        fused_pallas.force_fused_pallas(use_kernel)
        try:
            X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x))
            return tc.cdeint(X, JaxField(w1, b1, w2, b2, H, C), z0, t, method="reversible_heun",
                             **kwargs)
        finally:
            fused_pallas.force_fused_pallas(None)

    def loss(*a):
        out = run(*a)
        return jnp.sum(jnp.sin(out)), out

    args = tuple(jnp.asarray(p[k]) for k in NAMES)
    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _field(p, H):
    C, W = p["x"].shape[-1], p["w1"].shape[1]
    field = MLPVectorField(H, C, W, dtype=torch.from_numpy(p["x"]).dtype)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    return field


def _torch_run(p, H, t, **kwargs):
    """The port's cdeint over the MLP field: values and gradients of sum(sin(out))."""
    field = _field(p, H)
    x = torch.from_numpy(p["x"]).requires_grad_()
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
    out = tt.cdeint(X, field, z0, t, method="reversible_heun", **kwargs)
    torch.sin(out).sum().backward()
    grads = [x.grad, z0.grad, field.linear1.weight.grad.T, field.linear1.bias.grad,
             field.linear2.weight.grad.T, field.linear2.bias.grad]
    return out.detach().numpy(), [g.numpy() for g in grads]


def _assert_close(got, expected, rtol, name):
    # atol is a tenth of rtol relative to the largest magnitude: an entry that
    # cancels to near zero keeps the rounding of its largest terms.
    np.testing.assert_allclose(got, expected, rtol=rtol,
                               atol=rtol * 0.1 * float(np.abs(expected).max()), err_msg=name)


@pytest.mark.parametrize("H, C", [(4, 3), (8, 3), (16, 3), (8, 5)], ids=["4", "8", "H16", "C5"])
def test_plain_k8_matches_jax_kernel(H, C):
    # float32 on both sides: the JAX K8 kernel in interpret mode (its forward
    # and its inverse-map backward) against the port's plain K8 and autograd
    # through it.  They round in different orders, and XLA's CPU code rounds
    # as its host's instructions do, so the solutions are held against the
    # port's plain K8 in float64 on the same (float32) inputs: each float32
    # solve lies within 1e-5 of the largest magnitude of it (a tenth of the
    # reference's 1e-4; both measure ~4e-7..1e-6), and the two lie no farther
    # from each other than the farther of them from it (measured 0.28..0.6 of
    # that), so their gap is float32 rounding and nothing else.  The
    # gradients hold to 1e-4 (at 1e-5 one entry of 384 differs by 1.2e-4).
    p = _problem(3, 7, C, H, 16, np.float32, seed=2)
    t = np.array([0.0, 3.0, 6.0], dtype=np.float32)
    kwargs = dict(adjoint=True, backend="torchsde", dt=0.5)
    out_j, grads_j = _jax_run(p, H, t, True, **kwargs)
    out_t, grads_t = _torch_run(p, H, t, **kwargs)
    assert out_t.shape == out_j.shape == (3, 3, H)
    p64 = {k: v.astype(np.float64) for k, v in p.items()}
    out_64, _ = _torch_run(p64, H, t.astype(np.float64), **kwargs)
    err_t, err_j = (float(np.abs(out - out_64).max()) for out in (out_t, out_j))
    assert max(err_t, err_j) <= 1e-5 * float(np.abs(out_64).max()), (err_t, err_j)
    assert float(np.abs(out_t - out_j).max()) <= max(err_t, err_j)
    for name, got, expected in zip(NAMES, grads_t, grads_j):
        _assert_close(got, expected, 1e-4, name)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("t, step", [(np.linspace(0.0, 8.0, 9), 0.5),
                                     (np.array([1.0, 4.0, 8.0]), 1.0)])
def test_port_routing_matches_jax_xla_path(adjoint, t, step):
    # float64: the port's plain K8 against the JAX package's XLA reversible
    # path (reversible_heun_solve with the adjoint, the stepper without).
    p = _problem(4, 9, 3, 8, 16, np.float64, seed=3)
    out_j, grads_j = _jax_run(p, 8, t, False, adjoint=adjoint, step_size=step)
    out_t, grads_t = _torch_run(p, 8, t, adjoint=adjoint, step_size=step)
    _assert_close(out_t, out_j, 1e-10, "solution")
    for name, got, expected in zip(NAMES, grads_t, grads_j):
        _assert_close(got, expected, 1e-9, name)


def test_cpu_path_runs_the_plain_version():
    p = _problem(4, 9, 3, 8, 16, np.float64, seed=3)
    k8.reset_launch_counts()
    _torch_run(p, 8, np.linspace(0.0, 8.0, 9), adjoint=True, step_size=0.5)
    assert (k8.FWD_LAUNCHES, k8.BWD_LAUNCHES) == (0, 0)


def _spline(B, L, C, dtype=torch.float64, t=None):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, L, C))).to(dtype)
    return tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x, t), t)


# (label, control, field (H, C, W), output times, step): each declined, as
# the JAX package declines it.
DECLINES = [
    ("9 substeps", lambda: _spline(3, 6, 3), (8, 3, 16), np.arange(6.0), 1 / 9),
    ("non-uniform knots", lambda: _spline(3, 4, 3, t=np.array([0.0, 1.0, 3.0, 4.0])),
     (8, 3, 16), np.array([0.0, 1.0, 3.0, 4.0]), 1.0),
    ("3 C > 16", lambda: _spline(3, 5, 6), (4, 6, 16), np.arange(5.0), 1.0),
    ("C H > 512", lambda: _spline(3, 5, 5), (103, 5, 16), np.arange(5.0), 1.0),
    ("times off the grid", lambda: _spline(3, 6, 3), (8, 3, 16), np.array([0.0, 2.5, 5.0]), 0.5),
]


@pytest.mark.parametrize("label, control, shape, t, step", DECLINES, ids=[d[0] for d in DECLINES])
def test_declines_where_jax_declines(label, control, shape, t, step):
    X = control()
    H, C, W = shape
    field = MLPVectorField(H, C, W, dtype=torch.float64)
    z0 = torch.from_numpy(np.random.default_rng(1).standard_normal((3, H)))
    assert k8.try_fused_reversible_heun(X, field, z0, t, step) is None
    # The declined solve takes the plain reversible path: the same values as
    # the same field seen as a closure, which only that path takes.
    with torch.no_grad():
        for adjoint in (False, True):
            got = tt.cdeint(X, field, z0, t, adjoint=adjoint, method="reversible_heun",
                            step_size=step)
            plain = tt.cdeint(X, lambda s, z: field(s, z), z0, t, adjoint=adjoint,
                              method="reversible_heun", step_size=step)
            assert torch.equal(got, plain)


def test_takes_shapes_at_the_caps():
    X = _spline(3, 6, 5)
    field = MLPVectorField(102, 5, 512, dtype=torch.float64)
    z0 = torch.zeros(3, 102, dtype=torch.float64)
    assert k8.try_fused_reversible_heun(X, field, z0, np.arange(6.0), 0.125) is not None


def test_bf16_raises_the_k1_message():
    """bfloat16 takes K8 upcast at the boundary (K8 has no bfloat16 mode, in
    the JAX package either): the solution comes back bfloat16, near the
    float32 solve of the same quantized problem (tests/test_fused_pallas.py);
    mixed dtypes decline."""
    bf = torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 6, 3))).to(bf)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(x)
    X, X32 = tt.CubicSpline(coeffs), tt.CubicSpline(coeffs.float())
    field = MLPVectorField(8, 3, 16, dtype=bf)
    z0 = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 8))).to(bf)
    out = k8.try_fused_reversible_heun(X, field, z0, np.arange(6.0), 1.0)
    ref = k8.try_fused_reversible_heun(X32, field.float(), z0.float(), np.arange(6.0), 1.0)
    assert out.dtype == bf and ref.dtype == torch.float32
    np.testing.assert_allclose(out.detach().float().numpy(), ref.detach().numpy(), rtol=0.06,
                               atol=0.06)
    assert k8.try_fused_reversible_heun(X, field, z0.float(), np.arange(6.0), 1.0) is None


def _operands(n, C, B, H, W, seed):
    rng = np.random.default_rng(seed)
    arrays = (0.3 * rng.standard_normal((n, 3, C, B)), rng.standard_normal((H, B)),
              rng.standard_normal((W, H)) * 0.3, rng.standard_normal(W) * 0.1,
              rng.standard_normal((C * H, W)) * 0.3, rng.standard_normal(C * H) * 0.1)
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m", [1, 3])
def test_backward_walk_matches_autograd(m):
    # The backward kernel's algorithm in plain PyTorch: from the stored
    # states, the inverse map and the per-step VJPs give autograd's
    # gradients through the forward (float64; the inverse map's rounding).
    ops = _operands(5, 3, 4, 8, 16, seed=m)
    leaves = [t.clone().requires_grad_() for t in ops]
    y, yhat = k8.fused_reversible_solve_reference(*leaves, m, 1.0 / m)
    gy = torch.from_numpy(np.random.default_rng(7).standard_normal(y.shape))
    expected = torch.autograd.grad(y, leaves, gy)
    got = k8.fused_reversible_backward_reference(ops[0], y.detach(), yhat.detach(), gy,
                                                 *ops[2:], m, 1.0 / m)
    for name, g, e in zip(("ct", "z0", "w1", "b1", "w2", "b2"), got, expected):
        torch.testing.assert_close(g, e, rtol=1e-12, atol=1e-12, msg=name)


# Backward plans of a 4-lane batch: the resident weights' one block of 128
# lanes, and a streamed plan of three blocks (the partials' leading size).
STAND_IN_PLANS = [dict(variant=0, blocks=1), dict(variant=1, blocks=3)]


@pytest.mark.parametrize("launch", STAND_IN_PLANS, ids=["resident", "streamed"])
def test_autograd_function_and_launch_counts_with_stand_ins(launch, monkeypatch):
    # The kernels run only on the card: stand-ins for the forward launch (the
    # plain forward, counting) and for the backward kernel (the plain
    # backward walk, its weight gradients split over the plan's blocks) drive
    # the autograd Function, the backward wrapper's sizing of the partials
    # from the plan and their sum, the selection of the output knots and the
    # counters.
    def forward(ct, z0t, w1t, b1, w2t, b2, plan):
        k8.FWD_LAUNCHES += 1
        with torch.no_grad():
            return k8.fused_reversible_solve_reference(ct, z0t, w1t, b1, w2t, b2, plan.m,
                                                       plan.dt_sub)

    def backward_kernel(ops, outs, shape, plan, planned):
        assert planned is launch and shape == (4, 8, 8, 3, 16)
        dct, dz0, dw1t, db1, dw2t, db2 = k8.fused_reversible_backward_reference(
            *ops, plan.m, plan.dt_sub)
        outs[0].copy_(dct)
        outs[1].copy_(dz0)
        blocks = launch["blocks"]
        shares = torch.arange(1.0, blocks + 1, dtype=dct.dtype) / (blocks * (blocks + 1) / 2)
        for partial, grad in zip(outs[2:], (dw1t, db1, dw2t.t(), db2)):
            assert partial.shape == (blocks,) + grad.shape
            partial.copy_(shares.reshape((blocks,) + (1,) * grad.dim()) * grad)

    def solve(ct, z0t, w1t, b1, w2t, b2, m, dt_sub):
        return k8._FusedReversibleSolve.apply(ct, z0t, w1t, b1, w2t, b2, k8._Plan(m, dt_sub))

    p = _problem(4, 9, 3, 8, 16, np.float64, seed=4)
    t = np.array([0.0, 3.0, 8.0])
    expected = _torch_run(p, 8, t, adjoint=True, step_size=0.5)
    monkeypatch.setattr(k8, "launch_forward", forward)
    monkeypatch.setattr(k8, "backward_plan", lambda B, H, C, W, device: launch)
    monkeypatch.setattr(k8, "_backward_kernel", backward_kernel)
    monkeypatch.setattr(k8, "check_operands", lambda *a: None)
    monkeypatch.setattr(k8, "fused_reversible_solve", solve)
    k8.reset_launch_counts()
    got = _torch_run(p, 8, t, adjoint=True, step_size=0.5)
    assert (k8.FWD_LAUNCHES, k8.BWD_LAUNCHES) == (1, 1)
    np.testing.assert_array_equal(got[0], expected[0])
    for name, g, e in zip(NAMES, got[1], expected[1]):
        _assert_close(g, e, 1e-12, name)
    k8.reset_launch_counts()


# ---------------------------------------------------------------------------
# A numpy mirror of the forward kernel's arithmetic (csrc/fused_reversible.cu,
# rev_fwd_kernel): a warp per 16 batch lanes, the stage products as
# mma.sync m16n8k8 tiles in TF32, three passes (lo.hi and hi.lo summed apart,
# then added to hi.hi) with each float32 operand split as hi = tf32(x), lo =
# tf32(x - hi), W in chunks of 8 hidden units and H in state tiles of 8, both
# padded with zero weights, every operand in the kernel's fragment layout
# with the contraction index permuted (k t is column 2t, k t + 4 column
# 2t + 1), and past two tiles the warp split: S warps per lane group, each
# computing the whole h1 from every tile's A fragments and the second
# product for its NTW tiles.  Sums are float64: what is held against the
# plain version is the algorithm (the layout, the permutation, the padding,
# the split and the TF32 passes), not the card's rounding of its sums, which
# chip_smoke.py holds against the plain version.

_G, _T = np.arange(32) // 4, np.arange(32) % 4  # a thread's group and index in it


def _tf32(x):
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """(hi, lo) of float32 x: hi = tf32(x), lo = tf32(x - hi)."""
    x = np.asarray(x, dtype=np.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(a, b, c):
    """D = A B + C of one m16n8k8 tile per warp from the threads' fragments:
    a (..., 32, 4), b (32, 2), c (..., 32, 4) as PTX lays them out."""
    A = np.zeros(a.shape[:-2] + (16, 8))
    A[..., _G, _T], A[..., _G + 8, _T] = a[..., 0], a[..., 1]
    A[..., _G, _T + 4], A[..., _G + 8, _T + 4] = a[..., 2], a[..., 3]
    B = np.zeros((8, 8))
    B[_T, _G], B[_T + 4, _G] = b[:, 0], b[:, 1]
    C = np.zeros(c.shape[:-2] + (16, 8))
    C[..., _G, 2 * _T], C[..., _G, 2 * _T + 1] = c[..., 0], c[..., 1]
    C[..., _G + 8, 2 * _T], C[..., _G + 8, 2 * _T + 1] = c[..., 2], c[..., 3]
    D = A @ B + C
    return np.stack([D[..., _G, 2 * _T], D[..., _G, 2 * _T + 1], D[..., _G + 8, 2 * _T],
                     D[..., _G + 8, 2 * _T + 1]], axis=-1)


def _mma3(d, x, a, b, passes=3):
    """The kernel's passes of d += a b: a = (hi, lo) fragments, b (32, 4)
    staged as (hi0, hi1, lo0, lo1); the cross terms lo.hi and hi.lo into x,
    hi.hi into d.  One pass: hi.hi alone.  Returns (d, x)."""
    ahi, alo = a
    if passes == 3:
        x = _mma(ahi, b[:, 2:], _mma(alo, b[:, :2], x))
    return _mma(ahi, b[:, :2], d), x


def _as_a(c):
    """The A fragments (hi, lo) of an operand held as an accumulator
    fragment: (c0, c2, c1, c3), rounded to the kernel's float32 first."""
    return _split(np.asarray(c)[..., [0, 2, 1, 3]])


def _fwd_tiles(H):
    """(NT, NTW, S) as forward_plan picks them: state tiles (H padded to
    8 NT), tiles a warp, warps a lane group (past two tiles, at most 8)."""
    tiles = -(-H // 8)
    if tiles <= 2:
        return tiles, tiles, 1
    ntw = 2
    while -(-tiles // ntw) > 8:
        ntw *= 2
    S = -(-tiles // ntw)
    return S * ntw, ntw, S


def _stage(w1t, b1, w2t, b2, NT):
    """The weights as the kernel stages them (tc_frag): fragments (chunks,
    NT (1 + C), 32, 4), b1 padded to whole chunks, b2 (C, 8 NT)."""
    w1t, b1, w2t, b2 = (np.asarray(a, dtype=np.float32) for a in (w1t, b1, w2t, b2))
    W, H = w1t.shape
    C = w2t.shape[0] // H
    chunks, F = -(-W // 8), NT * (1 + C)
    frag = np.zeros((chunks, F, 32, 4), np.float32)
    for c in range(chunks):
        for j in range(F):
            v = np.zeros((2, 32), np.float32)
            if j < NT:  # W1's k-step j: B[k][n] = w1t[8c + n][8j + perm k]
                w, k = c * 8 + _G, 8 * j + 2 * _T
                for e in range(2):
                    ok = (w < W) & (k + e < H)
                    v[e, ok] = w1t[w[ok], k[ok] + e]
            else:  # channel i's W2, state tile s: B[k][n] = w2t[i H + 8s + n][8c + perm k]
                i, st = divmod(j - NT, NT)
                k, w = 8 * st + _G, c * 8 + 2 * _T
                for e in range(2):
                    ok = (k < H) & (w + e < W)
                    v[e, ok] = w2t[i * H + k[ok], w[ok] + e]
            (h0, l0), (h1, l1) = _split(v[0]), _split(v[1])
            frag[c, j] = np.stack([h0, h1, l0, l1], axis=-1)
    b1s = np.zeros(chunks * 8, np.float32)
    b1s[:W] = b1
    b2s = np.zeros((C, 8 * NT), np.float32)
    b2s[:, :H] = b2.reshape(C, H)
    return frag, b1s, b2s


def _tc_field(stage, y, dx, ntw, passes=3):
    """k = f(y) . dx for lane groups of 16: y (groups, NT, 32, 4) in the
    accumulator layout (r // 2: lane g or g + 8; r % 2: component 2t or
    2t + 1 of the tile), dx (groups, 32, 2, C) of each thread's two lanes;
    warp s of a group owns tiles s ntw .. s ntw + ntw - 1."""
    frag, b1s, b2s = stage
    NT, C = y.shape[1], dx.shape[-1]
    a = [_as_a(y[:, kt]) for kt in range(NT)]  # every warp reads every tile's fragments

    def bias(v, at):  # (v[at], v[at + 1]) at both of a thread's lanes
        pair = np.stack([v[at], v[at + 1], v[at], v[at + 1]], axis=-1).astype(np.float64)
        return np.broadcast_to(pair, y[:, 0].shape)

    lane_of = np.array([0, 0, 1, 1])
    k = np.zeros(y.shape)
    for s in range(NT // ntw):
        tiles = [s * ntw + nt for nt in range(ntw)]
        G = {(i, st): bias(b2s[i], 8 * st + 2 * _T) for i in range(C) for st in tiles}
        X = {key: np.zeros(y[:, 0].shape) for key in G}
        for c in range(frag.shape[0]):
            h, hx = bias(b1s, c * 8 + 2 * _T), np.zeros(y[:, 0].shape)
            for kt in range(NT):
                h, hx = _mma3(h, hx, a[kt], frag[c, kt], passes)
            hl = _as_a(np.maximum(h + hx, 0.0))
            for (i, st) in G:
                G[i, st], X[i, st] = _mma3(G[i, st], X[i, st], hl, frag[c, NT + i * NT + st],
                                           passes)
        for st in tiles:
            k[:, st] = sum(np.tanh(G[i, st] + X[i, st]) * dx[..., lane_of, i] for i in range(C))
    return k


def _lane_index(B, NT):
    """(components, lanes) gathering (8 NT, B) arrays into the threads'
    registers (groups, NT, 32, 4), for B padded to whole lane groups."""
    groups = -(-B // 16)
    w, nt, L, r = np.meshgrid(np.arange(groups), np.arange(NT), np.arange(32), np.arange(4),
                              indexing="ij")
    return 8 * nt + 2 * (L % 4) + (r & 1), w * 16 + L // 4 + 8 * (r >> 1)


def _padded(a, rows, cols):
    out = np.zeros((rows, cols))
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _tc_solve(ct, z0t, w1t, b1, w2t, b2, m, dt, passes=3):
    """The kernel's walk (rev_fwd_kernel) on the mirror's field: (y, ŷ),
    each (n, H, B), float64, lanes past B and components past H on zeros."""
    n, _, C, B = ct.shape
    H = z0t.shape[0]
    NT, ntw, _S = _fwd_tiles(H)
    groups = -(-B // 16)
    stage = _stage(w1t, b1, w2t, b2, NT)
    hs, lanes = _lane_index(B, NT)
    pad = np.zeros((n, 3, C, groups * 16))
    pad[..., :B] = ct
    y = yh = _padded(z0t, 8 * NT, groups * 16)[hs, lanes]
    two = np.arange(groups)[:, None, None] * 16 + _G[None, :, None] + 8 * np.arange(2)
    ys, yhs = [], []
    for j in range(n):
        rows = pad[j][..., two]  # (3, C, groups, 32, 2)
        sb, sc, sd = (np.moveaxis(r, 0, -1) for r in rows)  # (groups, 32, 2, C)

        def dxdt(fr):
            return sb + (sc + sd * fr) * fr

        f = _tc_field(stage, yh, dxdt(0.0), ntw, passes)
        for s in range(m):
            yn = 2.0 * y - yh + dt * f
            f1 = _tc_field(stage, yn, dxdt(float(np.float32((s + 1) * dt))), ntw, passes)
            y, yh, f = y + 0.5 * dt * (f + f1), yn, f1
        for out, v in ((ys, y), (yhs, yh)):
            full = np.zeros((8 * NT, groups * 16))
            full[hs, lanes] = v
            out.append(full[:H, :B])
    return np.stack(ys), np.stack(yhs)


def _f32_operands(n, C, B, H, W, seed):
    """K8's operands rounded to float32, as float64 tensors."""
    return [t.float().double() for t in _operands(n, C, B, H, W, seed)]


# (H, C): H 8, C 3 (one tile, one warp); H 7, C 2 (a padded tile); H 16
# (two tiles, one warp); H 16, C 5; H 102, C 5 (the caps: 13 tiles padded to
# 14, seven warps of two tiles).
FIELD_SHAPES = [(8, 3), (7, 2), (16, 3), (16, 5), (102, 5)]


@pytest.mark.parametrize("H, C", FIELD_SHAPES, ids=[f"H{h}C{c}" for h, c in FIELD_SHAPES])
def test_tensor_core_field_matches_the_plain_field(H, C):
    # B 37 (three lane groups, the last part-filled), W 40 (five chunks, the
    # last padded): the mirror's field against the plain field in float64 on
    # the same float32 inputs, within 1e-6 of its largest magnitude; one TF32
    # pass is ~2^-11 off, which is why the kernel takes three.
    ops = _f32_operands(1, C, 37, H, 40, seed=11)
    ct, z0t, w1t, b1, w2t, b2 = (t.numpy() for t in ops)
    NT, ntw, _S = _fwd_tiles(H)
    stage = _stage(w1t, b1, w2t, b2, NT)
    hs, lanes = _lane_index(37, NT)
    two = np.arange(3)[:, None, None] * 16 + _G[None, :, None] + 8 * np.arange(2)
    rows = _padded(ct[0, 0], C, 48)  # dX/dt at fraction 0: the b row
    dx = np.moveaxis(rows[:, two], 0, -1)
    errors = {}
    with torch.no_grad():
        ref = k8._field(ops[1].t(), 0.0, tuple(ops[0][0].permute(0, 2, 1)), *ops[2:]).t().numpy()
    for passes in (3, 1):
        full = np.zeros((8 * NT, 48))
        full[hs, lanes] = _tc_field(stage, _padded(z0t, 8 * NT, 48)[hs, lanes], dx, ntw, passes)
        errors[passes] = float(np.abs(full[:H, :37] - ref).max()) / float(np.abs(ref).max())
    print(f"field relative error (H {H}, C {C}): three passes {errors[3]:.2e}, "
          f"one pass {errors[1]:.2e}")
    assert errors[3] <= 1e-6, errors


# (m, H, C); the H 8, C 3 cases keep their first ids.
WALKS = [(m, H, C) for m in (1, 3) for H, C in FIELD_SHAPES]


@pytest.mark.parametrize("m, H, C", WALKS,
                         ids=[f"{m}" if (H, C) == (8, 3) else f"{m}-H{H}C{C}" for m, H, C in WALKS])
def test_tensor_core_walk_matches_the_reference_solve(m, H, C):
    # The kernel's walk on the mirror's field against the plain version in
    # float64: B 37 and W 40 are no multiples of the tile; within 1e-5 of
    # the largest magnitude (the one-pass error is printed beside it).
    ops = _f32_operands(9, C, 37, H, 40, seed=20 + m)
    with torch.no_grad():
        ref = torch.cat(k8.fused_reversible_solve_reference(*ops, m, 1.0 / m)).numpy()
    scale = float(np.abs(ref).max())
    errors = {}
    for passes in (3, 1):
        got = np.concatenate(_tc_solve(*(t.numpy() for t in ops), m, 1.0 / m, passes))
        assert got.shape == ref.shape
        errors[passes] = float(np.abs(got - ref).max()) / scale
    print(f"solve relative error (m {m}, H {H}, C {C}): three passes {errors[3]:.2e}, "
          f"one pass {errors[1]:.2e}")
    assert errors[3] <= 1e-5, errors


# ---------------------------------------------------------------------------
# A numpy mirror of the backward kernel's partition (csrc/
# fused_reversible_bwd.cu, rev_bwd_kernel), float64: G threads per lane, rank
# r owning the state components r HS .. r HS + HS - 1 (H padded to Hp = G HS
# with zero weights) and every channel's second-layer rows of them; per row
# of the weights' records, the H-long and C H-long dot products summed over
# the group by a butterfly (each rank adds its partner's sum at distances 1,
# 2, 4, ...); the W-long ones in one rank.  The weight gradients go through
# the block's units: chunks of CR rows, unit u of a chunk (row quad u // NB,
# column block u % NB) to thread u % T, summed over the block's LB lanes
# and written, past H and W dropped, into the block's partial; the blocks
# stride over the lane groups, and their partials are summed at the end.


def _bwd_shape(H, C, small=False):
    """(HS, G, Hp, LB) as backward_plan picks them (small: at a batch whose
    lane groups are fewer than half the SMs)."""
    HS = 16 if C == 1 and H > 256 else 8
    G = 1
    while G * HS < H:
        G *= 2
    Hp = G * HS
    if small and G > 1 and HS == 8 and 2 * G <= 32:
        HS, G = 4, 2 * G
    return HS, G, Hp, (256 // G if G > 1 else 128)


def _butterfly(parts):
    """The group's sum in every rank: parts (G, ...) of the ranks."""
    G, o = parts.shape[0], 1
    while o < G:
        parts = parts + parts[np.arange(G) ^ o]
        o *= 2
    assert all(np.array_equal(parts[0], p) for p in parts)
    return parts[0]


def _records(w1t, b1, w2t, Hp, W4):
    """The weights' records (rec_value): per row W1's row, W2's column in the
    order q = i Hp + h, b1 and three zeros; rows past W zero."""
    W, H = w1t.shape
    C = w2t.shape[0] // H
    rec = np.zeros((W4, (1 + C) * Hp + 4))
    rec[:W, :H] = w1t
    for i in range(C):
        rec[:W, (1 + i) * Hp:(1 + i) * Hp + H] = w2t[i * H:(i + 1) * H].T
    rec[:W, (1 + C) * Hp] = b1
    return rec


def _group_vjp(rec, b2s, y, u, dx, HS, G):
    """One evaluation and its VJP for lanes (L, Hp) partitioned over G ranks:
    k, dy, ddx and the reduction's operands h1, dp1 (L, W4) and dp2 (L, C Hp)."""
    L, Hp = y.shape
    C = dx.shape[1]
    W4 = rec.shape[0]
    w1 = rec[:, :Hp].reshape(W4, G, HS)
    w2 = rec[:, Hp:(1 + C) * Hp].reshape(W4, C, G, HS)
    ys, us = y.reshape(L, G, HS), u.reshape(L, G, HS)
    h = np.maximum(_butterfly(np.einsum("wgj,lgj->glw", w1, ys)) + rec[:, (1 + C) * Hp], 0.0)
    g = np.tanh(np.einsum("wcgj,lw->lcgj", w2, h) + b2s.reshape(C, G, HS))
    k = np.einsum("lcgj,lc->lgj", g, dx)
    ddx = _butterfly(np.einsum("lgj,lcgj->glc", us, g))
    dp2 = us[:, None] * dx[:, :, None, None] * (1.0 - g * g)
    dh = _butterfly(np.einsum("wcgj,lcgj->glw", w2, dp2))
    p = np.where(h > 0.0, dh, 0.0)
    dy = np.einsum("wgj,lw->lgj", w1, p)
    return k.reshape(L, Hp), dy.reshape(L, Hp), ddx, h, p, dp2.reshape(L, C * Hp)


def _unit_cells(W, H, C, Hp, CR, threads):
    """Every unit of the block's reduction: (chunk, its 4 padded rows, its 8
    padded columns (dp2 in the order q = i Hp + h, then y), the rows kept
    (< W), the columns kept (h < H), their columns in the partial (dW2 as
    q = i H + h, then dW1)).  Each real cell is checked to be written once."""
    W4 = -(-W // 4) * 4
    NB, NBQ = (1 + C) * Hp // 8, C * Hp // 8
    upc = -(-(CR // 4 * NB) // threads)
    cells, covered = [], np.zeros((W, (1 + C) * H), int)
    for c in range(-(-W4 // CR)):
        rows = min(CR, W4 - c * CR)
        for jj in range(upc):
            for tid in range(threads):
                k, b = divmod(tid + jj * threads, NB)
                if 4 * k >= rows:
                    continue
                w, cols = c * CR + 4 * k + np.arange(4), 8 * b + np.arange(8)
                i, hp = np.divmod(cols if b < NBQ else cols - C * Hp, Hp)
                real = i * H + hp if b < NBQ else C * H + hp
                cell = (c, w, cols, w < W, hp < H, real[hp < H])
                covered[np.ix_(w[w < W], cell[5])] += 1
                cells.append(cell)
    assert (covered == 1).all()
    return cells


def _group_backward(ct, y, yhat, gy, w1t, b1, w2t, b2, m, dt, blocks, CR=128, small=False):
    """The backward kernel's walk over its group partition and units:
    (dct, dz0, dw1t, db1, dw2t, db2) as ``launch_backward`` returns them."""
    n, _, C, B = ct.shape
    W, H = w1t.shape
    HS, G, Hp, LB = _bwd_shape(H, C, small)
    rec = _records(w1t, b1, w2t, Hp, -(-W // 4) * 4)
    b2s = _padded(b2.reshape(C, H), C, Hp).reshape(-1)
    cells = _unit_cells(W, H, C, Hp, CR, LB * G)
    partials = np.zeros((blocks, W, (1 + C) * H + 1))  # dW2 | dW1 | db1
    db2p = np.zeros((blocks, C * H))
    dct = np.zeros(ct.shape)
    dz0 = np.zeros((H, B))
    for grp in range(-(-B // LB)):
        blk = grp % blocks  # blocks stride over the lane groups
        lanes = grp * LB + np.arange(LB)
        live = lanes < B
        at = np.minimum(lanes, B - 1)

        def lanes_of(a):  # (H, B) -> (LB, Hp), lanes past B zero
            return _padded(a[:, at].T * live[:, None], LB, Hp)

        ay = ayh = np.zeros((LB, Hp))
        for j in reversed(range(n)):
            ay = ay + lanes_of(gy[j])
            y1, yh1 = lanes_of(y[j]), lanes_of(yhat[j])
            sb, sc, sd = (ct[j, r][:, at].T * live[:, None] for r in range(3))
            for st in reversed(range(m)):
                for fr, second in (((st + 1) * dt, True), (st * dt, False)):
                    if second:  # f1 = f(yh1) and its VJP
                        u, yv = 0.5 * dt * ay, yh1
                    else:  # the inverse map's companion, f0 = f(yh0) and its VJP
                        yv = 2.0 * y1 - yh1 - dt * f1
                        ayh = ayh + v
                        u = 0.5 * dt * ay + dt * ayh
                    f, v, ddx, h, p, dp2 = _group_vjp(rec, b2s, yv, u, sb + (sc + sd * fr) * fr,
                                                      HS, G)
                    right = np.concatenate([dp2, yv], axis=1)
                    for c, w, cols, rk, ck, real in cells:
                        dw1_block = cols[0] >= C * Hp
                        left = (p if dw1_block else h)[:, w]
                        tile = left.T @ right[:, cols]  # summed over the block's lanes
                        partials[blk][np.ix_(w[rk], real)] += tile[np.ix_(rk, ck)]
                        if cols[0] == C * Hp:
                            partials[blk][w[rk], -1] += left.sum(0)[rk]
                        if c == 0 and w[0] == 0 and not dw1_block:
                            db2p[blk][real] += right[:, cols].sum(0)[ck]
                    for r, scale in enumerate((1.0, fr, fr * fr)):
                        dct[j, r][:, lanes[live]] += scale * ddx[live].T
                    if second:
                        f1 = f
                    else:
                        y1, yh1 = y1 - 0.5 * dt * (f1 + f), yv
                        ay, ayh = ay + 2.0 * ayh, -ayh + v
        dz0[:, lanes[live]] = (ay + ayh)[live, :H].T
    total = partials.sum(0)
    return dct, dz0, total[:, C * H:-1], total[:, -1], total[:, :C * H].T, db2p.sum(0)


# (B, H, C, W, blocks): one thread a lane (H 8, C 3) with blocks striding;
# groups of 2 (H 16, C 3), of 4 (H 32, C 3) and of 16 (H 100, C 5, Hp 128);
# H 7, C 2 with W 44 (padded rows, a part-filled row quad).
GROUP_CASES = [(300, 8, 3, 40, 2), (40, 16, 3, 40, 1), (70, 32, 3, 24, 1), (20, 100, 5, 16, 1),
               (9, 7, 2, 44, 1)]


@pytest.mark.parametrize("B, H, C, W, blocks", GROUP_CASES,
                         ids=[f"H{c[1]}C{c[2]}" for c in GROUP_CASES])
def test_backward_group_partition_matches_the_reference(B, H, C, W, blocks):
    # The partition of each lane over its group, the butterflies, the padding
    # and the units of the weight gradients against the plain backward walk
    # (fused_reversible_backward_reference), both float64 on the same
    # stored states: within 1e-12 of each gradient's largest magnitude (the
    # orders of the float64 sums differ).
    n, m = 3, 2
    ops = _operands(n, C, B, H, W, seed=B)
    with torch.no_grad():
        y, yhat = k8.fused_reversible_solve_reference(*ops, m, 1.0 / m)
    gy = torch.from_numpy(np.random.default_rng(5).standard_normal(y.shape))
    expected = k8.fused_reversible_backward_reference(ops[0], y, yhat, gy, *ops[2:], m, 1.0 / m)
    got = _group_backward(*(t.numpy() for t in (ops[0], y, yhat, gy, *ops[2:])), m, 1.0 / m,
                          blocks)
    for name, g, e in zip(("dct", "dz0", "dw1", "db1", "dw2", "db2"), got, expected):
        e = e.numpy()
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-12 * float(np.abs(e).max()), err_msg=name)


# (B, H, C, W): slices of 4 components, twice the threads a lane, as the plan
# takes them at small batches: H 16 (4 threads), 32 (8), 100 (Hp 128: 32
# threads, a whole warp) and H 16 with C 5 at W 44 (a part-filled row quad).
SMALL_CASES = [(40, 16, 3, 40), (70, 32, 3, 24), (20, 100, 5, 16), (9, 16, 5, 44)]


@pytest.mark.parametrize("B, H, C, W", SMALL_CASES, ids=[f"H{c[1]}C{c[2]}" for c in SMALL_CASES])
def test_backward_small_batch_partition_matches_the_reference(B, H, C, W):
    # As test_backward_group_partition_matches_the_reference, for the
    # partition into slices of 4 that small batches take.
    n, m = 3, 2
    ops = _operands(n, C, B, H, W, seed=B + 1)
    with torch.no_grad():
        y, yhat = k8.fused_reversible_solve_reference(*ops, m, 1.0 / m)
    gy = torch.from_numpy(np.random.default_rng(6).standard_normal(y.shape))
    expected = k8.fused_reversible_backward_reference(ops[0], y, yhat, gy, *ops[2:], m, 1.0 / m)
    got = _group_backward(*(t.numpy() for t in (ops[0], y, yhat, gy, *ops[2:])), m, 1.0 / m, 1,
                          small=True)
    for name, g, e in zip(("dct", "dz0", "dw1", "db1", "dw2", "db2"), got, expected):
        e = e.numpy()
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-12 * float(np.abs(e).max()), err_msg=name)
