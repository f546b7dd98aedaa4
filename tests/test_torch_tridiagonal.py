"""The port's tridiagonal solves (K4's plain versions and VJP) against the JAX package.

Thomas and PCR are the same float64 operations on both sides in the same
order: values rtol 1e-12; gradients 1e-10 (against dense solves, whose
elimination order differs).  One float32 case
runs the JAX kernel itself in interpret mode, at the JAX tests' tolerance
(rtol 2e-4, atol 2e-5: its PCR levels reorder the elimination).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchcde_tpu.ops import tridiagonal as jtri
from torchcde_tpu.ops.tridiagonal_pallas import tridiagonal_solve_pallas
from torchcde_tpu_torch import misc
from torchcde_tpu_torch.ops import row_split, tridiagonal, tridiagonal_kernel

torch.set_num_threads(1)

RTOL, ATOL = 1e-12, 1e-12
GRAD_RTOL, GRAD_ATOL = 1e-10, 1e-10


def _system(batch, k, seed, band_batch=None, dtype=np.float64):
    """A diagonally dominant system; bands with their own batch shape (a
    single band broadcasts against every row, as in the spline fit)."""
    rng = np.random.default_rng(seed)
    band_batch = batch if band_batch is None else band_batch
    u = rng.standard_normal(band_batch + (k - 1,))
    l = rng.standard_normal(band_batch + (k - 1,))
    pad = np.zeros(band_batch + (1,))
    d = 1.0 + np.abs(np.concatenate([u, pad], -1)) + np.abs(np.concatenate([pad, l], -1))
    b = rng.standard_normal(batch + (k,))
    return tuple(a.astype(dtype) for a in (b, u, d, l))


CASES = [((3,), 1, None), ((3,), 2, None), ((4,), 9, None), ((2, 3), 17, None),
         ((5,), 33, ()), ((2, 3), 12, (3,))]


@pytest.mark.parametrize("method", ["thomas", "pcr", "auto", "kernel"])
@pytest.mark.parametrize("batch,k,band_batch", CASES)
def test_solve_matches_jax(method, batch, k, band_batch):
    system = _system(batch, k, seed=k, band_batch=band_batch)
    jax_method = {"kernel": "thomas", "auto": "thomas"}.get(method, method)
    expected = jtri.tridiagonal_solve(*map(jnp.asarray, system), method=jax_method)
    got = tridiagonal.tridiagonal_solve(*map(torch.from_numpy, system), method=method)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


GRAD_CASES = [((4,), 9, None), ((5,), 33, ()), ((2, 3), 12, (3,))]


def _dense_vjp(system, w):
    """Gradients of sum(w * A^{-1} b) by dense solves, per row: b_bar =
    A^{-T} w, diag_bar = -b_bar x, upper_bar_i = -b_bar_i x_{i+1},
    lower_bar_i = -b_bar_{i+1} x_i; summed over broadcast dimensions."""
    b, u, d, l = system
    shape = np.broadcast_shapes(d.shape, b.shape)
    k = shape[-1]
    off = shape[:-1] + (k - 1,)
    bb, dd = np.broadcast_to(b, shape), np.broadcast_to(d, shape)
    uu, ll = np.broadcast_to(u, off), np.broadcast_to(l, off)
    x, y = np.empty(shape), np.empty(shape)
    for idx in np.ndindex(shape[:-1]):
        A = np.diag(dd[idx]) + np.diag(uu[idx], 1) + np.diag(ll[idx], -1)
        x[idx] = np.linalg.solve(A, bb[idx])
        y[idx] = np.linalg.solve(A.T, w[idx])

    def sum_to(g, target):
        g = g.sum(axis=tuple(range(g.ndim - len(target)))) if g.ndim > len(target) else g
        axes = tuple(i for i, n in enumerate(target) if n == 1 and g.shape[i] != 1)
        return g.sum(axis=axes, keepdims=True) if axes else g

    return (sum_to(y, b.shape), sum_to(-y[..., :-1] * x[..., 1:], u.shape),
            sum_to(-y * x, d.shape), sum_to(-y[..., 1:] * x[..., :-1], l.shape))


@pytest.mark.parametrize("batch,k,band_batch", GRAD_CASES)
def test_thomas_gradients(batch, k, band_batch):
    # Held against the transpose-solve VJP of the JAX kernel (_tp_bwd),
    # evaluated by dense solves.  jax.grad of the JAX Thomas scan is not
    # taken: jaxlib 0.9.0's CPU runtime corrupts memory when it transposes
    # the float64 scan with respect to its bands.
    system = _system(batch, k, seed=k + 1, band_batch=band_batch)
    w = np.random.default_rng(0).standard_normal(batch + (k,))
    expected = _dense_vjp(system, w)
    leaves = [torch.from_numpy(a).requires_grad_() for a in system]
    out = tridiagonal.tridiagonal_solve_thomas(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for name, g, e in zip(("b", "upper", "diagonal", "lower"), got, expected):
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), e, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("batch,k,band_batch", GRAD_CASES)
def test_pcr_gradients_match_jax(batch, k, band_batch):
    # jax.grad of the JAX PCR solve.  Its band gradients are NaN: each level
    # divides by a zero-padded shifted diagonal in the branch its where
    # discards, and the discarded branch's gradient (0 * inf) poisons the
    # sum.  The port reproduces the function and so the NaNs; Thomas, the
    # default, has finite band gradients.
    system = _system(batch, k, seed=k + 1, band_batch=band_batch)
    w = np.random.default_rng(0).standard_normal(batch + (k,))
    expected = jax.grad(lambda *a: jnp.sum(jtri.tridiagonal_solve_pcr(*a) * w),
                        argnums=(0, 1, 2, 3))(*map(jnp.asarray, system))
    leaves = [torch.from_numpy(a).requires_grad_() for a in system]
    out = tridiagonal.tridiagonal_solve_pcr(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(got[0].numpy(), _dense_vjp(system, w)[0], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for name, g, e in zip(("b", "upper", "diagonal", "lower"), got, expected):
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)  # NaN where NaN


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    system = tuple(map(torch.from_numpy, _system((3,), 8, seed=2, band_batch=())))
    got = tridiagonal_kernel.tridiagonal_solve_kernel(*system)
    assert torch.equal(got, tridiagonal.tridiagonal_solve_thomas(*system))
    assert tridiagonal_kernel.LAUNCHES == 0


def test_unknown_method_and_shim():
    system = tuple(map(torch.from_numpy, _system((2,), 4, seed=3)))
    with pytest.raises(ValueError, match="Unknown tridiagonal method 'pallas'"):
        tridiagonal.tridiagonal_solve(*system, method="pallas")
    assert misc.tridiagonal_solve is tridiagonal.tridiagonal_solve
    assert misc.tridiagonal_solve_thomas is tridiagonal.tridiagonal_solve_thomas
    assert misc.tridiagonal_solve_pcr is tridiagonal.tridiagonal_solve_pcr
    from torchcde_tpu_torch.utils.tuple_control import TupleControl
    assert misc.TupleControl is TupleControl


def test_matches_the_jax_kernel_in_interpret_mode():
    b, u, d, l = _system((3,), 64, seed=5, dtype=np.float32)
    expected = tridiagonal_solve_pallas(*map(jnp.asarray, (b, u, d, l)), interpret=True)
    got = tridiagonal.tridiagonal_solve(*map(torch.from_numpy, (b, u, d, l)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# K4's shared-band route (csrc/tridiagonal.cu: band_pivot_kernel, then
# shared_band_kernel), mirrored in numpy: the pivots by a scan of Moebius
# maps with power-of-two rescaling, then per row the elimination and the
# substitution as affine scans, over chunks of POSITIONS positions in
# solve_plan's threads per row, joined across the threads in the kernel's
# order (row_scan.cuh: shuffle levels within a warp, then the warps' totals
# in order).  Past 4096 positions a row is split into segments, one block
# each: over a cluster the blocks' totals are composed in rank order; in a
# segmented row each block's carry-ins come from the totals that the
# earlier launches published (row_scan.cuh: seg_moebius_carry,
# seg_affine_carries).

POSITIONS = row_split.POSITIONS
CLUSTER_MAX = row_split.CLUSTER_REACH // row_split.RESIDENT_MAX


def _moebius(f, s):
    """s after f as 2 x 2 matrices (entries along the last axis), divided
    by the power of two at or below the largest entry where it is normal
    (MoebiusOp)."""
    m = np.stack([s[..., 0] * f[..., 0] + s[..., 1] * f[..., 2],
                  s[..., 0] * f[..., 1] + s[..., 1] * f[..., 3],
                  s[..., 2] * f[..., 0] + s[..., 3] * f[..., 2],
                  s[..., 2] * f[..., 1] + s[..., 3] * f[..., 3]], axis=-1)
    big = np.abs(m).max(axis=-1, keepdims=True)
    normal = np.isfinite(big) & (big >= np.finfo(m.dtype).tiny)
    scale = np.ldexp(np.ones_like(big), 1 - np.frexp(np.where(normal, big, 1))[1])
    return np.where(normal, m * scale, m)


def _affine(f, s):
    """s after f, x -> v[0] x + v[1] (AffineOp)."""
    return np.stack([s[..., 0] * f[..., 0], s[..., 0] * f[..., 1] + s[..., 1]], axis=-1)


def _param_affine(f, s):
    """s after f, x -> v[0] x + v[1] + v[2] p (ParamAffineOp)."""
    return np.stack([s[..., 0] * f[..., 0], s[..., 0] * f[..., 1] + s[..., 1],
                     s[..., 0] * f[..., 2] + s[..., 2]], axis=-1)


def _row_scan(ops, compose, identity, rev):
    """The exclusive scan of the threads' operators (..., tpr, N) across
    the row, as row_scan orders it."""
    tpr = ops.shape[-2]
    width = min(tpr, 32)
    idx = np.arange(tpr)
    li = idx % width
    incl = ops
    d = 1
    while d < width:
        take = (li + d < width) if rev else (li >= d)
        other = incl[..., np.clip(idx + d if rev else idx - d, 0, tpr - 1), :]
        incl = np.where(take[:, None], compose(other, incl), incl)
        d *= 2
    take = (li + 1 < width) if rev else (li >= 1)
    ident = np.broadcast_to(identity, incl.shape).astype(incl.dtype)
    excl = np.where(take[:, None], incl[..., np.clip(idx + 1 if rev else idx - 1, 0, tpr - 1), :],
                    ident)
    if tpr > 32:
        wpr = tpr // 32
        totals = incl[..., np.arange(wpr) * 32 + (0 if rev else 31), :]
        carries = []
        for wr in range(wpr):
            carry = ident[..., 0, :]
            for w in (range(wpr - 1, wr, -1) if rev else range(wr)):
                carry = compose(carry, totals[..., w, :])
            carries.append(carry)
        excl = compose(np.stack(carries, axis=-2)[..., idx // 32, :], excl)
    return excl


def _layout(k, plan):
    """The position of the row that each (block, thread, slot) of the
    route's launch holds, -1 where it holds none: (blocks, threads,
    POSITIONS).  A resident row is one block of its threads per row; over a
    cluster, block r holds the segment from r * segment on in all its 256
    threads."""
    if plan.cluster == 1:
        g = np.arange(plan.threads_per_row * POSITIONS).reshape(1, -1, POSITIONS)
        return np.where(g < k, g, -1)
    local = np.arange(plan.threads * POSITIONS).reshape(1, -1, POSITIONS)
    g = np.arange(plan.cluster)[:, None, None] * plan.segment + local
    return np.where((local < plan.segment) & (g < k), g, -1)


def _scan(ops, compose, identity, rev, cluster):
    """The exclusive scan of the threads' operators (..., blocks, threads,
    N) across the row: row_scan within each block, then, over a cluster
    (cluster_scan), the blocks' totals before each block (after it when
    rev) composed in rank order, then the block's own scan."""
    excl = _row_scan(ops, compose, identity, rev)
    if not cluster:
        return excl
    end = 0 if rev else ops.shape[-2] - 1
    totals = compose(excl[..., end, :], ops[..., end, :])
    blocks = ops.shape[-3]
    ident = np.broadcast_to(identity, totals[..., 0, :].shape).astype(ops.dtype)
    carries = []
    for r in range(blocks):
        carry = ident
        for q in (range(blocks - 1, r, -1) if rev else range(r)):
            carry = compose(carry, totals[..., q, :])
        carries.append(carry)
    carry = np.stack(carries, axis=-2)[..., None, :]
    return compose(np.broadcast_to(carry, excl.shape), excl)


def _split(plan):
    """How the route holds a row: "resident", "cluster" or "segmented"."""
    if plan.cluster == 1:
        return "resident"
    return "cluster" if plan.cluster <= CLUSTER_MAX else "segmented"


def _block_totals(ops, compose, identity, rev):
    """Each block's total in the scan's direction (publish_total): its
    exclusive scan at the thread at its end composed with that thread's
    map, (..., blocks, N)."""
    end = 0 if rev else ops.shape[-2] - 1
    excl = _row_scan(ops, compose, identity, rev)
    return compose(excl[..., end, :], ops[..., end, :])


def _carried(excl, compose, carry, moebius):
    """A segmented block's scan from its carry-in values (..., blocks): the
    map that sends everything there (moebius_to, affine_to), then excl."""
    zero, one = np.zeros_like(carry), np.ones_like(carry)
    to = np.stack([zero, carry, zero, one] if moebius else [zero, carry], -1)[..., None, :]
    return compose(np.broadcast_to(to, excl.shape), excl)


def _moebius_scan(mob, split):
    """The pivots' Moebius scan across a row held as ``split`` says; in a
    segmented row each block's carry-in is 1 with the totals before its
    segment applied in rank order (seg_moebius_carry)."""
    ident = np.array([1, 0, 0, 1], mob.dtype)
    if split != "segmented":
        return _scan(mob, _moebius, ident, False, split == "cluster")
    totals = _block_totals(mob, _moebius, ident, False)
    v, carries = np.ones(totals.shape[:-1][:-1], mob.dtype), []
    for q in range(totals.shape[-2]):
        carries.append(v)
        t = totals[..., q, :]
        v = (t[..., 0] * v + t[..., 1]) / (t[..., 2] * v + t[..., 3])
    return _carried(_row_scan(mob, _moebius, ident, False), _moebius, np.stack(carries, -1), True)


def _affine_carries(te, ts):
    """seg_affine_carries for every block: the elimination's value at each
    segment's start (0, then the totals te (..., blocks, 2) in rank order)
    and the substitution's after its end (the later segments' totals ts
    (..., blocks, 3), each with the elimination's value at its start as its
    parameter, composed in rank order, each before the composition so far,
    applied to 0)."""
    blocks = te.shape[-2]
    nb, starts = np.zeros(te.shape[:-2], te.dtype), []
    for q in range(blocks):
        starts.append(nb)
        nb = te[..., q, 0] * nb + te[..., q, 1]
    after = []
    for me in range(blocks):
        total = np.broadcast_to(np.array([1, 0], te.dtype), te.shape[:-2] + (2,))
        for q in range(me + 1, blocks):
            t = np.stack([ts[..., q, 0], ts[..., q, 1] + ts[..., q, 2] * starts[q]], -1)
            total = _affine(t, total)
        after.append(total[..., 1])
    return np.stack(starts, -1), np.stack(after, -1)


def _gather(a, g, offset=0):
    """a (..., m) at positions g + offset of the layout, 0 outside a and
    where g holds none: (..., blocks, threads, POSITIONS)."""
    idx = g + offset
    ok = (g >= 0) & (idx >= 0) & (idx < a.shape[-1])
    if not a.shape[-1]:
        return np.zeros(a.shape[:-1] + g.shape, a.dtype)
    return np.where(ok, a[..., np.clip(idx, 0, a.shape[-1] - 1)], 0)


def _pivots(u, d, l, plan):
    """band_pivot_kernel: w, r, c, each (blocks, threads, POSITIONS), zero
    where the layout holds no position of the row."""
    dtype, k = d.dtype, d.shape[0]
    g = _layout(k, plan)
    live = g >= 0
    dv = np.where(live, _gather(d, g), 1)
    lu = _gather(l * u, g, -1)  # l_{j-1} u_{j-1}, 0 at j = 0
    mob = np.broadcast_to(np.array([1, 0, 0, 1], dtype), g.shape[:-1] + (4,))
    for s in range(POSITIONS):
        step = np.stack([dv[..., s], -lu[..., s], np.ones_like(dv[..., s]),
                         np.zeros_like(dv[..., s])], -1)
        mob = np.where(live[..., s, None], _moebius(mob, step), mob)
    mob = _moebius_scan(mob, _split(plan))
    prev = (mob[..., 0] + mob[..., 1]) / (mob[..., 2] + mob[..., 3])  # nd before the chunk
    lp, up = _gather(l, g, -1), _gather(u, g)  # l_{j-1}; u_j, 0 from j = k - 1
    w, r, c = (np.zeros(g.shape, dtype) for _ in range(3))
    for s in range(POSITIONS):
        on = live[..., s]
        w[..., s] = np.where(on, lp[..., s] / prev, 0)
        prev = np.where(on, dv[..., s] - lu[..., s] / prev, prev)
        r[..., s] = np.where(on, 1 / prev, 0)
        c[..., s] = np.where(on, up[..., s] / prev, 0)
    return w, r, c


def _pivot_scratch(u, d, l, plan):
    """The (3, P) pivot scratch band_pivot_kernel writes (P:
    tridiagonal_kernel.pivot_positions): each route's positions in order,
    a cluster's segments one after another, zero past k."""
    k = d.shape[0]
    P = tridiagonal_kernel.pivot_positions(plan)
    out = np.zeros((3, P), d.dtype)
    g = _layout(k, plan)
    for row, a in zip(out, _pivots(u, d, l, plan)):
        row[g[g >= 0]] = a[g >= 0]
    return out


def _affine_solve(b, w, r, c, g, split):
    """The elimination nb = b - w nb_prev by an affine scan, the
    substitution x = r nb - c x_next by an affine suffix scan, over the
    layout g of a row held as ``split`` says, for every row of b (n, k): x
    (n, k).  A segmented row's totals come first (the SEG_TOTALS launch):
    the elimination's, then the substitution's with nb affine in the
    segment's unknown carry-in p, nb0 + sens p, composed into each chunk's
    map in ascending order."""
    n, k = b.shape
    live = g >= 0
    v = _gather(b, g)
    ident = np.array([1, 0], b.dtype)
    aff = np.broadcast_to(ident, v.shape[:-1] + (2,))
    for s in range(POSITIONS):  # the slots past the row hold no map
        step = _affine(aff, np.stack([np.broadcast_to(-w[..., s], v[..., s].shape), v[..., s]], -1))
        aff = np.where(live[..., s, None], step, aff)
    if split == "segmented":
        excl = _row_scan(aff, _affine, ident, False)
        nb0, sens = excl[..., 1], excl[..., 0]
        ident3 = np.array([1, 0, 0], b.dtype)
        sub = np.broadcast_to(ident3, v.shape[:-1] + (3,))
        for s in range(POSITIONS):
            nb0 = np.where(live[..., s], v[..., s] - w[..., s] * nb0, nb0)
            sens = np.where(live[..., s], -w[..., s] * sens, sens)
            step = np.stack([np.broadcast_to(-c[..., s], nb0.shape), r[..., s] * nb0,
                             r[..., s] * sens], -1)
            sub = np.where(live[..., s, None], _param_affine(step, sub), sub)
        nb_in, x_in = _affine_carries(_block_totals(aff, _affine, ident, False),
                                      _block_totals(sub, _param_affine, ident3, True))
        carry = _carried(excl, _affine, nb_in, False)[..., 1]
    else:
        carry = _scan(aff, _affine, ident, False, split == "cluster")[..., 1]
    for s in range(POSITIONS):
        carry = np.where(live[..., s], v[..., s] - w[..., s] * carry, carry)
        v[..., s] = carry
    aff = np.broadcast_to(ident, v.shape[:-1] + (2,))
    for s in reversed(range(POSITIONS)):
        step = _affine(aff, np.stack([np.broadcast_to(-c[..., s], v[..., s].shape),
                                      r[..., s] * v[..., s]], -1))
        aff = np.where(live[..., s, None], step, aff)
    if split == "segmented":
        carry = _carried(_row_scan(aff, _affine, ident, True), _affine, x_in, False)[..., 1]
    else:
        carry = _scan(aff, _affine, ident, True, split == "cluster")[..., 1]
    for s in reversed(range(POSITIONS)):
        carry = np.where(live[..., s], r[..., s] * v[..., s] - c[..., s] * carry, carry)
        v[..., s] = carry
    x = np.zeros((n, k), b.dtype)
    x[:, g[live]] = v[:, live]
    return x


def _resident_solve(b, u, d, l, plan=None):
    """The shared-band route (band_pivot_kernel, then shared_band_kernel)
    on every row of b (n, k), in b's dtype, resident or in segments."""
    k = b.shape[1]
    plan = plan or tridiagonal_kernel.solve_plan(k, shared=True)
    g = _layout(k, plan)
    return _affine_solve(b, *_pivots(u, d, l, plan), g, _split(plan))


def _per_row_solve(b, u, d, l, plan=None):
    """per_row_kernel on every row of b (n, k) with bands per row (u, l
    (n, k - 1), d (n, k); a single band broadcasts), in b's dtype: each
    row's Moebius maps scanned for its own pivots, then the elimination's
    affine scan and the substitution's affine suffix scan, with w, 1 / nd
    and u / nd formed where they are used."""
    n, k = b.shape
    plan = plan or tridiagonal_kernel.solve_plan(k, shared=False)
    u, l = (np.broadcast_to(a, (n, k - 1)) for a in (u, l))
    d = np.broadcast_to(d, (n, k))
    dtype, g = b.dtype, _layout(k, plan)
    live = g >= 0
    dv, bv = _gather(d, g), _gather(b, g)
    lp, upv, uc = _gather(l, g, -1), _gather(u, g, -1), _gather(u, g)  # l, u at j - 1; u at j
    ident4 = np.array([1, 0, 0, 1], dtype)
    mob = np.broadcast_to(ident4, dv.shape[:-1] + (4,))
    for s in range(POSITIONS):
        step = np.stack([dv[..., s], -lp[..., s] * upv[..., s], np.ones_like(dv[..., s]),
                         np.zeros_like(dv[..., s])], -1)
        mob = np.where(live[..., s, None], _moebius(mob, step), mob)
    mob = _moebius_scan(mob, _split(plan))
    prev = (mob[..., 0] + mob[..., 1]) / (mob[..., 2] + mob[..., 3])
    nd, w = np.ones(dv.shape, dtype), np.zeros(dv.shape, dtype)
    for s in range(POSITIONS):
        on = live[..., s]
        ws = lp[..., s] / prev
        dg = dv[..., s] - ws * upv[..., s]
        w[..., s] = np.where(on, ws, 0)
        nd[..., s] = np.where(on, dg, 1)
        prev = np.where(on, dg, prev)
    r = np.where(live, 1 / nd, 0)
    return _affine_solve(b, w, r, uc * r, g, _split(plan))


def _fit_system(rows, k, seed, dtype):
    """The dense natural cubic fit's system on irregular times: one band
    for every row (u = l = 1 / h, d = 2 (1 / h_prev + 1 / h)), b per row."""
    rng = np.random.default_rng(seed)
    hr = 1.0 / rng.uniform(0.2, 1.5, k - 1)
    pad = np.zeros(1)
    d = 2 * (np.concatenate([pad, hr]) + np.concatenate([hr, pad]))
    b = rng.standard_normal((rows, k))
    return tuple(a.astype(dtype) for a in (b, hr, d, hr))


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("k", [2, 3, 17, 513, 4096])
def test_shared_band_route_mirror_matches_jax_thomas(k, dtype, tol):
    # The route's arithmetic (in dtype) against the JAX package's Thomas
    # solve in float64 on the same inputs, within tol of the largest
    # magnitude: the pivot scan's rescaled Moebius products and the affine
    # scans reassociate the recurrences, nothing else.
    b, u, d, l = _fit_system(5, k, seed=k, dtype=dtype)
    got = _resident_solve(b, u, d, l)
    expected = np.asarray(jtri.tridiagonal_solve_thomas(
        *(jnp.asarray(a, dtype=jnp.float64) for a in (b, u, d, l))))
    assert got.dtype == dtype and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol * float(np.abs(expected).max()))


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("k", [2, 17, 513, 4096])
def test_per_row_route_mirror_matches_jax_thomas(k, dtype, tol):
    # per_row_kernel's arithmetic (in dtype): each row's pivots by its own
    # Moebius scan, then the two affine scans, against the JAX package's
    # Thomas solve in float64, within tol of the largest magnitude.
    b, u, d, l = _system((5,), k, seed=k, dtype=dtype)
    assert tridiagonal_kernel.solve_plan(k, shared=False).variant == "per_row"
    got = _per_row_solve(b, u, d, l)
    expected = np.asarray(jtri.tridiagonal_solve_thomas(
        *(jnp.asarray(a, dtype=jnp.float64) for a in (b, u, d, l))))
    assert got.dtype == dtype and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol * float(np.abs(expected).max()))


CLUSTER_LENGTHS = [4097, 8192, 8193, 16384, 32768]


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("k", CLUSTER_LENGTHS)
def test_cluster_route_mirror_matches_jax_thomas(k, shared, dtype, tol):
    # The cluster routes: each of the cluster's blocks scans its segment as
    # a resident block scans a row, and the blocks' totals are composed in
    # rank order (cluster_scan); against the JAX package's Thomas solve in
    # float64 within the resident mirrors' tolerances.
    plan = tridiagonal_kernel.solve_plan(k, shared)
    assert plan.variant == ("cluster" if shared else "per_row_cluster")
    assert plan.cluster == -(-k // 4096) and plan.cluster * plan.segment >= k
    if shared:
        b, u, d, l = _fit_system(3, k, seed=k, dtype=dtype)
        got = _resident_solve(b, u, d, l, plan)
    else:
        b, u, d, l = _system((3,), k, seed=k, dtype=dtype)
        got = _per_row_solve(b, u, d, l, plan)
    expected = np.asarray(jtri.tridiagonal_solve_thomas(
        *(jnp.asarray(a, dtype=jnp.float64) for a in (b, u, d, l))))
    assert got.dtype == dtype and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol * float(np.abs(expected).max()))


SEGMENTED_LENGTHS = [32769, 65536, 65537]


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("k", SEGMENTED_LENGTHS)
def test_segmented_route_mirror_matches_jax_thomas(k, shared, dtype, tol):
    # Past the clusters' reach: the same segments, one block each, in
    # launches of their own; each block's carry-ins from the totals that
    # the earlier launches published (the Moebius totals, then the
    # elimination's and the substitution's, the latter affine in the
    # elimination's carry-in), against the JAX package's Thomas solve in
    # float64 within the resident mirrors' tolerances.
    plan = tridiagonal_kernel.solve_plan(k, shared)
    assert plan.variant == ("segmented" if shared else "per_row_segmented")
    assert plan.cluster == -(-k // 4096) > CLUSTER_MAX
    assert plan.cluster * plan.segment >= k > (plan.cluster - 1) * plan.segment
    if shared:
        b, u, d, l = _fit_system(3, k, seed=k, dtype=dtype)
        got = _resident_solve(b, u, d, l, plan)
    else:
        b, u, d, l = _system((3,), k, seed=k, dtype=dtype)
        got = _per_row_solve(b, u, d, l, plan)
    expected = np.asarray(jtri.tridiagonal_solve_thomas(
        *(jnp.asarray(a, dtype=jnp.float64) for a in (b, u, d, l))))
    assert got.dtype == dtype and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol * float(np.abs(expected).max()))


def test_solve_plan_routes():
    # Up to RESIDENT_MAX each row resident in K6/K7's threads per row: shared
    # bands after the pivots, per-row bands with their own; up to the
    # cluster's reach over a cluster of ceil(k / 4096) blocks, the row split
    # evenly in whole chunks; longer rows in the same split, segmented.
    for k, tpr in ((1, 1), (2, 1), (16, 1), (17, 2), (512, 32), (513, 64), (4096, 256)):
        for shared, variant in ((True, "resident"), (False, "per_row")):
            plan = tridiagonal_kernel.solve_plan(k, shared=shared)
            assert plan == (variant, tpr, 256 // tpr, 256, POSITIONS, 1, k), (k, plan)
    for k, blocks, segment in ((4097, 2, 2064), (8192, 2, 4096), (8193, 3, 2736),
                               (16384, 4, 4096), (32768, 8, 4096)):
        for shared, variant in ((True, "cluster"), (False, "per_row_cluster")):
            plan = tridiagonal_kernel.solve_plan(k, shared=shared)
            assert plan == (variant, 256, 1, 256, POSITIONS, blocks, segment), (k, plan)
    assert row_split.CLUSTER_REACH == 32768
    for k, blocks, segment in ((32769, 9, 3648), (65536, 16, 4096), (65537, 17, 3856)):
        for shared, variant in ((True, "segmented"), (False, "per_row_segmented")):
            plan = tridiagonal_kernel.solve_plan(k, shared=shared)
            assert plan == (variant, 256, 1, 256, POSITIONS, blocks, segment), (k, plan)
    with pytest.raises(ValueError):
        tridiagonal_kernel.solve_plan(0, shared=True)


# (k, the shared bands' route and scratch, the per-row bands' route and
# scratch); the scratch's (pivots, totals) shapes, for 6 rows.
STAND_IN_ROUTES = {
    17: (("resident", ((3, 32), None)), ("per_row", (None, None))),
    4097: (("cluster", ((3, 4128), None)), ("per_row_cluster", (None, None))),
    8193: (("cluster", ((3, 8208), None)), ("per_row_cluster", (None, None))),
    32769: (("segmented", ((3, 32832), (9 * (4 + 5 * 6),))),
            ("per_row_segmented", (None, (9 * 9 * 6,)))),
}


@pytest.mark.parametrize("k", sorted(STAND_IN_ROUTES))
def test_kernel_wrapper_routes_with_stand_ins(k, monkeypatch):
    # The launches run only on the card: a stand-in for the route's kernels
    # (the mirrors above, the shared routes filling the pivot scratch)
    # drives the wrapper's own code: the band strides, the route, its
    # segments, its scratch and the counts.
    routes = []

    def kernel(plan, operands, x, scratch, sizes):
        b2, u2, d2, l2 = operands
        n, kk, sb, su, sd, sl = sizes
        assert kk == k and b2.shape == (n, k) and sb == k
        assert plan == tridiagonal_kernel.solve_plan(k, su == sd == sl == 0)
        routes.append((plan.variant, (su, sd, sl),
                       tuple(None if t is None else tuple(t.shape) for t in scratch)))
        rows = torch.arange(n)[:, None]
        bands = (u2[rows * su // (k - 1)].squeeze(1), d2[rows * sd // k].squeeze(1),
                 l2[rows * sl // (k - 1)].squeeze(1))
        if plan.variant in tridiagonal_kernel.SHARED_ROUTES:
            arrays = [a.numpy() for a in (b2, u2[0], d2[0], l2[0])]
            scratch[0].copy_(torch.from_numpy(_pivot_scratch(*arrays[1:], plan)))
            x.copy_(torch.from_numpy(_resident_solve(*arrays, plan)))
        else:
            x.copy_(torch.from_numpy(_per_row_solve(b2.numpy(), *(a.numpy() for a in bands),
                                                    plan)))

    monkeypatch.setattr(tridiagonal_kernel.dispatch, "check_operands", lambda *a: None)
    monkeypatch.setattr(tridiagonal_kernel, "_kernel", kernel)
    tridiagonal_kernel.reset_launch_counts()
    b, u, d, l = map(torch.from_numpy, _fit_system(6, k, seed=1, dtype=np.float64))
    for bands in ((u, d, l), tuple(a.expand(6, -1).reshape(2, 3, -1).clone() for a in (u, d, l))):
        got = tridiagonal_kernel.launch(b.reshape(2, 3, k), *bands)
        expected = tridiagonal.tridiagonal_solve_thomas(b.reshape(2, 3, k), *bands)
        assert got.shape == (2, 3, k)
        torch.testing.assert_close(got, expected, rtol=1e-10, atol=1e-10)
    (shared, shared_scratch), (per_row, per_row_scratch) = STAND_IN_ROUTES[k]
    assert routes == [(shared, (0, 0, 0), shared_scratch),
                      (per_row, (k - 1, k, k - 1), per_row_scratch)]
    assert tridiagonal_kernel.LAUNCHES == 2
    counts = dict.fromkeys(tridiagonal_kernel.ROUTES, 0)
    counts[shared] += 1
    counts[per_row] += 1
    assert tridiagonal_kernel.ROUTE_LAUNCHES == counts
    tridiagonal_kernel.reset_launch_counts()
    assert set(tridiagonal_kernel.ROUTE_LAUNCHES.values()) == {0}
