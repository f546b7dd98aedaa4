"""The port's natural cubic spline fit, dense and NaN-masked, against the JAX package.

On the CPU the fit runs its plain versions (K4's Thomas solve, K3's fill,
K5's gappy Thomas solve and K6/K7's pipeline); the kernels are held against
them on the card by ``chip_smoke.py``.  Both sides compute the same float64
formulas in the same order: values rtol/atol 1e-12 relative to the largest
magnitude, gradients 1e-10.  The float32 cases against the JAX kernels in
interpret mode use the JAX tests' tolerance (rtol/atol 2e-4; the TPU
kernels' prefix scans reorder the recurrences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_natural_cubic_spline import _oracle_masked_scalar

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.interpolation import cubic as jcubic
from torchcde_tpu.ops.masked_cubic_pallas import (
    masked_natural_cubic_full,
    masked_natural_cubic_pallas,
)
from torchcde_tpu.ops.masked_cubic_resident import masked_natural_cubic_resident
from torchcde_tpu.ops.masked_tridiagonal_pallas import masked_thomas_pallas
from torchcde_tpu_torch.interpolation import cubic
from torchcde_tpu_torch.ops import masked_cubic_kernel, masked_tridiagonal_kernel, row_split

torch.set_num_threads(1)

VALUE_TOL, GRAD_TOL = 1e-12, 1e-10
KERNEL_TOL = 2e-4
FITS = {0: (tc.natural_cubic_spline_coeffs, tt.natural_cubic_spline_coeffs),
        1: (tc.natural_cubic_coeffs, tt.natural_cubic_coeffs)}


def _close(got, expected, tol, what=""):
    expected = np.asarray(expected)
    scale = max(1.0, float(np.nanmax(np.abs(expected))) if expected.size else 1.0)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _data(case, seed, shape=(3, 23, 2)):
    """(x, t): x with the NaN pattern of ``case``; t irregular or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    t = np.cumsum(rng.uniform(0.2, 1.5, shape[-2]))
    if case == "dense":
        return x, None
    if case == "dense_irregular":
        return x, t
    x[rng.random(shape) < 0.3] = np.nan
    x[0, :, 0] = np.nan  # all-NaN channel
    x[1, :, 0] = np.nan
    x[1, 9, 0] = 0.7  # single observation
    x[2, :4, 1] = np.nan  # leading and trailing NaN runs
    x[2, -3:, 1] = np.nan
    x[2, 10, 1] = -0.4
    return x, (t if case == "masked_irregular" else None)


CASES = ["dense", "dense_irregular", "masked", "masked_irregular"]


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_fit_values_and_x_gradients(version, case):
    x, t = _data(case, seed=len(case) + version)
    jfit, tfit = FITS[version]
    tj = None if t is None else jnp.asarray(t)
    expected = jfit(jnp.asarray(x), tj)
    xt = torch.from_numpy(x).requires_grad_()
    got = tfit(xt, t)
    assert got.shape == expected.shape == x.shape[:-2] + (x.shape[-2] - 1, 4 * x.shape[-1])
    _close(got.detach().numpy(), expected, VALUE_TOL, "values")

    w = np.random.default_rng(1).standard_normal(expected.shape)
    g_expected = jax.grad(lambda z: jnp.sum(jfit(z, tj) * w))(jnp.asarray(x))
    (g_got,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    _close(g_got.numpy(), g_expected, GRAD_TOL, "d/dx")
    # Missing positions get exactly zero gradient, as in JAX.
    assert np.all(g_got.numpy()[np.isnan(x)] == 0.0)


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("case", ["dense_irregular", "masked_irregular"])
def test_fit_t_gradients(version, case):
    # With missing values the JAX public function is differentiated in t.
    # Without, it is held against the JAX masked pipeline (the same function
    # on fully observed data): jaxlib 0.9.0's CPU runtime corrupts memory when
    # it transposes the float64 Thomas scan with respect to its bands.
    x, t = _data(case, seed=7 + version)
    w = np.random.default_rng(2).standard_normal((3, 22, 8))
    jfit, tfit = FITS[version]
    if case == "masked_irregular":
        fn = lambda tj: jnp.sum(jfit(jnp.asarray(x), tj) * w)
    else:
        wT = jnp.asarray(w.reshape(3, 22, 4, 2).transpose(2, 0, 3, 1))
        fn = lambda tj: jnp.sum(jnp.stack(jcubic._natural_cubic_coeffs_masked(
            tj, jnp.swapaxes(jnp.asarray(x), -1, -2), version)) * wT)
    g_expected = jax.grad(fn)(jnp.asarray(t))
    t_t = torch.from_numpy(t).requires_grad_()
    (g_got,) = torch.autograd.grad((tfit(torch.from_numpy(x), t_t) * torch.from_numpy(w)).sum(),
                                   t_t)
    _close(g_got.numpy(), g_expected, GRAD_TOL, "d/dt")


def test_scalar_oracle():
    # The per-scalar NumPy re-implementation of the reference algorithm
    # (tests/test_natural_cubic_spline.py), at its tolerance.
    rng = np.random.default_rng(11)
    for version, fit in ((1, tt.natural_cubic_coeffs), (0, tt.natural_cubic_spline_coeffs)):
        for trial in range(4):
            length = int(rng.integers(5, 20))
            t = np.sort(rng.random(length) * 10) + 0.05 * np.arange(length)
            x = rng.standard_normal((2, length, 3))
            x[rng.random(x.shape) < 0.35] = np.nan
            x[0, :, 0] = np.nan
            if trial % 2:
                x[1, :, 1] = np.nan
                x[1, length // 2, 1] = 2.5
            coeffs = fit(torch.from_numpy(x), t).numpy()
            a, b, two_c, three_d = np.split(coeffs, 4, axis=-1)
            for bi in range(2):
                for ci in range(3):
                    expected = _oracle_masked_scalar(t, x[bi, :, ci], version)
                    for got, exp in zip((a, b, two_c, three_d), expected):
                        assert np.allclose(got[bi, :, ci], exp, atol=1e-8), (version, trial, bi, ci)


@pytest.mark.parametrize("version", [0, 1])
def test_plain_pipeline_matches_jax(version):
    x, t = _data("masked_irregular", seed=13)
    xT = np.swapaxes(x, -1, -2)
    expected = jcubic._masked_coeffs_xla(jnp.asarray(t),
                                         jcubic._impute_endpoints(jnp.asarray(xT), version))
    imputed = cubic._impute_endpoints(torch.from_numpy(xT), version)
    np.testing.assert_array_equal(
        imputed.numpy(), np.asarray(jcubic._impute_endpoints(jnp.asarray(xT), version)))
    got = cubic._masked_coeffs_plain(torch.from_numpy(t), imputed)
    for name, g, e in zip(("a", "b", "two_c", "three_d"), got, expected):
        _close(g.numpy(), e, VALUE_TOL, name)
    # K6/K7's wrapper takes the plain version for CPU tensors.
    plain = masked_cubic_kernel.masked_natural_cubic(torch.from_numpy(t), torch.from_numpy(xT),
                                                     version)
    for g, e in zip(plain, got):
        assert torch.equal(g, e)
    assert masked_cubic_kernel.LAUNCHES == 0


def _gappy_system(shape, seed):
    rng = np.random.default_rng(seed)
    observed = rng.random(shape) < 0.6
    hr = np.where(observed, rng.uniform(0.2, 1.0, shape), 0.0)
    hr_prev = rng.uniform(0.2, 1.0, shape)
    diag = 2 * (hr + hr_prev) + 0.5
    rhs = rng.standard_normal(shape)
    return diag, rhs, hr, hr_prev, observed


def test_gappy_solve_and_its_vjp_match_jax():
    system = _gappy_system((3, 4, 19), seed=17)
    expected = jcubic._masked_thomas_observed(*map(jnp.asarray, system))
    got = cubic._masked_thomas_observed(*map(torch.from_numpy, system))
    _close(got.numpy(), expected, VALUE_TOL, "solve")
    got = masked_tridiagonal_kernel.masked_thomas_kernel(*map(torch.from_numpy, system))
    _close(got.numpy(), expected, VALUE_TOL, "kernel wrapper on the CPU")

    g = np.random.default_rng(18).standard_normal(system[0].shape)
    observed = jnp.asarray(system[4])
    _, vjp = jax.vjp(lambda d, r, h, hp: jcubic._masked_solve(d, r, h, hp, observed),
                     *map(jnp.asarray, system[:4]))
    expected = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in system[:4]]
    out = cubic._MaskedSolve.apply(*leaves, torch.from_numpy(system[4]))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, gg, e in zip(("diag", "rhs", "hr", "hr_prev"), got, expected):
        _close(gg.numpy(), e, GRAD_TOL, name)


def _kernel_case(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 37)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[0, :5] = np.nan
    x[1, -6:] = np.nan
    x[2] = np.nan
    x[2, 20] = 1.25
    x[3, 18] = -0.5
    t = np.cumsum(0.5 + rng.random(37)).astype(np.float32)
    return t, x


@pytest.mark.parametrize("entry", ["full_v1", "resident_v0", "pallas"])
def test_matches_the_jax_kernels_in_interpret_mode(entry):
    # K6/K7 replaces three JAX entries; each is held against the port's
    # function (its plain version on the CPU) in float32.
    t, x = _kernel_case(seed=19)
    tj, xj = jnp.asarray(t), jnp.asarray(x)
    if entry == "full_v1":
        version, expected = 1, masked_natural_cubic_full(tj, xj, 1, interpret=True, kb=32)
    elif entry == "resident_v0":
        version, expected = 0, masked_natural_cubic_resident(tj, xj, 0, interpret=True)
    else:
        # Post-imputation values in (no imputation happens in the kernel).
        version = 1
        x = np.array(jcubic._impute_endpoints(xj, 1))
        expected = masked_natural_cubic_pallas(tj, jnp.asarray(x), interpret=True, kb=32)
    got = masked_cubic_kernel.masked_natural_cubic(torch.from_numpy(t), torch.from_numpy(x),
                                                   version)
    for name, g, e in zip(("a", "b", "two_c", "three_d"), got, expected):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(e)[..., :-1], KERNEL_TOL, name)


def test_gappy_solve_matches_the_jax_kernel_in_interpret_mode():
    diag, rhs, hr, hr_prev, observed = _gappy_system((4, 37), seed=23)
    arrays = [a.astype(np.float32) for a in (diag, rhs, hr, hr_prev)]
    expected = masked_thomas_pallas(*map(jnp.asarray, arrays), jnp.asarray(observed),
                                    interpret=True)
    got = cubic._masked_thomas_observed(*map(torch.from_numpy, arrays), torch.from_numpy(observed))
    _close(got.numpy(), expected, KERNEL_TOL)


def test_exports_and_alias():
    assert issubclass(tt.NaturalCubicSpline, tt.CubicSpline)
    x, _ = _data("masked", seed=29)
    coeffs = tt.natural_cubic_coeffs(torch.from_numpy(x))
    spline = tt.NaturalCubicSpline(coeffs)
    np.testing.assert_allclose(spline.evaluate(3.0).numpy(),
                               np.asarray(tc.NaturalCubicSpline(jnp.asarray(coeffs.numpy()))
                                          .evaluate(3.0)), rtol=VALUE_TOL, atol=VALUE_TOL)


# --------------------------------------------------------------------------
# The algebra of K6/K7's routes (csrc/masked_cubic.cu): each row cut into
# chunks of consecutive positions, every recurrence of the masked fit
# composed per chunk and scanned across the chunks, then run in each chunk
# from its carry-in.  A short emulation in torch, vectorised over rows and
# chunks, with the scans as Hillis-Steele doubling over the chunks, or in
# the kernel's order over its blocks (a cluster's, or a segmented row's with
# the carry-ins its launches give each block).

def _shifted(elems, d, identity, reverse):
    """elems (tuples of (rows, chunks) tensors) moved d chunks along the
    scan's direction, the identity shifted in."""
    out = []
    for e, i in zip(elems, identity):
        fill = torch.full_like(e[:, :d], i)
        out.append(torch.cat([e[:, d:], fill], 1) if reverse else torch.cat([fill, e[:, :-d]], 1))
    return tuple(out)


def _scan(elems, compose, identity, reverse=False):
    """Exclusive scan over the chunks: chunk c gets the composition of the
    chunks before it in the scan's direction (after it when reverse)."""
    d = 1
    while d < elems[0].shape[1]:
        elems = compose(_shifted(elems, d, identity, reverse), elems)
        d *= 2
    return _shifted(elems, 1, identity, reverse)


def _block_scan(elems, compose, identity, reverse=False, blocks=1, threads=256):
    """Each block's exclusive scan over its own threads' chunks as the
    kernels order it: the chunks are (blocks, threads) consecutive threads;
    shuffle levels over each warp of 32 (or of all the threads, where a toy
    block has fewer) and the warps' totals in order (row_scan.cuh:
    row_scan).  Returns (mine, excl), each element (rows, blocks, threads)."""
    rows = elems[0].shape[0]
    mine = tuple(v.reshape(rows, blocks, threads) for v in elems)
    width = min(threads, 32)
    lane = torch.arange(threads) % width

    def shift(vals, d):
        out = []
        for v, i in zip(vals, identity):
            fill = torch.full_like(v[..., :d], i)
            out.append(torch.cat([v[..., d:], fill], -1) if reverse
                       else torch.cat([fill, v[..., :-d]], -1))
        return tuple(out)

    def ident(like):
        return tuple(torch.full_like(like, i) for i in identity)

    incl, d = mine, 1
    while d < width:
        take = (lane + d < width) if reverse else (lane >= d)
        incl = tuple(torch.where(take, c, v) for c, v in zip(compose(shift(incl, d), incl), incl))
        d *= 2
    take = (lane + 1 < width) if reverse else (lane >= 1)
    excl = tuple(torch.where(take, s, i) for s, i in zip(shift(incl, 1), ident(incl[0])))
    warps = threads // width
    totals = tuple(v.reshape(rows, blocks, warps, width)[..., 0 if reverse else width - 1]
                   for v in incl)
    carries = []
    for wr in range(warps):
        carry = ident(totals[0][..., 0])
        for w in (range(warps - 1, wr, -1) if reverse else range(wr)):
            carry = compose(carry, tuple(v[..., w] for v in totals))
        carries.append(carry)
    carry = tuple(torch.stack([c[j] for c in carries], -1).repeat_interleave(width, -1)
                  for j in range(len(identity)))
    return mine, compose(carry, excl)


def _block_totals(mine, excl, compose, reverse=False):
    """Each block's total in its scan's direction, (rows, blocks) elements:
    what the block's last thread (first, in reverse) holds."""
    end = 0 if reverse else -1
    return compose(tuple(v[..., end] for v in excl), tuple(v[..., end] for v in mine))


def _cluster_scan(elems, compose, identity, reverse=False, blocks=1, threads=256):
    """The exclusive scan over the chunks as the cluster kernels order it:
    each block's own (_block_scan), then the blocks' totals in rank order
    (row_scan.cuh: cluster_scan)."""
    rows = elems[0].shape[0]
    mine, excl = _block_scan(elems, compose, identity, reverse, blocks, threads)
    block_totals = _block_totals(mine, excl, compose, reverse)
    carries = []
    for r in range(blocks):
        carry = tuple(torch.full_like(block_totals[0][..., 0], i) for i in identity)
        for q in (range(blocks - 1, r, -1) if reverse else range(r)):
            carry = compose(carry, tuple(v[..., q] for v in block_totals))
        carries.append(carry)
    carry = tuple(torch.stack([c[j] for c in carries], -1)[..., None].expand(-1, -1, threads)
                  for j in range(len(identity)))
    return tuple(v.reshape(rows, blocks * threads) for v in compose(carry, excl))


def _select(first, second):  # (present, values...): the later present element wins
    present = second[0] > 0
    return tuple(torch.where(present, s, f) for f, s in zip(first, second))


def _affine(first, second):  # x -> a x + b, first applied first
    return second[0] * first[0], second[0] * first[1] + second[1]


def _rescale(m, rescale):
    """A 2x2 Moebius matrix divided by the power of two at or below its
    largest entry (which lands in [1, 2)): the map it stands for is
    unchanged, its entries stay in range."""
    if not rescale:
        return m
    big = torch.stack([v.abs() for v in m]).amax(0)
    _, exponent = torch.frexp(big)
    exponent = torch.where(big > 0, exponent - 1, 0)
    return tuple(torch.ldexp(v, -exponent) for v in m)


def _moebius(rescale):
    def compose(first, second):  # second @ first
        a, b, c, d = first
        e, f, g, h = second
        return _rescale((e * a + f * c, e * b + f * d, g * a + h * c, g * b + h * d), rescale)
    return compose


def _param_affine(first, second):  # x -> a x + b + c p, first applied first
    return second[0] * first[0], second[0] * first[1] + second[1], second[0] * first[2] + second[2]


def _segment_walk(t, x, version, plan):
    """What each block of a segmented fit walks from its row's spans
    (``csrc/masked_cubic.cu``: span_fit_kernel, seg_fit_walk), (rows, S)
    each: the next observation after the segment (present, value, time),
    the last observed knot j' before it (present, value, time) and j''s hr
    and sph, after imputation."""
    rows, k = x.shape
    S, seg = plan.cluster, plan.segment
    big = torch.iinfo(torch.int64).max
    raw = ~torch.isnan(torch.nn.functional.pad(x, (0, S * seg - k), value=float("nan")))
    pos = torch.arange(S * seg)
    span_first = torch.where(raw, pos, big).reshape(rows, S, seg).amin(-1)
    span_last = torch.where(raw, pos, -1).reshape(rows, S, seg).amax(-1)
    first = span_first.amin(-1, keepdim=True)
    last = span_last.amax(-1, keepdim=True)
    any_ = first != big
    first, last = torch.where(any_, first, 0), torch.where(any_, last, k - 1)
    v_first, v_last = x.gather(1, first), x.gather(1, last)
    first_from = span_first.flip(1).cummin(1).values.flip(1)  # the segments from each on
    first_after = torch.cat([first_from[:, 1:], torch.full((rows, 1), big)], 1)
    last_before = torch.cat([torch.full((rows, 1), -1), span_last.cummax(1).values[:, :-1]], 1)
    starts = torch.arange(S) * seg
    ends = (starts + seg).clamp(max=k)

    def next_at(s, raw_next):
        if version == 0:
            j = torch.where(s == 0, 0, torch.where(raw_next != big, raw_next, k - 1))
        else:
            j = torch.where((s < first) | (s > last), s, raw_next)
        return torch.where(any_ & (s < k), j, -1)

    def prev_before(s, raw_prev):
        if version == 0:
            j = torch.where(raw_prev >= 0, raw_prev, 0)
        else:
            j = torch.where((s - 1 < first) | (s - 1 > last), s - 1, raw_prev)
        return torch.where(any_ & (s > 0), j, -1)

    def value(j):  # x after imputation at j (0 where j is -1)
        jc = j.clamp(min=0)
        v = x.gather(1, jc)
        fill = torch.where(jc == 0, v_first, v_last) if version == 0 else torch.where(
            jc < first, v_first, v_last)
        return torch.where(j >= 0, torch.where(torch.isnan(v), fill, v), 0.0)

    def time(j):
        return torch.where(j >= 0, t[j.clamp(min=0)], 0.0)

    after = next_at(ends, first_after)
    nxt = ((after >= 0).to(x.dtype), value(after), time(after))
    jp, jn = prev_before(starts, last_before), next_at(starts, first_from)
    on = (jp >= 0) & (jn >= 0)
    xj, tj = value(jp), time(jp)
    hr = torch.where(on, 1.0 / torch.where(on, time(jn) - tj, 1.0), 0.0)
    sph = torch.where(on, 6.0 * (value(jn) - xj) * hr, 0.0)
    return nxt, ((jp >= 0).to(x.dtype), xj, tj), hr, sph


def _chunked_fit(t, x, version, positions=16, rescale=True, plan=None):
    """K6/K7's function (``_masked_fit_plain``) by chunks and scans, in x's
    dtype: t (k,), x (rows, k) -> (a, b, two_c, three_d), each (rows, k - 1).
    With a cluster or segmented ``plan`` the chunks are laid out as those
    routes hold them (block r's threads from position r * segment on, the
    threads past its segment holding none).  Over a cluster they are scanned
    in its order (``_cluster_scan``).  Segmented, each block scans its own
    chunks (``_block_scan``) after its carry-ins, as the four launches give
    them: the walk over the spans for the observations' carries
    (``_segment_walk``); the Moebius totals, then the elimination's and the
    substitution's, walked in rank order; the polynomial's carry-in derived
    from those of the phases before it."""
    rows, k = x.shape
    scan = _scan
    segmented = plan is not None and plan.variant == "segmented"
    if plan is None or plan.cluster == 1:
        nc = -(-k // positions)
        pos = torch.arange(nc * positions)
        pos = torch.where(pos < k, pos, -1)
    else:
        nc = plan.cluster * plan.threads
        local = torch.arange(plan.threads * positions)
        pos = torch.cat([r * plan.segment + local for r in range(plan.cluster)])
        local = local.repeat(plan.cluster)
        pos = torch.where((local < plan.segment) & (pos < k), pos, -1)

        def scan(elems, compose, identity, reverse=False):
            return _cluster_scan(elems, compose, identity, reverse, plan.cluster, plan.threads)
    if segmented:
        S, T = plan.cluster, plan.threads
        walk_next, walk_prev, walk_hr, walk_sph = _segment_walk(t, x, version, plan)

        def block_scan(elems, compose, identity, reverse=False):
            return _block_scan(elems, compose, identity, reverse, S, T)

        def carried(excl, compose, carry):
            """A block's scan from its carry-in, carry (rows, S) elements."""
            carry = tuple(v[..., None].expand_as(excl[0]) for v in carry)
            return tuple(v.reshape(rows, nc) for v in compose(carry, excl))

        def scan(elems, compose, identity, reverse=False, carry=None):
            return carried(block_scan(elems, compose, identity, reverse)[1], compose, carry)
    K = nc * positions
    held = pos >= 0  # the layout's slots that hold a position of the row
    xp = torch.where(held, x[:, pos.clamp(min=0)], float("nan"))
    tp = torch.where(held, t[pos.clamp(min=0)], 0.0)
    # Phase 0: the first and last observed positions (a reduction).
    seen = ~torch.isnan(xp)
    first = torch.where(seen, pos, k).amin(-1, keepdim=True)
    last = torch.where(seen, pos, -1).amax(-1, keepdim=True)
    first, last = torch.where(first == k, 0, first), torch.where(first == k, k - 1, last)
    v_first, v_last = x.gather(1, first), x.gather(1, last)
    missing = torch.isnan(xp) & held
    if version == 0:
        fill = torch.where(pos == 0, v_first, torch.where(pos == k - 1, v_last, xp))
    else:
        fill = torch.where(pos < first, v_first, torch.where(pos > last, v_last, xp))
    v = torch.where(missing, fill, xp)
    obs = (~torch.isnan(v)) & held
    xs = torch.where(obs, v, 0.0)
    ob, xs = obs.reshape(rows, nc, positions), xs.reshape(rows, nc, positions)
    tc_ = tp.reshape(nc, positions).expand(rows, nc, positions)
    zero = torch.zeros((rows, nc), dtype=x.dtype)
    one = torch.ones_like(zero)
    U = range(positions)
    carry = {}
    if segmented:
        pds_in = 0.5 * walk_sph * walk_hr
        carry = {"next": walk_next, "prev": (walk_prev[0], walk_hr, pds_in)}

    # Phase 1 (reverse): the next observed (value, time), a select-carry.
    elem = (zero, zero, zero)
    for u in reversed(U):
        elem = _select(elem, (ob[..., u].to(x.dtype), xs[..., u], tc_[..., u]))
    later, cx, ct = scan(elem, _select, (0.0, 0.0, 0.0), reverse=True, **(
        {"carry": carry["next"]} if segmented else {}))
    later = later > 0
    hr, sph, pds = (torch.zeros_like(xs) for _ in range(3))
    for u in reversed(U):
        o = ob[..., u]
        on = o & later
        h = torch.where(on, 1.0 / torch.where(on, ct - tc_[..., u], 1.0), 0.0)
        hr[..., u] = h
        sph[..., u] = 6.0 * (cx - xs[..., u]) * h
        pds[..., u] = 0.5 * sph[..., u] * h
        cx, ct = torch.where(o, xs[..., u], cx), torch.where(o, tc_[..., u], ct)
        later = later | o

    # Phase 2: the previous observed (hr, pds), a select-carry; the Thomas
    # diagonal, a Moebius scan; its right-hand side, an affine scan.
    elem = (zero, zero, zero)
    for u in U:
        elem = _select(elem, (ob[..., u].to(x.dtype), hr[..., u], pds[..., u]))
    _, hp0, pp0 = scan(elem, _select, (0.0, 0.0, 0.0), **(
        {"carry": carry["prev"]} if segmented else {}))
    mob = _moebius(rescale)
    m, hp = (one, zero, zero, one), hp0
    for u in U:
        o = ob[..., u]
        dg = 2.0 * (hp + hr[..., u])
        dg = torch.where(dg > 0, dg, 1.0)
        step = mob(m, (dg, -hp * hp, one, zero))
        m = tuple(torch.where(o, s, v) for s, v in zip(step, m))
        hp = torch.where(o, hr[..., u], hp)
    if segmented:
        # The SEG_PIVOTS launch's totals, walked in rank order from d = 1
        # (seg_moebius_carry); each block's scan after its carry-in.
        mine, excl = block_scan(m, mob, (1.0, 0.0, 0.0, 1.0))
        tm = _block_totals(mine, excl, mob)
        d_carry, value = [], torch.ones((rows,), dtype=x.dtype)
        for q in range(S):
            d_carry.append(value)
            a, b, c, d = (e[:, q] for e in tm)
            value = (a * value + b) / (c * value + d)
        d_carry = torch.stack(d_carry, 1)
        to = torch.zeros_like(d_carry), torch.ones_like(d_carry)
        a, b, c, d = carried(excl, mob, (to[0], d_carry, to[0], to[1]))
    else:
        a, b, c, d = scan(m, mob, (1.0, 0.0, 0.0, 1.0))
    prev_d = (a + b) / (c + d)  # the carried map applied to d = 1
    nd, nb, w, r = (torch.zeros_like(xs) for _ in range(4))
    aff, hp, pp = (one, zero), hp0, pp0
    for u in U:
        o = ob[..., u]
        dg = 2.0 * (hp + hr[..., u])
        dg = torch.where(dg > 0, dg, 1.0)
        wu = hp / prev_d
        ru = pp + pds[..., u]
        du = dg - wu * hp
        nd[..., u], w[..., u], r[..., u] = torch.where(o, du, 1.0), wu, ru
        aff = tuple(torch.where(o, s, v) for s, v in zip(_affine(aff, (-wu, ru)), aff))
        prev_d = torch.where(o, du, prev_d)
        hp, pp = torch.where(o, hr[..., u], hp), torch.where(o, pds[..., u], pp)
    if segmented:
        # The SEG_TOTALS launch: the elimination's total, then the
        # substitution's, affine in the segment's elimination carry-in p
        # (nb = nb0 + sens p), composed in ascending order
        # (publish_segment_totals); then seg_affine_carries' walk.
        mine, excl = block_scan(aff, _affine, (1.0, 0.0))
        te = _block_totals(mine, excl, _affine)
        nb0, sens = excl[1].reshape(rows, nc), excl[0].reshape(rows, nc)
        sub = (one, zero, zero)
        for u in U:
            o, inv = ob[..., u], 1.0 / nd[..., u]
            nb0 = torch.where(o, r[..., u] - w[..., u] * nb0, nb0)
            sens = torch.where(o, -w[..., u] * sens, sens)
            step = _param_affine((-(hr[..., u] * inv), inv * nb0, inv * sens), sub)
            sub = tuple(torch.where(o, s, v) for s, v in zip(step, sub))
        ts = _block_totals(*block_scan(sub, _param_affine, (1.0, 0.0, 0.0), True),
                           _param_affine, True)
        nb_in, value = [], torch.zeros((rows,), dtype=x.dtype)
        for q in range(S):
            nb_in.append(value)
            value = te[0][:, q] * value + te[1][:, q]
        x_in = []
        for me in range(S):
            after = (torch.ones_like(value), torch.zeros_like(value))
            for q in range(me + 1, S):
                after = _affine((ts[0][:, q], ts[1][:, q] + ts[2][:, q] * nb_in[q]), after)
            x_in.append(after[1])
        nb_in, x_in = torch.stack(nb_in, 1), torch.stack(x_in, 1)
        _, prev_b = carried(excl, _affine, (torch.zeros_like(nb_in), nb_in))
    else:
        _, prev_b = scan(aff, _affine, (1.0, 0.0))
    for u in U:
        o = ob[..., u]
        bu = r[..., u] - w[..., u] * prev_b
        nb[..., u] = torch.where(o, bu, 0.0)
        prev_b = torch.where(o, bu, prev_b)

    # Phase 3 (reverse): back substitution, an affine scan of kd in kd at
    # the next observed knot.
    aff = (one, zero)
    for u in reversed(U):
        o = ob[..., u]
        step = _affine(aff, (-hr[..., u] / nd[..., u], nb[..., u] / nd[..., u]))
        aff = tuple(torch.where(o, s, v) for s, v in zip(step, aff))
    if segmented:
        _, kdn = scan(aff, _affine, (1.0, 0.0), reverse=True,
                      carry=(torch.zeros_like(x_in), x_in))
    else:
        _, kdn = scan(aff, _affine, (1.0, 0.0), reverse=True)
    kd, c0, d0 = (torch.zeros_like(xs) for _ in range(3))
    for u in reversed(U):
        o = ob[..., u]
        h, s6 = hr[..., u], sph[..., u]
        kdu = torch.where(o, (nb[..., u] - h * kdn) / nd[..., u], 0.0)
        kd[..., u] = kdu
        c0[..., u] = (s6 - 4.0 * kdu - 2.0 * kdn) * h
        d0[..., u] = (-s6 + 3.0 * (kdu + kdn)) * h * h
        kdn = torch.where(o, kdu, kdn)
    if segmented:
        # The polynomial of j', the last observed knot before each segment,
        # by phase 3's formulas: nd(j') and nb(j') the carry-ins, kd at the
        # next knot the one the block's first thread ended on.
        kd_next = kdn.reshape(rows, S, T)[..., 0]
        present, xj, tj = walk_prev
        kdj = (nb_in - walk_hr * kd_next) / d_carry
        poly = (xj, kdj, (walk_sph - 4.0 * kdj - 2.0 * kd_next) * walk_hr,
                (-walk_sph + 3.0 * (kdj + kd_next)) * walk_hr * walk_hr, tj)
        carry["poly"] = (present,) + tuple(torch.where(present > 0, v, 0.0) for v in poly)

    # Phase 4: the polynomial of the last observed knot at or before each
    # position (position 0's before any), a select-carry, re-based.
    start = ob | (pos.reshape(nc, positions) == 0)
    elem = (zero,) * 6
    for u in U:
        elem = _select(elem, (start[..., u].to(x.dtype), xs[..., u], kd[..., u], c0[..., u],
                              d0[..., u], tc_[..., u]))
    carry = scan(elem, _select, (0.0,) * 6, **(
        {"carry": carry["poly"]} if segmented else {}))[1:]
    outs = [torch.zeros_like(xs) for _ in range(4)]
    for u in U:
        carry = tuple(torch.where(start[..., u], v, cv) for v, cv in zip(
            (xs[..., u], kd[..., u], c0[..., u], d0[..., u], tc_[..., u]), carry))
        ca, cb, cc, cd, cto = carry
        off = cto - tc_[..., u]
        outs[0][..., u] = ca + ((0.5 * cc - cd * off / 3.0) * off - cb) * off
        outs[1][..., u] = cb + (cd * off - cc) * off
        outs[2][..., u] = cc - 2.0 * cd * off
        outs[3][..., u] = cd
    placed = []
    for o in outs:  # each slot's value at its position of the row
        row = torch.zeros((rows, k), dtype=x.dtype)
        row[:, pos[held]] = o.reshape(rows, K)[:, held]
        placed.append(row[:, :k - 1])
    return tuple(placed)


def _chunked_case(density, seed):
    """Eight rows of length 4096 at this NaN density, with a leading and a
    trailing NaN run, a single observation and an all-NaN row; irregular
    times."""
    rng = np.random.default_rng(seed)
    k = 4096
    x = rng.standard_normal((8, k)).astype(np.float32)
    x[rng.random(x.shape) < density] = np.nan
    x[0, :800] = np.nan
    x[1, -800:] = np.nan
    x[2] = np.nan
    x[2, 2000] = 1.5
    x[3] = np.nan
    t = np.cumsum(rng.uniform(0.2, 1.5, k)).astype(np.float32)
    return torch.from_numpy(t), torch.from_numpy(x)


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("density", [0.0, 0.2, 0.8, 1.0])
def test_chunked_scans_give_the_masked_fit(density, version):
    """In float32 at k 4096 in 256 chunks of 16 positions, the chunked
    recurrences and scans give the plain pipeline's fit in float64 within
    1e-4 of each output's largest magnitude (or 1), as chip_smoke.py holds
    the kernel."""
    t, x = _chunked_case(density, seed=int(10 * density) + version)
    got = _chunked_fit(t, x, version)
    expected = cubic._masked_fit_plain(t.double(), x.double(), version)
    for name, g, e in zip(("a", "b", "two_c", "three_d"), got, expected):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        limit = 1e-4 * max(1.0, float(e.abs().max()))
        assert float((g.double() - e).abs().max()) <= limit, name


def test_unrescaled_moebius_scan_overflows():
    """Without rescaling, the Moebius product over a long observed run
    overflows float32 (the diagonal grows by ~3.7 a knot over 4096 knots),
    and the fit is lost: why each composition is rescaled."""
    t, x = _chunked_case(0.0, seed=0)
    got = _chunked_fit(t, x, 0, rescale=False)
    assert not all(bool(torch.isfinite(g).all()) for g in got)
    assert all(bool(torch.isfinite(g).all()) for g in _chunked_fit(t, x, 0))


def _long_case(k, density, seed, rows=5):
    """Rows of length k at this NaN density, with a leading and a trailing
    NaN run, a single observation and an all-NaN row; irregular times."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[rng.random(x.shape) < density] = np.nan
    run = k // 5
    x[0, :run] = np.nan
    x[1, -run:] = np.nan
    x[2] = np.nan
    x[2, k // 2] = 1.5
    x[3] = np.nan
    t = np.cumsum(rng.uniform(0.2, 1.5, k)).astype(np.float32)
    return t, x


def _check_fit(got, expected):
    """The mirror's float32 outputs against the float64 expectation within
    1e-4 of each output's largest magnitude (or 1)."""
    for name, g, e in zip(("a", "b", "two_c", "three_d"), got, expected):
        e = np.asarray(e)
        assert g.dtype == torch.float32 and torch.isfinite(g).all() and g.shape == e.shape, name
        limit = 1e-4 * max(1.0, float(np.abs(e).max()))
        assert float(np.abs(g.double().numpy() - e).max()) <= limit, name


def _jax_masked_fit(t, x, version):
    return jcubic._masked_coeffs_xla(
        jnp.asarray(t, dtype=jnp.float64),
        jcubic._impute_endpoints(jnp.asarray(x, dtype=jnp.float64), version))


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("k", [4097, 8192, 8193, 16384, 32768])
def test_cluster_scans_give_the_jax_masked_fit(k, density, version):
    """The cluster variant's arithmetic in float32 (each block's segment
    scanned as a resident block scans a row, the blocks' totals composed in
    rank order, for all five phases) against the JAX package's masked
    pipeline after endpoint imputation in float64, within 1e-4 of each
    output's largest magnitude (or 1), as the resident mirror is held."""
    plan = masked_cubic_kernel.fit_plan(k)
    assert plan.variant == "cluster" and plan.cluster == -(-k // 4096)
    t, x = _long_case(k, density, seed=k + int(10 * density) + version)
    got = _chunked_fit(torch.from_numpy(t), torch.from_numpy(x), version, plan=plan)
    _check_fit(got, _jax_masked_fit(t, x, version))


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("k", [32769, 65536, 65537])
def test_segmented_scans_give_the_jax_masked_fit(k, density, version):
    """The segmented route's arithmetic in float32 (each block's segment
    scanned from carry-ins that the four launches give it: the walk over the
    spans, the Moebius totals, the elimination's and the substitution's, in
    rank order; the polynomial's derived) against the JAX package's masked
    pipeline after endpoint imputation in float64, within 1e-4 of each
    output's largest magnitude (or 1), as the cluster mirror is held."""
    plan = masked_cubic_kernel.fit_plan(k)
    assert plan.variant == "segmented" and plan.cluster == -(-k // 4096) > 8
    t, x = _long_case(k, density, seed=k + int(10 * density) + version)
    got = _chunked_fit(torch.from_numpy(t), torch.from_numpy(x), version, plan=plan)
    _check_fit(got, _jax_masked_fit(t, x, version))


def _sparse_segments(case, k, segment, seed, rows=5):
    """Rows of length k (20 % NaN elsewhere) whose observations leave whole
    segments empty: all in one middle segment ("one_segment"), none in
    several interior segments ("empty_segments"), or a leading and a
    trailing NaN run each longer than a segment ("long_runs"); irregular
    times."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    S = -(-k // segment)
    if case == "one_segment":
        mid = S // 2
        keep = x[:, mid * segment:(mid + 1) * segment].copy()
        x[:] = np.nan
        x[:, mid * segment:(mid + 1) * segment] = keep
        x[1, :mid * segment + segment // 2] = np.nan  # one observation-rich half
        x[2] = np.nan
        x[2, mid * segment + 7] = -0.75  # a single observation
    elif case == "empty_segments":
        for r, empty in enumerate(((2, 3, 4), (1, 3, 5, 6), tuple(range(1, S - 1)))):
            for q in empty:
                x[r, q * segment:(q + 1) * segment] = np.nan
    else:
        x[:, :3 * segment // 2] = np.nan
        x[:, k - (7 * segment // 3):] = np.nan
        x[1, :5 * segment // 2] = np.nan
    t = np.cumsum(rng.uniform(0.2, 1.5, k)).astype(np.float32)
    return t, x


SPARSE_CASES = ["one_segment", "empty_segments", "long_runs"]


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("case", SPARSE_CASES)
@pytest.mark.parametrize("k", [32769, 65537])
def test_segmented_scans_carry_across_empty_segments(k, case, version):
    """The segmented mirror on rows whose segments hold no observation:
    carries pass through them and imputation reaches across several."""
    plan = masked_cubic_kernel.fit_plan(k)
    t, x = _sparse_segments(case, k, plan.segment, seed=k + SPARSE_CASES.index(case))
    got = _chunked_fit(torch.from_numpy(t), torch.from_numpy(x), version, plan=plan)
    _check_fit(got, _jax_masked_fit(t, x, version))


TOY_SEGMENT = 32  # two threads of 16 positions a block


def _toy_plan(k):
    """The segmented route at a toy split: blocks of two threads, segments
    of 32 positions."""
    segments = -(-k // TOY_SEGMENT)
    assert segments > row_split.CLUSTER_MAX
    return row_split.SolvePlan("segmented", 2, 1, 2, 16, segments, TOY_SEGMENT)


@pytest.mark.parametrize("k, case, version", [
    (301, "density 0.3", 0), (480, "one_segment", 1), (577, "empty_segments", 0),
    (600, "long_runs", 1), (333, "density 0.8", 1)])
def test_segmented_scans_at_a_toy_split_match_the_jax_kernel(k, case, version):
    """The segmented mirror over 10 to 19 segments of 32 positions against
    the JAX streaming fit in interpret mode, 32 positions a block (the JAX
    tests' tolerance, 2e-4), on the rows with an observation (the JAX
    kernel leaves the others to its caller; the port's are zeros)."""
    if case.startswith("density"):
        t, x = _long_case(k, float(case.split()[1]), seed=k + version)
    else:
        t, x = _sparse_segments(case, k, TOY_SEGMENT, seed=k + version)
    expected = masked_natural_cubic_full(jnp.asarray(t), jnp.asarray(x), version,
                                         interpret=True, kb=32)
    got = _chunked_fit(torch.from_numpy(t), torch.from_numpy(x), version, plan=_toy_plan(k))
    some = ~np.isnan(x).all(-1)
    for name, g, e in zip(("a", "b", "two_c", "three_d"), got, expected):
        assert torch.isfinite(g).all() and not g[~torch.from_numpy(some)].any(), name
        _close(g.numpy()[some], np.asarray(e)[some, :-1], KERNEL_TOL, name)


@pytest.mark.parametrize("k, variant, threads_per_row, cluster, segment", [
    (2, "resident", 1, 1, 2), (3, "resident", 1, 1, 3), (16, "resident", 1, 1, 16),
    (17, "resident", 2, 1, 17), (16 * 32 - 1, "resident", 32, 1, 511),
    (16 * 32, "resident", 32, 1, 512), (16 * 32 + 1, "resident", 64, 1, 513),
    (4096, "resident", 256, 1, 4096), (4097, "cluster", 256, 2, 2064),
    (8192, "cluster", 256, 2, 4096), (8193, "cluster", 256, 3, 2736),
    (16384, "cluster", 256, 4, 4096), (32768, "cluster", 256, 8, 4096),
    (32769, "segmented", 256, 9, 3648), (65536, "segmented", 256, 16, 4096),
    (65537, "segmented", 256, 17, 3856)])
def test_fit_plan_boundaries(k, variant, threads_per_row, cluster, segment):
    """The plan picks K6/K7's route and threads per row from k: the
    resident route holds 16 positions a thread, a row in a power of two of
    threads (several rows a block of 256 for short rows) up to 4096
    positions; longer rows span ceil(k / 4096) blocks, the row split evenly
    in whole chunks of 16, over a cluster up to 32 768 positions and in
    segmented launches beyond."""
    plan = masked_cubic_kernel.fit_plan(k)
    assert (plan.variant, plan.threads_per_row, plan.cluster, plan.segment) == (
        variant, threads_per_row, cluster, segment)
    assert plan.threads_per_row * plan.rows_per_block == plan.threads
    if variant == "resident":
        assert (plan.threads, plan.positions) == (256, 16)
        assert plan.threads_per_row * 16 >= k > plan.threads_per_row * 8 or k <= 16
    else:
        assert (plan.threads, plan.positions, plan.rows_per_block) == (256, 16, 1)
        assert segment % 16 == 0 and segment <= 4096 and (cluster - 1) * segment < k
        assert row_split.row_split(k) == (cluster, segment)
        assert (cluster > 8) == (variant == "segmented")
    assert masked_cubic_kernel.RESIDENT_MAX == 4096
    assert masked_cubic_kernel.CLUSTER_REACH == 8 * 4096


def test_fit_totals_size():
    # Each segment's span (2), Moebius (4), elimination (2) and
    # substitution (3) totals, for every row.
    assert row_split.fit_totals(17, 2048) == 17 * 2048 * 11
    assert row_split.fit_totals(9, 1) == 99


@pytest.mark.parametrize("k", [17, 4097, 8193, 32769, 65537])
def test_fit_wrapper_routes_with_stand_ins(k, monkeypatch):
    """The launch runs only on the card: a stand-in for the route's kernel
    (the chunked mirror in the route's layout and order) drives the
    wrapper's own code: the plan handed to the kernel, the outputs' shapes
    and the counts."""
    seen = []

    def kernel(plan, t, x, outs, version):
        seen.append((plan, tuple(x.shape), tuple(o.shape for o in outs), version))
        got = _chunked_fit(t, x, version, plan=plan)
        for o, g in zip(outs, got):
            o.copy_(g)

    monkeypatch.setattr(masked_cubic_kernel.dispatch, "check_operands", lambda *a: None)
    monkeypatch.setattr(masked_cubic_kernel, "_kernel", kernel)
    masked_cubic_kernel.reset_launch_counts()
    t, x = _long_case(k, 0.2, seed=k, rows=4)
    t, x = torch.from_numpy(t), torch.from_numpy(x)
    got = masked_cubic_kernel.launch(t, x, 1)
    expected = cubic._masked_fit_plain(t.double(), x.double(), 1)
    for g, e in zip(got, expected):
        assert g.shape == (4, k - 1)
        assert float((g.double() - e).abs().max()) <= 1e-4 * max(1.0, float(e.abs().max()))
    plan = masked_cubic_kernel.fit_plan(k)
    assert seen == [(plan, (4, k), ((4, k - 1),) * 4, 1)]
    assert masked_cubic_kernel.LAUNCHES == 1
    assert masked_cubic_kernel.ROUTE_LAUNCHES == {v: int(v == plan.variant)
                                                  for v in ("resident", "cluster", "segmented")}
    masked_cubic_kernel.reset_launch_counts()
    assert masked_cubic_kernel.LAUNCHES == 0
    assert set(masked_cubic_kernel.ROUTE_LAUNCHES.values()) == {0}


def test_fit_plan_rejects_short_rows():
    with pytest.raises(ValueError):
        masked_cubic_kernel.fit_plan(1)
