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
# The algebra of K6/K7's resident design (csrc/masked_cubic.cu): each row cut
# into chunks of consecutive positions, every recurrence of the masked fit
# composed per chunk and scanned across the chunks, then run in each chunk
# from its carry-in.  A short emulation in torch, vectorised over rows and
# chunks, with the scans as Hillis-Steele doubling over the chunks.

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


def _cluster_scan(elems, compose, identity, reverse=False, blocks=1, threads=256):
    """The exclusive scan over the chunks as the cluster kernels order it:
    the chunks are (blocks, threads) consecutive threads; within a block,
    shuffle levels over each warp of 32 and the warps' totals in order
    (row_scan.cuh: row_scan), then the blocks' totals in rank order
    (cluster_scan)."""
    rows = elems[0].shape[0]
    mine = tuple(v.reshape(rows, blocks, threads) for v in elems)
    lane = torch.arange(threads) % 32

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
    while d < 32:
        take = (lane + d < 32) if reverse else (lane >= d)
        incl = tuple(torch.where(take, c, v) for c, v in zip(compose(shift(incl, d), incl), incl))
        d *= 2
    take = (lane + 1 < 32) if reverse else (lane >= 1)
    excl = tuple(torch.where(take, s, i) for s, i in zip(shift(incl, 1), ident(incl[0])))
    warps = threads // 32
    totals = tuple(v.reshape(rows, blocks, warps, 32)[..., 0 if reverse else 31] for v in incl)
    carries = []
    for wr in range(warps):
        carry = ident(totals[0][..., 0])
        for w in (range(warps - 1, wr, -1) if reverse else range(wr)):
            carry = compose(carry, tuple(v[..., w] for v in totals))
        carries.append(carry)
    carry = tuple(torch.stack([c[j] for c in carries], -1).repeat_interleave(32, -1)
                  for j in range(len(identity)))
    excl = compose(carry, excl)
    end = 0 if reverse else threads - 1
    block_totals = compose(tuple(v[..., end] for v in excl), tuple(v[..., end] for v in mine))
    carries = []
    for r in range(blocks):
        carry = ident(block_totals[0][..., 0])
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


def _chunked_fit(t, x, version, positions=16, rescale=True, plan=None):
    """K6/K7's function (``_masked_fit_plain``) by chunks and scans, in x's
    dtype: t (k,), x (rows, k) -> (a, b, two_c, three_d), each (rows, k - 1).
    With a cluster ``plan`` the chunks are laid out as the cluster variant
    holds them (block r's threads from position r * segment on, the threads
    past its segment holding none) and scanned in its order
    (``_cluster_scan``)."""
    rows, k = x.shape
    scan = _scan
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

    # Phase 1 (reverse): the next observed (value, time), a select-carry.
    elem = (zero, zero, zero)
    for u in reversed(U):
        elem = _select(elem, (ob[..., u].to(x.dtype), xs[..., u], tc_[..., u]))
    later, cx, ct = scan(elem, _select, (0.0, 0.0, 0.0), reverse=True)
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
    _, hp0, pp0 = scan(elem, _select, (0.0, 0.0, 0.0))
    mob = _moebius(rescale)
    m, hp = (one, zero, zero, one), hp0
    for u in U:
        o = ob[..., u]
        dg = 2.0 * (hp + hr[..., u])
        dg = torch.where(dg > 0, dg, 1.0)
        step = mob(m, (dg, -hp * hp, one, zero))
        m = tuple(torch.where(o, s, v) for s, v in zip(step, m))
        hp = torch.where(o, hr[..., u], hp)
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

    # Phase 4: the polynomial of the last observed knot at or before each
    # position (position 0's before any), a select-carry, re-based.
    start = ob | (pos.reshape(nc, positions) == 0)
    elem = (zero,) * 6
    for u in U:
        elem = _select(elem, (start[..., u].to(x.dtype), xs[..., u], kd[..., u], c0[..., u],
                              d0[..., u], tc_[..., u]))
    carry = scan(elem, _select, (0.0,) * 6)[1:]
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
    expected = jcubic._masked_coeffs_xla(
        jnp.asarray(t, dtype=jnp.float64),
        jcubic._impute_endpoints(jnp.asarray(x, dtype=jnp.float64), version))
    for name, g, e in zip(("a", "b", "two_c", "three_d"), got, expected):
        e = np.asarray(e)
        assert g.dtype == torch.float32 and torch.isfinite(g).all() and g.shape == e.shape, name
        limit = 1e-4 * max(1.0, float(np.abs(e).max()))
        assert float(np.abs(g.double().numpy() - e).max()) <= limit, name


@pytest.mark.parametrize("k, variant, threads_per_row, cluster, segment", [
    (2, "resident", 1, 1, 2), (3, "resident", 1, 1, 3), (16, "resident", 1, 1, 16),
    (17, "resident", 2, 1, 17), (16 * 32 - 1, "resident", 32, 1, 511),
    (16 * 32, "resident", 32, 1, 512), (16 * 32 + 1, "resident", 64, 1, 513),
    (4096, "resident", 256, 1, 4096), (4097, "cluster", 256, 2, 2064),
    (8192, "cluster", 256, 2, 4096), (8193, "cluster", 256, 3, 2736),
    (16384, "cluster", 256, 4, 4096), (32768, "cluster", 256, 8, 4096),
    (32769, "long", 1, 1, 32769)])
def test_fit_plan_boundaries(k, variant, threads_per_row, cluster, segment):
    """The plan picks K6/K7's variant and threads per row from k: the
    resident variant holds 16 positions a thread, a row in a power of two of
    threads (several rows a block of 256 for short rows) up to 4096
    positions; longer rows up to 32 768 span a cluster of ceil(k / 4096)
    blocks, the row split evenly in whole chunks of 16; longer rows take the
    long-row variant, one thread a row."""
    plan = masked_cubic_kernel.fit_plan(k)
    assert (plan.variant, plan.threads_per_row, plan.cluster, plan.segment) == (
        variant, threads_per_row, cluster, segment)
    assert plan.threads_per_row * plan.rows_per_block == plan.threads
    if variant == "resident":
        assert (plan.threads, plan.positions) == (256, 16)
        assert plan.threads_per_row * 16 >= k > plan.threads_per_row * 8 or k <= 16
    if variant == "cluster":
        assert (plan.threads, plan.positions, plan.rows_per_block) == (256, 16, 1)
        assert segment % 16 == 0 and segment <= 4096 and (cluster - 1) * segment < k
        assert row_split.row_split(k) == (cluster, segment)
    assert masked_cubic_kernel.RESIDENT_MAX == 4096
    assert masked_cubic_kernel.CLUSTER_REACH == 8 * 4096


@pytest.mark.parametrize("k", [17, 4097, 8193, 32769])
def test_fit_wrapper_routes_with_stand_ins(k, monkeypatch):
    """The launch runs only on the card: a stand-in for the variant's kernel
    (the chunked mirror in the kernel's layout and order for the resident
    and cluster variants, the plain pipeline for the long-row one) drives
    the wrapper's own code: the plan handed to the kernel, the outputs'
    shapes and the counts."""
    seen = []

    def kernel(plan, t, x, outs, version):
        seen.append((plan, tuple(x.shape), tuple(o.shape for o in outs), version))
        if plan.variant == "long":
            got = cubic._masked_fit_plain(t, x, version)
        else:
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
                                                  for v in ("resident", "cluster", "long")}
    masked_cubic_kernel.reset_launch_counts()
    assert masked_cubic_kernel.LAUNCHES == 0
    assert set(masked_cubic_kernel.ROUTE_LAUNCHES.values()) == {0}


def test_fit_plan_rejects_short_rows():
    with pytest.raises(ValueError):
        masked_cubic_kernel.fit_plan(1)
