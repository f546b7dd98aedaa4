"""K5's gappy tridiagonal solve: its routes mirrored in numpy, against the JAX package.

K5's routes (``csrc/masked_tridiagonal.cu``, ``gappy_kernel``) run only on
the card.  Their arithmetic is mirrored here in the kernel's order: chunks
of ``POSITIONS`` positions in ``solve_plan``'s threads per row, the
eliminated diagonal by a scan of rescaled Moebius maps, the right-hand side
and the substitution by affine scans (the substitution multiplying by 1 / nd
where the reference divides), each joined across the row's threads as
``row_scan`` joins them (shuffle levels within a warp, then the warps'
totals in order; the helpers of ``test_torch_tridiagonal.py``).  Past 4096
positions a row is split into segments, one block each: over a cluster the
blocks' totals are composed in rank order; past 32 768 (segmented) each
block's carry-ins come from the totals that the earlier launches published.
The mirror is held against JAX's ``_masked_thomas_observed`` in float64 on
the same inputs, within 1e-10 of the largest magnitude when it computes in
float64 and 1e-5 in float32: the scans reassociate the recurrences, nothing
else.  The systems are the masked fit's own (irregular times) and
``chip_smoke.py``'s random ones, with an all-missing row, a single
observation and leading and trailing missing runs.  One float32 case runs
the JAX kernel in interpret mode (the JAX tests' tolerance, 2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tridiagonal import (
    _affine,
    _affine_carries,
    _block_totals,
    _carried,
    _gather,
    _layout,
    _moebius,
    _moebius_scan,
    _param_affine,
    _row_scan,
    _scan,
    _split,
)

from torchcde_tpu.interpolation import cubic as jcubic
from torchcde_tpu.ops.masked_tridiagonal_pallas import masked_thomas_pallas
from torchcde_tpu_torch.interpolation import cubic
from torchcde_tpu_torch.ops import masked_tridiagonal_kernel, row_split, tridiagonal_kernel

torch.set_num_threads(1)

POSITIONS = row_split.POSITIONS
ROWS = 5


def _gappy_solve(diag, rhs, hr, hr_prev, observed, plan=None):
    """gappy_kernel on every row of the (n, k) operands, in their dtype,
    with the rows held as ``plan`` (by default ``solve_plan(k)``) holds
    them: resident, over a cluster or segmented."""
    n, k = diag.shape
    dtype = diag.dtype
    plan = plan or masked_tridiagonal_kernel.solve_plan(k)
    split, g = _split(plan), _layout(k, plan)
    d, r, h, hp = (_gather(a, g) for a in (diag, rhs, hr, hr_prev))
    o = _gather(observed, g).astype(bool)  # (n, blocks, threads, POSITIONS)
    one, zero = np.ones(o.shape[:-1], dtype), np.zeros(o.shape[:-1], dtype)
    affine_id, param_id = np.array([1, 0], dtype), np.array([1, 0, 0], dtype)
    with np.errstate(all="ignore"):  # the kernel computes at observed positions only
        # The eliminated diagonal's carry-in, applied to nd = 1.
        mob = np.stack([one, zero, zero, one], -1)
        for s in range(POSITIONS):
            step = np.stack([d[..., s], -hp[..., s] * hp[..., s], one, zero], -1)
            mob = np.where(o[..., s, None], _moebius(mob, step), mob)
        mob = _moebius_scan(mob, split)
        prev_d = (mob[..., 0] + mob[..., 1]) / (mob[..., 2] + mob[..., 3])
        # The diagonal in the chunk and the right-hand side's maps.
        nd, nb = np.ones(o.shape, dtype), np.zeros(o.shape, dtype)
        aff = np.stack([one, zero], -1)
        for s in range(POSITIONS):
            os_ = o[..., s]
            w = hp[..., s] / prev_d
            prev_d = np.where(os_, d[..., s] - w * hp[..., s], prev_d)
            aff = np.where(os_[..., None], _affine(aff, np.stack([-w, r[..., s]], -1)), aff)
            nd[..., s] = np.where(os_, prev_d, 1)
            nb[..., s] = np.where(os_, w, 0)
        if split == "segmented":
            # The segment's totals: the elimination's, then the
            # substitution's with nb = nb0 + sens p, p its carry-in,
            # composed in ascending order.
            excl = _row_scan(aff, _affine, affine_id, rev=False)
            nb0, sens = excl[..., 1], excl[..., 0]
            sub = np.stack([one, zero, zero], -1)
            for s in range(POSITIONS):
                os_, inv = o[..., s], 1 / nd[..., s]
                nb0 = np.where(os_, r[..., s] - nb[..., s] * nb0, nb0)
                sens = np.where(os_, -nb[..., s] * sens, sens)
                step = np.stack([-h[..., s] * inv, nb0 * inv, sens * inv], -1)
                sub = np.where(os_[..., None], _param_affine(step, sub), sub)
            nb_in, x_in = _affine_carries(_block_totals(aff, _affine, affine_id, False),
                                          _block_totals(sub, _param_affine, param_id, True))
            prev_b = _carried(excl, _affine, nb_in, False)[..., 1]
        else:
            prev_b = _scan(aff, _affine, affine_id, False, split == "cluster")[..., 1]
        for s in range(POSITIONS):
            prev_b = np.where(o[..., s], r[..., s] - nb[..., s] * prev_b, prev_b)
            nb[..., s] = np.where(o[..., s], prev_b, 0)
        # The substitution, in reverse, multiplying by 1 / nd.
        aff = np.stack([one, zero], -1)
        inv = 1 / nd
        for s in reversed(range(POSITIONS)):
            step = np.stack([-h[..., s] * inv[..., s], nb[..., s] * inv[..., s]], -1)
            aff = np.where(o[..., s, None], _affine(aff, step), aff)
        if split == "segmented":
            x_next = _carried(_row_scan(aff, _affine, affine_id, rev=True), _affine, x_in,
                              False)[..., 1]
        else:
            x_next = _scan(aff, _affine, affine_id, True, split == "cluster")[..., 1]
        x = np.zeros(o.shape, dtype)
        for s in reversed(range(POSITIONS)):
            xi = (nb[..., s] - h[..., s] * x_next) * inv[..., s]
            x_next = np.where(o[..., s], xi, x_next)
            x[..., s] = np.where(o[..., s], xi, 0)
    out = np.zeros((n, k), dtype)
    out[:, g[g >= 0]] = x[:, g >= 0]
    return out


def _nan_rows(k, density, seed):
    """Values (ROWS, k) with NaNs at the given density; row 0 with a
    leading missing run, row 1 a trailing one, row 2 a single observation,
    row 3 none."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, k))
    x[rng.random(x.shape) < density] = np.nan
    run = max(1, k // 5)
    x[0, :run] = np.nan
    x[1, -run:] = np.nan
    x[2] = np.nan
    x[2, k // 2] = 1.5
    x[3] = np.nan
    return x


def _fit_system(k, density, seed):
    """The gappy system the masked fit solves (the plain pipeline's own
    operands, in float64) for values at irregular times."""
    x = torch.from_numpy(_nan_rows(k, density, seed))
    t = torch.from_numpy(np.cumsum(np.random.default_rng(seed + 1).uniform(0.2, 1.5, k)))
    captured = []

    def capture(diag, rhs, hr, hr_prev, observed):
        captured.append((diag, rhs, hr, hr_prev, observed))
        return cubic._masked_thomas_observed(diag, rhs, hr, hr_prev, observed)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(cubic._MaskedSolve, "apply", capture)
        cubic._masked_coeffs_plain(t, cubic._impute_endpoints(x, 1))
    (system,) = captured
    return tuple(a.numpy() for a in system)


def _random_system(k, density, seed):
    """chip_smoke.py's check_k5 systems: every coupling in [0.2, 1.2), the
    first observation's hr_prev too."""
    observed = ~np.isnan(_nan_rows(k, density, seed))
    rng = np.random.default_rng(seed)
    hr = np.where(observed, rng.random(observed.shape) + 0.2, 0.0)
    hr_prev = rng.random(observed.shape) + 0.2
    diag = 2 * (hr + hr_prev) + 0.5
    rhs = rng.standard_normal(observed.shape)
    return diag, rhs, hr, hr_prev, observed


SYSTEMS = {"fit": _fit_system, "random": _random_system}


def _check_mirror(k, density, system, dtype, tol, variant):
    """The mirror of the route solve_plan(k) takes (``variant``) against
    JAX's float64 solve of the same system, within tol of the largest
    magnitude, and zero where missing."""
    assert masked_tridiagonal_kernel.solve_plan(k).variant == variant
    *arrays, observed = SYSTEMS[system](k, density, seed=k + int(10 * density))
    expected = np.asarray(jcubic._masked_thomas_observed(
        *(jnp.asarray(a, dtype=jnp.float64) for a in arrays), jnp.asarray(observed)))
    got = _gappy_solve(*(a.astype(dtype) for a in arrays), observed)
    assert got.dtype == dtype and got.shape == expected.shape
    assert not got[~observed].any()  # zero where missing
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol * float(np.abs(expected).max()))


DTYPES = pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                                 ids=["float64", "float32"])
DENSITIES = [0.0, 0.2, 0.8, 1.0]
# Past 4096 positions: every density on chip_smoke.py's random systems, the
# masked fit's own at 20 % NaN (its plain pipeline walks every position).
LONG_CASES = [(density, "random") for density in DENSITIES] + [(0.2, "fit")]


@DTYPES
@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("k", [2, 3, 17, 512, 513, 4096])
def test_resident_route_mirror_matches_jax(k, density, system, dtype, tol):
    _check_mirror(k, density, system, dtype, tol, "resident")


@DTYPES
@pytest.mark.parametrize("density, system", LONG_CASES)
@pytest.mark.parametrize("k", [4097, 8193, 16384, 32768])
def test_cluster_route_mirror_matches_jax(k, density, system, dtype, tol):
    # Each of the cluster's blocks holds a segment as a resident block
    # holds a row (its mask packed per segment, threads past its end
    # holding identity maps); the blocks' totals composed in rank order.
    _check_mirror(k, density, system, dtype, tol, "cluster")


@DTYPES
@pytest.mark.parametrize("density, system", LONG_CASES)
@pytest.mark.parametrize("k", [32769, 65536, 65537])
def test_segmented_route_mirror_matches_jax(k, density, system, dtype, tol):
    # Past the clusters' reach the same segments in three launches: each
    # block's carry-ins from the Moebius totals, then from the elimination's
    # and the substitution's (affine in the elimination's carry-in).
    _check_mirror(k, density, system, dtype, tol, "segmented")


def test_resident_route_mirror_matches_the_jax_kernel_in_interpret_mode():
    *arrays, observed = _random_system(37, 0.3, seed=23)
    arrays = [a.astype(np.float32) for a in arrays]
    expected = np.asarray(masked_thomas_pallas(*map(jnp.asarray, arrays), jnp.asarray(observed),
                                               interpret=True))
    got = _gappy_solve(*arrays, observed)
    np.testing.assert_allclose(got, expected, rtol=2e-4,
                               atol=2e-4 * max(1.0, float(np.abs(expected).max())))


def test_solve_plan_routes():
    # Up to RESIDENT_MAX the resident route, in K6/K7's threads per row; up
    # to the clusters' reach a cluster of ceil(k / 4096) blocks, the row
    # split evenly in whole chunks; beyond, the same split segmented (K4's
    # per-row plans).
    for k, tpr in ((1, 1), (2, 1), (16, 1), (17, 2), (512, 32), (513, 64), (4096, 256)):
        plan = masked_tridiagonal_kernel.solve_plan(k)
        assert plan == ("resident", tpr, 256 // tpr, 256, POSITIONS, 1, k), (k, plan)
    for k, variant, blocks, segment in ((4097, "cluster", 2, 2064), (16384, "cluster", 4, 4096),
                                        (32768, "cluster", 8, 4096),
                                        (32769, "segmented", 9, 3648),
                                        (65536, "segmented", 16, 4096),
                                        (65537, "segmented", 17, 3856)):
        plan = masked_tridiagonal_kernel.solve_plan(k)
        assert plan == (variant, 256, 1, 256, POSITIONS, blocks, segment), (k, plan)
        assert plan[1:] == tridiagonal_kernel.solve_plan(k, shared=False)[1:]
    with pytest.raises(ValueError):
        masked_tridiagonal_kernel.solve_plan(0)


@pytest.mark.parametrize("k", [17, 4097, 32769])
def test_kernel_wrapper_routes_with_stand_ins(k, monkeypatch):
    # The launches run only on the card: a stand-in for the route's kernel
    # (the mirror above) drives the wrapper's own code: the flattening, the
    # route and the counts.
    routes = []

    def kernel(plan, operands, x):
        assert x.shape == (ROWS, k)
        assert all(a.shape == (ROWS, k) and a.is_contiguous() for a in operands)
        routes.append(plan.variant)
        x.copy_(torch.from_numpy(_gappy_solve(*(a.numpy() for a in operands), plan=plan)))

    monkeypatch.setattr(masked_tridiagonal_kernel.dispatch, "check_operands", lambda *a, **kw: None)
    monkeypatch.setattr(masked_tridiagonal_kernel.dispatch, "runs_kernel", lambda *ts: True)
    monkeypatch.setattr(masked_tridiagonal_kernel, "_kernel", kernel)
    masked_tridiagonal_kernel.reset_launch_counts()
    *arrays, observed = _random_system(k, 0.2, seed=3)
    system = [torch.from_numpy(a).reshape(1, ROWS, k) for a in (*arrays, observed)]
    got = masked_tridiagonal_kernel.masked_thomas_kernel(*system)
    assert got.shape == (1, ROWS, k)
    torch.testing.assert_close(got, cubic._masked_thomas_observed(*system), rtol=1e-10,
                               atol=1e-10)
    route = masked_tridiagonal_kernel.solve_plan(k).variant
    assert routes == [route] and route == {17: "resident", 4097: "cluster"}.get(k, "segmented")
    assert masked_tridiagonal_kernel.LAUNCHES == 1
    assert masked_tridiagonal_kernel.ROUTE_LAUNCHES == {
        r: int(r == route) for r in masked_tridiagonal_kernel.ROUTES}
    masked_tridiagonal_kernel.reset_launch_counts()
    assert set(masked_tridiagonal_kernel.ROUTE_LAUNCHES.values()) == {0}
