"""K5's gappy tridiagonal solve: its resident route mirrored in numpy, against the JAX package.

K5's resident route (``csrc/masked_tridiagonal.cu``, ``resident_gappy_kernel``)
runs only on the card.  Its arithmetic is mirrored here in the kernel's
order: chunks of ``POSITIONS`` positions in ``solve_plan``'s threads per
row, the eliminated diagonal by a scan of rescaled Moebius maps, the
right-hand side and the substitution by affine scans (the substitution
multiplying by 1 / nd where the reference divides), each joined across
the row's threads as ``row_scan`` joins them (shuffle levels within a
warp, then the warps' totals in order; the helpers of
``test_torch_tridiagonal.py``).  The mirror is held against JAX's
``_masked_thomas_observed`` in float64 on the same inputs, within 1e-10 of
the largest magnitude when it computes in float64 and 1e-5 in float32: the
scans reassociate the recurrences, nothing else.  The systems are the
masked fit's own (irregular times) and ``chip_smoke.py``'s random ones, with
an all-missing row, a single observation and leading and trailing missing
runs.  One float32 case runs the JAX kernel in interpret mode (the JAX
tests' tolerance, 2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tridiagonal import _affine, _moebius, _row_scan

from torchcde_tpu.interpolation import cubic as jcubic
from torchcde_tpu.ops.masked_tridiagonal_pallas import masked_thomas_pallas
from torchcde_tpu_torch.interpolation import cubic
from torchcde_tpu_torch.ops import masked_tridiagonal_kernel

torch.set_num_threads(1)

POSITIONS = masked_tridiagonal_kernel.POSITIONS
ROWS = 5


def _resident_solve(diag, rhs, hr, hr_prev, observed):
    """resident_gappy_kernel on every row of the (n, k) operands, in their
    dtype."""
    n, k = diag.shape
    dtype = diag.dtype
    plan = masked_tridiagonal_kernel.solve_plan(k)
    tpr = plan.threads_per_row
    pad = tpr * POSITIONS - k

    def chunks(a, fill):
        return np.pad(a, ((0, 0), (0, pad)), constant_values=fill).reshape(n, tpr, POSITIONS)

    d, r, h, hp = (chunks(a, 0) for a in (diag, rhs, hr, hr_prev))
    o = chunks(observed, False)
    one, zero = np.ones((n, tpr), dtype), np.zeros((n, tpr), dtype)
    moebius_id, affine_id = np.array([1, 0, 0, 1], dtype), np.array([1, 0], dtype)
    with np.errstate(all="ignore"):  # the kernel computes at observed positions only
        # The eliminated diagonal's carry-in, applied to nd = 1.
        mob = np.stack([one, zero, zero, one], -1)
        for s in range(POSITIONS):
            step = np.stack([d[..., s], -hp[..., s] * hp[..., s], one, zero], -1)
            mob = np.where(o[..., s, None], _moebius(mob, step), mob)
        mob = _row_scan(mob, _moebius, moebius_id, rev=False)
        prev_d = (mob[..., 0] + mob[..., 1]) / (mob[..., 2] + mob[..., 3])
        # The diagonal in the chunk and the right-hand side's maps.
        nd, nb = np.ones((n, tpr, POSITIONS), dtype), np.zeros((n, tpr, POSITIONS), dtype)
        aff = np.stack([one, zero], -1)
        for s in range(POSITIONS):
            os_ = o[..., s]
            w = hp[..., s] / prev_d
            prev_d = np.where(os_, d[..., s] - w * hp[..., s], prev_d)
            aff = np.where(os_[..., None], _affine(aff, np.stack([-w, r[..., s]], -1)), aff)
            nd[..., s] = np.where(os_, prev_d, 1)
            nb[..., s] = np.where(os_, w, 0)
        prev_b = _row_scan(aff, _affine, affine_id, rev=False)[..., 1]
        for s in range(POSITIONS):
            prev_b = np.where(o[..., s], r[..., s] - nb[..., s] * prev_b, prev_b)
            nb[..., s] = np.where(o[..., s], prev_b, 0)
        # The substitution, in reverse, multiplying by 1 / nd.
        aff = np.stack([one, zero], -1)
        inv = 1 / nd
        for s in reversed(range(POSITIONS)):
            step = np.stack([-h[..., s] * inv[..., s], nb[..., s] * inv[..., s]], -1)
            aff = np.where(o[..., s, None], _affine(aff, step), aff)
        x_next = _row_scan(aff, _affine, affine_id, rev=True)[..., 1]
        x = np.zeros((n, tpr, POSITIONS), dtype)
        for s in reversed(range(POSITIONS)):
            xi = (nb[..., s] - h[..., s] * x_next) * inv[..., s]
            x_next = np.where(o[..., s], xi, x_next)
            x[..., s] = np.where(o[..., s], xi, 0)
    return x.reshape(n, -1)[:, :k]


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


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("density", [0.0, 0.2, 0.8, 1.0])
@pytest.mark.parametrize("k", [2, 3, 17, 512, 513, 4096])
def test_resident_route_mirror_matches_jax(k, density, system, dtype, tol):
    *arrays, observed = SYSTEMS[system](k, density, seed=k + int(10 * density))
    expected = np.asarray(jcubic._masked_thomas_observed(
        *(jnp.asarray(a, dtype=jnp.float64) for a in arrays), jnp.asarray(observed)))
    got = _resident_solve(*(a.astype(dtype) for a in arrays), observed)
    assert got.dtype == dtype and got.shape == expected.shape
    assert not got[~observed].any()  # zero where missing
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol * float(np.abs(expected).max()))


def test_resident_route_mirror_matches_the_jax_kernel_in_interpret_mode():
    *arrays, observed = _random_system(37, 0.3, seed=23)
    arrays = [a.astype(np.float32) for a in arrays]
    expected = np.asarray(masked_thomas_pallas(*map(jnp.asarray, arrays), jnp.asarray(observed),
                                               interpret=True))
    got = _resident_solve(*arrays, observed)
    np.testing.assert_allclose(got, expected, rtol=2e-4,
                               atol=2e-4 * max(1.0, float(np.abs(expected).max())))


def test_solve_plan_routes():
    # Up to RESIDENT_MAX the resident route, in K6/K7's threads per row;
    # longer rows take masked_thomas_kernel, one thread a row (K4's plan
    # type: no cluster, a block's segment the whole row).
    for k, tpr in ((1, 1), (2, 1), (16, 1), (17, 2), (512, 32), (513, 64), (4096, 256)):
        plan = masked_tridiagonal_kernel.solve_plan(k)
        assert plan == ("resident", tpr, 256 // tpr, 256, POSITIONS, 1, k), (k, plan)
    assert masked_tridiagonal_kernel.solve_plan(4097) == ("thomas", 1, 32, 32, 4097, 1, 4097)
    with pytest.raises(ValueError):
        masked_tridiagonal_kernel.solve_plan(0)


@pytest.mark.parametrize("k", [17, 4097])
def test_kernel_wrapper_routes_with_stand_ins(k, monkeypatch):
    # The launches run only on the card: a stand-in for the route's kernel
    # (the mirror above for the resident route, the plain version for
    # masked_thomas_kernel) drives the wrapper's own code: the flattening,
    # the route and the count.
    routes = []

    def kernel(plan, operands, x):
        assert x.shape == (ROWS, k)
        assert all(a.shape == (ROWS, k) and a.is_contiguous() for a in operands)
        routes.append(plan.variant)
        if plan.variant == "resident":
            x.copy_(torch.from_numpy(_resident_solve(*(a.numpy() for a in operands))))
        else:
            x.copy_(cubic._masked_thomas_observed(*operands))

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
    assert routes == ["resident" if k == 17 else "thomas"]
    assert masked_tridiagonal_kernel.LAUNCHES == 1
    masked_tridiagonal_kernel.reset_launch_counts()
