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
from torchcde_tpu_torch.ops import masked_cubic_kernel, masked_tridiagonal_kernel

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
