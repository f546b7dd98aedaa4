"""The PyTorch port's controls against the JAX package, on the CPU in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu_torch.utils.misc import cheap_stack, stack_endpoints, validate_input_path
from torchcde_tpu.utils.misc import validate_input_path as jax_validate_input_path

torch.set_num_threads(1)

# Both sides compute the same float64 formulas; only rounding order differs.
RTOL, ATOL = 1e-12, 1e-12


def _bad_path(case):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3))
    t = np.linspace(0.0, 1.0, 5)
    return {
        "int_x": (np.arange(10).reshape(5, 2), None),
        "one_dim_x": (rng.standard_normal(5), None),
        "int_t": (x, np.arange(5)),
        "two_dim_t": (x, np.stack([t, t])),
        "length_mismatch": (x, np.linspace(0.0, 1.0, 4)),
        "too_short": (x[:, :1], np.array([0.0])),
        "not_increasing": (x, np.array([0.0, 0.5, 0.4, 0.8, 1.0])),
    }[case]


@pytest.mark.parametrize("case", ["int_x", "one_dim_x", "int_t", "two_dim_t",
                                  "length_mismatch", "too_short", "not_increasing"])
def test_validate_input_path_error_text(case):
    x, t = _bad_path(case)
    with pytest.raises(ValueError) as jax_err:
        jax_validate_input_path(jnp.asarray(x), t)
    with pytest.raises(ValueError) as torch_err:
        validate_input_path(torch.from_numpy(x), t)
    assert str(torch_err.value) == str(jax_err.value)


def test_small_utilities():
    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    assert cheap_stack([a], 1).shape == (2, 1, 3)
    assert torch.equal(cheap_stack([a, b], 0), torch.stack([a, b]))
    grid = np.linspace(0.0, 3.0, 4)
    assert isinstance(stack_endpoints(grid), np.ndarray)
    np.testing.assert_array_equal(stack_endpoints(grid), [0.0, 3.0])
    assert torch.equal(stack_endpoints(torch.from_numpy(grid)), torch.tensor([0.0, 3.0], dtype=torch.float64))


@pytest.mark.parametrize("irregular", [False, True])
def test_hermite_coefficients(irregular):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 3))
    t = np.cumsum(rng.uniform(0.2, 1.5, 9)) if irregular else None
    expected = tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x), t=t)
    got = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x), t=t)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


def test_not_ported_preprocessing_raises():
    # The NaN infill and the rectilinear scheme of linear_interpolation_coeffs
    # used to raise here; they are ported now, and so is the Hermite fit of
    # data with missing values, which fills through them.  Each matches JAX.
    x = np.random.default_rng(5).standard_normal((2, 5, 3))
    x[0, 2, 1] = x[1, 0, 2] = np.nan
    for fn in ("linear_interpolation_coeffs",
               "hermite_cubic_coefficients_with_backward_differences"):
        got = getattr(tt, fn)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(tc, fn)(jnp.asarray(x))),
                                   rtol=RTOL, atol=ATOL)
    with pytest.warns(UserWarning, match="not causal"):
        rect = tt.linear_interpolation_coeffs(torch.from_numpy(x), rectilinear=0)
    assert rect.shape == (2, 9, 3) and not torch.isnan(rect).any()
    clean = torch.randn(2, 5, 3, dtype=torch.float64)
    assert tt.linear_interpolation_coeffs(clean) is clean


def test_cubic_spline_invalid_coeffs():
    with pytest.raises(ValueError, match="Passed invalid coeffs."):
        tt.CubicSpline(torch.zeros(3, 7))


def _spline_inputs(irregular):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 2))
    t = np.cumsum(rng.uniform(0.3, 1.2, 8)) if irregular else None
    coeffs = np.array(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x), t=t))
    grid = t if irregular else np.linspace(0.0, 7.0, 8)
    # Random interior times, every knot exactly, and times outside the interval.
    times = np.concatenate([
        rng.uniform(grid[0], grid[-1], 11), grid,
        [grid[0] - 0.7, grid[-1] + 0.9],
    ])
    return coeffs, t, times


@pytest.mark.parametrize("irregular", [False, True])
@pytest.mark.parametrize("which", ["evaluate", "derivative"])
def test_cubic_spline_values(irregular, which):
    coeffs, t, times = _spline_inputs(irregular)
    Xj = tc.CubicSpline(jnp.asarray(coeffs), t)
    Xt = tt.CubicSpline(torch.from_numpy(coeffs), t)
    np.testing.assert_array_equal(Xt.grid_points, Xj.grid_points)
    np.testing.assert_array_equal(Xt.interval, Xj.interval)
    expected = getattr(Xj, which)(jnp.asarray(times))
    got = getattr(Xt, which)(torch.from_numpy(times))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)
    # A host scalar time is located on the host; it keeps the batch shape.
    for i, tau in enumerate(times):
        scalar = getattr(Xt, which)(float(tau))
        np.testing.assert_allclose(scalar.numpy(), np.asarray(expected)[..., i, :], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("irregular", [False, True])
def test_cubic_spline_gradients(irregular):
    coeffs, t, times = _spline_inputs(irregular)
    rng = np.random.default_rng(3)
    weight_e = rng.standard_normal((3, times.size, 2))
    weight_d = rng.standard_normal((3, times.size, 2))

    def jax_loss(c, tau):
        X = tc.CubicSpline(c, t)
        return jnp.sum(X.evaluate(tau) * weight_e) + jnp.sum(X.derivative(tau) * weight_d)

    g_c, g_t = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(coeffs), jnp.asarray(times))

    c = torch.from_numpy(coeffs).requires_grad_()
    tau = torch.from_numpy(times).requires_grad_()
    X = tt.CubicSpline(c, t)
    loss = (X.evaluate(tau) * torch.from_numpy(weight_e)).sum() + (
        X.derivative(tau) * torch.from_numpy(weight_d)).sum()
    loss.backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_c), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tau.grad.numpy(), np.asarray(g_t), rtol=1e-10, atol=1e-10)
