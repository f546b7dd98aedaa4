"""The port's linear and rectilinear interpolation against the JAX package.

On the CPU in float64: the NaN infill (its fills are K3's plain version
here), the rectilinear preparation, ``LinearInterpolation``'s values and its
left-continuous slopes, gradients through the slopes to the coefficients,
and the error and warning texts.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.ops import forward_fill as jax_forward_fill

torch.set_num_threads(1)

# Both sides compute the same float64 formulas; only rounding order differs.
RTOL, ATOL = 1e-12, 1e-12


def _nan_data(seed, shape=(3, 4, 40, 3)):
    """Random values with NaNs, a leading and a trailing NaN run and an
    all-NaN channel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    x[rng.random(shape) < 0.3] = np.nan
    rows = x.reshape((-1,) + shape[-2:])  # a view: the series of the batch
    rows[0, :5, 0] = np.nan
    rows[1, -6:, 1] = np.nan
    rows[-1, :, 2] = np.nan
    return x


@pytest.mark.parametrize("irregular", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_nan_infill_matches_jax(seed, irregular):
    x = _nan_data(seed)
    t = np.cumsum(np.random.default_rng(seed + 5).uniform(0.2, 1.5, x.shape[-2])) if irregular else None
    expected = np.asarray(tc.linear_interpolation_coeffs(jnp.asarray(x), t=t))
    got = tt.linear_interpolation_coeffs(torch.from_numpy(x), t=t)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)
    assert (got[-1, -1, :, 2] == 0).all()  # an all-NaN channel is the zero path


def test_nan_free_data_is_returned_as_is():
    clean = torch.randn(2, 5, 3, dtype=torch.float64)
    assert tt.linear_interpolation_coeffs(clean) is clean


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_linear_data_is_reproduced(seed):
    # The reference's test_random: linear data with NaN drops is recovered
    # exactly at every knot, with the true slope, on both sides.
    rng = np.random.default_rng(seed)
    num_points = int(rng.integers(5, 60))
    start, end = sorted(rng.random(2) * 10 - 5)
    t = np.linspace(start, end, num_points)
    m = rng.random(3) * 10 - 5
    c = rng.random(3) * 10 - 5
    values = m * t[:, None] + c
    dropped = values.copy()
    for ch in range(3):
        to_drop = rng.permutation(num_points - 2)[: max(0, min(num_points // 4, num_points - 4))] + 1
        dropped[to_drop, ch] = np.nan
    coeffs_j = tc.linear_interpolation_coeffs(jnp.asarray(dropped), t=jnp.asarray(t))
    coeffs = tt.linear_interpolation_coeffs(torch.from_numpy(dropped), t=torch.from_numpy(t))
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(coeffs_j), rtol=RTOL, atol=ATOL)
    X = tt.LinearInterpolation(coeffs, t=torch.from_numpy(t))
    np.testing.assert_allclose(X.evaluate(torch.from_numpy(t)).numpy(), values, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(X.derivative(torch.from_numpy(t)).numpy(),
                               np.broadcast_to(m, values.shape), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("use_t", [False, True])
def test_small(use_t):
    rng = np.random.default_rng(3)
    t = np.sort(rng.random(2) * 10 - 5) if use_t else None
    x = rng.random((2, 1))
    Xj = tc.LinearInterpolation(tc.linear_interpolation_coeffs(jnp.asarray(x), t=t), t)
    Xt = tt.LinearInterpolation(tt.linear_interpolation_coeffs(torch.from_numpy(x), t=t), t)
    times = np.linspace(-1, 2, 20)
    for which in ("evaluate", "derivative"):
        np.testing.assert_allclose(getattr(Xt, which)(torch.from_numpy(times)).numpy(),
                                   np.asarray(getattr(Xj, which)(jnp.asarray(times))),
                                   rtol=RTOL, atol=ATOL)


def _interpolation(irregular, batch=(2, 3)):
    rng = np.random.default_rng(4)
    length = 8
    x = rng.standard_normal(batch + (length, 2))
    t = np.cumsum(rng.uniform(0.3, 1.2, length)) if irregular else None
    grid = t if irregular else np.linspace(0.0, length - 1, length)
    # Random interior times, every knot exactly, and times outside the interval.
    times = np.concatenate([rng.uniform(grid[0], grid[-1], 11), grid,
                            [grid[0] - 0.7, grid[-1] + 0.9]])
    return x, t, grid, times


@pytest.mark.parametrize("irregular", [False, True])
@pytest.mark.parametrize("which", ["evaluate", "derivative"])
def test_values_and_slopes_match_jax(irregular, which):
    x, t, _grid, times = _interpolation(irregular)
    Xj = tc.LinearInterpolation(jnp.asarray(x), t)
    Xt = tt.LinearInterpolation(torch.from_numpy(x), t)
    np.testing.assert_array_equal(Xt.grid_points, Xj.grid_points)
    np.testing.assert_array_equal(Xt.interval, Xj.interval)
    np.testing.assert_allclose(Xt._derivs.numpy(), np.asarray(Xj._derivs), rtol=RTOL, atol=ATOL)
    expected = np.asarray(getattr(Xj, which)(jnp.asarray(times)))
    got = getattr(Xt, which)(torch.from_numpy(times))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)
    # A host scalar time is located on the host; it keeps the batch shape.
    for i, tau in enumerate(times):
        np.testing.assert_allclose(getattr(Xt, which)(float(tau)).numpy(), expected[..., i, :],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("irregular", [False, True])
def test_slope_is_left_continuous_at_knots_and_clamped_outside(irregular):
    x, t, grid, _times = _interpolation(irregular)
    X = tt.LinearInterpolation(torch.from_numpy(x), t)
    derivs = X._derivs
    for k in range(1, len(grid) - 1):  # an interior knot reads the slope on its left
        torch.testing.assert_close(X.derivative(torch.tensor(grid[k])), derivs[..., k - 1, :],
                                   rtol=0, atol=0)
        torch.testing.assert_close(X.derivative(float(grid[k])), derivs[..., k - 1, :], rtol=0,
                                   atol=0)
    for tau in (grid[0] - 3.0, grid[0]):
        torch.testing.assert_close(X.derivative(float(tau)), derivs[..., 0, :], rtol=0, atol=0)
    torch.testing.assert_close(X.derivative(float(grid[-1] + 3.0)), derivs[..., -1, :], rtol=0,
                               atol=0)
    # Outside the interval the path extends its first and last pieces.
    first = X.evaluate(float(grid[0] - 0.5))
    torch.testing.assert_close(first, X._coeffs[..., 0, :] - 0.5 * derivs[..., 0, :])


@pytest.mark.parametrize("irregular", [False, True])
def test_gradients_reach_the_coefficients(irregular):
    x, t, _grid, times = _interpolation(irregular)
    rng = np.random.default_rng(6)
    weight_e = rng.standard_normal(x.shape[:-2] + (times.size, 2))
    weight_d = rng.standard_normal(x.shape[:-2] + (times.size, 2))

    def jax_loss(c, tau):
        X = tc.LinearInterpolation(c, t)
        return jnp.sum(X.evaluate(tau) * weight_e) + jnp.sum(X.derivative(tau) * weight_d)

    g_c, g_t = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(times))
    c = torch.from_numpy(x).requires_grad_()
    tau = torch.from_numpy(times).requires_grad_()
    X = tt.LinearInterpolation(c, t)
    loss = (X.evaluate(tau) * torch.from_numpy(weight_e)).sum() + (
        X.derivative(tau) * torch.from_numpy(weight_d)).sum()
    loss.backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_c), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tau.grad.numpy(), np.asarray(g_t), rtol=1e-10, atol=1e-10)


def test_infill_gradients_match_jax():
    x = _nan_data(2, shape=(2, 30, 3))
    rng = np.random.default_rng(7)
    weight = rng.standard_normal(x.shape)
    t = np.cumsum(rng.uniform(0.2, 1.5, 30))
    obs = ~np.isnan(x)

    def jax_loss(v):
        full = jnp.where(obs, v, jnp.nan)
        return jnp.sum(tc.linear_interpolation_coeffs(full, t=t) * weight)

    v = np.where(obs, x, 0.0)
    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(v)))
    vt = torch.from_numpy(v).requires_grad_()
    full = torch.where(torch.from_numpy(obs), vt, torch.tensor(float("nan"), dtype=vt.dtype))
    (tt.linear_interpolation_coeffs(full, t=t) * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), expected, rtol=1e-8, atol=1e-10)


def test_rectilinear_preparation():
    nan = np.nan
    x1 = np.array([[0.1, 0.4], [0.2, nan], [0.9, 1.1]])
    x2 = np.array([[0.2, nan], [0.3, 2.0], [nan, nan]])
    x = np.stack([x1, x2])
    x[..., 0] = np.asarray(jax_forward_fill(jnp.asarray(x[..., 0]), fill_index=-1))
    x1_true = np.array([[0.1, 0.2, 0.2, 0.9, 0.9], [0.4, 0.4, 0.4, 0.4, 1.1]]).T
    x2_true = np.array([[0.2, 0.3, 0.3, 0.3, 0.3], [2.0, 2.0, 2.0, 2.0, 2.0]]).T
    rect_true = np.stack([x1_true, x2_true])
    for data, index, truth in ((x, 0, rect_true), (x[:, :, [1, 0]], 1, rect_true[:, :, [1, 0]]),
                               (x[0], 0, rect_true[0]),
                               (np.stack([x, x]), 0, np.stack([rect_true, rect_true]))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = tt.linear_interpolation_coeffs(torch.from_numpy(data), rectilinear=index)
            expected = tc.linear_interpolation_coeffs(jnp.asarray(data), rectilinear=index)
        np.testing.assert_array_equal(got.numpy(), truth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("seed", [0, 1])
def test_rectilinear_random(seed):
    rng = np.random.default_rng(seed)
    ts = [np.linspace(s, s + 10, int(rng.integers(2, 50))) for s in rng.standard_normal(5) ** 2]
    max_len = max(len(t) for t in ts)
    rows = []
    for t_ in ts:
        row = np.concatenate([t_[:, None], rng.standard_normal((len(t_), 9))], axis=1)
        rows.append(np.concatenate([row, np.full((max_len - len(t_), 10), np.nan)], axis=0))
    x = np.stack(rows)
    x[:, :, 1:][rng.random(x[:, :, 1:].shape) < 0.2] = np.nan
    x[..., 0] = np.asarray(jax_forward_fill(jnp.asarray(x[..., 0]), fill_index=-1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = np.asarray(tc.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0))
        got = tt.linear_interpolation_coeffs(torch.from_numpy(x), rectilinear=0)
    assert got.shape == (5, 2 * max_len - 1, 10)
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)


def _error_text(fn, data, **kwargs):
    with pytest.raises(ValueError) as err:
        fn(data, **kwargs)
    return str(err.value)


@pytest.mark.parametrize("index", [1.0, 3, -1])
def test_rectilinear_error_texts_match_jax(index):
    x = np.random.default_rng(0).standard_normal((2, 4, 3))
    assert (_error_text(tt.linear_interpolation_coeffs, torch.from_numpy(x), rectilinear=index)
            == _error_text(tc.linear_interpolation_coeffs, jnp.asarray(x), rectilinear=index))


def test_nan_times_and_the_non_causal_warning_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 4, 3))
    x[0, 1, 0] = np.nan
    assert (_error_text(tt.linear_interpolation_coeffs, torch.from_numpy(x), rectilinear=0)
            == _error_text(tc.linear_interpolation_coeffs, jnp.asarray(x), rectilinear=0))
    x = np.random.default_rng(1).standard_normal((2, 4, 3))
    x[1, 0, 2] = np.nan
    texts = []
    for fn, data in ((tt.linear_interpolation_coeffs, torch.from_numpy(x)),
                     (tc.linear_interpolation_coeffs, jnp.asarray(x))):
        with pytest.warns(UserWarning) as record:
            fn(data, rectilinear=0)
        texts.append([str(w.message) for w in record])
    assert texts[0] == texts[1] and len(texts[0]) == 1
