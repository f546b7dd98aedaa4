"""The port's windowed logsignature transform against the JAX package.

On the CPU in float64: ``logsig_windows`` and the deprecated
``logsignature_windows`` (values, times, gradients), with and without
missing values, on the default grid and on custom times whose window
boundaries fall between observations, and the host window plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu import log_ode as jax_log_ode
from torchcde_tpu_torch import log_ode

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12


def _data(seed, shape, nan=0.0, custom_t=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    x[rng.random(shape) < nan] = np.nan
    t = None
    if custom_t:
        t = np.sort(rng.random(shape[-2])) * 13 + 0.01 * np.arange(shape[-2])
    return x, t


CASES = {
    # label: (shape, depth, window, NaN fraction, custom t)
    "aligned": ((4, 50, 3), 3, 10.0, 0.0, False),
    "ragged last window": ((2, 47, 3), 3, 10.0, 0.0, False),
    "inserted rows": ((3, 30, 2), 2, 3.0, 0.0, True),
    "NaNs, inserted rows": ((3, 30, 2), 2, 3.0, 0.2, True),
    "NaNs, aligned": ((2, 3, 41, 3), 3, 8.0, 0.3, False),
    "depth 1": ((2, 20, 4), 1, 4.5, 0.0, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_logsig_windows_matches_jax(case):
    shape, depth, window, nan, custom_t = CASES[case]
    x, t = _data(len(case), shape, nan, custom_t)
    expected = np.asarray(tc.logsig_windows(jnp.asarray(x), depth, window,
                                            None if t is None else jnp.asarray(t)))
    got = tt.logsig_windows(torch.from_numpy(x), depth, window,
                            None if t is None else torch.from_numpy(t))
    assert got.shape == expected.shape
    assert np.isfinite(expected).all()
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["aligned", "inserted rows", "NaNs, inserted rows"])
def test_logsignature_windows_matches_jax(case):
    shape, depth, window, nan, custom_t = CASES[case]
    x, t = _data(len(case), shape, nan, custom_t)
    values_j, times_j = tc.logsignature_windows(jnp.asarray(x), depth, window, t)
    values, times = tt.logsignature_windows(torch.from_numpy(x), depth, window, t)
    np.testing.assert_allclose(values.numpy(), np.asarray(values_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(times.numpy(), np.asarray(times_j), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["aligned", "NaNs, aligned", "NaNs, inserted rows"])
def test_logsig_windows_gradients_match_jax(case):
    shape, depth, window, nan, custom_t = CASES[case]
    x, t = _data(len(case), shape, nan, custom_t)
    obs = ~np.isnan(x)
    weight = np.random.default_rng(9).standard_normal(
        np.asarray(tc.logsig_windows(jnp.asarray(x), depth, window, t)).shape)
    # The JAX transform reads its values on the host, so its device part is
    # differentiated: on the merged grid, NaN at the inserted rows.
    t_np = np.linspace(0, shape[-2] - 1, shape[-2]) if t is None else t
    merged, boundaries, _ = jax_log_ode._merge_window_grid(t_np, window)
    keep = np.isin(merged, t_np)
    obs_full = np.zeros(x.shape[:-2] + (merged.shape[0], x.shape[-1]), dtype=bool)
    obs_full[..., keep, :] = obs
    v_full = np.zeros(obs_full.shape)
    v_full[..., keep, :] = np.where(obs, x, 0.0)

    def jax_loss(v_):
        full = jnp.where(obs_full, v_, jnp.nan)
        return jnp.sum(jax_log_ode._device_logsig_windows(
            full, jnp.asarray(merged), None, depth, tuple(boundaries), bool(nan)) * weight)

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(v_full)))[..., keep, :]
    vt = torch.from_numpy(np.where(obs, x, 0.0)).requires_grad_()
    xt = torch.where(torch.from_numpy(obs), vt, torch.tensor(float("nan"), dtype=vt.dtype))
    (tt.logsig_windows(xt, depth, window, t) * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), expected, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("t_last, window", [(49.0, 10.0), (47.0, 10.0), (12.9, 3.0),
                                            (9.0, 9.0), (10.0, 0.7)])
def test_merge_window_grid_matches_jax(t_last, window):
    rng = np.random.default_rng(int(t_last))
    t = np.sort(np.concatenate([[0.0, t_last], rng.uniform(0.0, t_last, 20)]))
    for got, expected in zip(log_ode._merge_window_grid(t, window),
                             jax_log_ode._merge_window_grid(t, window)):
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("depth, window", [(0, 1.0), (2.0, 1.0), (2, 0.0), (2, -1.0)])
def test_argument_errors_match_jax(depth, window):
    x = np.random.default_rng(0).standard_normal((2, 10, 2))
    with pytest.raises(ValueError) as jax_err:
        tc.logsig_windows(jnp.asarray(x), depth, window)
    with pytest.raises(ValueError) as torch_err:
        tt.logsig_windows(torch.from_numpy(x), depth, window)
    assert str(torch_err.value) == str(jax_err.value)
