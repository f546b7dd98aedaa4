"""Linear and rectilinear interpolation (port of
``torchcde_tpu/interpolation/linear.py``).

The NaN infill is one masked pass over every batch and channel at once:
previous and next observed (value, time) fills (``ops.fill.masked_fill``:
K3 on the card), then one linear blend.  ``LinearInterpolation`` is the
piecewise-linear control; its derivative reads the slope of the interval on
the left of a knot (``searchsorted(side="left") - 1``), as the reference's
``bucketize`` does.
"""

import warnings

import numpy as np
import torch

from ..ops.fill import forward_fill, masked_fill
from ..utils.misc import numpy_dtype, stack_endpoints, validate_input_path
from .base import InterpolationBase
from .cubic import _knot, _take, _time_dtype


def _fill_missing_linear(t, x):
    """NaN infill (interpolation_linear.py:13-71), vectorized.

    Endpoint NaNs take the first/last observation in the channel; interior
    NaN runs are interpolated linearly in ``t`` between the neighbouring
    observations; all-NaN channels become zeros.  x: (..., length,
    channels); t: (length,) of x's dtype on x's device.  The length axis is
    moved last for the fills."""
    xT = x.transpose(-1, -2)  # (..., channels, length)
    last = xT.ndim - 1
    observed = ~torch.isnan(xT)
    # Before the first observation the backward fill's boundary value (and
    # its time) stand in, so the blend degenerates to that constant.
    t_b = t.expand(xT.shape)
    safe_x = torch.where(observed, xT, torch.zeros_like(xT))
    xp, tp = masked_fill((safe_x, t_b), observed, axis=-1)
    xn, tn = masked_fill((safe_x, t_b), observed, axis=-1, reverse=True)

    obs_i = observed.to(torch.int32)
    has_prev = torch.cummax(obs_i, dim=last).values > 0
    has_next = torch.flip(torch.cummax(torch.flip(obs_i, [last]), dim=last).values, [last]) > 0
    any_obs = has_prev[..., -1:]

    xp = torch.where(has_prev, xp, xn[..., :1])
    tp = torch.where(has_prev, tp, tn[..., :1])
    xn = torch.where(has_next, xn, xp[..., -1:])
    tn = torch.where(has_next, tn, tp[..., -1:])

    denom = torch.where(tn > tp, tn - tp, torch.ones_like(tn))
    ratio = (t - tp) / denom
    filled = torch.clamp(ratio, 0.0, 1.0) * (xn - xp) + xp

    out = torch.where(observed, xT, filled)
    out = torch.where(any_obs, out, torch.zeros_like(out))
    return out.transpose(-1, -2)


def _prepare_rectilinear_interpolation(data, time_index):
    """Fill-and-lag so that plain linear interpolation realises the
    rectilinear ("first move in time, then in value") scheme.

    Reference: interpolation_linear.py:87-128.  Returns (..., 2L - 1, C)."""
    n_channels = data.shape[-1]
    if not isinstance(time_index, int):
        raise ValueError(
            "Index of the time channel must be an integer in [0, {}]".format(n_channels - 1)
        )
    if not 0 <= time_index < n_channels:
        raise ValueError(
            "Time index must be in [0, {}], was given {}.".format(n_channels - 1, time_index)
        )

    times = data[..., time_index]
    if bool(torch.isnan(times).any()):
        raise ValueError(
            "There exist nan values in the time column which is not allowed. If the times are "
            "padded with nans after final time, a simple solution is to forward fill the final time."
        )

    data_filled = forward_fill(data)
    data_repeat = torch.repeat_interleave(data_filled, 2, dim=-2)
    times_rep = data_repeat[..., time_index]
    shifted_times = torch.cat([times_rep[..., 1:], times_rep[..., -1:]], dim=-1)
    chan = torch.arange(n_channels, device=data.device)
    data_repeat = torch.where(chan == time_index, shifted_times[..., None], data_repeat)
    return data_repeat[..., :-1, :]


def _grid_tensor(t, like):
    """A time grid (host NumPy or tensor) as a tensor of like's dtype and device."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.to(dtype=like.dtype, device=like.device)


def linear_interpolation_coeffs(x, t=None, rectilinear=None):
    """Knots of the linear interpolation of a batch of controls
    (interpolation_linear.py:131-171).

    The returned "coefficients" are the NaN-infilled data itself, to be
    handed to ``LinearInterpolation``.  x: (..., length, channels), NaNs
    mark missing observations; t: optional 1-D strictly increasing times
    (default 0..length-1); rectilinear: optional int index of the time
    channel within ``x``, for the causal rectilinear scheme.  On the card
    the fills run as K3."""
    if rectilinear is not None:
        # One host sync each here and below: this is offline preprocessing.
        if bool(torch.isnan(x[..., 0, :]).any()):
            warnings.warn(
                "The data `x` begins with missing values in some channels. The path will be "
                "constructed by backward-filling the first observed value, which is not causal. "
                "Raising a warning as the `rectilinear` argument has also been passed, which is "
                "nearly always only used when causality is desired. If you need causality then "
                "fill in the missing value at the start of each channel with whatever you'd like "
                "it to be. (The mean over that channel is a common choice.)"
            )
        x = _prepare_rectilinear_interpolation(x, rectilinear)

    t = validate_input_path(x, t)

    if not bool(torch.isnan(x).any()):
        return x  # fast path: nothing to infill
    return _fill_missing_linear(_grid_tensor(t, x), x)


class LinearInterpolation(InterpolationBase):
    """The piecewise-linear control path (interpolation_linear.py:174-225).

    Holds the knot times ``_t`` (length,), the knot values ``_coeffs``
    (..., length, channels) and the slopes ``_derivs`` (..., length - 1,
    channels), computed from the coefficients by tensor ops so that
    gradients reach them.  The default grid is the host NumPy constant
    0..length-1."""

    def __init__(self, coeffs, t=None):
        if t is None:
            t = np.linspace(0, coeffs.shape[-2] - 1, coeffs.shape[-2],
                            dtype=numpy_dtype(coeffs.dtype))
        elif not isinstance(t, np.ndarray):
            t = torch.as_tensor(t)
        self._t = t
        self._coeffs = coeffs
        spans = _grid_tensor(t[1:] - t[:-1], coeffs)
        self._derivs = (coeffs[..., 1:, :] - coeffs[..., :-1, :]) / spans[..., None]

    @property
    def grid_points(self):
        return self._t

    @property
    def interval(self):
        return stack_endpoints(self._t)

    def _interpret_t(self, t):
        """(fractional part, interval index) of t: the interval on the left
        of a knot (searchsorted side='left' minus one, interpolation_linear.py
        :203-210), clamped to the grid because t may leave the interval.

        A host scalar time on a host grid is located on the host, as in
        ``CubicSpline``."""
        maxlen = self._derivs.shape[-2] - 1
        if isinstance(self._t, np.ndarray) and not isinstance(t, torch.Tensor) and np.ndim(t) == 0:
            tv = self._t.dtype.type(t)
            index = int(np.clip(np.searchsorted(self._t, tv, side="left") - 1, 0, maxlen))
            return float(tv - self._t[index]), index
        work = _time_dtype(self._derivs.dtype)
        t = torch.as_tensor(t, dtype=work, device=self._derivs.device)
        grid = _grid_tensor(self._t, self._derivs).to(work)
        index = torch.clamp(torch.searchsorted(grid, t.detach(), side="left") - 1, 0, maxlen)
        return (t - _knot(grid, index)).to(self._derivs.dtype), index

    @staticmethod
    def _pick(x, index):
        return x[..., index, :] if isinstance(index, int) else _take(x, index)

    def evaluate(self, t):
        fractional_part, index = self._interpret_t(t)
        prev_coeff = self._pick(self._coeffs, index)
        next_coeff = self._pick(self._coeffs, index + 1)
        if isinstance(index, int):
            diff_t = float(self._t[index + 1] - self._t[index])
            return prev_coeff + fractional_part * (next_coeff - prev_coeff) / diff_t
        grid = _grid_tensor(self._t, self._derivs)
        diff_t = _knot(grid, index + 1) - _knot(grid, index)
        return (prev_coeff + fractional_part[..., None] * (next_coeff - prev_coeff)
                / diff_t[..., None])

    def derivative(self, t):
        _, index = self._interpret_t(t)
        return self._pick(self._derivs, index)
