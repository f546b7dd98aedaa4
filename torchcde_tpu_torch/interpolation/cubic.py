"""Cubic spline control path (port of ``torchcde_tpu/interpolation/cubic.py::CubicSpline``).

Natural cubic coefficients (``natural_cubic_coeffs``) are ROADMAP queue 1
item 7; ``CubicSpline`` evaluates any packed cubic coefficients, such as the
Hermite ones of this package.
"""

import numpy as np
import torch

from ..utils.misc import numpy_dtype, stack_endpoints
from .base import InterpolationBase


def _take(x, index):
    """``jnp.take(x, index, axis=-2)``: index (any shape) along the knot axis."""
    picked = torch.index_select(x, -2, index.reshape(-1))
    return picked.reshape(x.shape[:-2] + index.shape + x.shape[-1:])


class CubicSpline(InterpolationBase):
    """Evaluates packed cubic coefficients (..., n_intervals, 4 * channels).

    The default grid is the host NumPy constant t = [0, 1, ..., n_intervals]:
    coefficients have one row per interval, so this is
    linspace(0, n, n + 1).
    """

    def __init__(self, coeffs, t=None):
        if t is None:
            t = np.linspace(
                0, coeffs.shape[-2], coeffs.shape[-2] + 1, dtype=numpy_dtype(coeffs.dtype)
            )
        elif not isinstance(t, np.ndarray):
            t = torch.as_tensor(t)

        channels = coeffs.shape[-1] // 4
        if channels * 4 != coeffs.shape[-1]:
            raise ValueError("Passed invalid coeffs.")
        self._t = t
        self._a = coeffs[..., :channels]
        self._b = coeffs[..., channels : 2 * channels]
        self._two_c = coeffs[..., 2 * channels : 3 * channels]
        self._three_d = coeffs[..., 3 * channels :]

    @property
    def grid_points(self):
        return self._t

    @property
    def interval(self):
        return stack_endpoints(self._t)

    def _interpret_t(self, t):
        """(fractional part, interval index) of t, broadcast against channels.

        A host scalar time on the host grid is located on the host: the
        fixed-step solvers and the model's initial value evaluate at such
        times, and a host-to-device copy there would stall the host on the
        device's queue."""
        maxlen = self._b.shape[-2] - 1
        if isinstance(self._t, np.ndarray) and not isinstance(t, torch.Tensor) and np.ndim(t) == 0:
            tv = self._t.dtype.type(t)
            index = int(np.clip(np.searchsorted(self._t, tv, side="left") - 1, 0, maxlen))
            return float(tv - self._t[index]), index
        t = torch.as_tensor(t, dtype=self._b.dtype, device=self._b.device)
        grid = torch.as_tensor(self._t, dtype=self._b.dtype, device=self._b.device)
        index = torch.searchsorted(grid, t.detach(), side="left") - 1
        index = torch.clamp(index, 0, maxlen)
        fractional_part = t - grid[index]
        return fractional_part[..., None], index

    @staticmethod
    def _pick(x, index):
        return x[..., index, :] if isinstance(index, int) else _take(x, index)

    def evaluate(self, t):
        fractional_part, index = self._interpret_t(t)
        inner = 0.5 * self._pick(self._two_c, index) + self._pick(self._three_d, index) * fractional_part / 3
        inner = self._pick(self._b, index) + inner * fractional_part
        return self._pick(self._a, index) + inner * fractional_part

    def derivative(self, t):
        fractional_part, index = self._interpret_t(t)
        inner = self._pick(self._two_c, index) + self._pick(self._three_d, index) * fractional_part
        return self._pick(self._b, index) + inner * fractional_part
