"""Hermite cubic splines with backward differences.

Port of ``torchcde_tpu/interpolation/hermite.py``.  On each knot interval the
spline is the cubic Hermite interpolant of the two endpoint values, with the
slope at knot i the backward difference (x_i - x_{i-1}) / (t_i - t_{i-1}); the
first knot borrows the first interval's secant.  In monomial form in
tau = t - t_i, with h = t_{i+1} - t_i and secant S:

    p(tau) = x_i + m_i tau + (3S - 2m_i - m_{i+1})/h tau^2
                 + (m_i + m_{i+1} - 2S)/h^2 tau^3,

stored in the (a, b, 2c, 3d) layout ``CubicSpline`` evaluates.
"""

import torch

from ..utils.misc import validate_input_path
from .linear import linear_interpolation_coeffs


def hermite_cubic_coefficients_with_backward_differences(x, t=None):
    """Coefficients of shape (..., length - 1, 4 * channels), to be passed to
    ``CubicSpline``."""
    filled = linear_interpolation_coeffs(x, t=t)
    t = validate_input_path(filled, t)
    t = torch.as_tensor(t, dtype=filled.dtype, device=filled.device)

    h = (t[1:] - t[:-1])[..., None]
    secant = (filled[..., 1:, :] - filled[..., :-1, :]) / h
    slope_start = torch.cat([secant[..., :1, :], secant[..., :-1, :]], dim=-2)
    slope_end = secant

    a = filled[..., :-1, :]
    b = slope_start
    two_c = 2 * (3 * secant - 2 * slope_start - slope_end) / h
    three_d = 3 * (slope_start + slope_end - 2 * secant) / h**2
    return torch.cat([a, b, two_c, three_d], dim=-1)
