from .base import InterpolationBase
from .cubic import CubicSpline
from .hermite import hermite_cubic_coefficients_with_backward_differences
from .linear import linear_interpolation_coeffs

__all__ = [
    "CubicSpline",
    "InterpolationBase",
    "hermite_cubic_coefficients_with_backward_differences",
    "linear_interpolation_coeffs",
]
