from .base import InterpolationBase
from .cubic import (
    CubicSpline,
    NaturalCubicSpline,
    natural_cubic_coeffs,
    natural_cubic_spline_coeffs,
)
from .hermite import hermite_cubic_coefficients_with_backward_differences
from .linear import LinearInterpolation, linear_interpolation_coeffs

__all__ = [
    "CubicSpline",
    "InterpolationBase",
    "LinearInterpolation",
    "NaturalCubicSpline",
    "hermite_cubic_coefficients_with_backward_differences",
    "linear_interpolation_coeffs",
    "natural_cubic_coeffs",
    "natural_cubic_spline_coeffs",
]
