"""torchcde_tpu_torch: the PyTorch and CUDA port of torchcde_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA H100.
It carries the spiral Neural CDE training step: Hermite coefficients,
``CubicSpline``, ``cdeint`` (fixed-step and adaptive dopri5, direct
backpropagation or the backsolve adjoint) with the canonical MLP vector
field, whose whole solve runs as a hand-written CUDA kernel pair on the
card, BCE loss and Adam.  The package imports torch and numpy, never jax.
"""

from .interpolation import (
    CubicSpline,
    InterpolationBase,
    hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs,
)
from .solvers import SolverConfig, cdeint

__all__ = [
    "CubicSpline",
    "InterpolationBase",
    "SolverConfig",
    "cdeint",
    "hermite_cubic_coefficients_with_backward_differences",
    "linear_interpolation_coeffs",
]
