"""torchcde_tpu_torch: the PyTorch and CUDA port of torchcde_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA H100.
It carries the spiral Neural CDE training step: Hermite coefficients, the
natural cubic spline fit of data with missing values (NaN-masked),
``CubicSpline``, ``cdeint`` (fixed-step and adaptive dopri5, direct
backpropagation or the backsolve adjoint) with the canonical MLP vector
field, whose whole solve runs as a hand-written CUDA kernel pair on the
card, BCE loss and Adam.  The spline fit, its fills and tridiagonal solves run
as CUDA kernels on the card too.  It also carries the log-ODE Neural RDE
path: the windowed logsignature transform (``logsig_windows``), linear and
rectilinear interpolation with NaN infill (``linear_interpolation_coeffs``,
``LinearInterpolation``), and the adaptive kernel pair's linear-control
mode.  Its ``cdeint`` has every method of the JAX package, ``jump_t``,
per-sample stepping, tuple states over a ``TupleControl`` and
``method="scipy_solver"``.  On the host side, ``native`` is the multithreaded
C++ preprocessing runtime (built with g++ at first use), ``data`` its
prefetching ``CoefficientDataLoader``, and ``utils`` has tracing, profiling
and checkpoints.  ``parallel`` runs it on several ranks over
``torch.distributed``: data parallelism (each rank's fused kernels on its
shard), tensor parallelism of the vector field's width (``DTensor``), and the
natural cubic fit and the tridiagonal solve with the length sharded.  The
package imports torch and numpy, never jax.
"""

from .interpolation import (
    CubicSpline,
    InterpolationBase,
    LinearInterpolation,
    NaturalCubicSpline,
    hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs,
    natural_cubic_coeffs,
    natural_cubic_spline_coeffs,
)
from .log_ode import logsig_windows, logsignature_windows
from .solvers import SolverConfig, cdeint
from .utils.tuple_control import TupleControl

__version__ = "0.3.0"

__all__ = [
    "CubicSpline",
    "InterpolationBase",
    "LinearInterpolation",
    "NaturalCubicSpline",
    "SolverConfig",
    "TupleControl",
    "cdeint",
    "hermite_cubic_coefficients_with_backward_differences",
    "linear_interpolation_coeffs",
    "logsig_windows",
    "logsignature_windows",
    "natural_cubic_coeffs",
    "natural_cubic_spline_coeffs",
    "__version__",
]
