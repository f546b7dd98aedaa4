"""Fills, tridiagonal solves and their CUDA kernels (K3, K4, K5, K6/K7); logsignatures.

The names of ``torchcde_tpu/ops/__init__.py``; ``tridiagonal_solve_kernel``
(K4) stands for its ``tridiagonal_solve_pallas``, and is imported on first
use: its module reaches ``interpolation.cubic``, which imports this package."""

from .fill import backward_fill, forward_fill, next_observed_index, prev_observed_index
from .logsignature import (
    logsignature_channels,
    lyndon_words,
    path_logsignature,
    path_signature,
    windowed_logsignatures,
)
from .tridiagonal import tridiagonal_solve, tridiagonal_solve_pcr, tridiagonal_solve_thomas

__all__ = [
    "backward_fill",
    "forward_fill",
    "logsignature_channels",
    "lyndon_words",
    "next_observed_index",
    "path_logsignature",
    "path_signature",
    "prev_observed_index",
    "tridiagonal_solve",
    "tridiagonal_solve_kernel",
    "tridiagonal_solve_pcr",
    "tridiagonal_solve_thomas",
    "windowed_logsignatures",
]


def __getattr__(name):
    if name == "tridiagonal_solve_kernel":
        from .tridiagonal_kernel import tridiagonal_solve_kernel

        return tridiagonal_solve_kernel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
