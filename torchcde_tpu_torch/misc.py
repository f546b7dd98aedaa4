"""Compatibility module mirroring the reference's ``torchcde.misc`` surface.

Port of ``torchcde_tpu/misc.py``: users migrating from the reference find
``forward_fill``, the tridiagonal solves, ``cheap_stack`` and
``validate_input_path`` and ``TupleControl`` under the same names.
"""

from .ops.fill import forward_fill
from .ops.tridiagonal import (
    tridiagonal_solve,
    tridiagonal_solve_pcr,
    tridiagonal_solve_thomas,
)
from .utils.misc import cheap_stack, validate_input_path
from .utils.tuple_control import TupleControl

__all__ = [
    "cheap_stack",
    "forward_fill",
    "tridiagonal_solve",
    "tridiagonal_solve_pcr",
    "tridiagonal_solve_thomas",
    "validate_input_path",
    "TupleControl",
]
