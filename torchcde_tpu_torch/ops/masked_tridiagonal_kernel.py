"""K5: the gappy Thomas solve as CUDA kernels (``csrc/masked_tridiagonal.cu``).

Replaces ``torchcde_tpu/ops/masked_tridiagonal_pallas.py::_fwd_kernel`` and
``_bwd_kernel`` (entry ``masked_thomas_pallas``).  Its plain version is
``interpolation.cubic._masked_thomas_observed``.

* ``masked_thomas_kernel(diag, rhs, hr, hr_prev, observed)``: arrays
  (..., k) and a bool mask; the kernel for CUDA float32/bfloat16 operands,
  the plain version otherwise;
* ``solve_plan(k)``: the route that solves rows of length k (each row
  resident in the registers of a power of two of threads up to
  ``RESIDENT_MAX`` positions, as K4's shared bands and K6/K7's rows; one
  thread per row beyond);
* ``LAUNCHES``: the count of solves launched.
"""

import ctypes

import torch

from .. import _build
from ..interpolation.cubic import _masked_thomas_observed  # the plain version
from . import dispatch
from .masked_cubic_kernel import BLOCK_THREADS, POSITIONS, RESIDENT_MAX, threads_per_row
from .tridiagonal_kernel import SolvePlan

LAUNCHES = 0
THOMAS_THREADS = 32  # masked_thomas_kernel: one thread per row, one warp per block


def solve_plan(k):
    """The launch for rows of length k: the resident route up to
    ``RESIDENT_MAX`` positions (K6/K7's threads per row), ``masked_thomas_kernel``
    beyond."""
    if k < 1:
        raise ValueError(f"the solve needs rows of at least 1 position, got {k}")
    if k > RESIDENT_MAX:
        return SolvePlan("thomas", 1, THOMAS_THREADS, THOMAS_THREADS, k, 1, k)
    tpr = threads_per_row(k)
    return SolvePlan("resident", tpr, BLOCK_THREADS // tpr, BLOCK_THREADS, POSITIONS, 1, k)


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mt_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mt_solve.argtypes = [p] * 7 + [ll, i, p]
        lib.mt_solve.restype = i
        lib.mt_solve_resident.argtypes = [p] * 6 + [ll, i, i, p]
        lib.mt_solve_resident.restype = i
        lib.mt_error_string.argtypes = [i]
        lib.mt_error_string.restype = ctypes.c_char_p
        lib._mt_declared = True
    return lib


def launch(diag, rhs, hr, hr_prev, observed):
    """One solve on (n, k) float32 arrays and an (n, k) bool mask, all
    contiguous on one CUDA device.  Returns x (n, k), zero where missing."""
    global LAUNCHES
    ops = (diag, rhs, hr, hr_prev, observed)
    dispatch.check_operands(ops[:4], ("diag", "rhs", "hr", "hr_prev"), mask=observed)
    if observed.ndim != 2:
        raise ValueError("observed must be two-dimensional")
    if any(a.shape != observed.shape for a in ops):
        raise ValueError("every operand must have the mask's shape")
    x = torch.empty_like(diag)
    _kernel(solve_plan(observed.shape[1]), ops, x)
    LAUNCHES += 1
    return x


def _kernel(plan, operands, x):
    """The route of ``plan`` on the operands (diag, rhs, hr, hr_prev,
    observed, each (n, k)) into x (n, k)."""
    lib = _library()
    n, k = x.shape
    ptrs = [t.data_ptr() for t in (*operands, x)]
    stream = dispatch.stream_of(x)
    with torch.cuda.device(x.device):
        if plan.variant == "resident":
            rc = lib.mt_solve_resident(*ptrs, n, k, plan.threads_per_row, stream)
        else:
            nd = torch.empty((k, n), dtype=x.dtype, device=x.device)  # the eliminated diagonal
            rc = lib.mt_solve(*ptrs, nd.data_ptr(), n, k, stream)
    if rc != 0:
        raise RuntimeError(f"masked tridiagonal kernel failed: {lib.mt_error_string(rc).decode()} "
                           f"(code {rc})")


def masked_thomas_kernel(diag, rhs, hr, hr_prev, observed):
    """The gappy solve of ``_masked_thomas_observed``: the kernel for CUDA
    float32/bfloat16 operands (bfloat16 upcast at the boundary), the plain
    version otherwise."""
    if not dispatch.runs_kernel(diag, rhs, hr, hr_prev):
        return _masked_thomas_observed(diag, rhs, hr, hr_prev, observed)
    (diag, rhs, hr, hr_prev), restore = dispatch.upcast_kernel_operands(diag, rhs, hr, hr_prev)
    shape = diag.shape
    k = shape[-1]
    flat = [a.reshape(-1, k).contiguous() for a in (diag, rhs, hr, hr_prev, observed)]
    if flat[0].shape[0] == 0:
        return restore(torch.zeros_like(diag))
    return restore(launch(*flat).reshape(shape))
