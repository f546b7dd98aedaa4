"""K5: the gappy Thomas solve as a CUDA kernel (``csrc/masked_tridiagonal.cu``).

Replaces ``torchcde_tpu/ops/masked_tridiagonal_pallas.py::_fwd_kernel`` and
``_bwd_kernel`` (entry ``masked_thomas_pallas``).  Its plain version is
``interpolation.cubic._masked_thomas_observed``.

* ``masked_thomas_kernel(diag, rhs, hr, hr_prev, observed)``: arrays
  (..., k) and a bool mask; the kernel for CUDA float32/bfloat16 operands,
  the plain version otherwise;
* ``LAUNCHES``: the count of kernel launches.
"""

import ctypes

import torch

from .. import _build
from ..interpolation.cubic import _masked_thomas_observed  # the plain version
from . import dispatch

LAUNCHES = 0


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mt_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mt_solve.argtypes = [p] * 7 + [ll, i, p]
        lib.mt_solve.restype = i
        lib.mt_error_string.argtypes = [i]
        lib.mt_error_string.restype = ctypes.c_char_p
        lib._mt_declared = True
    return lib


def launch(diag, rhs, hr, hr_prev, observed):
    """One launch on (n, k) float32 arrays and an (n, k) bool mask, all
    contiguous on one CUDA device.  Returns x (n, k), zero where missing."""
    global LAUNCHES
    ops = (diag, rhs, hr, hr_prev, observed)
    dispatch.check_operands(ops[:4], ("diag", "rhs", "hr", "hr_prev"), mask=observed)
    if observed.ndim != 2:
        raise ValueError("observed must be two-dimensional")
    if any(a.shape != observed.shape for a in ops):
        raise ValueError("every operand must have the mask's shape")
    n, k = observed.shape
    x = torch.empty_like(diag)
    nd = torch.empty((k, n), dtype=diag.dtype, device=diag.device)
    lib = _library()
    with torch.cuda.device(diag.device):
        rc = lib.mt_solve(*(a.data_ptr() for a in ops), x.data_ptr(), nd.data_ptr(), n, k,
                          dispatch.stream_of(diag))
    if rc != 0:
        raise RuntimeError(f"masked tridiagonal kernel failed: {lib.mt_error_string(rc).decode()} "
                           f"(code {rc})")
    LAUNCHES += 1
    return x


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
