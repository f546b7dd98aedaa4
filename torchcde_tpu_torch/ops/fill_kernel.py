"""K3: the masked fill as a CUDA kernel (``csrc/masked_fill.cu``).

Replaces ``torchcde_tpu/ops/fill_pallas.py::_fill_kernel`` (entry
``masked_fill_pallas``).  Its plain version is ``ops.fill.masked_fill_scan``;
``ops.fill`` decides which of the two runs (``ops/dispatch.py``'s rule).

* ``masked_fill_kernel(values, observed, reverse)``: 1 to 5 arrays
  (..., k) sharing the mask (..., k), filled along the last axis;
* ``LAUNCHES``: the count of kernel launches.
"""

import ctypes

import torch

from .. import _build
from . import dispatch
from .fill import masked_fill_scan  # the plain version

MAX_VALUES = 5
LAUNCHES = 0


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mf_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mf_fill.argtypes = [p] * 11 + [ll, i, i, i, p]
        lib.mf_fill.restype = i
        lib.mf_error_string.argtypes = [i]
        lib.mf_error_string.restype = ctypes.c_char_p
        lib._mf_declared = True
    return lib


def launch(values, observed, reverse):
    """One launch on (n, k) float32 arrays and an (n, k) bool mask, all
    contiguous on one CUDA device.  Returns the filled arrays."""
    global LAUNCHES
    if not 1 <= len(values) <= MAX_VALUES:
        raise ValueError(f"the fill kernel takes 1 to {MAX_VALUES} arrays, got {len(values)}")
    dispatch.check_operands(values, [f"values[{i}]" for i in range(len(values))], mask=observed)
    if observed.ndim != 2:
        raise ValueError("observed must be two-dimensional")
    if any(v.shape != observed.shape for v in values):
        raise ValueError("every value array must have the mask's shape")
    n, k = observed.shape
    outs = [torch.empty_like(v) for v in values]
    pad = [None] * (MAX_VALUES - len(values))
    ins = [v.data_ptr() for v in values] + pad
    outp = [o.data_ptr() for o in outs] + pad
    lib = _library()
    with torch.cuda.device(observed.device):
        rc = lib.mf_fill(*ins, *outp, observed.data_ptr(), n, k, len(values), int(reverse),
                         dispatch.stream_of(observed))
    if rc != 0:
        raise RuntimeError(f"masked fill kernel failed: {lib.mf_error_string(rc).decode()} "
                           f"(code {rc})")
    LAUNCHES += 1
    return outs


def masked_fill_kernel(values, observed, reverse=False):
    """Fill of ``values`` (a tuple of arrays with the mask's shape (..., k))
    along the last axis: the kernel for CUDA float32/bfloat16 operands
    (bfloat16 upcast at the boundary), the plain version otherwise."""
    if not dispatch.runs_kernel(observed, *values):
        return masked_fill_scan(tuple(values), observed, axis=-1, reverse=reverse)
    values, restore = dispatch.upcast_kernel_operands(*values)
    shape = observed.shape
    k = shape[-1]
    flat = [v.reshape(-1, k).contiguous() for v in values]
    obs = observed.reshape(-1, k).contiguous()
    if obs.shape[0] == 0 or k == 0:
        return tuple(restore(v.clone()) for v in values)
    outs = launch(flat, obs, reverse)
    return tuple(restore(o.reshape(shape)) for o in outs)
