"""K5: the gappy Thomas solve as CUDA kernels (``csrc/masked_tridiagonal.cu``).

Replaces ``torchcde_tpu/ops/masked_tridiagonal_pallas.py::_fwd_kernel`` and
``_bwd_kernel`` (entry ``masked_thomas_pallas``).  Its plain version is
``interpolation.cubic._masked_thomas_observed``.

* ``masked_thomas_kernel(diag, rhs, hr, hr_prev, observed)``: arrays
  (..., k) and a bool mask; the kernel for CUDA float32/bfloat16 operands,
  the plain version otherwise;
* ``solve_plan(k)``: the route that solves rows of length k, as K4's
  per-row bands take them: each row resident in the registers of a power
  of two of threads up to ``RESIDENT_MAX`` positions; over a thread block
  cluster, one segment a block, up to ``CLUSTER_REACH``; beyond, the same
  segments in launches of their own, the scans' totals crossing through
  device memory;
* ``LAUNCHES``: the count of solves launched; ``ROUTE_LAUNCHES`` the same
  by route.
"""

import ctypes

import torch

from .. import _build
from ..interpolation.cubic import _masked_thomas_observed  # the plain version
from . import dispatch
from .row_split import row_plan, segment_totals

LAUNCHES = 0
ROUTES = ("resident", "cluster", "segmented")
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def solve_plan(k):
    """The launch for rows of length k: ``row_plan(k)``, the resident route
    up to ``RESIDENT_MAX`` positions, the cluster route up to
    ``CLUSTER_REACH``, the segmented route beyond (K4's per-row plans)."""
    return row_plan(k)


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for route in ROUTES:
        ROUTE_LAUNCHES[route] = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mt_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mt_solve.argtypes = [p] * 7 + [ll, i, i, i, i, p]
        lib.mt_solve.restype = i
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
    plan = solve_plan(observed.shape[1])
    _kernel(plan, ops, x)
    LAUNCHES += 1
    ROUTE_LAUNCHES[plan.variant] += 1
    return x


def _kernel(plan, operands, x):
    """The route of ``plan`` on the operands (diag, rhs, hr, hr_prev,
    observed, each (n, k)) into x (n, k); the segmented route with its
    totals (``segment_totals``)."""
    lib = _library()
    n, k = x.shape
    ptrs = [t.data_ptr() for t in (*operands, x)]
    totals = None
    if plan.variant == "segmented":
        totals = torch.empty(segment_totals(plan.cluster, n, False), dtype=x.dtype,
                             device=x.device)
    stream = dispatch.stream_of(x)
    with torch.cuda.device(x.device):
        rc = lib.mt_solve(*ptrs, 0 if totals is None else totals.data_ptr(), n, k,
                          plan.threads_per_row, plan.cluster, plan.segment, stream)
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
