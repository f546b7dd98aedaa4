"""K6/K7: the whole NaN-masked natural cubic fit as one CUDA kernel
(``csrc/masked_cubic.cu``).

Replaces the TPU's streaming fit (``torchcde_tpu/ops/masked_cubic_pallas.py``,
entries ``masked_natural_cubic_full`` and ``masked_natural_cubic_pallas``)
and its VMEM-resident single launch (``ops/masked_cubic_resident.py``, entry
``masked_natural_cubic_resident``); one kernel serves all three.  Its plain
version is ``interpolation.cubic._masked_fit_plain``: endpoint imputation,
then the masked pipeline.

* ``masked_natural_cubic(t, x, version)``: raw values x (..., k) with NaNs,
  times t (k,) -> (a, b, two_c, three_d), each (..., k - 1),
  differentiable; the kernel for CUDA float32/bfloat16 values (its
  gradient recomputes the plain pipeline: ``cubic._MaskedFitFused``), the
  plain version otherwise.  Rows without an observation are the caller's
  to mask;
* ``fit_plan(k)``: the route that fits rows of length k (``row_plan``:
  each row resident in the registers of a power of two of threads, up to
  ``RESIDENT_MAX`` positions; over a thread block cluster of up to
  ``CLUSTER_MAX`` blocks, each holding one segment of the row as a resident
  block holds a row, up to ``CLUSTER_REACH``; beyond, the same segments in
  four launches of their own, the scans' totals crossing through device
  memory);
* ``LAUNCHES``: the count of fits launched; ``ROUTE_LAUNCHES`` the same by
  route.
"""

import ctypes

import torch

from .. import _build
from ..interpolation.cubic import _MaskedFitFused, _masked_fit_plain  # the plain version
from . import dispatch
from .row_split import (
    BLOCK_THREADS,
    CLUSTER_MAX,
    CLUSTER_REACH,
    POSITIONS,
    RESIDENT_MAX,
    fit_totals,
    row_plan,
)

LAUNCHES = 0
ROUTES = ("resident", "cluster", "segmented")
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def fit_plan(k):
    """The launch for rows of length k: ``row_plan(k)``, the resident route
    up to ``RESIDENT_MAX`` positions, the cluster route up to
    ``CLUSTER_REACH``, the segmented route beyond."""
    if k < 2:
        raise ValueError(f"the fit needs rows of at least 2 positions, got {k}")
    return row_plan(k)


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for route in ROUTES:
        ROUTE_LAUNCHES[route] = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mc_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mc_fit_resident.argtypes = [p] * 7 + [ll, i, i, i, i, i, p]
        lib.mc_fit_resident.restype = i
        shape = (ctypes.c_int * 4)()
        lib.mc_resident_shape(shape)
        if tuple(shape) != (POSITIONS, BLOCK_THREADS, RESIDENT_MAX, CLUSTER_MAX):
            raise RuntimeError(f"masked cubic fit library's resident shape {tuple(shape)} is "
                               "not the wrapper's")
        lib.mc_error_string.argtypes = [i]
        lib.mc_error_string.restype = ctypes.c_char_p
        lib._mc_declared = True
    return lib


def launch(t, x, version):
    """One launch: x (n, k) and t (k,) float32, contiguous on one CUDA
    device.  Returns (a, b, two_c, three_d), each (n, k - 1)."""
    global LAUNCHES
    dispatch.check_operands((x, t), ("x", "t"))
    if x.ndim != 2 or t.shape != (x.shape[1],) or x.shape[1] < 2:
        raise ValueError("x must be (n, k) with k >= 2 and t (k,)")
    if version not in (0, 1):
        raise ValueError(f"version must be 0 or 1, got {version!r}")
    n, k = x.shape
    plan = fit_plan(k)
    outs = [torch.empty((n, k - 1), dtype=x.dtype, device=x.device) for _ in range(4)]
    _kernel(plan, t, x, outs, int(version))
    LAUNCHES += 1
    ROUTE_LAUNCHES[plan.variant] += 1
    return tuple(outs)


def _kernel(plan, t, x, outs, version):
    """The route of ``plan`` on x (n, k) at times t into the four outputs
    (n, k - 1); the segmented route with its totals (``fit_totals``)."""
    lib = _library()
    n, k = x.shape
    ptrs = [a.data_ptr() for a in (x, t, *outs)]
    totals = None
    if plan.variant == "segmented":
        totals = torch.empty(fit_totals(plan.cluster, n), dtype=torch.float32, device=x.device)
    stream = dispatch.stream_of(x)
    with torch.cuda.device(x.device):
        rc = lib.mc_fit_resident(*ptrs, 0 if totals is None else totals.data_ptr(), n, k,
                                 plan.threads_per_row, plan.cluster, plan.segment, version, stream)
    if rc != 0:
        raise RuntimeError(f"masked cubic fit kernel failed: {lib.mc_error_string(rc).decode()} "
                           f"(code {rc})")


def masked_natural_cubic(t, x, version):
    """The masked fit of raw values x (..., k) at times t (k,)."""
    if not dispatch.runs_kernel(x):
        return _masked_fit_plain(t.to(x.dtype), x, version)
    return _MaskedFitFused.apply(version, t, x)


def fit_on_card(t, x, version):
    """The kernel's forward for CUDA float32/bfloat16 values x (..., k)."""
    (x,), restore = dispatch.upcast_kernel_operands(x)
    shape = x.shape
    k = shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    out_shape = shape[:-1] + (k - 1,)
    if x2.shape[0] == 0:
        return tuple(restore(x.new_zeros(out_shape)) for _ in range(4))
    outs = launch(t.to(device=x.device, dtype=x.dtype).contiguous(), x2, version)
    return tuple(restore(o.reshape(out_shape)) for o in outs)
