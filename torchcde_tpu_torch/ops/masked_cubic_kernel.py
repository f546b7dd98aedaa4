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
* ``fit_plan(k)``: the variant that fits rows of length k (each row
  resident in the registers of a power of two of threads, up to
  ``RESIDENT_MAX`` positions; over a thread block cluster of up to
  ``CLUSTER_MAX`` blocks, each holding one segment of the row as a resident
  block holds a row, up to ``CLUSTER_REACH``; a thread per row through
  scratch beyond; the split is ``row_split``'s);
* ``LAUNCHES``: the count of kernel launches; ``ROUTE_LAUNCHES`` the same by
  variant.
"""

import ctypes
from typing import NamedTuple

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
    row_split,
    threads_per_row,
)

LAUNCHES = 0
ROUTE_LAUNCHES = {"resident": 0, "cluster": 0, "long": 0}

LONG_THREADS = 32      # the long-row variant: one thread per row, one warp per block


class FitPlan(NamedTuple):
    variant: str          # "resident", "cluster" or "long"
    threads_per_row: int  # (a cluster's block: the threads holding its segment)
    rows_per_block: int
    threads: int          # per block
    positions: int        # per thread (the long-row variant: the row)
    cluster: int          # blocks a row spans (1 off the cluster variant)
    segment: int          # positions of a row a block holds


def fit_plan(k):
    """The launch for rows of length k: the resident variant, its threads
    per row the least power of two that holds k at ``POSITIONS`` a thread,
    ``BLOCK_THREADS / threads_per_row`` rows a block; past
    ``RESIDENT_MAX``, the cluster variant (``row_split``); past
    ``CLUSTER_REACH``, the long-row variant."""
    if k < 2:
        raise ValueError(f"the fit needs rows of at least 2 positions, got {k}")
    if k > CLUSTER_REACH:
        return FitPlan("long", 1, LONG_THREADS, LONG_THREADS, k, 1, k)
    if k > RESIDENT_MAX:
        blocks, segment = row_split(k)
        return FitPlan("cluster", BLOCK_THREADS, 1, BLOCK_THREADS, POSITIONS, blocks, segment)
    tpr = threads_per_row(k)
    return FitPlan("resident", tpr, BLOCK_THREADS // tpr, BLOCK_THREADS, POSITIONS, 1, k)


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for variant in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[variant] = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mc_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mc_fit.argtypes = [p] * 13 + [ll, i, i, p]
        lib.mc_fit.restype = i
        lib.mc_fit_resident.argtypes = [p] * 6 + [ll, i, i, i, i, i, p]
        lib.mc_fit_resident.restype = i
        shape = (ctypes.c_int * 4)()
        lib.mc_resident_shape(shape)
        if tuple(shape) != (POSITIONS, BLOCK_THREADS, RESIDENT_MAX, CLUSTER_MAX):
            raise RuntimeError(f"masked cubic fit library's resident shape {tuple(shape)} is "
                               "not the wrapper's")
        lib.mc_scratch_positions.argtypes = [i]
        lib.mc_scratch_positions.restype = i
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
    """The variant of ``plan`` on x (n, k) at times t into the four outputs
    (n, k - 1)."""
    lib = _library()
    n, k = x.shape
    ptrs = [a.data_ptr() for a in (x, t, *outs)]
    stream = dispatch.stream_of(x)
    if plan.variant in ("resident", "cluster"):
        with torch.cuda.device(x.device):
            rc = lib.mc_fit_resident(*ptrs, n, k, plan.threads_per_row, plan.cluster,
                                     plan.segment, version, stream)
    else:
        # Per-row intermediates, laid out in tiles by the kernel.
        size = n * lib.mc_scratch_positions(k)
        scratch = [torch.empty(size, dtype=x.dtype, device=x.device) for _ in range(6)]
        obs = torch.empty(size, dtype=torch.uint8, device=x.device)
        ptrs += [a.data_ptr() for a in (*scratch[:1], obs, *scratch[1:])]
        with torch.cuda.device(x.device):
            rc = lib.mc_fit(*ptrs, n, k, version, stream)
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
