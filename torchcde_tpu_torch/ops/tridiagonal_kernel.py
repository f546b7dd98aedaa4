"""K4: the batched tridiagonal solve as CUDA kernels (``csrc/tridiagonal.cu``).

Replaces ``torchcde_tpu/ops/tridiagonal_pallas.py::_pcr_thomas_kernel``
(entry ``tridiagonal_solve_pallas``) and its custom VJP ``_tp_bwd``: for
x = A^{-1} b,

    grad_b = A^{-T} g          (the kernel again, bands swapped)
    grad_diag_i  = -grad_b_i x_i
    grad_upper_i = -grad_b_i x_{i+1}
    grad_lower_i = -grad_b_{i+1} x_i

Its plain version is ``ops.tridiagonal.tridiagonal_solve_thomas``.

* ``tridiagonal_solve_kernel(b, A_upper, A_diagonal, A_lower)``: the
  reference's signature and broadcasting; the kernel for CUDA
  float32/bfloat16 operands, the plain version otherwise;
* ``solve_plan(k, shared)``: the route that solves rows of length k: up to
  ``RESIDENT_MAX`` positions each row resident in the registers of a power
  of two of threads (one band for every row: after one pass that
  eliminates the shared diagonal; bands per row: each row scanning its own
  pivots); up to ``CLUSTER_REACH`` each row over a thread block cluster,
  one segment a block, in the same two ways; one thread per row beyond;
* ``LAUNCHES``: the count of solves launched (forward and transpose solves;
  a shared-band solve's two kernels count once); ``ROUTE_LAUNCHES`` the
  same by route.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from . import dispatch
from .masked_cubic_kernel import (
    BLOCK_THREADS,
    CLUSTER_REACH,
    POSITIONS,
    RESIDENT_MAX,
    cluster_shape,
    threads_per_row,
)
from .tridiagonal import tridiagonal_solve_thomas  # the plain version

LAUNCHES = 0
# The routes: shared bands resident or over a cluster, per-row bands
# resident or over a cluster, one thread a row.
ROUTES = ("resident", "cluster", "per_row", "per_row_cluster", "thomas")
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
THOMAS_THREADS = 32  # one thread per row, one warp per block


class SolvePlan(NamedTuple):
    variant: str          # one of ROUTES
    threads_per_row: int  # (over a cluster: the threads of a block's segment)
    rows_per_block: int
    threads: int          # per block
    positions: int        # per thread (thomas: the row)
    cluster: int          # blocks a row spans (1 off the cluster routes)
    segment: int          # positions of a row a block holds


def solve_plan(k, shared):
    """The launch for rows of length k whose bands are one for every row
    (``shared``) or one per row: up to ``RESIDENT_MAX`` positions each row
    resident in K6/K7's threads per row (``resident`` after the shared
    pivots, or ``per_row``); up to ``CLUSTER_REACH`` over K6/K7's clusters
    (``cluster_shape``: ``cluster`` or ``per_row_cluster``);
    ``thomas_kernel`` beyond."""
    if k < 1:
        raise ValueError(f"the solve needs rows of at least 1 position, got {k}")
    if k > CLUSTER_REACH:
        return SolvePlan("thomas", 1, THOMAS_THREADS, THOMAS_THREADS, k, 1, k)
    if k > RESIDENT_MAX:
        blocks, segment = cluster_shape(k)
        return SolvePlan("cluster" if shared else "per_row_cluster", BLOCK_THREADS, 1,
                         BLOCK_THREADS, POSITIONS, blocks, segment)
    tpr = threads_per_row(k)
    return SolvePlan("resident" if shared else "per_row", tpr, BLOCK_THREADS // tpr,
                     BLOCK_THREADS, POSITIONS, 1, k)


def pivot_positions(plan):
    """The positions of each row of the shared routes' (3, P) pivot
    scratch: the threads' chunks of the row, or the cluster's segments."""
    if plan.variant == "cluster":
        return plan.cluster * plan.segment
    return plan.threads_per_row * plan.positions


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for route in ROUTES:
        ROUTE_LAUNCHES[route] = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_td_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.td_solve.argtypes = [p] * 6 + [ll, i, ll, ll, ll, ll, p]
        lib.td_solve.restype = i
        lib.td_solve_shared.argtypes = [p] * 6 + [ll, i, i, i, i, p]
        lib.td_solve_shared.restype = i
        lib.td_solve_rows.argtypes = [p] * 5 + [ll, i, i, i, i, ll, ll, ll, p]
        lib.td_solve_rows.restype = i
        lib.td_error_string.argtypes = [i]
        lib.td_error_string.restype = ctypes.c_char_p
        lib._td_declared = True
    return lib


def _rows(a, shape):
    """``a`` broadcast to ``shape`` as (rows, width) plus its row stride: a
    single band is passed once with stride 0, never copied per row."""
    width = shape[-1]
    if math.prod(a.shape[:-1]) == 1:
        return a.reshape(1, width).contiguous(), 0
    if tuple(a.shape) != tuple(shape):
        a = a.expand(shape)
    return a.contiguous().reshape(-1, width), width


def launch(b, A_upper, A_diagonal, A_lower):
    """One solve: b (..., k) float32 on a CUDA device, bands broadcasting
    against it (A_diagonal (..., k), A_upper/A_lower (..., k - 1))."""
    global LAUNCHES
    shape = tuple(b.shape)
    k = shape[-1]
    off = shape[:-1] + (k - 1,)
    b2, sb = _rows(b, shape)
    d2, sd = _rows(A_diagonal, shape)
    u2, su = _rows(A_upper, off)
    l2, sl = _rows(A_lower, off)
    dispatch.check_operands((b2, u2, d2, l2), ("b", "A_upper", "A_diagonal", "A_lower"))
    n = b2.shape[0]
    x = torch.empty((n, k), dtype=b.dtype, device=b.device)
    if n == 0:
        return x.reshape(shape)
    plan = solve_plan(k, shared=su == sd == sl == 0)
    _kernel(plan, (b2, u2, d2, l2), x, _scratch(plan, n, k, b), (n, k, sb, su, sd, sl))
    LAUNCHES += 1
    ROUTE_LAUNCHES[plan.variant] += 1
    return x.reshape(shape)


def _scratch(plan, n, k, like):
    """The route's scratch: the shared band's pivots w, r, c (zero past
    k), the eliminated diagonal (k, n) of thomas_kernel, or none."""
    if plan.variant in ("resident", "cluster"):
        return torch.empty((3, pivot_positions(plan)), dtype=like.dtype, device=like.device)
    if plan.variant == "thomas":
        return torch.empty((k, n), dtype=like.dtype, device=like.device)
    return None


def _kernel(plan, operands, x, scratch, sizes):
    """The route of ``plan`` on the operands (b, u, d, l as rows, ``_rows``)
    into x (n, k), with its scratch."""
    lib = _library()
    n, k, sb, su, sd, sl = sizes
    ptrs = [t.data_ptr() for t in (*operands, x)]
    shape = (plan.threads_per_row, plan.cluster, plan.segment)
    stream = dispatch.stream_of(x)
    with torch.cuda.device(x.device):
        if plan.variant in ("resident", "cluster"):
            rc = lib.td_solve_shared(*ptrs, scratch.data_ptr(), n, k, *shape, stream)
        elif plan.variant in ("per_row", "per_row_cluster"):
            rc = lib.td_solve_rows(*ptrs, n, k, *shape, su, sd, sl, stream)
        else:
            rc = lib.td_solve(*ptrs, scratch.data_ptr(), n, k, sb, su, sd, sl, stream)
    if rc != 0:
        raise RuntimeError(f"tridiagonal solve kernel failed: {lib.td_error_string(rc).decode()} "
                           f"(code {rc})")


def _sum_to(grad, shape):
    """Sums a broadcast gradient back to an operand's shape."""
    extra = grad.ndim - len(shape)
    if extra:
        grad = grad.sum(dim=tuple(range(extra)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and grad.shape[i] != 1)
    return grad.sum(dim=dims, keepdim=True) if dims else grad


class _TridiagonalKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, A_upper, A_diagonal, A_lower):
        shape = torch.broadcast_shapes(A_diagonal.shape, b.shape)
        x = launch(b.expand(shape), A_upper, A_diagonal, A_lower)
        ctx.save_for_backward(x, A_upper, A_diagonal, A_lower)
        ctx.shapes = (b.shape, A_upper.shape, A_diagonal.shape, A_lower.shape)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, u, d, l = ctx.saved_tensors
        sb, su, sd, sl = ctx.shapes
        y = launch(g.contiguous(), l, d, u)  # A^T: the bands swapped
        need = ctx.needs_input_grad
        grad_b = _sum_to(y, sb) if need[0] else None
        grad_u = _sum_to(-y[..., :-1] * x[..., 1:], su) if need[1] else None
        grad_d = _sum_to(-y * x, sd) if need[2] else None
        grad_l = _sum_to(-y[..., 1:] * x[..., :-1], sl) if need[3] else None
        return grad_b, grad_u, grad_d, grad_l


def tridiagonal_solve_kernel(b, A_upper, A_diagonal, A_lower):
    """Solves Ax = b with the kernel for CUDA float32/bfloat16 operands
    (``ops/dispatch.py``), with the plain Thomas solve otherwise."""
    if not dispatch.runs_kernel(b, A_upper, A_diagonal, A_lower):
        return tridiagonal_solve_thomas(b, A_upper, A_diagonal, A_lower)
    (b, A_upper, A_diagonal, A_lower), restore = dispatch.upcast_kernel_operands(
        b, A_upper, A_diagonal, A_lower)
    return restore(_TridiagonalKernel.apply(b, A_upper, A_diagonal, A_lower))
