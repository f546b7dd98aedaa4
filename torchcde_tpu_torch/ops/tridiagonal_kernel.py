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
  one segment a block, in the same two ways; beyond, segmented: the same
  segments in launches of their own, the scans' totals crossing through
  device memory (``row_split.segment_totals``);
* ``LAUNCHES``: the count of solves launched (forward and transpose solves;
  a route's kernels count once a solve); ``ROUTE_LAUNCHES`` the same by
  route.
"""

import ctypes
import math

import torch

from .. import _build
from . import dispatch
from .row_split import row_plan, segment_totals
from .tridiagonal import tridiagonal_solve_thomas  # the plain version

LAUNCHES = 0
# The routes: shared bands resident, over a cluster or segmented; per-row
# bands the same three ways.
SHARED_ROUTES = ("resident", "cluster", "segmented")
ROUTES = SHARED_ROUTES + ("per_row", "per_row_cluster", "per_row_segmented")
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def solve_plan(k, shared):
    """The launch for rows of length k whose bands are one for every row
    (``shared``) or one per row: ``row_plan(k)``'s split, resident,
    over a cluster or segmented; per-row bands' routes are named
    ``per_row``, ``per_row_cluster`` and ``per_row_segmented``."""
    plan = row_plan(k)
    if shared:
        return plan
    return plan._replace(variant="per_row" if plan.variant == "resident"
                         else f"per_row_{plan.variant}")


def pivot_positions(plan):
    """The positions of each row of the shared routes' (3, P) pivot
    scratch: the threads' chunks of the row, or its segments."""
    if plan.variant in ("cluster", "segmented"):
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
        lib.td_solve_shared.argtypes = [p] * 7 + [ll, i, i, i, i, p]
        lib.td_solve_shared.restype = i
        lib.td_solve_rows.argtypes = [p] * 6 + [ll, i, i, i, i, ll, ll, ll, p]
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
    _kernel(plan, (b2, u2, d2, l2), x, _scratch(plan, n, b), (n, k, sb, su, sd, sl))
    LAUNCHES += 1
    ROUTE_LAUNCHES[plan.variant] += 1
    return x.reshape(shape)


def _scratch(plan, n, like):
    """The route's scratch, (pivots, totals), each a tensor or None: the
    shared band's pivots w, r, c (3, P), zero past k, on the shared routes;
    a segmented route's totals (``row_split.segment_totals``)."""
    pivots = totals = None
    if plan.variant in SHARED_ROUTES:
        pivots = torch.empty((3, pivot_positions(plan)), dtype=like.dtype, device=like.device)
    if plan.variant.endswith("segmented"):
        totals = torch.empty(segment_totals(plan.cluster, n, plan.variant in SHARED_ROUTES),
                             dtype=like.dtype, device=like.device)
    return pivots, totals


def _kernel(plan, operands, x, scratch, sizes):
    """The route of ``plan`` on the operands (b, u, d, l as rows, ``_rows``)
    into x (n, k), with its scratch (``_scratch``)."""
    lib = _library()
    n, k, _sb, su, sd, sl = sizes
    ptrs = [t.data_ptr() for t in (*operands, x)]
    pivots, totals = (0 if t is None else t.data_ptr() for t in scratch)
    shape = (plan.threads_per_row, plan.cluster, plan.segment)
    stream = dispatch.stream_of(x)
    with torch.cuda.device(x.device):
        if plan.variant in SHARED_ROUTES:
            rc = lib.td_solve_shared(*ptrs, pivots, totals, n, k, *shape, stream)
        else:
            rc = lib.td_solve_rows(*ptrs, totals, n, k, *shape, su, sd, sl, stream)
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
