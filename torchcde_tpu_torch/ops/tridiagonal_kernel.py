"""K4: the batched tridiagonal solve as a CUDA kernel (``csrc/tridiagonal.cu``).

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
* ``LAUNCHES``: the count of kernel launches (forward and transpose solves).
"""

import ctypes
import math

import torch

from .. import _build
from . import dispatch
from .tridiagonal import tridiagonal_solve_thomas  # the plain version

LAUNCHES = 0


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_td_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.td_solve.argtypes = [p] * 6 + [ll, i, ll, ll, ll, ll, p]
        lib.td_solve.restype = i
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
    """One launch: b (..., k) float32 on a CUDA device, bands broadcasting
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
    nd = torch.empty((k, n), dtype=b.dtype, device=b.device)
    lib = _library()
    with torch.cuda.device(b.device):
        rc = lib.td_solve(b2.data_ptr(), u2.data_ptr(), d2.data_ptr(), l2.data_ptr(),
                          x.data_ptr(), nd.data_ptr(), n, k, sb, su, sd, sl,
                          dispatch.stream_of(b))
    if rc != 0:
        raise RuntimeError(f"tridiagonal solve kernel failed: {lib.td_error_string(rc).decode()} "
                           f"(code {rc})")
    LAUNCHES += 1
    return x.reshape(shape)


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
