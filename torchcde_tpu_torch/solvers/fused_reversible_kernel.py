"""The whole reversible-Heun Neural CDE solve as one CUDA kernel pair (K8).

Replaces ``torchcde_tpu/solvers/fused_pallas.py::_rev_fwd_kernel`` and
``_rev_bwd_kernel`` (built by ``_make_fused_rev_solve``, reached through
``try_fused_reversible_heun``).  The kernels live in
``csrc/fused_reversible.cu``, whose header notes what bounds them on the card
and what their design does about it.  The forward carries (y, ŷ) across the
knot grid and stores both after every interval; the backward walks the
intervals in reverse, restarts each from its stored state, rebuilds the steps
with the algebraic inverse map and accumulates the per-step vector-Jacobian
products.  This module holds what surrounds them:

* ``fused_reversible_solve_reference``: the plain PyTorch version of the
  kernels' function on the operands of ``fused_fixed_kernel.pack_operands``,
  differentiable by autograd; ``fused_reversible_backward_reference``, the
  backward kernel's inverse-map walk in plain PyTorch;
* ``fused_reversible_solve``: launches the kernels for CUDA tensors (through
  a ``torch.autograd.Function`` whose backward is the backward kernel) and
  runs the plain version for CPU tensors;
* ``FWD_LAUNCHES`` / ``BWD_LAUNCHES``: counts of kernel launches;
* ``try_fused_reversible_heun``: the dispatch rules of the JAX package.

At a knot the kernels evaluate dX/dt with the next interval's rows at
fraction 0: f̂ is evaluated anew at the start of every interval, not carried
across the knot as ``reversible_adjoint.py`` carries it (that one reads the
left interval at its end).  For a C1 control (Hermite, natural cubic) the two
agree up to rounding; the plain version here follows the kernels.

Eligibility is K1's: the caps of ``pack_operands``, m <= 8, one dtype,
uniform knots.  On the card the kernels take float32: one forward and one
backward take every float32 shape inside the caps, H, C and W at run time,
the weights resident in shared memory where they fit and streamed through it
otherwise (``forward_plan``, ``backward_plan``).  bfloat16 operands are
upcast to float32 at the boundary and the solution is cast back, as the JAX
package's K8 takes them (it has no bfloat16 mode).  A CUDA tensor never
falls back to the plain version: the kernel launches or raises.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..ops.dispatch import check_operands, scratch_buffer, stream_of
from .fused_fixed import admits_fused, plan_fixed_grid
from .fused_fixed_kernel import MAX_SUBSTEPS, _shapes, pack_operands

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts():
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


def _field(y, fr, rows, w1t, b1, w2t, b2):
    """The MLP field's value along dX/dt at fraction fr of an interval whose
    rows b, 2c, 3d are ``rows`` (each (B, C)): (B, H) from y (B, H)."""
    b_j, c_j, d_j = rows
    B, C = b_j.shape
    dx = b_j + (c_j + d_j * fr) * fr
    h1 = torch.relu(y @ w1t.t() + b1)
    g = torch.tanh(h1 @ w2t.t() + b2)
    return (g.reshape(B, C, -1) * dx[:, :, None]).sum(dim=1)


def fused_reversible_solve_reference(ct, z0t, w1t, b1, w2t, b2, m, dt_sub):
    """Plain PyTorch version of the kernels' function on the same operands.

    Returns (y, ŷ), each (n, H, B): the state and its companion after every
    interval (knots 1..n)."""
    weights = (w1t, b1, w2t, b2)
    slab = ct.permute(0, 1, 3, 2)  # (n, 3, B, C)
    y = yhat = z0t.t()
    ys, yhats = [], []
    for j in range(ct.shape[0]):
        rows = tuple(slab[j])
        # dX/dt jumps at knots: f̂ is evaluated anew at the interval's
        # fraction 0, with its own rows.
        fhat = _field(yhat, 0.0, rows, *weights)
        for s in range(m):
            yhat1 = 2.0 * y - yhat + dt_sub * fhat
            fhat1 = _field(yhat1, (s + 1) * dt_sub, rows, *weights)
            y = y + (0.5 * dt_sub) * (fhat + fhat1)
            yhat, fhat = yhat1, fhat1
        ys.append(y.t())
        yhats.append(yhat.t())
    return torch.stack(ys), torch.stack(yhats)


def fused_reversible_backward_reference(ct, y, yhat, gy, w1t, b1, w2t, b2, m, dt_sub):
    """Plain PyTorch version of the backward kernel's walk: each interval,
    in reverse, from its stored (y, ŷ), rebuilt with the inverse map one
    substep at a time, the cotangents pulled back through each step's two
    evaluations.  Returns (dct, dz0, dw1t, db1, dw2t, db2), as
    ``launch_backward`` does."""
    weights = [w.detach() for w in (w1t, b1, w2t, b2)]
    dweights = [torch.zeros_like(w) for w in weights]
    dct = torch.zeros_like(ct)
    slab = ct.detach().permute(0, 1, 3, 2)  # (n, 3, B, C)

    def vjp(yv, fr, rows, u):
        """The evaluation at yv and its VJP for u: (k, dy, drows, dweights)."""
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (yv, *rows, *weights)]
            k = _field(leaves[0], fr, leaves[1:4], *leaves[4:])
            grads = torch.autograd.grad(k, leaves, u)
        return k.detach(), grads[0], grads[1:4], grads[4:]

    a_y = a_yhat = torch.zeros_like(y[0].t())
    for j in reversed(range(ct.shape[0])):
        a_y = a_y + gy[j].t()
        y1, yhat1 = y[j].t(), yhat[j].t()
        rows = tuple(slab[j])
        for s in reversed(range(m)):
            fr1, fr0 = (s + 1) * dt_sub, s * dt_sub
            f1, v1, drows1, dw1 = vjp(yhat1, fr1, rows, (0.5 * dt_sub) * a_y)
            yhat0 = 2.0 * y1 - yhat1 - dt_sub * f1
            a_yhat1 = a_yhat + v1
            f0, v0, drows0, dw0 = vjp(yhat0, fr0, rows, (0.5 * dt_sub) * a_y + dt_sub * a_yhat1)
            y1, yhat1 = y1 - (0.5 * dt_sub) * (f1 + f0), yhat0
            a_y, a_yhat = a_y + 2.0 * a_yhat1, -a_yhat1 + v0
            for r in range(3):
                dct[j, r] += (drows1[r] + drows0[r]).t()
            dweights = [d + a + b for d, a, b in zip(dweights, dw1, dw0)]
    # y and ŷ both start at z0: both adjoints flow there.
    return (dct, (a_y + a_yhat).t(), *dweights)


class _Plan(NamedTuple):
    m: int
    dt_sub: float


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_fr_declared", False):
        p, i, d, out = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_long)
        lib.fr_forward.argtypes = [p] * 9 + [i] * 6 + [d, p]
        lib.fr_forward.restype = i
        lib.fr_forward_plan.argtypes = [i] * 4 + [out]
        lib.fr_forward_plan.restype = i
        lib.fr_backward.argtypes = [p] * 15 + [i] * 6 + [d, i, p]
        lib.fr_backward.restype = i
        lib.fr_backward_plan.argtypes = [i] * 4 + [out]
        lib.fr_backward_plan.restype = i
        lib.fr_backward_scratch.argtypes = [i] * 4 + [out]
        lib.fr_backward_scratch.restype = i
        lib.fr_error_string.argtypes = [i]
        lib.fr_error_string.restype = ctypes.c_char_p
        lib._fr_declared = True
    return lib


def _raise_on(lib, rc, which):
    if rc != 0:
        raise RuntimeError(
            f"fused reversible-Heun {which} kernel failed: "
            f"{lib.fr_error_string(rc).decode()} (code {rc})")


def _plan_of(entry, keys, which, *args):
    lib = _library()
    out = (ctypes.c_long * len(keys))()
    _raise_on(lib, getattr(lib, entry)(*args, out), which)
    return dict(zip(keys, out))


FORWARD_PLAN_KEYS = ("streamed", "blocks", "threads", "lanes_per_block", "warps_per_lane_group",
                     "padded_hidden", "shared_bytes", "scratch_floats")


def forward_plan(B, H, C, W):
    """The forward kernel's launch for these shapes, as a dict
    (``FORWARD_PLAN_KEYS``): whether the weights stream through shared
    memory (1) or stay resident in it (0), blocks, threads per block, lanes
    per block, warps per group of 16 lanes, H padded to whole state tiles,
    the shared memory of a block and the floats of the staged weights'
    scratch (0 when resident)."""
    return _plan_of("fr_forward_plan", FORWARD_PLAN_KEYS, "forward", B, H, C, W)


BACKWARD_PLAN_KEYS = ("variant", "blocks", "threads", "lanes_per_block", "resident_per_sm",
                      "sms", "lane_groups", "shared_bytes")


def backward_plan(B, H, C, W, device):
    """The backward kernel's launch for these shapes, as a dict
    (``BACKWARD_PLAN_KEYS``): the weights' path (0 resident in shared
    memory, 1 streamed through it), blocks (the leading size of the weight
    partials), threads per block, lanes per block, blocks an SM holds, the
    card's SMs, lane groups (blocks stride over them) and the shared memory
    of a block.  It launches as many blocks as the SMs of ``device`` hold at
    once."""
    with torch.cuda.device(device):
        return _plan_of("fr_backward_plan", BACKWARD_PLAN_KEYS, "backward", B, H, C, W)


def launch_forward(ct, z0t, w1t, b1, w2t, b2, plan):
    """Forward kernel: returns (y, ŷ), each (n, H, B)."""
    global FWD_LAUNCHES
    check_operands((ct, z0t, w1t, b1, w2t, b2), ("ct", "z0t", "w1t", "b1", "w2t", "b2"))
    n, C, B, H, W = _shapes(ct, z0t, w1t, w2t)
    lib = _library()
    _buf, scratch = scratch_buffer(forward_plan(B, H, C, W)["scratch_floats"], ct)
    y = torch.empty((n, H, B), dtype=ct.dtype, device=ct.device)
    yhat = torch.empty_like(y)
    ptrs = [t.data_ptr() for t in (ct, z0t, w1t, b1, w2t, b2, y, yhat)]
    with torch.cuda.device(ct.device):
        rc = lib.fr_forward(*ptrs, scratch, B, n, H, C, W, plan.m, plan.dt_sub, stream_of(ct))
    _raise_on(lib, rc, "forward")
    FWD_LAUNCHES += 1
    return y, yhat


def launch_backward(ct, y, yhat, gy, w1t, b1, w2t, b2, plan):
    """Backward kernel for the cotangent gy of y: returns (dct, dz0, dw1t,
    db1, dw2t, db2)."""
    global BWD_LAUNCHES
    ops = (ct, y, yhat, gy, w1t, b1, w2t, b2)
    check_operands(ops, ("ct", "y", "yhat", "gy", "w1t", "b1", "w2t", "b2"))
    n, C, B, H, W = _shapes(ct, y[0], w1t, w2t)
    if any(t.shape != (n, H, B) for t in (y, yhat, gy)):
        raise ValueError("inconsistent fused-solve state shapes")
    launch = backward_plan(B, H, C, W, ct.device)
    blocks = launch["blocks"]
    empty = functools.partial(torch.empty, dtype=ct.dtype, device=ct.device)
    outs = (empty(ct.shape), empty((H, B)), empty((blocks, W, H)), empty((blocks, W)),
            empty((blocks, W, C * H)), empty((blocks, C * H)))
    _backward_kernel(ops, outs, (B, n, H, C, W), plan, launch)
    BWD_LAUNCHES += 1
    dct, dz0, dw1p, db1p, dw2p, db2p = outs
    # Per-block partials are summed after the launch (deterministic).
    return (dct, dz0, dw1p.sum(0), db1p.sum(0), dw2p.sum(0).t(), db2p.sum(0))


def _backward_kernel(ops, outs, shape, plan, launch):
    """The backward kernel on ``ops`` into ``outs`` (dct, dz0 and the
    partials), as ``launch`` (``backward_plan``) plans it."""
    lib = _library()
    B, n, H, C, W = shape
    floats = ctypes.c_long()
    ptrs = [t.data_ptr() for t in (*ops, *outs)]
    with torch.cuda.device(ops[0].device):
        _raise_on(lib, lib.fr_backward_scratch(B, H, C, W, ctypes.byref(floats)), "backward")
        _buf, scratch = scratch_buffer(floats.value, ops[0])
        rc = lib.fr_backward(*ptrs, scratch, B, n, H, C, W, plan.m, plan.dt_sub,
                             launch["blocks"], stream_of(ops[0]))
    _raise_on(lib, rc, "backward")


class _FusedReversibleSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, z0t, w1t, b1, w2t, b2, plan):
        y, yhat = launch_forward(ct, z0t, w1t, b1, w2t, b2, plan)
        ctx.save_for_backward(ct, y, yhat, w1t, b1, w2t, b2)
        ctx.plan = plan
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        ct, y, yhat, w1t, b1, w2t, b2 = ctx.saved_tensors
        grads = launch_backward(ct, y, yhat, gy.contiguous(), w1t, b1, w2t, b2, ctx.plan)
        return grads + (None,)


def fused_reversible_solve(ct, z0t, w1t, b1, w2t, b2, m, dt_sub):
    """y after every interval, (n, H, B), over packed operands (see
    ``pack_operands``).  CUDA tensors run the kernels; CPU tensors run the
    plain version."""
    if ct.is_cuda:
        return _FusedReversibleSolve.apply(ct, z0t, w1t, b1, w2t, b2, _Plan(int(m), float(dt_sub)))
    if ct.device.type != "cpu":
        raise ValueError(f"no fused reversible-Heun solve for device {ct.device}")
    return fused_reversible_solve_reference(ct, z0t, w1t, b1, w2t, b2, m, dt_sub)[0]


def try_fused_reversible_heun(X, func, z0, ts, step_size):
    """The fused reversible-Heun solve with its exact O(1)-memory adjoint.

    The rules of the JAX package: an ``MLPVectorField``, a tensor z0, a
    knot-aligned plan (``plan_fixed_grid``) over uniform knots, at most
    ``MAX_SUBSTEPS`` steps per interval and operands inside the caps.
    Returns the time-leading solution at ``ts``, or None."""
    if not admits_fused(func) or not isinstance(z0, torch.Tensor):
        return None
    plan = plan_fixed_grid(X, ts, step_size)
    if plan is None or not plan[-1]:  # uniform spacing required
        return None
    rows, _grid, out_idx, j0, jN, m, dt_sub, _uniform = plan
    if m > MAX_SUBSTEPS:
        return None
    p = pack_operands(*(r[..., j0:jN, :] for r in rows[1:]), z0, func)
    if p is None:
        return None
    y = fused_reversible_solve(p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2, m, dt_sub)
    knots = y.permute(0, 2, 1).reshape((jN - j0,) + p.batch + (p.H,))
    # Knot 0 is z0 itself, taken outside the kernels.
    z0b = p.z0f.reshape(p.batch + (p.H,))
    out = torch.stack([knots[k - 1] if k else z0b for k in (int(i) - j0 for i in out_idx)])
    return out.to(p.out_dtype)
