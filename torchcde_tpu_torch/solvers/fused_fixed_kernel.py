"""The whole fixed-step Neural CDE solve as one CUDA kernel pair.

Replaces ``torchcde_tpu/solvers/fused_pallas.py::_fwd_kernel`` and
``_bwd_kernel`` (built by ``_make_fused_solve``, reached through
``try_fused_mlp_pallas``).  The kernels live in ``csrc/fused_fixed.cu``,
whose header notes what bounds them on the card and what their design does
about it.  This module holds what surrounds them:

* ``pack_operands``: the kernel layout, made by differentiable tensor ops so
  autograd carries gradients through the packing, as in the JAX package;
* ``fused_fixed_solve_reference``: the plain PyTorch version of the kernels'
  function on the same operands, differentiable by autograd;
* ``fused_fixed_solve``: launches the kernels for CUDA tensors (through a
  ``torch.autograd.Function`` whose backward is the backward kernel) and runs
  the plain version for CPU tensors;
* ``forward_plan`` / ``backward_plan``: each kernel's launch for some shapes,
  from the occupancy API of the kernel it launches (as many blocks of lanes
  as the SMs hold, striding beyond; fewer lanes a block at small batches);
* ``FWD_LAUNCHES`` / ``BWD_LAUNCHES``: counts of kernel launches, and
  ``BF16_FWD_LAUNCHES`` / ``BF16_BWD_LAUNCHES`` of those in the bfloat16 mode.

Eligibility mirrors the JAX package's ``_pack_operands`` caps (width <= 512,
C * H <= 512, 3 * C <= 16, or C <= 16 for a linear control's slopes, m <= 8,
one dtype) and is decided from shapes
before any launch; a declined solve returns None and ``try_fused_fixed``
streams the rows instead.  On the card the kernels take float32, and every
float32 shape inside the caps launches the one forward and the one backward
kernel, H, C and W at run time (see the CUDA sources): the weights resident
in shared memory where they fit, streamed through it where they do not.

Mixed precision follows the JAX package's dtype policy.  A bfloat16 model's
solve keeps the coefficient slabs in bfloat16 (``ct_store="native"``), holds
the state, the weights and every sum in float32, and rounds the operands of
each stage product to bfloat16 where the JAX kernel feeds its matrix unit;
the solution comes back bfloat16, and so do the slabs' cotangents.
On the card that is the kernels' bfloat16 mode, which a bfloat16 slab table
always launches.  A CUDA tensor never falls back to the plain version: the
kernel launches or raises.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..ops.dispatch import check_operands, scratch_buffer, stream_of
from .runge_kutta import TABLEAUS

# Caps mirrored from the JAX package's _pack_operands.
MAX_WIDTH = 512
MAX_CONTRACT = 512  # C * H
MAX_SLAB_ROWS = 16  # rows per interval: 3 * C (cubic), C (linear slopes)
MAX_SUBSTEPS = 8

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0


def reset_launch_counts():
    global FWD_LAUNCHES, BWD_LAUNCHES, BF16_FWD_LAUNCHES, BF16_BWD_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = BF16_FWD_LAUNCHES = BF16_BWD_LAUNCHES = 0


def _chain_form(method):
    """(stage time fractions, weight of the previous stage, solution weights).

    Every tableau here reads only the previous stage (A is zero off its
    subdiagonal), which is what lets the kernels carry one stage at a time."""
    tab = TABLEAUS[method]
    alpha, beta, c_sol = tab.alpha, tab.beta, tab.c_sol
    prev = [0.0]
    for s, row in enumerate(beta, start=1):
        if any(coef != 0.0 for coef in row[:-1]) or len(row) != s:
            raise ValueError(f"{method}: stage {s} reads more than the previous stage")
        prev.append(row[-1])
    return (0.0,) + tuple(alpha), tuple(prev), tuple(c_sol)


class Packed(NamedTuple):
    ct: torch.Tensor    # (n, R, C, B): rows b, 2c, 3d (R 3) or the slopes (R 1) per interval
    z0t: torch.Tensor   # (H, B); this and the weights float32 for a bfloat16 model
    w1t: torch.Tensor   # (W, H)
    b1: torch.Tensor    # (W,)
    w2t: torch.Tensor   # (C*H, W), rows in the kernel order i*H + h
    b2: torch.Tensor    # (C*H,)
    z0f: torch.Tensor   # (B, H)
    batch: tuple
    H: int
    out_dtype: torch.dtype  # the operands' own dtype, which the solution takes


def pack_operands(b_rows, c_rows, d_rows, z0, field, linear=False, ct_store=None):
    """Validate shapes and pack the kernel operands, or None if ineligible.

    b_rows, c_rows, d_rows: (..., n, C) spline rows b, 2c, 3d; z0 (..., H);
    field: an ``MLPVectorField``.  ``linear=True``: b_rows are a
    ``LinearInterpolation``'s slopes and c_rows, d_rows are None; the table
    holds C rows per interval, so C <= 16 instead of 3 * C <= 16 (the
    depth-3 log-ODE control's 14 channels fit).

    bfloat16 operands (the JAX package's policy): z0 and the weights are
    upcast to float32, and so is the slab table unless ``ct_store="native"``
    (K1's bfloat16 mode), which keeps it bfloat16.  The casts are autograd
    ops, so bfloat16 inputs receive bfloat16 cotangents."""
    C = b_rows.shape[-1]
    H = field.hidden_channels
    w1, b1 = field.linear1.weight, field.linear1.bias
    w2, b2 = field.linear2.weight, field.linear2.bias
    W = w1.shape[0]
    if (w1.shape != (W, H) or w2.shape != (H * C, W)
            or field.input_channels != C or z0.shape[-1] != H):
        return None
    slab_rows = C if linear else 3 * C
    if W > MAX_WIDTH or C * H > MAX_CONTRACT or slab_rows > MAX_SLAB_ROWS:
        return None
    rows = (b_rows,) if linear else (b_rows, c_rows, d_rows)
    arrays = rows + (z0, w1, b1, w2, b2)
    if any(a.dtype != z0.dtype or a.device != z0.device for a in arrays):
        return None  # mixed dtypes decline, as in the JAX package
    out_dtype = z0.dtype
    if out_dtype == torch.bfloat16:
        z0, w1, b1, w2, b2 = (a.float() for a in (z0, w1, b1, w2, b2))
        if ct_store != "native":
            rows = tuple(r.float() for r in rows)
    elif z0.is_cuda and out_dtype != torch.float32:
        return None  # as in the JAX package, whose kernel takes f32 and bf16
    n = b_rows.shape[-2]
    if any(r.shape[-2:] != (n, C) for r in rows):
        return None
    batch = tuple(torch.broadcast_shapes(*(r.shape[:-2] for r in rows), z0.shape[:-1]))
    B = 1
    for size in batch:
        B *= size
    if B == 0:
        return None

    def flat_rows(r):
        return r.expand(batch + (n, C)).reshape(B, n, C)

    ct = torch.stack([flat_rows(r) for r in rows])
    ct = ct.permute(2, 0, 3, 1).contiguous()  # (n, R, C, B)
    z0f = z0.expand(batch + (H,)).reshape(B, H)
    # Vector-field rows from the model's h*C + i order to the kernel's i*H + h.
    w2t = w2.reshape(H, C, W).transpose(0, 1).reshape(C * H, W).contiguous()
    b2p = b2.reshape(H, C).t().reshape(C * H).contiguous()
    return Packed(ct, z0f.t().contiguous(), w1.contiguous(), b1.contiguous(),
                  w2t, b2p, z0f, batch, H, out_dtype)


def round_bf16(x):
    """x rounded to the nearest bfloat16, kept in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _MxDot(torch.autograd.Function):
    """a @ b with both operands rounded to bfloat16 and the products summed
    in a's dtype: the JAX kernels' ``_dot``/``_dg`` with bfloat16 operands
    and float32 accumulation.  Its VJP is theirs too: each backward product
    rounds its operands, the incoming cotangent included."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_bf16(g)
        return g @ b.t(), a.t() @ g


def _mx_selection(C, H, dtype, device):
    """The 0/1 matrices of the JAX kernels' padded layout (H % 8 != 0):
    rep (C, C*H) repeats dx over h, sel (C*H, H) sums over i."""
    rep = torch.kron(torch.eye(C, dtype=dtype, device=device),
                     torch.ones((1, H), dtype=dtype, device=device))
    sel = torch.eye(H, dtype=dtype, device=device).repeat(C, 1)
    return rep, sel


def fused_fixed_solve_reference(ct, z0t, w1t, b1, w2t, b2, method, m, dt_sub,
                                out_knots):
    """Plain PyTorch version of the kernels' function on the same operands.

    Returns the states at ``out_knots`` (each >= 1; knot k is the state after
    interval k - 1) as (len(out_knots), H, B), in z0t's dtype, in which it
    computes (a bfloat16 slab table is upcast to it).

    A bfloat16 slab table runs the bfloat16 mode, as it does on the card:
    the operands of the stage products are rounded to bfloat16 exactly where
    the JAX kernel feeds its matrix unit: y before W1 y and h1 before W2 h1; in the backward (by ``_MxDot``),
    dpre2 in dW2 and dh1, h1 in dW2, dpre1 in dW1 and dy, y in dW1; and,
    only when H % 8 != 0, the selection products of the padded layout (dx
    in rep dx, g (rep dx) in sel (...), u in sel^T u, and (sel^T u) g in
    rep^T (...)).  db1, db2, dx, the stage combinations and the carried
    state stay unrounded."""
    frac, prev, c_sol = _chain_form(method)
    n, _, C, B = ct.shape
    H = z0t.shape[0]
    mx = ct.dtype == torch.bfloat16
    slab = ct.to(z0t.dtype).permute(0, 3, 1, 2)  # (n, B, 3, C)
    if mx:
        dot = _MxDot.apply
        if H % 8:
            rep, sel = _mx_selection(C, H, z0t.dtype, z0t.device)
    else:
        dot = torch.matmul
    wanted = set(out_knots)
    outs = {}
    z = z0t.t()
    for j in range(n):
        b_j, c_j, d_j = slab[j, :, 0], slab[j, :, 1], slab[j, :, 2]
        for s in range(m):
            z_next, k = z, None
            for st in range(len(c_sol)):
                y = z if st == 0 else z + (dt_sub * prev[st]) * k
                fr = s * dt_sub + frac[st] * dt_sub
                dx = b_j + (c_j + d_j * fr) * fr
                h1 = torch.relu(dot(y, w1t.t()) + b1)
                g = torch.tanh(dot(h1, w2t.t()) + b2)
                if mx and H % 8:
                    k = dot(g * dot(dx, rep), sel)
                else:
                    k = (g.reshape(B, C, H) * dx[:, :, None]).sum(dim=1)
                if c_sol[st] != 0.0:
                    z_next = z_next + (dt_sub * c_sol[st]) * k
            z = z_next
        if j + 1 in wanted:
            outs[j + 1] = z
    return torch.stack([outs[k].t() for k in out_knots])


class _Plan(NamedTuple):
    method: str
    m: int
    dt_sub: float
    out_knots: tuple


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_ff_declared", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        dp = ctypes.POINTER(ctypes.c_double)
        lib.ff_forward.argtypes = [p] * 10 + [i] * 6 + [d, i, dp, dp, dp, i, i, p]
        lib.ff_forward.restype = i
        lib.ff_backward.argtypes = [p] * 16 + [i] * 6 + [d, i, dp, dp, dp, i, i, p]
        lib.ff_backward.restype = i
        for plan in (lib.ff_forward_plan, lib.ff_backward_plan):
            plan.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_long)]
            plan.restype = i
        lib.ff_error_string.argtypes = [i]
        lib.ff_error_string.restype = ctypes.c_char_p
        lib._ff_declared = True
    return lib


@functools.lru_cache(maxsize=64)
def _knot_slots(out_knots, n, device):
    """slot[j] = position of knot j + 1 in out_knots, or -1."""
    slot = [-1] * n
    for pos, knot in enumerate(out_knots):
        slot[knot - 1] = pos
    return torch.tensor(slot, dtype=torch.int32, device=device)


def _tableau_args(method):
    frac, prev, c_sol = _chain_form(method)
    arr = ctypes.c_double * len(c_sol)
    return len(c_sol), arr(*frac), arr(*prev), arr(*c_sol)


def _raise_on(lib, rc, which):
    if rc != 0:
        raise RuntimeError(
            f"fused fixed-step {which} kernel failed: "
            f"{lib.ff_error_string(rc).decode()} (code {rc})")


def _shapes(ct, z0t, w1t, w2t):
    n, three, C, B = ct.shape
    H, W = z0t.shape[0], w1t.shape[0]
    if (three != 3 or z0t.shape != (H, B) or w1t.shape != (W, H)
            or w2t.shape != (C * H, W)):
        raise ValueError("inconsistent fused-solve operand shapes")
    return n, C, B, H, W


def _slab_mode(ct):
    """The kernels' mode: 1 for a bfloat16 slab table (bfloat16 operands in
    the stage products), 0 for float32."""
    if ct.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ct must be float32 or bfloat16, found {ct.dtype}")
    return int(ct.dtype == torch.bfloat16)


PLAN_KEYS = ("streamed", "blocks", "threads", "lanes_per_block", "threads_per_lane", "slices",
             "resident_per_sm", "sms", "shared_bytes", "scratch_floats")


def _plan(which, B, H, C, W, plan, mode, device):
    lib = _library()
    out = (ctypes.c_long * len(PLAN_KEYS))()
    planner = lib.ff_forward_plan if which == "forward" else lib.ff_backward_plan
    with torch.cuda.device(device):
        rc = planner(B, H, C, W, plan.m, len(_chain_form(plan.method)[2]), mode, out)
    _raise_on(lib, rc, which)
    return dict(zip(PLAN_KEYS, out))


def forward_plan(B, H, C, W, plan, mode, device):
    """The forward kernel's launch for these shapes in ``mode`` (0 float32,
    1 bfloat16), as a dict (``PLAN_KEYS``): the weights' path (0 resident in
    shared memory, 1 streamed through it), blocks, threads per block, lanes a
    block walks at once, threads per lane, state slices per lane, blocks an
    SM holds, the card's SMs, the shared memory of a block and the floats of
    the staged weights' scratch (0 when resident).  The kernel launches as
    many blocks as the SMs of ``device`` hold at once, striding over the
    lanes beyond that."""
    return _plan("forward", B, H, C, W, plan, mode, device)


def backward_plan(B, H, C, W, plan, mode, device):
    """The backward kernel's launch, as ``forward_plan`` gives the
    forward's; its blocks are the leading size of the weight partials."""
    return _plan("backward", B, H, C, W, plan, mode, device)


def launch_forward(ct, z0t, w1t, b1, w2t, b2, plan):
    """Forward kernel: returns (out (n_out, H, B), zres (n, H, B)), float32.

    A bfloat16 ``ct`` launches the bfloat16 mode; the other operands are
    float32 either way."""
    global FWD_LAUNCHES, BF16_FWD_LAUNCHES
    mode = _slab_mode(ct)
    ops = (ct, z0t, w1t, b1, w2t, b2)
    check_operands(ops, ("ct", "z0t", "w1t", "b1", "w2t", "b2"), dtypes={"ct": ct.dtype})
    n, C, B, H, W = _shapes(ct, z0t, w1t, w2t)
    launch = forward_plan(B, H, C, W, plan, mode, ct.device)
    out = torch.empty((len(plan.out_knots), H, B), dtype=z0t.dtype, device=ct.device)
    zres = torch.empty((n, H, B), dtype=z0t.dtype, device=ct.device)
    _forward_kernel(ops, (out, zres), (B, n, H, C, W), plan, mode, launch)
    FWD_LAUNCHES += 1
    BF16_FWD_LAUNCHES += mode
    return out, zres


def _forward_kernel(ops, outs, shape, plan, mode, launch):
    """The forward kernel on ``ops`` into ``outs`` (out, zres), in ``mode``,
    as ``launch`` (``forward_plan``) plans it."""
    lib = _library()
    B, n, H, C, W = shape
    slot = _knot_slots(plan.out_knots, n, ops[0].device)
    _buf, scratch = scratch_buffer(launch["scratch_floats"], ops[0])
    ptrs = [t.data_ptr() for t in (*ops, slot, *outs)]
    with torch.cuda.device(ops[0].device):
        rc = lib.ff_forward(*ptrs, scratch, B, n, H, C, W, plan.m, plan.dt_sub,
                            *_tableau_args(plan.method), mode, launch["blocks"],
                            stream_of(ops[0]))
    _raise_on(lib, rc, "forward")


def launch_backward(ct, zres, z0t, gz, w1t, b1, w2t, b2, plan):
    """Backward kernel: returns (dct, dz0, dw1t, db1, dw2t, db2); dct in
    ct's dtype, the others float32."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    mode = _slab_mode(ct)
    ops = (ct, zres, z0t, gz, w1t, b1, w2t, b2)
    check_operands(ops, ("ct", "zres", "z0t", "gz", "w1t", "b1", "w2t", "b2"),
                   dtypes={"ct": ct.dtype})
    n, C, B, H, W = _shapes(ct, z0t, w1t, w2t)
    if zres.shape != (n, H, B) or gz.shape != (len(plan.out_knots), H, B):
        raise ValueError("inconsistent fused-solve cotangent shapes")
    launch = backward_plan(B, H, C, W, plan, mode, ct.device)
    blocks = launch["blocks"]
    empty = functools.partial(torch.empty, dtype=z0t.dtype, device=ct.device)
    outs = (torch.empty_like(ct), empty((H, B)), empty((blocks, W, H)), empty((blocks, W)),
            empty((blocks, W, C * H)), empty((blocks, C * H)))
    _backward_kernel(ops, outs, (B, n, H, C, W), plan, mode, launch)
    BWD_LAUNCHES += 1
    BF16_BWD_LAUNCHES += mode
    dct, dz0, dw1p, db1p, dw2p, db2p = outs
    # Per-block partials are summed after the launch (deterministic).
    return (dct, dz0, dw1p.sum(0), db1p.sum(0), dw2p.sum(0).t(), db2p.sum(0))


def _backward_kernel(ops, outs, shape, plan, mode, launch):
    """The backward kernel on ``ops`` into ``outs`` (dct, dz0 and the
    partials), in ``mode``, as ``launch`` (``backward_plan``) plans it."""
    lib = _library()
    B, n, H, C, W = shape
    slot = _knot_slots(plan.out_knots, n, ops[0].device)
    _buf, scratch = scratch_buffer(launch["scratch_floats"], ops[0])
    ptrs = [t.data_ptr() for t in (*ops, slot, *outs)]
    with torch.cuda.device(ops[0].device):
        rc = lib.ff_backward(*ptrs, scratch, B, n, H, C, W, plan.m, plan.dt_sub,
                             *_tableau_args(plan.method), mode, launch["blocks"],
                             stream_of(ops[0]))
    _raise_on(lib, rc, "backward")


class _FusedFixedSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, z0t, w1t, b1, w2t, b2, plan):
        out, zres = launch_forward(ct, z0t, w1t, b1, w2t, b2, plan)
        ctx.save_for_backward(ct, zres, z0t, w1t, b1, w2t, b2)
        ctx.plan = plan
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        ct, zres, z0t, w1t, b1, w2t, b2 = ctx.saved_tensors
        grads = launch_backward(ct, zres, z0t, gout.contiguous(), w1t, b1,
                                w2t, b2, ctx.plan)
        return grads + (None,)


def fused_fixed_solve(ct, z0t, w1t, b1, w2t, b2, method, m, dt_sub, out_knots):
    """The fused solve over packed operands (see ``pack_operands``); a
    bfloat16 slab table runs the bfloat16 mode.

    CUDA tensors run the kernels; CPU tensors run the plain version."""
    if ct.is_cuda:
        plan = _Plan(method, int(m), float(dt_sub), tuple(out_knots))
        return _FusedFixedSolve.apply(ct, z0t, w1t, b1, w2t, b2, plan)
    if ct.device.type != "cpu":
        raise ValueError(f"no fused fixed-step solve for device {ct.device}")
    return fused_fixed_solve_reference(ct, z0t, w1t, b1, w2t, b2, method, m,
                                       dt_sub, out_knots)


def try_fused_mlp(rows, z0, field, method, m, dt_sub, n, out_knots=None):
    """Attempt the fused solve.

    rows: (b, two_c, three_d) spline rows, each (..., n, C); z0 (..., H);
    field: an ``MLPVectorField``; m substeps of size dt_sub per interval;
    out_knots: increasing knot indices in [0, n] to return (None: all).
    Returns the states at ``out_knots``, time leading, or None when the
    solve is not eligible."""
    if method not in TABLEAUS or m > MAX_SUBSTEPS:
        return None
    if out_knots is None:
        out_knots = tuple(range(n + 1))
    kernel_knots = tuple(int(k) for k in out_knots if k > 0)
    if not kernel_knots:
        return None
    p = pack_operands(*rows, z0, field, ct_store="native")
    if p is None:
        return None
    outk = fused_fixed_solve(p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2, method, m,
                             dt_sub, kernel_knots)
    sel = outk.permute(0, 2, 1).reshape((len(kernel_knots),) + p.batch + (p.H,))
    if 0 in out_knots:  # knot 0 is z0 itself
        z0b = p.z0f.reshape(p.batch + (p.H,))
        sel = torch.cat([z0b[None], sel], dim=0)
    return sel.to(p.out_dtype)
