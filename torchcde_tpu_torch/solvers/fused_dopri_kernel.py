"""One chunk of the adaptive dopri5 Neural CDE solve as a CUDA kernel pair.

Replaces ``torchcde_tpu/solvers/fused_dopri_pallas.py::_dopri_fwd_kernel``
and ``_dopri_bwd_kernel`` (built by ``_make_fused_dopri``), for cubic
controls and in their linear-control mode (``Plan.linear``, ``Plan.lead``).
The kernels live in ``csrc/fused_dopri.cu``, whose header notes what bounds
them on the card and what their design does about it.  This
module holds what surrounds them:

* ``fused_dopri5_solve_reference``: the plain PyTorch version of the forward
  kernel's function, the whole PI-controlled solve of one chunk for one group
  of lanes, on the packed operands of ``fused_fixed_kernel.pack_operands``;
* ``fused_dopri5_replay``: the plain version of the backward kernel's
  function, a replay of a given accepted-step mesh (the fixed sequence of
  dopri5 steps plus the quartic dense output), differentiable by autograd;
* ``fused_dopri5_solve``: launches the kernels for CUDA tensors (through a
  ``torch.autograd.Function`` whose backward is the backward kernel) and runs
  the plain versions for CPU tensors; ``padded_weights`` pads the field once
  per solve for both directions of every launch;
* ``FWD_LAUNCHES`` / ``BWD_LAUNCHES``: counts of kernel launches, and
  ``LINEAR_FWD_LAUNCHES`` / ``LINEAR_BWD_LAUNCHES`` of those in linear mode.

Times and step sizes are carried in the state's precision: float32 in the
kernel (as the JAX kernel carries them) and in the plain version on float32
tensors, float64 in the plain version on float64 tensors.  One error norm
(the root mean square over every lane and hidden channel) controls the whole
group.  A CUDA tensor never runs the plain version: the kernel launches or
raises.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..ops.dispatch import check_operands, stream_of
from ..utils.misc import numpy_dtype
from .integrate import _QUARTIC_MINV
from .runge_kutta import DOPRI5, DOPRI5_BMID
from .team import (sum_team_partials, team_forward_plan, team_partials, team_plan,
                   team_weights)

MAX_TILE = 4096      # lanes per group: one error norm couples one group
MAX_INTERVALS = 128  # intervals per chunk
MAX_OUT_TIMES = 64   # dense-output rows per chunk
STORE_CAP = 2048     # accepted-step trajectory rows

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
LINEAR_FWD_LAUNCHES = 0
LINEAR_BWD_LAUNCHES = 0


def reset_launch_counts():
    global FWD_LAUNCHES, BWD_LAUNCHES, LINEAR_FWD_LAUNCHES, LINEAR_BWD_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = LINEAR_FWD_LAUNCHES = LINEAR_BWD_LAUNCHES = 0


class Plan(NamedTuple):
    """One chunk solve over [t_start, t_end] (static, like the JAX kernel's
    closure): output times in (t_start, t_end], the uniform grid's first
    knot t0g and spacing w, the controller's constants and the step budget
    (cap: attempted steps and stored accepted steps).  ``linear``: the
    table holds a linear control's slopes, read left-continuously at knots;
    ``lead``: its first row is the interval left of t0g (see ``_field``)."""
    out_ts: tuple
    t_start: float
    t_end: float
    t0g: float
    w: float
    rtol: float
    atol: float
    cap: int
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    linear: bool = False
    lead: bool = False


class Mesh(NamedTuple):
    """The realised accepted-step mesh: step start times and sizes, in the
    precision the forward carried them, and the attempted-step count."""
    t: np.ndarray
    dt: np.ndarray
    attempted: int


def _field(ct, w1t, b1, w2t, b2, plan, sc):
    """f(y (B, H), host time) -> k (B, H) at the time's interval of the
    uniform grid, clamped to the table; positions are computed in the time
    type sc, by the kernel's rule.

    Cubic (ct (n, 3, C, B)): interval floor((t - t0g) / w) and the monomials
    at the fraction.  Linear (ct (n, 1, C, B), the slopes): interval
    ceil((t - t0g) / w) - 1, so that a time exactly on a knot reads the
    slope on its left, as ``LinearInterpolation.derivative`` does; with
    ``plan.lead`` row 0 is the interval left of t0g and the rule drops the
    - 1 (``fused_dopri_pallas.py::_slab_at``)."""
    n, _, C, B = ct.shape
    H = w1t.shape[1]
    slab = ct.permute(0, 3, 1, 2)  # (n, B, R, C)
    t0g, w = sc(plan.t0g), sc(plan.w)

    def f(y, tval):
        pos = (tval - t0g) / w
        if plan.linear:
            j = int(min(max(np.ceil(pos) - (0 if plan.lead else 1), 0), n - 1))
            dx = slab[j, :, 0]
        else:
            j = int(min(max(np.floor(pos), 0), n - 1))
            fr = float(tval - (t0g + sc(j) * w))
            dx = slab[j, :, 0] + (slab[j, :, 1] + slab[j, :, 2] * fr) * fr
        h1 = torch.relu(y @ w1t.t() + b1)
        g = torch.tanh(h1 @ w2t.t() + b2)
        return (g.reshape(B, C, H) * dx[:, :, None]).sum(dim=1)

    return f


def _axpy(z, dt, coeffs, ks):
    """z + sum_q (dt * coeffs[q]) ks[q], skipping zeros, in the JAX kernel's
    order; dt * coeffs[q] rounds in the time precision."""
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            z = z + float(dt * type(dt)(c)) * k
    return z


def _stages(f, z, k0, t, dt):
    """The seven dopri5 stages of the step (t, dt) from z, first stage k0."""
    sc = type(dt)
    ks = [k0]
    for alpha, beta in zip(DOPRI5.alpha, DOPRI5.beta):
        ks.append(f(_axpy(z, dt, beta, ks), t + sc(alpha) * dt))
    return ks


def _dense(z, z1, ks, dt, theta):
    """The quartic dense output at theta in the JAX kernel's (cA, cB, cC) form."""
    sc = type(dt)
    m = _QUARTIC_MINV
    p2 = theta * theta
    p3, p4 = p2 * theta, p2 * theta * theta
    cA = p2 * sc(m[2][0]) + p3 * sc(m[1][0]) + p4 * sc(m[0][0])
    cB = p2 * sc(m[2][1]) + p3 * sc(m[1][1]) + p4 * sc(m[0][1])
    cC = p2 * sc(m[2][2]) + p3 * sc(m[1][2]) + p4 * sc(m[0][2])
    y_mid = _axpy(z, dt, DOPRI5_BMID, ks)
    rA = z1 - z - float(dt) * ks[0]
    rB = float(dt) * (ks[-1] - ks[0])
    rC = y_mid - z - float(sc(0.5) * dt) * ks[0]
    return (z + float(theta * dt) * ks[0] + float(cA) * rA + float(cB) * rB
            + float(cC) * rC)


def _emit(plan, out, z, z1, ks, t, dt):
    """Writes the dense output at every output time in (t, t + dt]."""
    sc = type(dt)
    for k, tk in enumerate(plan.out_ts):
        tk = sc(tk)
        if t < tk <= t + dt:
            theta = min(max((tk - t) / max(dt, sc(1e-30)), sc(0.0)), sc(1.0))
            out[k] = _dense(z, z1, ks, dt, theta)


def _poison(zout, zfin):
    """NaN everywhere, as the kernel writes when the budget ran out."""
    on = torch.ones((), dtype=torch.bool, device=zfin.device)
    return (torch.where(on, torch.full_like(zout, math.nan), zout),
            torch.where(on, torch.full_like(zfin, math.nan), zfin))


@torch.no_grad()
def fused_dopri5_solve_reference(ct, z0t, w1t, b1, w2t, b2, dt0, plan):
    """Plain PyTorch version of the forward kernel's function.

    ct (n, R, C, B), z0t (H, B), the packed field, dt0 (1,) the proposal
    to start from.  Returns (zout (n_out, H, B), zfin (H, B), dtfin (1,),
    mesh): outputs at ``plan.out_ts`` (z0 where no accepted step reached
    them), the state at t_end and the step proposal there; NaN in zout and
    zfin if the budget ran out first."""
    sc = numpy_dtype(ct.dtype).type
    f = _field(ct, w1t, b1, w2t, b2, plan, sc)
    H, B = z0t.shape
    z = z0t.t()
    out = [z] * len(plan.out_ts)
    t, t1, dt = sc(plan.t_start), sc(plan.t_end), sc(dt0.reshape(()).item())
    k0 = f(z, t)
    mesh_t, mesh_dt, attempted = [], [], 0
    while t < t1 and attempted < plan.cap and len(mesh_t) < plan.cap:
        dt = max(dt, sc(1e-14))
        dt_c = min(dt, t1 - t)
        ks = _stages(f, z, k0, t, dt_c)
        z1 = _axpy(z, dt_c, DOPRI5.c_sol, ks)
        err = None
        for c, k in zip(DOPRI5.c_error, ks):
            if c != 0.0:
                err = c * k if err is None else err + c * k
        err = float(dt_c) * err
        scaled = err / (plan.atol + plan.rtol * torch.maximum(torch.abs(z), torch.abs(z1)))
        ratio = sc(torch.sqrt(torch.sum(scaled * scaled) / float(B * H)).item())
        accept = bool(ratio <= 1.0)
        # integrate.py's controller in the JAX kernel's form.
        factor = sc(plan.safety) * np.exp(sc(-1.0 / DOPRI5.order) * np.log(max(ratio, sc(1e-10))))
        if not math.isfinite(factor):
            factor = sc(plan.dfactor)
        upper = sc(plan.ifactor) if accept else sc(1.0)
        dt_new = dt_c * min(max(factor, sc(plan.dfactor)), upper)
        if accept and dt_c < dt:
            dt_new = max(dt, dt_new)
        if accept:
            mesh_t.append(t)
            mesh_dt.append(dt_c)
            _emit(plan, out, z, z1, ks, t, dt_c)
            z, k0, t = z1, ks[-1], t + dt_c
        dt = dt_new
        attempted += 1
    zout = torch.stack(out).transpose(1, 2) if out else z0t.new_zeros((0, H, B))
    zfin = z.t()
    if t < t1:
        zout, zfin = _poison(zout, zfin)
    mesh = Mesh(np.array(mesh_t, dtype=sc), np.array(mesh_dt, dtype=sc), attempted)
    return (zout.contiguous(), zfin.contiguous(),
            torch.tensor([dt], dtype=ct.dtype, device=ct.device), mesh)


def reaches_end(mesh, plan):
    """Whether the mesh reached t_end, as its forward decided it: the last
    step's end in the precision the mesh was carried in."""
    sc = mesh.t.dtype.type
    end = mesh.t[-1] + mesh.dt[-1] if len(mesh.t) else sc(plan.t_start)
    return bool(end >= sc(plan.t_end))


def fused_dopri5_replay(ct, z0t, w1t, b1, w2t, b2, mesh, plan):
    """Plain version of the backward kernel's function: the given mesh's
    steps and dense output replayed in ct's precision, differentiable by
    autograd.  The mesh's own times (stage times, intervals, fractions, step
    coefficients) are computed in the precision the mesh was carried in, as
    its forward computed them.  Returns (zout (n_out, H, B), zfin (H, B))."""
    f = _field(ct, w1t, b1, w2t, b2, plan, mesh.t.dtype.type)
    H, B = z0t.shape
    z = z0t.t()
    out = [z] * len(plan.out_ts)
    for t, dt in zip(mesh.t, mesh.dt):
        ks = _stages(f, z, f(z, t), t, dt)
        z1 = _axpy(z, dt, DOPRI5.c_sol, ks)
        _emit(plan, out, z, z1, ks, t, dt)
        z = z1
    zout = torch.stack(out).transpose(1, 2) if out else z0t.new_zeros((0, H, B))
    zfin = z.t()
    if not reaches_end(mesh, plan):
        zout, zfin = _poison(zout, zfin)
    return zout, zfin


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_fd_declared", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fp = ctypes.POINTER(ctypes.c_float)
        lib.fd_forward.argtypes = [p] * 15 + [i] * 7 + [fp, fp] + [f] * 9 + [i] * 4 + [p]
        lib.fd_forward.restype = i
        lib.fd_backward.argtypes = [p] * 17 + [i] * 6 + [fp, fp] + [f] * 2 + [i] * 4 + [p]
        lib.fd_backward.restype = i
        lib.fd_error_string.argtypes = [i]
        lib.fd_error_string.restype = ctypes.c_char_p
        lib._fd_declared = True
    return lib


def _shapes(ct, z0t, w1t, w2t, plan):
    n, rows, C, B = ct.shape
    H, W = z0t.shape[0], w1t.shape[0]
    if (rows != (1 if plan.linear else 3) or z0t.shape != (H, B) or w1t.shape != (W, H)
            or w2t.shape != (C * H, W)):
        raise ValueError("inconsistent fused-solve operand shapes")
    return n, C, B, H, W


def _raise_on(lib, rc, which):
    if rc != 0:
        raise RuntimeError(
            f"fused dopri5 {which} kernel failed: "
            f"{lib.fd_error_string(rc).decode()} (code {rc})")


def _out_times(plan):
    """The plan's output times and the dense output's constants (the midpoint
    weights, then the quartic's inverse system), as the kernels take them."""
    if len(plan.out_ts) > MAX_OUT_TIMES:
        raise ValueError(f"at most {MAX_OUT_TIMES} output times per chunk")
    dense = tuple(DOPRI5_BMID) + tuple(float(v) for v in _QUARTIC_MINV.reshape(-1))
    return ((ctypes.c_float * max(len(plan.out_ts), 1))(*plan.out_ts),
            (ctypes.c_float * len(dense))(*dense))


def padded_weights(ct, w1t, b1, w2t, b2):
    """The field padded for the team kernels (``team.team_weights``) where
    ct runs the kernels, else None: a solve pads once and passes the result
    to every launch, forward and backward."""
    return team_weights(w1t, b1, w2t, b2) if _runs_kernel(ct) else None


def _forward_kernel(lib, tensors, sizes, plan, layout):
    """The forward kernel's launch over ``fd_forward``'s tensors, in its
    order, sizes (B, n, H, C, W) and its plan's blocks and row length;
    returns its code."""
    with torch.cuda.device(tensors[0].device):
        return lib.fd_forward(*(t.data_ptr() for t in tensors), *sizes, plan.cap,
                              len(plan.out_ts), *_out_times(plan), plan.t_start, plan.t_end,
                              plan.t0g, plan.w, plan.rtol, plan.atol, plan.safety, plan.ifactor,
                              plan.dfactor, int(plan.linear), int(plan.lead), *layout,
                              stream_of(tensors[0]))


def launch_forward(ct, z0t, w1t, b1, w2t, b2, dt0, plan, weights=None):
    """Forward kernel: returns (zout, zfin, dtfin, store) with store =
    (zst (cap, H, B), tst (cap,), dtst (cap,), stats (2,) int32: accepted and
    attempted steps), all left on the device.  A team of threads per lane,
    for every shape, on the padded ``weights`` (``padded_weights``; padded
    here if not given); a shape that no launch plan fits raises."""
    global FWD_LAUNCHES, LINEAR_FWD_LAUNCHES
    ops = (ct, z0t, w1t, b1, w2t, b2, dt0)
    check_operands(ops, ("ct", "z0t", "w1t", "b1", "w2t", "b2", "dt0"))
    n, C, B, H, W = _shapes(ct, z0t, w1t, w2t, plan)
    lib = _library()
    weights = team_weights(w1t, b1, w2t, b2) if weights is None else weights
    team = team_forward_plan(B, H, C, W, cooperative=True)
    if weights.w1.shape[1] != team["row"]:
        raise ValueError("padded weights of another row length than the team plan's")
    empty = functools.partial(torch.empty, dtype=ct.dtype, device=ct.device)
    zout, zfin, dtfin = empty((len(plan.out_ts), H, B)), empty((H, B)), empty((1,))
    zst, tst, dtst = empty((plan.cap, H, B)), empty((plan.cap,)), empty((plan.cap,))
    stats = torch.empty(2, dtype=torch.int32, device=ct.device)
    scratch = torch.zeros(team["scratch_floats"], dtype=ct.dtype, device=ct.device)
    rc = _forward_kernel(lib, (ct, z0t, *weights[:4], dt0, zout, zfin, dtfin, zst, tst, dtst,
                               stats, scratch), (B, n, H, C, W), plan,
                         (team["blocks"], team["row"]))
    _raise_on(lib, rc, "forward")
    FWD_LAUNCHES += 1
    LINEAR_FWD_LAUNCHES += int(plan.linear)
    return zout, zfin, dtfin, (zst, tst, dtst, stats)


def _backward_kernel(lib, tensors, sizes, plan, layout):
    """The backward kernel's launch over ``fd_backward``'s tensors, in its
    order, sizes (B, n, H, C, W, n_out) and the team plan's slots and row;
    returns its code."""
    with torch.cuda.device(tensors[0].device):
        return lib.fd_backward(*(t.data_ptr() for t in tensors), *sizes, *_out_times(plan),
                               plan.t0g, plan.w, int(plan.linear), int(plan.lead), *layout,
                               stream_of(tensors[0]))


def launch_backward(ct, store, gzout, gzfin, w1t, b1, w2t, b2, plan, weights=None):
    """Backward kernel over the stored mesh, a team of threads per lane, for
    every shape, on the padded ``weights`` (padded here if not given):
    returns (dct, dz0, dw1t, db1, dw2t, db2) for the cotangents of zout and
    zfin."""
    global BWD_LAUNCHES, LINEAR_BWD_LAUNCHES
    zst, tst, dtst, stats = store
    ops = (ct, zst, tst, dtst, gzout, gzfin, w1t, b1, w2t, b2)
    check_operands(ops, ("ct", "zst", "tst", "dtst", "gzout", "gzfin", "w1t", "b1", "w2t", "b2"))
    n, C, B, H, W = _shapes(ct, gzfin, w1t, w2t, plan)
    if (gzfin.shape != (H, B) or gzout.shape != (len(plan.out_ts), H, B)
            or zst.shape != (plan.cap, H, B) or stats.dtype != torch.int32):
        raise ValueError("inconsistent fused dopri5 cotangent or store shapes")
    lib = _library()
    team = team_plan(B, H, C, W)
    zeros = functools.partial(torch.zeros, dtype=ct.dtype, device=ct.device)
    dct, dz0 = zeros(ct.shape), zeros((H, B))
    weights = team_weights(w1t, b1, w2t, b2) if weights is None else weights
    if weights.w1.shape[1] != team["row"]:
        raise ValueError("padded weights of another row length than the team plan's")
    partials = team_partials(team["slots"], H, C, team["row"], ct.dtype, ct.device)
    rc = _backward_kernel(lib, (*ops[:6], *weights[:4], stats, dct, dz0, *partials),
                          (B, n, H, C, W, len(plan.out_ts)), plan, (team["slots"], team["row"]))
    _raise_on(lib, rc, "backward")
    BWD_LAUNCHES += 1
    LINEAR_BWD_LAUNCHES += int(plan.linear)
    # The partials are summed after the launch (deterministic).
    return (dct, dz0, *sum_team_partials(*partials, W))


def read_mesh(store):
    """The kernel's realised mesh, read back to the host (for comparisons)."""
    zst, tst, dtst, stats = store
    cnt, attempted = (int(v) for v in stats.cpu())
    return Mesh(tst[:cnt].cpu().numpy(), dtst[:cnt].cpu().numpy(), attempted)


def _runs_kernel(ct):
    """CUDA tensors run the kernels, CPU tensors the plain versions."""
    if ct.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused dopri5 solve for device {ct.device}")
    return ct.is_cuda


class _FusedDopriSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, z0t, w1t, b1, w2t, b2, dt0, plan, weights):
        ctx.plan, ctx.kernel = plan, _runs_kernel(ct)
        if ctx.kernel:
            ctx.weights = weights
            zout, zfin, dtfin, store = launch_forward(ct, z0t, w1t, b1, w2t, b2, dt0, plan,
                                                      weights=weights)
            ctx.save_for_backward(ct, w1t, b1, w2t, b2, *store)
        else:
            zout, zfin, dtfin, ctx.mesh = fused_dopri5_solve_reference(
                ct, z0t, w1t, b1, w2t, b2, dt0, plan)
            ctx.save_for_backward(ct, z0t, w1t, b1, w2t, b2)
        ctx.mark_non_differentiable(dtfin)
        return zout, zfin, dtfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gzout, gzfin, _gdtfin):
        if ctx.kernel:
            ct, w1t, b1, w2t, b2, *store = ctx.saved_tensors
            grads = launch_backward(ct, store, gzout.contiguous(), gzfin.contiguous(),
                                    w1t, b1, w2t, b2, ctx.plan, weights=ctx.weights)
        else:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
                outs = fused_dopri5_replay(*leaves, ctx.mesh, ctx.plan)
                pairs = [(o, g) for o, g in zip(outs, (gzout, gzfin)) if o.requires_grad]
                grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                            [g for _, g in pairs], allow_unused=True)
        return (*grads, None, None, None)


def fused_dopri5_solve(ct, z0t, w1t, b1, w2t, b2, dt0, plan, weights=None):
    """One chunk solve for one group over packed operands (see
    ``fused_fixed_kernel.pack_operands``): (zout, zfin, dtfin).

    CUDA tensors run the kernels, on the padded ``weights`` of the solve
    (``padded_weights``; each launch pads its own if not given); CPU tensors
    run the plain versions."""
    return _FusedDopriSolve.apply(ct, z0t, w1t, b1, w2t, b2, dt0, plan, weights)
