"""One chunk of the per-sample adaptive dopri5 Neural CDE solve as a CUDA
kernel pair (K9).

Replaces ``torchcde_tpu/solvers/fused_dopri_persample.py::_psd_fwd_kernel``
and ``_psd_bwd_kernel`` (built by ``_make_fused_dopri_ps``), for cubic
controls and in their linear-control mode (``PsPlan.linear``,
``PsPlan.lead``).  Every lane has its own time, step proposal, PI controller
and error norm over its own hidden channels, its own step budget and its own
output times.  The kernels live in ``csrc/fused_dopri_persample.cu``, whose
header notes what bounds them on the card and what their design does about
it.  This module holds what surrounds them:

* ``fused_dopri5_per_sample_reference``: the plain PyTorch version of the
  forward kernel's function, the lanes in lockstep with per-lane masks, as
  the JAX kernel runs them;
* ``fused_dopri5_per_sample_replay``: the plain version of the backward
  kernel's function, a replay of given per-lane accepted-step meshes,
  differentiable by autograd;
* ``fused_dopri5_per_sample_solve``: launches the kernels for CUDA tensors
  (through a ``torch.autograd.Function`` whose backward is the backward
  kernel) and runs the plain versions for CPU tensors; ``padded_weights``
  pads the field once per solve for both directions of every launch;
* ``FWD_LAUNCHES`` / ``BWD_LAUNCHES``: counts of kernel launches, and
  ``LINEAR_FWD_LAUNCHES`` / ``LINEAR_BWD_LAUNCHES`` of those in linear mode.

The chunk's operands: ct (n, R, C, B) the packed table of
``fused_fixed_kernel.pack_operands``; z0t (H, B); ctl (4, B) the carried
controller rows (t, step proposal, attempted steps so far, poisoned); ts_rows
(n_out, B) each lane's output times; tend (B,) each lane's end; zout_in
(n_out, H, B) the output rows so far.  Times are carried in the tensors'
precision: float32 in the kernel (as the JAX kernel carries them) and in the
plain version on float32 tensors, float64 in the plain version on float64
tensors.  A CUDA tensor never runs the plain version: the kernel launches or
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
from .integrate import _QUARTIC_MINV
from .runge_kutta import DOPRI5, DOPRI5_BMID
from .team import (sum_team_partials, team_forward_plan, team_partials, team_plan,
                   team_weights)

MAX_INTERVALS = 128  # intervals per chunk
MAX_OUT_TIMES = 64   # output rows per lane
STORE_CAP = 2048     # attempted steps per lane and chunk

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
LINEAR_FWD_LAUNCHES = 0
LINEAR_BWD_LAUNCHES = 0


def reset_launch_counts():
    global FWD_LAUNCHES, BWD_LAUNCHES, LINEAR_FWD_LAUNCHES, LINEAR_BWD_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = LINEAR_FWD_LAUNCHES = LINEAR_BWD_LAUNCHES = 0


class PsPlan(NamedTuple):
    """One chunk (static, like the JAX kernel's closure): its end, the
    uniform grid's first knot t0g and spacing w, the controller's constants,
    the global step budget (attempted steps, counted across chunks) and the
    chunk's cap on each lane's attempted steps.  ``linear``: the table holds
    a linear control's slopes, read left-continuously at knots; ``lead``: its
    first row is the interval left of t0g."""
    t_chunk_end: float
    t0g: float
    w: float
    rtol: float
    atol: float
    budget: float
    cap: int
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    linear: bool = False
    lead: bool = False


class PsMesh(NamedTuple):
    """The realised per-lane meshes: each lane's accepted steps (t, dt) in
    the precision the forward carried them (steps past a lane's count are
    padding), the counts, and the lanes that ended poisoned."""
    t: np.ndarray     # (S, B)
    dt: np.ndarray    # (S, B)
    cnt: np.ndarray   # (B,) accepted steps
    bad: np.ndarray   # (B,) bool


def _lane_dx(ct, t, plan, time_dtype):
    """dX/dt of each lane at its own time t (B,) on the chunk's uniform grid:
    (dx (B, C), interval j (B,)).  Cubic: j = floor((t - t0g) / w) and the
    rows at the fraction; linear: j = ceil((t - t0g) / w) - 1, the slope on
    the left of a knot, or ceil((t - t0g) / w) with ``plan.lead`` (row 0 is
    the interval left of t0g).  j is clamped to the table; positions are in
    time_dtype, by the kernel's rule."""
    return _lane_reader(ct, plan, time_dtype)(t)


def _lane_reader(ct, plan, time_dtype):
    """``_lane_dx`` as a function of t, its constants made once: a tensor
    made from a host number on the card waits for the stream."""
    n, _, C, B = ct.shape
    lanes = torch.arange(B, device=ct.device)
    t0g = torch.tensor(plan.t0g, dtype=time_dtype, device=ct.device)
    w = torch.tensor(plan.w, dtype=time_dtype, device=ct.device)

    def read(t):
        pos = (t - t0g) / w
        if plan.linear:
            j = torch.clamp(torch.ceil(pos) - (0 if plan.lead else 1), 0, n - 1).long()
            return ct[j, 0, :, lanes], j
        j = torch.clamp(torch.floor(pos), 0, n - 1).long()
        fr = (t - (t0g + j.to(time_dtype) * w)).to(ct.dtype)[:, None]
        return ct[j, 0, :, lanes] + (ct[j, 1, :, lanes] + ct[j, 2, :, lanes] * fr) * fr, j

    return read


def _lane_field(ct, w1t, b1, w2t, b2, plan, time_dtype):
    """f(y (B, H), t (B,)) -> k (B, H): each lane reads its own interval
    (``_lane_dx``)."""
    _, _, C, B = ct.shape
    H = w1t.shape[1]
    lane_dx = _lane_reader(ct, plan, time_dtype)

    def f(y, t):
        dx, _ = lane_dx(t)
        h1 = torch.relu(y @ w1t.t() + b1)
        g = torch.tanh(h1 @ w2t.t() + b2)
        return (g.reshape(B, C, H) * dx[:, :, None]).sum(dim=1)

    return f


def _axpy(z, dt, coeffs, ks):
    """z + sum_q (dt * coeffs[q]) ks[q] per lane, skipping zeros, in the JAX
    kernel's order; dt * coeffs[q] rounds in dt's precision."""
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            z = z + (dt * c).to(z.dtype)[:, None] * k
    return z


def _stages(f, z, k0, t, dt):
    """The seven dopri5 stages of each lane's step (t, dt) from z."""
    ks = [k0]
    for alpha, beta in zip(DOPRI5.alpha, DOPRI5.beta):
        ks.append(f(_axpy(z, dt, beta, ks), t + alpha * dt))
    return ks


def _emit(zo, ts_rows, on, z, z1, ks, t, dt):
    """Writes each lane's dense output at its output times in (t, t + dt],
    where ``on`` (the lanes that accepted a step)."""
    m = _QUARTIC_MINV
    y_mid = _axpy(z, dt, DOPRI5_BMID, ks)
    h = dt.to(z.dtype)[:, None]
    rA = z1 - z - h * ks[0]
    rB = h * (ks[-1] - ks[0])
    rC = y_mid - z - (0.5 * dt).to(z.dtype)[:, None] * ks[0]
    for k in range(len(zo)):
        tk = ts_rows[k]
        hit = on & (tk > t) & (tk <= t + dt)
        theta = torch.clamp((tk - t) / torch.clamp(dt, min=1e-30), 0.0, 1.0)
        p2 = theta * theta
        p3 = p2 * theta
        p4 = p3 * theta
        cA = p2 * m[2][0] + p3 * m[1][0] + p4 * m[0][0]
        cB = p2 * m[2][1] + p3 * m[1][1] + p4 * m[0][1]
        cC = p2 * m[2][2] + p3 * m[1][2] + p4 * m[0][2]
        col = [v.to(z.dtype)[:, None] for v in (theta * dt, cA, cB, cC)]
        val = z + col[0] * ks[0] + col[1] * rA + col[2] * rB + col[3] * rC
        zo[k] = torch.where(hit[:, None], val, zo[k])


def _poison(zo, zfin, ts_rows, t_in, bad):
    """NaN in a lane that ran out of budget, or entered poisoned: its state
    and the rows at or after its chunk-entry time."""
    nan = torch.full_like(zfin, math.nan)
    zo = [torch.where((bad & (ts_rows[k] > t_in))[:, None], nan, zo[k]) for k in range(len(zo))]
    return zo, torch.where(bad[:, None], nan, zfin)


@torch.no_grad()
def fused_dopri5_per_sample_reference(ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in,
                                      plan):
    """Plain PyTorch version of the forward kernel's function: the lanes in
    lockstep, each active until it reaches min(its end, the chunk's end), runs
    out of budget or the chunk's cap, or entered poisoned.

    Returns (zout (n_out, H, B), zfin (H, B), ctlout (4, B), nacc (B,), natt
    (B,), mesh): the output rows, the state, the controller rows carried out
    (t, proposal, attempted so far, poisoned), the accepted steps of the
    chunk and the attempted steps so far, and the realised ``PsMesh``."""
    f = _lane_field(ct, w1t, b1, w2t, b2, plan, ct.dtype)
    H, B = z0t.shape
    z = z0t.t()
    t, dt, att = ctl[0].clone(), ctl[1].clone(), ctl[2].clone()
    pois = ctl[3] > 0.5
    t1 = torch.clamp(tend, max=plan.t_chunk_end)
    t_in = t
    k1 = f(z, t)
    zo = [zout_in[k].t() for k in range(zout_in.shape[0])]
    acc = torch.zeros_like(t)
    mesh_t, mesh_dt, mesh_on = [], [], []
    it = 0
    while it < plan.cap and bool(((t < t1) & (att < plan.budget) & ~pois).any()):
        active = (t < t1) & (att < plan.budget) & ~pois
        dtm = torch.clamp(dt, min=1e-14)
        dc = torch.minimum(dtm, torch.clamp(t1 - t, min=0.0))
        ks = _stages(f, z, k1, t, dc)
        z1 = _axpy(z, dc, DOPRI5.c_sol, ks)
        err = None
        for c, k in zip(DOPRI5.c_error, ks):
            if c != 0.0:
                err = c * k if err is None else err + c * k
        err = dc.to(z.dtype)[:, None] * err
        scaled = err / (plan.atol + plan.rtol * torch.maximum(torch.abs(z), torch.abs(z1)))
        ratio = torch.sqrt(torch.sum(scaled * scaled, dim=1) / float(H)).to(t.dtype)
        accept = (ratio <= 1.0) & active
        # The controller of integrate.py in the JAX kernel's form, per lane.
        factor = plan.safety * torch.exp((-1.0 / DOPRI5.order)
                                         * torch.log(torch.clamp(ratio, min=1e-10)))
        factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, plan.dfactor))
        upper = torch.where(accept, torch.full_like(t, plan.ifactor), torch.ones_like(t))
        dt_new = dc * torch.minimum(torch.clamp(factor, min=plan.dfactor), upper)
        dt_new = torch.where(accept & (dc < dtm), torch.maximum(dtm, dt_new), dt_new)
        mesh_t.append(t)
        mesh_dt.append(dc)
        mesh_on.append(accept)
        _emit(zo, ts_rows, accept, z, z1, ks, t, dc)
        z = torch.where(accept[:, None], z1, z)
        k1 = torch.where(accept[:, None], ks[-1], k1)
        t = torch.where(accept, t + dc, t)
        dt = torch.where(active, dt_new, dt)
        att = att + active.to(att.dtype)
        acc = acc + accept.to(acc.dtype)
        it += 1
    bad = (t < t1) | pois
    zo, zfin = _poison(zo, z, ts_rows, t_in, bad)
    ctlout = torch.stack([t, dt, att, bad.to(t.dtype)])
    return (torch.stack(zo).transpose(1, 2).contiguous(), zfin.t().contiguous(), ctlout, acc, att,
            _compact_mesh(mesh_t, mesh_dt, mesh_on, bad))


def _compact_mesh(mesh_t, mesh_dt, mesh_on, bad):
    """Each lane's accepted steps, in order, from the lockstep iterations."""
    B = bad.shape[0]
    if not mesh_t:
        empty = np.zeros((0, B))
        return PsMesh(empty, empty, np.zeros(B, dtype=np.int64), bad.cpu().numpy())
    ts, dts, on = (torch.stack(v).cpu().numpy() for v in (mesh_t, mesh_dt, mesh_on))
    cnt = on.sum(axis=0)
    t = np.zeros((max(int(cnt.max()), 1), B), dtype=ts.dtype)
    dt = np.zeros_like(t)
    for lane in range(B):
        rows = np.nonzero(on[:, lane])[0]
        t[: len(rows), lane] = ts[rows, lane]
        dt[: len(rows), lane] = dts[rows, lane]
    return PsMesh(t, dt, cnt, bad.cpu().numpy())


def fused_dopri5_per_sample_replay(ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, zout_in, mesh, plan):
    """Plain version of the backward kernel's function: each lane's accepted
    steps and dense output replayed in ct's precision, differentiable by
    autograd.  The mesh's own times (stage times, intervals, fractions, step
    coefficients, thetas) are computed in the precision the mesh was carried
    in, as its forward computed them.  Returns (zout (n_out, H, B), zfin (H,
    B))."""
    time_dtype = torch.from_numpy(mesh.t[:0]).dtype
    f = _lane_field(ct, w1t, b1, w2t, b2, plan, time_dtype)
    dev = ct.device
    rows = ts_rows.detach().to(time_dtype)
    z = z0t.t()
    zo = [zout_in[k].t() for k in range(zout_in.shape[0])]
    cnt = torch.as_tensor(mesh.cnt, device=dev)
    mesh_t, mesh_dt = (torch.as_tensor(a, device=dev) for a in (mesh.t, mesh.dt))
    for s in range(mesh.t.shape[0]):
        on = s < cnt
        t, dt = mesh_t[s], mesh_dt[s]
        ks = _stages(f, z, f(z, t), t, dt)
        z1 = _axpy(z, dt, DOPRI5.c_sol, ks)
        _emit(zo, rows, on, z, z1, ks, t, dt)
        z = torch.where(on[:, None], z1, z)
    bad = torch.as_tensor(mesh.bad, device=dev)
    zo, zfin = _poison(zo, z, rows, ctl[0].detach().to(time_dtype), bad)
    return torch.stack(zo).transpose(1, 2), zfin.t()


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_ps_declared", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fp = ctypes.POINTER(ctypes.c_float)
        lib.ps_forward.argtypes = [p] * 19 + [i] * 7 + [fp] + [f] * 9 + [i] * 4 + [p]
        lib.ps_forward.restype = i
        lib.ps_backward.argtypes = [p] * 19 + [i] * 6 + [fp] + [f] * 2 + [i] * 4 + [p]
        lib.ps_backward.restype = i
        lib.ps_error_string.argtypes = [i]
        lib.ps_error_string.restype = ctypes.c_char_p
        lib._ps_declared = True
    return lib


def _shapes(ct, z0t, w1t, w2t, ts_rows, plan):
    n, rows, C, B = ct.shape
    H, W = z0t.shape[0], w1t.shape[0]
    if (rows != (1 if plan.linear else 3) or z0t.shape != (H, B) or w1t.shape != (W, H)
            or w2t.shape != (C * H, W) or ts_rows.ndim != 2 or ts_rows.shape[1] != B):
        raise ValueError("inconsistent fused per-sample operand shapes")
    if ts_rows.shape[0] > MAX_OUT_TIMES:
        raise ValueError(f"at most {MAX_OUT_TIMES} output times per lane")
    return n, C, B, H, W


def _raise_on(lib, rc, which):
    if rc != 0:
        raise RuntimeError(
            f"fused per-sample dopri5 {which} kernel failed: "
            f"{lib.ps_error_string(rc).decode()} (code {rc})")


def _dense():
    """The dense output's constants as the kernels take them: the midpoint
    weights, then the quartic's inverse system."""
    dense = tuple(DOPRI5_BMID) + tuple(float(v) for v in _QUARTIC_MINV.reshape(-1))
    return (ctypes.c_float * len(dense))(*dense)


def padded_weights(ct, w1t, b1, w2t, b2):
    """The field padded for the team kernels (``team.team_weights``) where
    ct runs the kernels, else None: a solve pads once and passes the result
    to every launch, forward and backward."""
    return team_weights(w1t, b1, w2t, b2) if _runs_kernel(ct) else None


def _forward_kernel(lib, tensors, sizes, plan, layout):
    """The forward kernel's launch over ``ps_forward``'s tensors, in its
    order, sizes (B, n, H, C, W, n_out) and the team plan's blocks and row;
    returns its code."""
    with torch.cuda.device(tensors[0].device):
        return lib.ps_forward(*(t.data_ptr() for t in tensors), *sizes[:5], plan.cap, sizes[5],
                              _dense(), plan.t_chunk_end, plan.t0g, plan.w, plan.rtol, plan.atol,
                              plan.budget, plan.safety, plan.ifactor, plan.dfactor,
                              int(plan.linear), int(plan.lead), *layout, stream_of(tensors[0]))


def launch_forward(ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in, plan, weights=None):
    """Forward kernel, a team of threads per lane, on the padded ``weights``
    (``padded_weights``; padded here if not given): returns (zout, zfin,
    ctlout, nacc, natt, store) with store = (zst (cap, H, B), tst (cap, B),
    dtst (cap, B), cnt (B,) int32): each lane's accepted steps, left on the
    device."""
    global FWD_LAUNCHES, LINEAR_FWD_LAUNCHES
    ops = (ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in)
    check_operands(ops, ("ct", "z0t", "w1t", "b1", "w2t", "b2", "ctl", "ts_rows", "tend",
                         "zout_in"))
    n, C, B, H, W = _shapes(ct, z0t, w1t, w2t, ts_rows, plan)
    n_out = ts_rows.shape[0]
    if ctl.shape != (4, B) or tend.shape != (B,) or zout_in.shape != (n_out, H, B):
        raise ValueError("inconsistent fused per-sample controller or output rows")
    lib = _library()
    weights = team_weights(w1t, b1, w2t, b2) if weights is None else weights
    team = team_forward_plan(B, H, C, W, cooperative=False)
    empty = functools.partial(torch.empty, dtype=ct.dtype, device=ct.device)
    zout, zfin, ctlout = empty((n_out, H, B)), empty((H, B)), empty((4, B))
    nacc, natt = empty((B,)), empty((B,))
    zst, tst, dtst = empty((plan.cap, H, B)), empty((plan.cap, B)), empty((plan.cap, B))
    cnt = torch.empty(B, dtype=torch.int32, device=ct.device)
    rc = _forward_kernel(lib, (ct, z0t, *weights[:4], *ops[6:], zout, zfin, ctlout, nacc, natt,
                               zst, tst, dtst, cnt), (B, n, H, C, W, n_out), plan,
                         (team["blocks"], team["row"]))
    _raise_on(lib, rc, "forward")
    FWD_LAUNCHES += 1
    LINEAR_FWD_LAUNCHES += int(plan.linear)
    return zout, zfin, ctlout, nacc, natt, (zst, tst, dtst, cnt)


def _backward_kernel(lib, tensors, sizes, plan, layout):
    """The backward kernel's launch over ``ps_backward``'s tensors, in its
    order, sizes (B, n, H, C, W, n_out) and the team plan's slots and row;
    returns its code."""
    with torch.cuda.device(tensors[0].device):
        return lib.ps_backward(*(t.data_ptr() for t in tensors), *sizes, _dense(), plan.t0g,
                               plan.w, int(plan.linear), int(plan.lead), *layout,
                               stream_of(tensors[0]))


def launch_backward(ct, store, ts_rows, gzout, gzfin, w1t, b1, w2t, b2, plan, weights=None):
    """Backward kernel over each lane's stored steps, a team of threads per
    lane, on the padded ``weights`` (padded here if not given): returns
    (dct, dz0, dw1t, db1, dw2t, db2, dzout_in) for the cotangents of zout
    and zfin."""
    global BWD_LAUNCHES, LINEAR_BWD_LAUNCHES
    zst, tst, dtst, cnt = store
    ops = (ct, zst, tst, dtst, ts_rows, gzout, gzfin, w1t, b1, w2t, b2)
    check_operands(ops, ("ct", "zst", "tst", "dtst", "ts_rows", "gzout", "gzfin", "w1t", "b1",
                         "w2t", "b2"))
    n, C, B, H, W = _shapes(ct, gzfin, w1t, w2t, ts_rows, plan)
    n_out = ts_rows.shape[0]
    if (gzout.shape != (n_out, H, B) or zst.shape[1:] != (H, B) or cnt.dtype != torch.int32
            or cnt.shape != (B,)):
        raise ValueError("inconsistent fused per-sample cotangent or store shapes")
    lib = _library()
    team = team_plan(B, H, C, W)
    zeros = functools.partial(torch.zeros, dtype=ct.dtype, device=ct.device)
    dct, dz0, dzout_in = zeros(ct.shape), zeros((H, B)), zeros((n_out, H, B))
    weights = team_weights(w1t, b1, w2t, b2) if weights is None else weights
    if weights.w1.shape[1] != team["row"]:
        raise ValueError("padded weights of another row length than the team plan's")
    partials = team_partials(team["slots"], H, C, team["row"], ct.dtype, ct.device)
    rc = _backward_kernel(lib, (*ops[:7], *weights[:4], cnt, dct, dz0, dzout_in, *partials),
                          (B, n, H, C, W, n_out), plan, (team["slots"], team["row"]))
    _raise_on(lib, rc, "backward")
    BWD_LAUNCHES += 1
    LINEAR_BWD_LAUNCHES += int(plan.linear)
    # The partials are summed after the launch (deterministic).
    return (dct, dz0, *sum_team_partials(*partials, W), dzout_in)


def read_mesh(store, ctlout):
    """The kernel's realised per-lane meshes, read back to the host (for
    comparisons)."""
    zst, tst, dtst, cnt = store
    cnt = cnt.cpu().numpy().astype(np.int64)
    S = max(int(cnt.max()), 1) if cnt.size else 1
    # A lane's store past its count was never written.
    written = np.arange(S)[:, None] < cnt[None, :]
    return PsMesh(np.where(written, tst[:S].cpu().numpy(), 0), np.where(written,
                  dtst[:S].cpu().numpy(), 0), cnt, ctlout[3].cpu().numpy() > 0.5)


def _runs_kernel(ct):
    """CUDA tensors run the kernels, CPU tensors the plain versions."""
    if ct.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused per-sample dopri5 solve for device {ct.device}")
    return ct.is_cuda


class _FusedPerSampleSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in, plan, weights):
        ctx.plan, ctx.kernel = plan, _runs_kernel(ct)
        if ctx.kernel:
            ctx.weights = weights
            zout, zfin, ctlout, nacc, natt, store = launch_forward(
                ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in, plan, weights=weights)
            ctx.save_for_backward(ct, w1t, b1, w2t, b2, ts_rows, *store)
        else:
            zout, zfin, ctlout, nacc, natt, ctx.mesh = fused_dopri5_per_sample_reference(
                ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in, plan)
            ctx.save_for_backward(ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, zout_in)
        ctx.mark_non_differentiable(ctlout, nacc, natt)
        return zout, zfin, ctlout, nacc, natt

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gzout, gzfin, *_):
        if ctx.kernel:
            ct, w1t, b1, w2t, b2, ts_rows, *store = ctx.saved_tensors
            *grads, dzout_in = launch_backward(ct, store, ts_rows, gzout.contiguous(),
                                               gzfin.contiguous(), w1t, b1, w2t, b2, ctx.plan,
                                               weights=ctx.weights)
        else:
            ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, zout_in = ctx.saved_tensors
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (ct, z0t, w1t, b1, w2t, b2,
                                                                zout_in)]
                outs = fused_dopri5_per_sample_replay(*leaves[:6], ctl, ts_rows, leaves[6],
                                                      ctx.mesh, ctx.plan)
                pairs = [(o, g) for o, g in zip(outs, (gzout, gzfin)) if o.requires_grad]
                *grads, dzout_in = torch.autograd.grad(
                    [o for o, _ in pairs], leaves, [g for _, g in pairs], allow_unused=True)
        return (*grads, None, None, None, dzout_in, None, None)


def fused_dopri5_per_sample_solve(ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in, plan,
                                  weights=None):
    """One chunk of the per-sample solve over packed operands: (zout, zfin,
    ctlout, nacc, natt).

    CUDA tensors run the kernels, on the padded ``weights`` of the solve
    (``padded_weights``; each launch pads its own if not given); CPU tensors
    run the plain versions."""
    return _FusedPerSampleSolve.apply(ct, z0t, w1t, b1, w2t, b2, ctl, ts_rows, tend, zout_in,
                                      plan, weights)
