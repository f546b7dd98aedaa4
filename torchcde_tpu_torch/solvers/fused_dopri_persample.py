"""The fused per-sample adaptive dopri5 Neural CDE solve: planning and dispatch.

Port of ``torchcde_tpu/solvers/fused_dopri_persample.py::
try_fused_dopri5_per_sample``, ``_ps_chunk_plan`` and
``_per_lane_initial_step``.  ``options={'per_sample': True}`` gives every
sample its own error norm, PI controller and accepted steps; with the
canonical ``MLPVectorField`` over a ``CubicSpline`` or a
``LinearInterpolation`` with a uniform host grid, the whole per-lane solve
runs as one kernel launch per chunk of intervals
(``fused_dopri_persample_kernel.py``), whose backward walks each lane's
stored steps: the frozen-mesh gradients of direct backpropagation through
each lane's adaptive loop, so one route serves ``adjoint=False`` and
``adjoint=True``.

Composition, as in the JAX package:

* Every lane starts from its own initial step: the Hairer heuristic with
  per-lane norms and the probe time t0 + min(h0) shared by the lanes for a
  shared t, each lane's own heuristic at its own start for batched t.
* Tables beyond ``MAX_INTERVALS`` intervals stream as chunks, each lane's
  state, time, step proposal, attempted count and poison flag carried
  between them; each lane's steps clamp to min(its end, the chunk's end),
  and its first stage is re-evaluated at each chunk entry.  A linear
  control's chunks after the first carry one extra interval on their left
  (``PsPlan.lead``).  Every chunk sees every output row: each lane emits its
  own rows where its steps cover them, and rows at a lane's start time keep
  z0.
* The step budget is global: an explicit ``max_steps`` counts a lane's
  attempted steps across chunks; each chunk also caps a lane's attempts at
  ``min(max_steps or STORE_CAP, 256 + 64 n_c, STORE_CAP)``.  A lane that
  runs out poisons its state and its rows from its chunk-entry time on with
  NaN, and idles in later chunks; the other lanes are untouched.

The JAX package also sizes its chunks and 512-lane tiles to fit TPU VMEM;
that model has no counterpart on the GPU, whose stores live in device
memory, so the port runs every lane in one launch and chunks of
``MAX_INTERVALS`` (at the slice's shapes the JAX plan is the same eight
128-interval chunks).

bfloat16 operands are upcast to float32 at the boundary (the initial-step
heuristic runs on them as given) and the solution is cast back, as the JAX
package solves them.  Returns None where the JAX package declines, and where
the output times require grad (the JAX plan declines traced ones).
"""

import numpy as np
import torch

from ..interpolation.cubic import CubicSpline
from ..interpolation.linear import LinearInterpolation
from ..utils.misc import host_array
from . import fused_dopri_persample_kernel as k9
from .fused_fixed import admits_fused
from .fused_fixed_kernel import pack_operands
from .runge_kutta import DOPRI5
from .terms import _matvec, make_cde_rhs


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x), dim=-1))


def _initial_step(f0, f1_of, z0, order, rtol, atol):
    """The Hairer/Wanner heuristic with per-lane norms; ``f1_of(h0)`` gives
    the field at the probe."""
    scale = atol + torch.abs(z0) * rtol
    d0 = _rms(z0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / torch.clamp(d1, min=1e-30))
    # The probe state in the state's dtype, as integrate.select_initial_step
    # keeps it: with batched times f0 and h0 are float32 for a bfloat16
    # state, and the field takes only the state's dtype.
    f1 = f1_of(h0, (z0 + h0[..., None] * f0).to(z0.dtype))
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.clamp(dmax, min=1e-30)) ** (1.0 / (order + 1)))
    return torch.minimum(100 * h0, h1)


@torch.no_grad()
def _per_lane_initial_step(rhs, t0, z0b, order, rtol, atol):
    """The Hairer/Wanner initial step with per-lane norms over the batched
    state z0b (B, H), all lanes starting at t0; the probe is evaluated once,
    at the time t0 + min(h0) shared by the lanes."""
    return _initial_step(rhs(t0, z0b), lambda h0, z1: rhs(t0 + torch.min(h0), z1), z0b,
                         order, rtol, atol)


def _lane_derivative(X, t):
    """dX/dt of each lane at its own time t (B,), by the control's own rule
    (the JAX package's vmap of ``X.derivative``): knot index by
    searchsorted on the grid, left side."""
    grid = torch.as_tensor(X.grid_points, dtype=t.dtype, device=t.device)
    t = t.contiguous()
    lanes = torch.arange(t.shape[0], device=t.device)

    def pick(rows, index):
        return rows[lanes, index] if rows.ndim == 3 else rows[index]

    if isinstance(X, LinearInterpolation):
        index = torch.clamp(torch.searchsorted(grid, t, side="left") - 1, 0,
                            X._derivs.shape[-2] - 1)
        return pick(X._derivs, index)
    index = torch.clamp(torch.searchsorted(grid, t, side="left") - 1, 0, X._b.shape[-2] - 1)
    frac = (t - grid[index])[:, None]
    return pick(X._b, index) + (pick(X._two_c, index) + pick(X._three_d, index) * frac) * frac


@torch.no_grad()
def _per_lane_initial_step_at(func, X, t0, z0b, order, rtol, atol):
    """Each lane's own Hairer/Wanner initial step at its own start t0 (B,)
    (batched output times)."""
    def rhs(t, z):
        return _matvec(func(t, z), _lane_derivative(X, t))

    return _initial_step(rhs(t0, z0b), lambda h0, z1: rhs(t0 + h0, z1), z0b, order, rtol, atol)


def _ps_chunk_plan(grid, t_lo, t_hi, max_intervals):
    """Interval chunks [j0, j1) covering [t_lo, t_hi], as (j0, j1, chunk
    end).  Output times are per lane, so every chunk sees every row."""
    n = grid.shape[0] - 1
    g = grid.astype(np.float64)
    chunks = []
    j0 = 0
    while j0 < n:
        j1 = min(j0 + max_intervals, n)
        start = float(g[j0]) if j0 > 0 else min(t_lo, float(g[0]))
        end = float(g[j1]) if j1 < n else max(t_hi, float(g[n]))
        if end <= t_lo:
            j0 = j1
            continue
        if start >= t_hi:
            break
        chunks.append((j0, j1, min(end, t_hi)))
        j0 = j1
        if end >= t_hi:
            break
    return chunks


def _host_times(ts):
    """Output times on the host in float64, or None where they require grad."""
    if isinstance(ts, torch.Tensor):
        if ts.requires_grad:
            return None
        ts = host_array(ts)
    return np.asarray(ts, dtype=np.float64)


def try_fused_dopri5_per_sample(X, func, z0, ts, *, rtol, atol, max_steps, t_rows=None):
    """The fused per-sample dopri5 solve, or None if not eligible.

    X: the control with its batch flattened to (B, n, C) rows (or rows
    shared by every lane); z0 (B, H).  ``ts`` is the shared 1-D output-time
    vector, or, when ``t_rows`` is given, ``t_rows`` is the (B, n_times)
    matrix of each lane's times and ``ts`` is ignored.  Returns the
    time-leading (n_times, B, H) solution."""
    if not admits_fused(func) or not isinstance(z0, torch.Tensor):
        return None
    if isinstance(X, CubicSpline):
        rows, linear = (X._b, X._two_c, X._three_d), False
    elif isinstance(X, LinearInterpolation):
        rows, linear = (X._derivs, None, None), True
    else:
        return None
    grid = X.grid_points
    if not isinstance(grid, np.ndarray) or grid.shape[0] < 2:
        return None
    times = _host_times(ts if t_rows is None else t_rows)
    if times is None or times.ndim != (1 if t_rows is None else 2):
        return None
    n_out = times.shape[-1]
    t_lo, t_hi = float(times[..., 0].min()), float(times[..., -1].max())
    spans = np.diff(grid.astype(np.float64))
    if not np.allclose(spans, spans[0], rtol=1e-9, atol=1e-12):
        return None
    w = float(spans[0])
    n = grid.shape[0] - 1
    if t_lo < float(grid[0]) - 1e-9 or t_hi > float(grid[-1]) + 1e-9:
        return None
    p = pack_operands(*rows, z0, func, linear=linear)
    if p is None:
        return None
    # An explicit budget beyond a chunk's store, or more output rows than the
    # kernel reads per lane, take the per-lane general integrator.
    if max_steps is not None and max_steps > k9.STORE_CAP:
        return None
    if n_out > k9.MAX_OUT_TIMES:
        return None

    def chunk_cap(n_c):
        return min(max_steps or k9.STORE_CAP, 256 + 64 * n_c, k9.STORE_CAP)

    chunks = _ps_chunk_plan(grid, t_lo, t_hi, min(k9.MAX_INTERVALS, n))
    if not chunks:
        return None
    if max_steps is not None and any(256 + 64 * (j1 - j0) < max_steps for j0, j1, _ in chunks):
        return None

    dtype, device = p.ct.dtype, p.ct.device
    B, H = p.z0t.shape[1], p.H
    z0b = p.z0f.detach().to(p.out_dtype)
    if t_rows is None:
        t0 = torch.tensor(t_lo, dtype=dtype, device=device)
        dt0 = _per_lane_initial_step(make_cde_rhs(func, X), t0, z0b, DOPRI5.order, rtol, atol)
        ts_rows = torch.tensor(times, dtype=dtype, device=device)[:, None].expand(n_out, B)
        t_start = torch.full((B,), t_lo, dtype=dtype, device=device)
        tend = torch.full((B,), t_hi, dtype=dtype, device=device)
    else:
        rows_t = torch.tensor(times, dtype=dtype, device=device)
        dt0 = _per_lane_initial_step_at(func, X, rows_t[:, 0], z0b, DOPRI5.order, rtol, atol)
        ts_rows, t_start, tend = rows_t.t(), rows_t[:, 0], rows_t[:, -1]
    ts_rows = ts_rows.contiguous()
    # Output rows start as the initial state: rows at a lane's start time are
    # never hit by a step and keep it.
    zout = p.z0t.unsqueeze(0).expand(n_out, H, B).contiguous()
    z = p.z0t
    zero = torch.zeros_like(t_start)
    ctl = torch.stack([t_start, dt0.reshape(B).to(dtype), zero, zero])
    budget = float(max_steps) if max_steps is not None else float(1 << 30)
    weights = k9.padded_weights(p.ct, p.w1t, p.b1, p.w2t, p.b2)  # once per solve
    for j0, j1, c_end in chunks:
        lead = linear and j0 > 0
        plan = k9.PsPlan(float(c_end), float(grid[j0]), w, float(rtol), float(atol), budget,
                         chunk_cap(j1 - j0), linear=linear, lead=lead)
        zout, z, ctl, _nacc, _natt = k9.fused_dopri5_per_sample_solve(
            p.ct[j0 - lead:j1], z.contiguous(), p.w1t, p.b1, p.w2t, p.b2, ctl, ts_rows,
            tend.contiguous(), zout, plan, weights=weights)
    return zout.transpose(1, 2).to(p.out_dtype)  # (n_out, B, H)
