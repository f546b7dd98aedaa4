"""The fused adaptive dopri5 Neural CDE solve: grouping, chunking and dispatch.

Port of ``torchcde_tpu/solvers/fused_dopri_pallas.py::try_fused_dopri5`` and
``_chunk_plan``.  The whole tolerance-controlled solve of the canonical
``MLPVectorField`` over a ``CubicSpline`` or a ``LinearInterpolation`` with a
uniform host grid runs as one kernel launch per group of lanes and chunk of
intervals
(``fused_dopri_kernel.py``); its backward walks the stored accepted-step
mesh, which gives the frozen-mesh gradients of direct backpropagation
through the adaptive loop.  So one route serves ``adjoint=False`` and
``adjoint=True``.

Composition, as in the JAX package:

* Batches beyond ``MAX_TILE`` lanes split into independent groups, each with
  its own error norm and controller; a batch of at most ``MAX_TILE`` is one
  group, i.e. the whole-batch norm of the general integrator.
* Tables beyond ``MAX_INTERVALS`` intervals stream as chunks, with the state
  and the (detached) step proposal carried between them and the first stage
  re-evaluated at each chunk entry.  Steps clamp to chunk boundaries.  A
  linear control's chunks after the first carry one extra interval on their
  left (``Plan.lead``), so that a stage on the chunk's first knot reads the
  slope on its left, as the unchunked solve does.
* Each chunk's step budget is ``min(max_steps, 256 + 64 * n_c)`` attempted
  steps, with ``max_steps = min(cfg.max_steps or 4096, STORE_CAP)``.

The JAX package also shrinks chunks to fit TPU VMEM; that model has no
counterpart on the GPU, whose trajectory store lives in device memory, so the
port always runs chunks of ``MAX_INTERVALS`` (the plans agree wherever the
JAX one fits whole chunks in VMEM, as at 99 intervals and 4096 lanes).

bfloat16 operands are upcast to float32 at the boundary (the initial-step
heuristic runs on them as given) and the solution is cast back, as the JAX
package solves them.  Returns None where the JAX package declines.
"""

import numpy as np
import torch

from ..interpolation.cubic import CubicSpline
from ..interpolation.linear import LinearInterpolation
from ..utils.misc import host_array
from . import fused_dopri_kernel as k2
from .fused_fixed import admits_fused
from .fused_fixed_kernel import pack_operands
from .integrate import select_initial_step
from .runge_kutta import DOPRI5
from .terms import make_cde_rhs


def _chunk_plan(grid, ts_np, max_intervals):
    """Splits the knot grid into interval chunks of <= max_intervals and
    routes each output time (after ts[0]) to the chunk whose span contains
    it.  Returns a list of (j0, j1, t_start, t_end, out_ts, out_idx)."""
    n = grid.shape[0] - 1
    t0, tN = float(ts_np[0]), float(ts_np[-1])
    chunks = []
    prev_end = t0
    j0 = 0
    while j0 < n:
        j1 = min(j0 + max_intervals, n)
        start = float(grid[j0]) if j0 > 0 else min(t0, float(grid[0]))
        end = float(grid[j1]) if j1 < n else max(tN, float(grid[n]))
        if end <= t0:  # chunk entirely before the solve begins
            j0 = j1
            continue
        if start >= tN:  # chunk entirely after the solve ends
            break
        t_start = max(start, t0)
        t_end = min(end, tN)
        out_idx = [k for k in range(1, len(ts_np)) if prev_end < ts_np[k] <= t_end]
        out_ts = tuple(float(ts_np[k]) for k in out_idx)
        chunks.append((j0, j1, t_start, t_end, out_ts, tuple(out_idx)))
        prev_end = t_end
        j0 = j1
        if t_end >= tN:
            break
    return chunks


def try_fused_dopri5(X, func, z0, ts, cfg):
    """The fused adaptive dopri5 solve, time leading, or None if not eligible.

    Requires an ``MLPVectorField`` over a ``CubicSpline`` or a
    ``LinearInterpolation`` with a uniform host knot grid, a tensor state,
    no step_size (the caller checks), output times that do not require grad,
    and the shapes and dtype ``pack_operands`` admits."""
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
    if isinstance(ts, torch.Tensor):
        if ts.requires_grad:  # the JAX plan declines traced output times
            return None
        ts = host_array(ts)
    ts_np = np.asarray(ts, dtype=np.float64)
    spans = np.diff(grid.astype(np.float64))
    if not np.allclose(spans, spans[0], rtol=1e-9, atol=1e-12):
        return None
    w = float(spans[0])
    n = grid.shape[0] - 1

    # An explicit budget beyond the trajectory store takes the general
    # integrator, which honours it.
    if cfg.max_steps is not None and cfg.max_steps > k2.STORE_CAP:
        return None
    max_steps = min(cfg.max_steps or 4096, k2.STORE_CAP)
    p = pack_operands(*rows, z0, func, linear=linear)
    if p is None:
        return None

    def chunk_cap(n_c):
        return min(max_steps, 256 + 64 * n_c)

    chunks = _chunk_plan(grid, ts_np, min(k2.MAX_INTERVALS, n))
    if not chunks or any(len(c[4]) > k2.MAX_OUT_TIMES for c in chunks):
        return None
    if cfg.max_steps is not None and any(chunk_cap(c[1] - c[0]) < cfg.max_steps for c in chunks):
        return None

    # The initial-step heuristic on the batch-shaped state, left on the
    # device: it is mesh data, outside autograd.
    rhs = make_cde_rhs(func, X)
    t0 = torch.tensor(float(np.float32(ts_np[0])), dtype=p.ct.dtype, device=z0.device)
    z0b = z0.detach().expand(p.batch + (p.H,))
    dt0 = select_initial_step(rhs, t0, z0b, DOPRI5.order, cfg.rtol, cfg.atol, rhs(t0, z0b))
    dt0 = dt0.reshape(1).to(p.ct.dtype)

    B, tile = p.z0t.shape[1], min(p.z0t.shape[1], k2.MAX_TILE)
    weights = k2.padded_weights(p.ct, p.w1t, p.b1, p.w2t, p.b2)  # once per solve
    groups = []
    for g0 in range(0, B, tile):
        lanes = slice(g0, min(g0 + tile, B))
        ct = p.ct[..., lanes].contiguous()
        z, dt = p.z0t[:, lanes], dt0
        rows = [z] + [None] * (len(ts_np) - 1)
        for j0, j1, t_start, t_end, out_ts, out_idx in chunks:
            lead = linear and j0 > 0
            plan = k2.Plan(out_ts, t_start, t_end, float(grid[j0]), w, float(cfg.rtol),
                           float(cfg.atol), chunk_cap(j1 - j0), float(cfg.safety),
                           float(cfg.ifactor), float(cfg.dfactor), linear, lead)
            zout, z, dt = k2.fused_dopri5_solve(ct[j0 - lead:j1], z.contiguous(), p.w1t,
                                                p.b1, p.w2t, p.b2, dt, plan, weights=weights)
            for row, k in enumerate(out_idx):
                rows[k] = zout[row]
        groups.append(torch.stack(rows))  # (n_out, H, lanes)
    out = torch.cat(groups, dim=-1).transpose(1, 2)  # (n_out, B, H)
    return out.reshape((len(ts_np),) + p.batch + (p.H,)).to(p.out_dtype)
