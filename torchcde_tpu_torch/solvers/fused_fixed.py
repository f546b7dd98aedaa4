"""Knot-aligned fixed-step CDE solver.

Port of ``torchcde_tpu/solvers/fused_fixed.py``.  For fixed steps over a
cubic control with a host knot grid and output times on the grid, the
interval of every stage is known on the host: the step loop walks the
per-interval coefficient rows directly, with no searchsorted and no gathers.
Uniform grids with the canonical ``MLPVectorField`` go further and run the
whole solve in one kernel (``fused_fixed_kernel.py``).  Returns None when the
preconditions do not hold; ``cdeint`` then takes the general integrator.

This module also holds the switch of every fused solve route (K1, K2 in both
modes, K8 and K9): ``force_fused_kernels`` and ``disable_fused_dispatch``,
the port of ``torchcde_tpu/solvers/fused_pallas.py``'s ``force_fused_pallas``
and ``disable_fused_dispatch``, read by each route through ``admits_fused``.
"""

import threading

import numpy as np
import torch

from ..interpolation.cubic import CubicSpline
from ..utils.misc import host_array, numpy_dtype
from .fused_fixed_kernel import try_fused_mlp
from .runge_kutta import TABLEAUS, rk_step
from .terms import MLPVectorField, holds_dtensor

_MAX_SUBSTEPS = 256

# None or True: the fused routes take every solve they admit.  False: never.
_FORCE = None
# The depth of the disable_fused_dispatch contexts active in each thread.
_TLS = threading.local()


class disable_fused_dispatch:
    """Context manager: while it is active, this thread's solves take no
    fused route (K1, K2, K8, K9): each solves on the general path, the
    backsolve under ``adjoint=True``.  Nestable; other threads are not
    affected.  The port of ``fused_pallas.py::disable_fused_dispatch``."""

    def __enter__(self):
        self._prev = getattr(_TLS, "disable", 0)
        _TLS.disable = self._prev + 1
        return self

    def __exit__(self, *exc):
        _TLS.disable = self._prev
        return False


def force_fused_kernels(mode):
    """The switch of the fused solve routes, the port of
    ``fused_pallas.py::force_fused_pallas``.

    ``None`` (the default): each route takes the solves it admits, which
    launch its kernel on a CUDA device and run its plain version on the
    CPU.  ``True``: the same; it differs from None in nothing, because the
    routes decline nothing for being off the card (JAX's auto mode declines
    off the TPU).  ``False``: every route declines, in every thread, and the
    solve takes the general path (``runge_kutta`` / ``integrate``, the
    streamed knot walk for a knot-aligned fixed-step solve, and the backsolve
    under ``adjoint=True``).  The switch covers the fused solve kernels
    only; the fit's kernels (K3-K7) follow ``ops.dispatch.runs_kernel``."""
    global _FORCE
    if mode not in (None, True, False):
        raise ValueError(f"force_fused_kernels takes None, True or False, not {mode!r}")
    _FORCE = mode


def admits_fused(func):
    """The gate of every fused route (K1, K2, K8, K9): the switch is not
    False, no ``disable_fused_dispatch`` is active in this thread, and the
    field is an ``MLPVectorField`` whose weights are plain tensors.  A
    tensor-parallel field is declined and solved on the plain path, where its
    layers run as ``DTensor`` ops, as the JAX package declines its kernels on
    a mesh with a model axis (``fused_pallas.py:530-545``).  A data-parallel
    rank's field holds plain tensors, so each rank launches its own kernel on
    its shard."""
    return (_FORCE is not False and not getattr(_TLS, "disable", 0)
            and isinstance(func, MLPVectorField) and not holds_dtensor(func))


def _knot_indices(grid, ts):
    """Host-side: index of each output time in the knot grid, or None."""
    idx = np.searchsorted(grid, ts)
    idx = np.clip(idx, 0, len(grid) - 1)
    if not np.allclose(grid[idx], ts, rtol=1e-12, atol=1e-12):
        return None
    return idx


def plan_fixed_grid(X, ts, step_size):
    """Host-side plan shared by the fixed-step fast paths.

    Returns ``(rows, grid, out_idx, j0, jN, m, step_size_val, uniform)`` when
    the solve is a knot-aligned fixed-step walk over a cubic control, else
    None.  Preconditions: a host knot grid, output times on the grid, and a
    step_size dividing every knot span the same number (m) of times.  Output
    times that require grad decline, as the JAX plan declines traced ones:
    the general integrator differentiates them.
    """
    if step_size is None or isinstance(step_size, torch.Tensor):
        return None
    if isinstance(ts, torch.Tensor) and ts.requires_grad:
        return None
    if not isinstance(X, CubicSpline):
        return None
    rows = (X._a, X._b, X._two_c, X._three_d)
    grid = X.grid_points
    if not isinstance(grid, np.ndarray):
        return None
    if isinstance(ts, torch.Tensor):
        ts_np = host_array(ts).astype(np.float64)
    else:
        ts_np = np.asarray(ts, dtype=np.float64)
    out_idx = _knot_indices(grid, ts_np)
    if out_idx is None:
        return None
    j0, jN = int(out_idx[0]), int(out_idx[-1])
    if jN <= j0:
        return None
    spans = np.diff(grid[j0 : jN + 1].astype(np.float64))
    step_size_val = float(step_size)
    m_per = spans / step_size_val
    m = int(np.max(np.round(m_per)))
    # step_size must divide every span so the step sequence is identical to
    # the general interval-clamped path.
    if m > _MAX_SUBSTEPS or m < 1 or not np.allclose(
        np.round(m_per) * step_size_val, spans, rtol=1e-9, atol=1e-12
    ) or not np.all(np.round(m_per) == m):
        return None
    uniform = bool(np.allclose(spans, spans[0], rtol=1e-9, atol=1e-12))
    return rows, grid, out_idx, j0, jN, m, step_size_val, uniform


def try_fused_fixed(X, func, z0, ts, method, step_size, kernel_only=False):
    """Returns the solution (time leading) or None if not applicable.

    ``kernel_only=True`` takes only the fused kernel, not the streamed walk
    (the adjoint's route: autograd through the walk would keep every stage)."""
    if method not in TABLEAUS or not isinstance(z0, torch.Tensor):
        return None
    plan = plan_fixed_grid(X, ts, step_size)
    if plan is None:
        return None
    rows, grid, out_idx, j0, jN, m, step_size_val, uniform = plan

    if uniform and admits_fused(func):
        sliced = tuple(r[..., j0:jN, :] for r in rows[1:])
        out = try_fused_mlp(
            sliced, z0, func, method, m, step_size_val, jN - j0,
            out_knots=tuple(int(k) - j0 for k in out_idx),
        )
        if out is not None:
            return out
    if kernel_only:
        return None

    # The streamed walk: the general fallback when the kernel declines.
    tableau = TABLEAUS[method]
    is_prod = hasattr(func, "prod")
    scalar = numpy_dtype(rows[0].dtype).type
    spans = np.diff(grid[j0 : jN + 1].astype(np.float64))
    knots = [z0]
    z = z0
    for j in range(j0, jN):
        b_j, c_j, d_j = (r[..., j, :] for r in rows[1:])
        tl, w = scalar(grid[j]), scalar(spans[j - j0])

        def rhs(tau, zz, tl=tl, b_j=b_j, c_j=c_j, d_j=d_j):
            frac = float(scalar(tau) - tl)
            cg = b_j + (c_j + d_j * frac) * frac
            if is_prod:
                return func.prod(tau, zz, cg)
            return torch.sum(func(tau, zz) * cg[..., None, :], dim=-1)

        if m == 1:
            z = rk_step(tableau, rhs, float(tl), z, float(w))
        else:
            tcur = tl
            for _ in range(m):
                dt = np.clip(tl + w - tcur, 0.0, scalar(step_size_val))
                z = rk_step(tableau, rhs, float(tcur), z, float(dt))
                tcur = tcur + dt
        knots.append(z)
    return torch.stack([knots[int(k) - j0] for k in out_idx], dim=0)
