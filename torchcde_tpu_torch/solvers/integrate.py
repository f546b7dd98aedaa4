"""The ODE integration driver.

Port of ``torchcde_tpu/solvers/integrate.py``: ``SolverConfig``, the fixed-step
branch (stateless RK methods, and the steppers with a state: dopri5 with an
explicit ``step_size``, reversible Heun, the Adams methods), the adaptive
dense-output branch with its PI controller, initial-step heuristic, quartic
dense output and loud NaN poisoning when the step budget runs out, the
adaptive driver that restarts at every output time for steppers without a
dense step (``_advance_adaptive``), and ``jump_t``: adaptive steps land on
the declared derivative discontinuities, which fixed steps ignore with the
JAX package's warning.

The JAX loops become Python loops on host scalars.  Times and step sizes are
NumPy scalars in the state's precision, so they round as the JAX integrator's
do, and the adaptive controller reads one error ratio from the device per
attempted step.  The adaptive step sizes are host numbers, outside autograd:
gradients are those of the scheme on the realised mesh (the frozen mesh that
the JAX package gets from ``stop_gradient``).

Output times that are a tensor requiring grad receive the JAX integrator's
gradient: the host scalars still decide every branch, and beside them the
loops carry 0-d tensors of the same values whose graph is JAX's (``_follow``):
the clamped fixed step clip(t1 - t, 0, step) with ties split in half, stage
times t0 + sum of the frozen adaptive steps, and the dense output's theta.
"""

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..utils.misc import host_array, numpy_dtype
from .runge_kutta import STEPPERS, rk_step, unknown_method

_FIXED_DEFAULT_MAX_STEPS = 65536
_ADAPTIVE_DEFAULT_MAX_STEPS = 4096


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (the typed form of ``cdeint``'s kwargs)."""

    method: str = "dopri5"
    rtol: float = 1e-4
    atol: float = 1e-6
    step_size: Optional[float] = None
    max_steps: Optional[int] = None
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    # Knot count of the control (cdeint sets it from X.grid_points); sizes
    # only the default adaptive step budget.
    knots_hint: Optional[int] = None

    def stepper(self):
        if self.method not in STEPPERS:
            raise unknown_method(self.method)
        return STEPPERS[self.method]


def host_times(ts, dtype):
    """Output times as a host NumPy array in the state's precision.

    The step sequence is planned on the host, as the JAX package plans it from
    concrete times."""
    if isinstance(ts, torch.Tensor):
        ts = host_array(ts)
    return np.asarray(ts).astype(numpy_dtype(dtype))


def host_jumps(jump_t, dtype):
    """``jump_t`` as a sorted host NumPy array in the state's precision: the
    drivers search it for the next jump, and an unsorted caller list would
    otherwise let the mesh straddle the kinks it hides."""
    return np.sort(host_times(jump_t, dtype).reshape(-1))


def _next_jump(jump_t, t):
    """The smallest jump time strictly greater than t (inf if none)."""
    idx = int(np.searchsorted(jump_t, t, side="right"))
    return jump_t[idx] if idx < jump_t.shape[0] else jump_t.dtype.type(np.inf)


def warn_fixed_jumps():
    """The JAX package's warning for ``jump_t`` given to fixed steps."""
    warnings.warn(
        "options={'jump_t': ...} is ignored by fixed-step methods "
        "(and by adaptive methods run with an explicit step_size): "
        "steps may straddle the declared derivative discontinuities. "
        "Use an adaptive method without step_size, or choose a "
        "step_size that divides the jump times."
    )


def _rms_norm(x):
    return torch.sqrt(torch.sum(torch.square(x)) / x.numel())


def _error_ratio(err, rtol, atol, z0, z1):
    return _rms_norm(err / (atol + rtol * torch.maximum(torch.abs(z0), torch.abs(z1))))


@torch.no_grad()
def select_initial_step(rhs, t0, z0, order, rtol, atol, f0):
    """Hairer/Wanner initial step heuristic (as used by torchdiffeq).

    Returns a 0-d tensor on z0's device: it is mesh data, outside autograd."""
    scale = atol + torch.abs(z0) * rtol
    d0 = _rms_norm(z0 / scale)
    d1 = _rms_norm(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / torch.clamp(d1, min=1e-30))
    z1 = z0 + h0 * f0
    f1 = rhs(torch.as_tensor(t0, dtype=z0.dtype, device=z0.device) + h0, z1)
    d2 = _rms_norm((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.clamp(dmax, min=1e-30)) ** (1.0 / (order + 1)),
    )
    return torch.minimum(100 * h0, h1)


def _optimal_factor(ratio, order, cfg: SolverConfig, accepted):
    """clip(safety * ratio^(-1/order), dfactor, ifactor, or 1 after a
    rejection), on host scalars of the state's precision."""
    sc = type(ratio)
    ratio = max(ratio, sc(1e-10))
    factor = sc(cfg.safety) * ratio ** sc(-1.0 / order)
    if not math.isfinite(factor):
        factor = sc(cfg.dfactor)
    upper = sc(cfg.ifactor) if accepted else sc(1.0)
    return min(max(factor, sc(cfg.dfactor)), upper)


# p(theta) = z0 + dt*f0*theta + c2*theta^2 + c3*theta^3 + c4*theta^4 with
# p(1) = z1, p'(1) = dt*f1, p(1/2) = y_mid: the 3x3 system for (c4, c3, c2)
# is the same for every step.
_QUARTIC_MINV = np.linalg.inv(
    np.array([[1.0, 1.0, 1.0], [4.0, 3.0, 2.0], [1 / 16, 1 / 8, 1 / 4]])
)


def _follow(value, expr):
    """A 0-d tensor with the host scalar's value and the gradient of expr
    (whose value equals it): the host keeps deciding the branches."""
    return expr - expr.detach() + float(value)


def _clip(x, lo, hi):
    """jnp.clip's value and gradient, ties split in half between the bounds'
    branches (torch.maximum/minimum split them as lax.max/min do)."""
    hi = hi if isinstance(hi, torch.Tensor) else torch.zeros_like(x) + hi
    return torch.minimum(torch.maximum(x, torch.zeros_like(x) + lo), hi)


def _interp_quartic(z0, z1, f0, f1, y_mid, dt, theta):
    """The quartic dense-output polynomial at theta, a host scalar or a 0-d
    tensor that carries the output time's gradient."""
    m = _QUARTIC_MINV
    sc = type(dt)
    rA = z1 - z0 - float(dt) * f0
    rB = float(dt) * (f1 - f0)
    rC = y_mid - z0 - float(sc(0.5) * dt) * f0
    c4 = m[0][0] * rA + m[0][1] * rB + m[0][2] * rC
    c3 = m[1][0] * rA + m[1][1] * rB + m[1][2] * rC
    c2 = m[2][0] * rA + m[2][1] * rB + m[2][2] * rC
    th = theta if isinstance(theta, torch.Tensor) else float(theta)
    return z0 + th * (float(dt) * f0 + th * (c2 + th * (c3 + th * c4)))


def _poisoned(out):
    """NaN everywhere, as ``jnp.where(incomplete, nan, out)``."""
    return torch.where(torch.ones((), dtype=torch.bool, device=out.device),
                       torch.full_like(out, math.nan), out)


def _integrate_adaptive_dense(rhs, z0, ts, dt0, state0, cfg, stepper, max_steps, jump_t=None,
                              tts=None):
    """One continuous adaptive solve over [ts[0], ts[-1]] with dense output.

    Each accepted step writes the 4th-order interpolant into every output row
    whose time falls inside (t, t + dt]; steps clamp only to ts[-1] and to the
    jumps, so the step count does not grow with len(ts) (a method of order
    above 5 also lands on every output time: the quartic would lower its
    order).  Returns (out, (attempted, accepted)) with out time-leading, NaN
    everywhere if the budget ran out before ts[-1].  ``jump_t``: the sorted
    host jumps, or None; ``tts``: the output times as a tensor that carries
    their gradient, or None."""
    sc = ts.dtype.type
    t_end = ts[-1]
    out = [z0] * len(ts)
    t, z, dt, state = ts[0], z0, dt0, state0
    tt = None if tts is None else tts[0]  # t = ts[0] + the frozen steps
    attempted = accepted = 0
    while t < t_end and attempted < max_steps:
        dt = max(dt, sc(1e-14))
        dt_c = min(dt, t_end - t)
        if jump_t is not None:
            dt_c = min(dt_c, _next_jump(jump_t, t) - t)
        if stepper.order > 5:
            dt_c = min(dt_c, _next_jump(ts, t) - t)
        z1, err, state1, (f0, f1, y_mid) = stepper.step_dense(
            rhs, t if tt is None else tt, z, dt_c, state)
        with torch.no_grad():
            ratio = sc(_error_ratio(err, cfg.rtol, cfg.atol, z, z1).item())
        accept = bool(ratio <= 1.0)
        dt_new = dt_c * _optimal_factor(ratio, stepper.order, cfg, accept)
        # A step that was only short because it was clamped to the end (or a
        # jump) does not shrink the carried proposal.
        if accept and dt_c < dt:
            dt_new = max(dt, dt_new)
        if accept:
            for k, tk in enumerate(ts):
                if t < tk <= t + dt_c:
                    theta = min(max((tk - t) / max(dt_c, sc(1e-30)), sc(0.0)), sc(1.0))
                    if tt is not None:
                        theta = _follow(theta, _clip((tts[k] - tt) / float(max(dt_c, sc(1e-30))),
                                                     0.0, 1.0))
                    out[k] = _interp_quartic(z, z1, f0, f1, y_mid, dt_c, theta)
            t, z, state = t + dt_c, z1, state1
            if tt is not None:
                tt = _follow(t, tt)
        dt = dt_new
        attempted += 1
        accepted += int(accept)
    out = torch.stack(out, dim=0)
    if t < t_end:
        out = _poisoned(out)
    return out, (attempted, accepted)


def _advance_adaptive(rhs, z0, t0, t1, dt0, state0, cfg, stepper, max_steps, jump_t, tt=None,
                      tt1=None):
    """Adaptive steps from t0 to exactly t1, for steppers without a dense
    step.  Returns (z1, dt_next, state1, (attempted, accepted), complete); z1
    is NaN everywhere if the budget ran out first.  ``tt``, ``tt1``: t0 and t1
    as 0-d tensors that carry the output times' gradient, or None; the clamp
    to t1 (and to a jump) stays differentiable, as in the JAX package."""
    sc = type(t0)
    t, z, dt, state = t0, z0, dt0, state0
    attempted = accepted = 0
    while t < t1 and attempted < max_steps:
        dt = max(dt, sc(1e-14))
        dt_c = min(dt, t1 - t)
        jump = None
        if jump_t is not None:
            jump = _next_jump(jump_t, t)
            dt_c = min(dt_c, jump - t)
        dtt = None
        if tt is not None:
            d = torch.minimum(torch.zeros_like(tt) + float(dt), tt1 - tt)
            if jump is not None:
                d = torch.minimum(d, float(jump) - tt)
            dtt = _follow(dt_c, d)
        z1, err, state1 = stepper.step(rhs, t if tt is None else tt, z,
                                       dt_c if tt is None else dtt, state)
        with torch.no_grad():
            ratio = sc(_error_ratio(err, cfg.rtol, cfg.atol, z, z1).item())
        accept = bool(ratio <= 1.0)
        dt_new = dt_c * _optimal_factor(ratio, stepper.order, cfg, accept)
        if accept and dt_c < dt:
            dt_new = max(dt, dt_new)
        if accept:
            t, z, state = t + dt_c, z1, state1
            if tt is not None:
                tt = _follow(t, tt + dtt)
        dt = dt_new
        attempted += 1
        accepted += int(accept)
    complete = not t < t1
    return (z if complete else _poisoned(z)), dt, state, (attempted, accepted), complete


def _static_fixed_steps(ts, step_size):
    """Exact per-interval step bound for host times."""
    if step_size is None:
        return 1
    tv = np.asarray(ts, dtype=np.float64)
    intervals = np.diff(tv)
    if intervals.size == 0:
        return 1
    n = int(np.max(np.ceil(intervals / float(step_size) - 1e-9)))
    return max(n, 1)


def _adaptive_max_steps(cfg, order, differentiable):
    """The default adaptive step budget of the JAX package: with direct
    backprop and a known knot count, 8 steps per knot scaled by the
    tolerance, at least 1024 and at most 4096; else 4096; eight times that
    for methods of order below 3, whose step counts grow much faster as the
    tolerance tightens."""
    order_scale = 8 if order < 3 else 1
    default_steps = _ADAPTIVE_DEFAULT_MAX_STEPS
    if differentiable and order >= 4 and cfg.max_steps is None and cfg.knots_hint is not None:
        inv_order = 1.0 / (order + 1)
        tol_scale = max(
            1.0,
            (1e-4 / max(cfg.rtol, 1e-30)) ** inv_order,
            (1e-6 / max(cfg.atol, 1e-30)) ** inv_order,
        )
        default_steps = int(min(default_steps, max(1024, 8 * cfg.knots_hint * tol_scale)))
    return cfg.max_steps or default_steps * order_scale


def _stats(attempted, accepted, init_nfe, stages):
    return {
        "steps_attempted": attempted,
        "steps_accepted": accepted,
        "steps_rejected": attempted - accepted,
        "nfe": init_nfe + attempted * stages,
    }


def odeint(rhs, z0, ts, cfg: SolverConfig, jump_t=None, differentiable=True,
           collect_stats=False):
    """Integrates dz/dt = rhs(t, z) from ts[0], returning z at every ts[i],
    time leading: (len(ts), ...).

    ``jump_t``: times of derivative discontinuities (any order, host array or
    tensor), on which adaptive steps land.  ``differentiable=False`` (inside
    the adjoint) only changes the default adaptive step budget, as in the JAX
    package.  With ``collect_stats=True`` returns ``(out, stats)`` with the
    step and evaluation counts."""
    tts = None
    if isinstance(ts, torch.Tensor) and ts.requires_grad and torch.is_grad_enabled():
        tts = ts.to(z0.dtype)
    ts = host_times(ts, z0.dtype)
    if ts.shape[0] > 1 and not bool(np.all(np.diff(ts) > 0)):
        raise ValueError("t must be monotonically increasing.")
    sc = ts.dtype.type
    if jump_t is not None:
        jump_t = host_jumps(jump_t, z0.dtype)

    stepper = cfg.stepper()
    if cfg.method == "dopri5" and jump_t is not None:
        # The cached first stage is not valid across a discontinuity.
        stepper = STEPPERS["dopri5_nofsal"]
    init_nfe = stepper.init_nfe
    adaptive = stepper.adaptive and cfg.step_size is None
    if jump_t is not None and not adaptive:
        warn_fixed_jumps()

    if stepper.tableau is not None and not adaptive:
        # Stateless RK steps: clip(t1 - t, 0, step) in every interval.
        n_static = min(_static_fixed_steps(ts, cfg.step_size),
                       cfg.max_steps or _FIXED_DEFAULT_MAX_STEPS)
        out, z, steps = [z0], z0, 0
        for i, (t0, t1) in enumerate(zip(ts[:-1], ts[1:])):
            step_size = sc(cfg.step_size if cfg.step_size is not None else t1 - t0)
            t = t0
            if tts is not None:
                tt = tts[i]
                size = cfg.step_size if cfg.step_size is not None else tts[i + 1] - tts[i]
            # Steps with dt == 0 are the JAX loop's padding iterations: they
            # change nothing but the output times' gradient, so they run
            # only where that is wanted.
            for _ in range(n_static):
                dt = np.clip(t1 - t, sc(0.0), step_size)
                if tts is not None:
                    dtt = _follow(dt, _clip(tts[i + 1] - tt, 0.0, size))
                    z = rk_step(stepper.tableau, rhs, tt, z, dtt)
                    tt = _follow(t + dt, tt + dtt)
                    steps += int(dt > 0)
                elif dt > 0:
                    z = rk_step(stepper.tableau, rhs, float(t), z, float(dt))
                    steps += 1
                t = t + dt
            out.append(z)
        out = torch.stack(out, dim=0)
        if not collect_stats:
            return out
        return out, _stats(steps, steps, init_nfe, stepper.nfe_per_step)

    state = stepper.init(rhs, ts[0] if tts is None else tts[0], z0)
    if adaptive:
        with torch.no_grad():
            f0 = state if stepper.init_nfe else rhs(ts[0], z0)
            dt0 = sc(select_initial_step(rhs, ts[0], z0, stepper.order, cfg.rtol, cfg.atol,
                                         f0).item())
        init_nfe += 2  # the initial-step heuristic
        max_steps = _adaptive_max_steps(cfg, stepper.order, differentiable)
        if stepper.step_dense is not None:
            out, (attempted, accepted) = _integrate_adaptive_dense(
                rhs, z0, ts, dt0, state, cfg, stepper, max_steps, jump_t, tts)
        else:
            # No dense step: restart at every output time, each interval
            # with its own budget.  Once one runs out, its NaN state rejects
            # every attempt of the intervals after it, which only count.
            outs, z, dt, attempted, accepted, complete = [z0], z0, dt0, 0, 0, True
            for i, (t0, t1) in enumerate(zip(ts[:-1], ts[1:])):
                if complete:
                    z, dt, state, (a, c), complete = _advance_adaptive(
                        rhs, z, t0, t1, dt, state, cfg, stepper, max_steps, jump_t,
                        *((None, None) if tts is None else (tts[i], tts[i + 1])))
                else:
                    a, c = max_steps, 0
                attempted, accepted = attempted + a, accepted + c
                outs.append(z)
            out = torch.stack(outs, dim=0)
    else:
        # Fixed steps of step_size (last step of each interval clamped),
        # carrying the stepper's state (dopri5's first-same-as-last stage,
        # reversible Heun's companion, the Adams history) across output
        # times.  With no step_size, one step per output interval.
        n_static = min(_static_fixed_steps(ts, cfg.step_size),
                       cfg.max_steps or _FIXED_DEFAULT_MAX_STEPS)
        outs, z, attempted = [z0], z0, 0
        for i, (t0, t1) in enumerate(zip(ts[:-1], ts[1:])):
            t, n = t0, 0
            step_size = sc(cfg.step_size if cfg.step_size is not None else t1 - t0)
            if tts is not None:
                tt = tts[i]
                size = cfg.step_size if cfg.step_size is not None else tts[i + 1] - tts[i]
            while t < t1 and n < n_static:
                dt = min(step_size, t1 - t)
                if tts is None:
                    z, _err, state = stepper.step(rhs, t, z, dt, state)
                else:
                    dtt = _follow(dt, torch.minimum(tts[i + 1] - tt, torch.zeros_like(tt) + size))
                    z, _err, state = stepper.step(rhs, tt, z, dtt, state)
                    tt = _follow(t + dt, tt + dtt)
                t, n = t + dt, n + 1
            attempted += n
            outs.append(z)
        out, accepted = torch.stack(outs, dim=0), attempted
    if not collect_stats:
        return out
    return out, _stats(attempted, accepted, init_nfe, stepper.nfe_per_step)
