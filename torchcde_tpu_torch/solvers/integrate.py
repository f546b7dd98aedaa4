"""The fixed-step ODE integrator.

Port of the fixed-step branch of ``torchcde_tpu/solvers/integrate.py``:
``SolverConfig``, ``_advance_fixed``, ``_static_fixed_steps`` and ``odeint``.
The JAX ``lax.scan`` loops become Python loops over host-side step times, and
autograd differentiates through them, so ``loops.py`` (a reverse-differentiable
bounded while loop) has no counterpart.  Adaptive stepping is ROADMAP queue 1
item 6.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.misc import numpy_dtype
from .runge_kutta import TABLEAUS, rk_step

_FIXED_DEFAULT_MAX_STEPS = 65536


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (the typed form of ``cdeint``'s kwargs).

    The adaptive controller's fields arrive with adaptive stepping."""

    method: str = "dopri5"
    rtol: float = 1e-4
    atol: float = 1e-6
    step_size: Optional[float] = None
    max_steps: Optional[int] = None

    def tableau(self):
        if self.method not in TABLEAUS:
            raise ValueError(
                f"Unrecognised method={self.method!r}; expected one of {sorted(TABLEAUS)}"
            )
        return TABLEAUS[self.method]


def host_times(ts, dtype):
    """Output times as a host NumPy array in the state's precision.

    The step sequence is planned on the host, as the JAX package plans it from
    concrete times."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    return np.asarray(ts).astype(numpy_dtype(dtype))


def _advance_fixed(rhs, z0, t0, t1, step_size, tableau, max_steps):
    """Fixed steps of ``step_size`` (last step clamped) from t0 to exactly t1.

    t0, t1 and step_size are NumPy scalars in the state's precision, so the
    step times round as the JAX integrator's do.  Steps with dt == 0 are the JAX
    loop's padding iterations, exact identities, and are skipped."""
    t, z = t0, z0
    for _ in range(max_steps):
        dt = np.clip(t1 - t, 0.0, step_size)
        if dt > 0:
            z = rk_step(tableau, rhs, float(t), z, float(dt))
        t = t + dt
    return z


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


def odeint(rhs, z0, ts, cfg: SolverConfig):
    """Integrates dz/dt = rhs(t, z) from ts[0] with a fixed-step method,
    returning z at every ts[i], time leading: (len(ts), ...)."""
    ts = host_times(ts, z0.dtype)
    if ts.shape[0] > 1 and not bool(np.all(np.diff(ts) > 0)):
        raise ValueError("t must be monotonically increasing.")
    tableau = cfg.tableau()
    n_static = min(_static_fixed_steps(ts, cfg.step_size),
                   cfg.max_steps or _FIXED_DEFAULT_MAX_STEPS)

    out = [z0]
    z = z0
    for t0, t1 in zip(ts[:-1], ts[1:]):
        step_size = ts.dtype.type(cfg.step_size if cfg.step_size is not None else t1 - t0)
        z = _advance_fixed(rhs, z, t0, t1, step_size, tableau, n_static)
        out.append(z)
    return torch.stack(out, dim=0)
