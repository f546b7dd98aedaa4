"""Explicit Runge–Kutta steps.

Port of ``torchcde_tpu/solvers/runge_kutta.py`` for euler, midpoint, heun and
rk4 (``TABLEAUS``, ``rk_step``), for dopri5 with its error estimate, its
4th-order dense-output midpoint and the first-same-as-last stepper
(``DOPRI5``), and for the algebraically reversible Heun method, whose
stepper carries its companion state (``STEPPERS``).  State is a tensor.  The
other adaptive and multistep methods are ROADMAP queue 1 item 11.

``TABLEAUS`` holds only the methods whose stage s reads only stage s - 1:
the fused fixed-step kernel admits every method in it.  dopri5 reads all its
earlier stages, so it lives in ``STEPPERS`` alone.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def _weighted_sum(coeffs, ks):
    """sum_i coeffs[i] * ks[i], skipping exact zeros."""
    total = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        term = c * k
        total = term if total is None else total + term
    if total is None:
        total = 0.0 * ks[0]
    return total


class ButcherTableau(NamedTuple):
    alpha: tuple  # c_2..c_s
    beta: tuple  # rows of the (strictly lower triangular) A matrix
    c_sol: tuple  # b
    c_error: Optional[tuple] = None  # b - b_hat, or None for fixed-step methods
    order: int = 1  # the step controller's exponent order (adaptive methods)


TABLEAUS = {
    "euler": ButcherTableau(alpha=(), beta=(), c_sol=(1.0,)),
    "midpoint": ButcherTableau(alpha=(0.5,), beta=((0.5,),), c_sol=(0.0, 1.0)),
    "heun": ButcherTableau(alpha=(1.0,), beta=((1.0,),), c_sol=(0.5, 0.5)),
    "rk4": ButcherTableau(
        alpha=(0.5, 0.5, 1.0),
        beta=((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
        c_sol=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
    ),
}

_DOPRI5_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI5_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)

DOPRI5 = ButcherTableau(
    alpha=(1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    beta=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    c_sol=_DOPRI5_B,
    c_error=tuple(b - b4 for b, b4 in zip(_DOPRI5_B, _DOPRI5_B4)),
    order=5,
)


def scalar(x):
    """A step's time or size as a factor of a tensor: host scalars become
    Python floats, tensors (times that carry a gradient) stay tensors."""
    return x if isinstance(x, torch.Tensor) else float(x)


def rk_step(tableau: ButcherTableau, rhs, t0, z0, dt):
    """One explicit RK step of size dt from (t0, z0); returns z1.  t0 and dt
    are host scalars, or 0-d tensors where the output times carry a
    gradient."""
    ks = [rhs(t0, z0)]
    for alpha_i, beta_i in zip(tableau.alpha, tableau.beta):
        ti = t0 + alpha_i * dt
        zi = z0 + dt * _weighted_sum(beta_i, ks)
        ks.append(rhs(ti, zi))
    return z0 + dt * _weighted_sum(tableau.c_sol, ks)


def _solve_dense_midpoint(tableau: ButcherTableau):
    """Weights b(1/2) of a 4th-order continuous extension of the tableau.

    Solves the eight rooted-tree conditions through order 4 at theta = 1/2
    (float64 least squares), as the JAX package does; None if they cannot be
    met."""
    s = len(tableau.c_sol)
    c = np.zeros(s)
    c[1 : 1 + len(tableau.alpha)] = tableau.alpha
    A = np.zeros((s, s))
    for i, row in enumerate(tableau.beta):
        A[i + 1, : len(row)] = row
    Ac, Ac2, AAc = A @ c, A @ (c * c), A @ (A @ c)
    M = np.stack([np.ones(s), c, c * c, Ac, c**3, c * Ac, Ac2, AAc])
    th = 0.5
    rhs = np.array([th, th**2 / 2, th**3 / 3, th**3 / 6,
                    th**4 / 4, th**4 / 8, th**4 / 12, th**4 / 24])
    bmid, *_ = np.linalg.lstsq(M, rhs, rcond=None)
    if np.abs(M @ bmid - rhs).max() > 1e-10:
        return None
    return tuple(float(b) for b in bmid)


DOPRI5_BMID = _solve_dense_midpoint(DOPRI5)


class Stepper(NamedTuple):
    init: Callable  # (rhs, t0, z0) -> state
    step: Callable  # (rhs, t, z, dt, state) -> (z1, err or None, state1)
    order: int
    # Adaptive steppers take the controller when no step_size is given;
    # the others take fixed steps (integrate.py).
    adaptive: bool
    # (rhs, t, z, dt, state) -> (z1, err, state1, (f0, f1, y_mid)): the triple
    # feeds the quartic dense output (integrate.py); None for fixed steps.
    step_dense: Optional[Callable]
    nfe_per_step: int
    init_nfe: int


def _make_dopri5_fsal() -> Stepper:
    """Dormand–Prince 5(4) with the first-same-as-last optimisation: the 7th
    stage is f(t + dt, z1), so it seeds the next step's first stage (6
    evaluations per step).  The cached stage stays valid across rejections
    (same (t, z)) and across output times."""
    tab = DOPRI5

    def init(rhs, t0, z0):
        return rhs(t0, z0)

    # t and dt are host scalars (NumPy scalars keep the state's precision in
    # the stage times), or 0-d tensors where the output times carry a
    # gradient; the tensor products take dt through ``scalar``.
    def stages(rhs, t, z, dt, k1):
        ks = [k1]
        h = scalar(dt)
        for alpha_i, beta_i in zip(tab.alpha, tab.beta):
            ks.append(rhs(t + alpha_i * dt, z + h * _weighted_sum(beta_i, ks)))
        z1 = z + h * _weighted_sum(tab.c_sol, ks)
        err = h * _weighted_sum(tab.c_error, ks)
        return ks, z1, err

    def step(rhs, t, z, dt, k1):
        ks, z1, err = stages(rhs, t, z, dt, k1)
        return z1, err, ks[-1]

    def step_dense(rhs, t, z, dt, k1):
        ks, z1, err = stages(rhs, t, z, dt, k1)
        y_mid = z + scalar(dt) * _weighted_sum(DOPRI5_BMID, ks)
        return z1, err, ks[-1], (ks[0], ks[-1], y_mid)

    return Stepper(init=init, step=step, order=tab.order, adaptive=True,
                   step_dense=step_dense, nfe_per_step=6, init_nfe=1)


def _make_reversible_heun() -> Stepper:
    """Algebraically reversible Heun (Kidger et al. 2021, the torchsde
    capability).  The state is the companion (ŷ, f(t, ŷ)); one evaluation per
    step; second order.  The update is exactly invertible, which
    ``reversible_adjoint.py`` uses to rebuild the trajectory backwards."""

    def init(rhs, t0, z0):
        return (z0, rhs(t0, z0))

    def step(rhs, t, z, dt, state):
        yhat, fhat = state
        yhat1 = (2.0 * z - yhat) + scalar(dt) * fhat
        fhat1 = rhs(t + dt, yhat1)
        z1 = z + scalar(0.5 * dt) * (fhat + fhat1)
        return z1, None, (yhat1, fhat1)  # no error estimate: never adaptive

    return Stepper(init=init, step=step, order=2, adaptive=False, step_dense=None,
                   nfe_per_step=1, init_nfe=1)


STEPPERS = {"dopri5": _make_dopri5_fsal(), "reversible_heun": _make_reversible_heun()}

# Every method name of the JAX package (its runge_kutta.STEPPERS).  A name
# here that the port lacks is not ported yet; any other name is unknown.
METHODS = ("euler", "midpoint", "heun", "heun3", "rk4", "bosh3", "dopri5", "dopri5_nofsal",
           "dopri8", "adaptive_heun", "fehlberg2", "reversible_heun", "explicit_adams",
           "implicit_adams", "fixed_adams")


def unknown_method(name):
    """The JAX package's error for a method name it does not know (for an
    adjoint_method too: its solver configuration raises it)."""
    return ValueError(f"Unrecognised method={name!r}; expected one of {sorted(METHODS)}")
