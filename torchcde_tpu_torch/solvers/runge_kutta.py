"""Explicit Runge–Kutta and Adams steppers.

Port of ``torchcde_tpu/solvers/runge_kutta.py``: the Butcher tableaus of
euler, midpoint, heun, heun3, rk4, bosh3, dopri5, dopri8, adaptive_heun and
fehlberg2; the general stepper of a tableau (``_make_rk_stepper``), whose
dense step exists for the first-same-as-last pairs; dopri5 with its cached
first stage; the algebraically reversible Heun method; the fourth-order
Adams–Bashforth and Adams–Bashforth–Moulton multistep methods; and
``STEPPERS``, every method name of the JAX package.  State is a tensor.

``TABLEAUS`` holds only euler, midpoint, heun and rk4, the methods whose
stage s reads only stage s - 1: the fused fixed-step kernel admits every
method in it, as the JAX package's fuses exactly these four.  The other
tableaus live in ``STEPPERS`` alone.
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
    order: int = 1  # the method's order, the step controller's exponent


TABLEAUS = {
    "euler": ButcherTableau(alpha=(), beta=(), c_sol=(1.0,)),
    "midpoint": ButcherTableau(alpha=(0.5,), beta=((0.5,),), c_sol=(0.0, 1.0), order=2),
    "heun": ButcherTableau(alpha=(1.0,), beta=((1.0,),), c_sol=(0.5, 0.5), order=2),
    "rk4": ButcherTableau(
        alpha=(0.5, 0.5, 1.0),
        beta=((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
        c_sol=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
        order=4,
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

# Heun's third-order method (a fixed-step method: no error estimate).
HEUN3 = ButcherTableau(alpha=(1 / 3, 2 / 3), beta=((1 / 3,), (0.0, 2 / 3)),
                       c_sol=(0.25, 0.0, 0.75), order=3)

_BOSH3_B = (2 / 9, 1 / 3, 4 / 9, 0.0)
_BOSH3_BHAT = (7 / 24, 1 / 4, 1 / 3, 1 / 8)

BOSH3 = ButcherTableau(
    alpha=(1 / 2, 3 / 4, 1.0),
    beta=((1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    c_sol=_BOSH3_B,
    c_error=tuple(b - bh for b, bh in zip(_BOSH3_B, _BOSH3_BHAT)),
    order=3,
)

# Heun–Euler 2(1): the trapezoidal step, the Euler step its error reference.
_AHEUN_B = (0.5, 0.5)
_AHEUN_BHAT = (1.0, 0.0)

ADAPTIVE_HEUN = ButcherTableau(
    alpha=(1.0,), beta=((1.0,),), c_sol=_AHEUN_B,
    c_error=tuple(b - bh for b, bh in zip(_AHEUN_B, _AHEUN_BHAT)), order=2,
)

# Fehlberg's RK1(2) pair.
_FEHLBERG2_B = (1 / 256, 255 / 256, 0.0)
_FEHLBERG2_BHAT = (1 / 512, 255 / 256, 1 / 512)

FEHLBERG2 = ButcherTableau(
    alpha=(1 / 2, 1.0), beta=((1 / 2,), (1 / 256, 255 / 256)), c_sol=_FEHLBERG2_B,
    c_error=tuple(b - bh for b, bh in zip(_FEHLBERG2_B, _FEHLBERG2_BHAT)), order=2,
)

# Prince–Dormand RK8(7)13M (Prince & Dormand 1981, "High order embedded
# Runge-Kutta formulae"), the constants of the JAX package.
_DOPRI8_B = (
    14005451 / 335480064, 0.0, 0.0, 0.0, 0.0, -59238493 / 1068277825,
    181606767 / 758867731, 561292985 / 797845732, -1041891430 / 1371343529,
    760417239 / 1151165299, 118820643 / 751138087, -528747749 / 2220607170,
    1 / 4,
)
_DOPRI8_BHAT = (
    13451932 / 455176623, 0.0, 0.0, 0.0, 0.0, -808719846 / 976000145,
    1757004468 / 5645159321, 656045339 / 265891186, -3867574721 / 1518517206,
    465885868 / 322736535, 53011238 / 667516719, 2 / 45, 0.0,
)

DOPRI8 = ButcherTableau(
    alpha=(
        1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
        5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1.0, 1.0,
    ),
    beta=(
        (1 / 18,),
        (1 / 48, 1 / 16),
        (1 / 32, 0.0, 3 / 32),
        (5 / 16, 0.0, -75 / 64, 75 / 64),
        (3 / 80, 0.0, 0.0, 3 / 16, 3 / 20),
        (29443841 / 614563906, 0.0, 0.0, 77736538 / 692538347,
         -28693883 / 1125000000, 23124283 / 1800000000),
        (16016141 / 946692911, 0.0, 0.0, 61564180 / 158732637,
         22789713 / 633445777, 545815736 / 2771057229, -180193667 / 1043307555),
        (39632708 / 573591083, 0.0, 0.0, -433636366 / 683701615,
         -421739975 / 2616292301, 100302831 / 723423059, 790204164 / 839813087,
         800635310 / 3783071287),
        (246121993 / 1340847787, 0.0, 0.0, -37695042795 / 15268766246,
         -309121744 / 1061227803, -12992083 / 490766935, 6005943493 / 2108947869,
         393006217 / 1396673457, 123872331 / 1001029789),
        (-1028468189 / 846180014, 0.0, 0.0, 8478235783 / 508512852,
         1311729495 / 1432422823, -10304129995 / 1701304382,
         -48777925059 / 3047939560, 15336726248 / 1032824649,
         -45442868181 / 3398467696, 3065993473 / 597172653),
        (185892177 / 718116043, 0.0, 0.0, -3185094517 / 667107341,
         -477755414 / 1098053517, -703635378 / 230739211, 5731566787 / 1027545527,
         5232866602 / 850066563, -4093664535 / 808688257, 3962137247 / 1805957418,
         65686358 / 487910083),
        (403863854 / 491063109, 0.0, 0.0, -5068492393 / 434740067,
         -411421997 / 543043805, 652783627 / 914296604, 11173962825 / 925320556,
         -13158990841 / 6184727034, 3936647629 / 1978049680, -160528059 / 685178525,
         248638103 / 1413531060, 0.0),
    ),
    c_sol=_DOPRI8_B,
    c_error=tuple(b - bh for b, bh in zip(_DOPRI8_B, _DOPRI8_BHAT)),
    order=8,
)


def scalar(x):
    """A step's time or size as a factor of a tensor: host scalars become
    Python floats, tensors (times that carry a gradient) stay tensors."""
    return x if isinstance(x, torch.Tensor) else float(x)


def _rk_stages(tableau: ButcherTableau, rhs, t0, z0, dt):
    """The stages ks of one explicit RK step of size dt from (t0, z0), and
    z1.  t0 and dt are host scalars, or 0-d tensors where the output times
    carry a gradient."""
    ks = [rhs(t0, z0)]
    h = scalar(dt)
    for alpha_i, beta_i in zip(tableau.alpha, tableau.beta):
        ks.append(rhs(t0 + alpha_i * dt, z0 + h * _weighted_sum(beta_i, ks)))
    return ks, z0 + h * _weighted_sum(tableau.c_sol, ks)


def rk_step(tableau: ButcherTableau, rhs, t0, z0, dt):
    """One explicit RK step of size dt from (t0, z0); returns z1."""
    return _rk_stages(tableau, rhs, t0, z0, dt)[1]



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
    # The tableau of a stateless RK stepper, whose fixed steps the driver
    # takes as plain RK steps; None for the steppers with a state.
    tableau: Optional[ButcherTableau] = None


def _is_fsal(tableau: ButcherTableau) -> bool:
    """True when the last stage is f(t + dt, z1): alpha ends at 1 and the last
    A row equals b, so ks[-1] is the derivative at the step's end."""
    if not tableau.alpha or tableau.alpha[-1] != 1.0:
        return False
    last = tableau.beta[-1]
    return all(
        b == (last[j] if j < len(last) else 0.0) for j, b in enumerate(tableau.c_sol[:-1])
    ) and tableau.c_sol[-1] == 0.0


def _hermite_midpoint(z0, z1, f0, f1, dt):
    """The cubic Hermite value at theta = 1/2 (the 3rd-order fallback midpoint)."""
    return 0.5 * (z0 + z1) + scalar(0.125 * dt) * (f0 - f1)


def _make_rk_stepper(tableau: ButcherTableau) -> Stepper:
    """The stateless stepper of a tableau.  Its dense step (the quartic dense
    output's triple) exists only where the tableau is first-same-as-last, so
    that ks[-1] is the derivative at the step's end; the adaptive steppers
    without it restart at every output time (integrate.py)."""

    def init(rhs, t0, z0):
        return None

    def stages(rhs, t, z, dt):
        ks, z1 = _rk_stages(tableau, rhs, t, z, dt)
        err = None
        if tableau.c_error is not None:
            err = scalar(dt) * _weighted_sum(tableau.c_error, ks)
        return ks, z1, err

    def step(rhs, t, z, dt, state):
        _ks, z1, err = stages(rhs, t, z, dt)
        return z1, err, None

    step_dense = None
    if tableau.c_error is not None and _is_fsal(tableau):
        bmid = _solve_dense_midpoint(tableau)

        def step_dense(rhs, t, z, dt, state):
            ks, z1, err = stages(rhs, t, z, dt)
            if bmid is not None:
                y_mid = z + scalar(dt) * _weighted_sum(bmid, ks)
            else:
                y_mid = _hermite_midpoint(z, z1, ks[0], ks[-1], dt)
            return z1, err, None, (ks[0], ks[-1], y_mid)

    return Stepper(init=init, step=step, order=tableau.order,
                   adaptive=tableau.c_error is not None, step_dense=step_dense,
                   nfe_per_step=len(tableau.alpha) + 1, init_nfe=0, tableau=tableau)


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


def _make_adams_stepper(implicit: bool) -> Stepper:
    """Fixed-step 4th-order Adams multistep methods: Adams–Bashforth
    ("explicit_adams") and Adams–Bashforth–Moulton in PECE
    predictor–corrector form ("implicit_adams", "fixed_adams").

    The state carries a step count, a host integer, and the derivative
    history (f_n .. f_{n-3}); the first three steps bootstrap with single RK4
    steps.  Steady state: 1 evaluation per step explicit, 2 implicit.  The
    constant-step coefficients assume a uniform grid: a clamped last step
    lowers the formal order locally, as in the JAX package."""
    ab4 = (55 / 24, -59 / 24, 37 / 24, -9 / 24)
    am4 = (9 / 24, 19 / 24, -5 / 24, 1 / 24)  # on (f_pred, f_n, f_{n-1}, f_{n-2})

    def init(rhs, t0, z0):
        f0 = rhs(t0, z0)
        zero = 0.0 * f0
        return (0, (f0, zero, zero, zero))

    def step(rhs, t, z, dt, state):
        count, (f0, f1, f2, f3) = state
        h = scalar(dt)
        if count >= 3:
            z1 = z + h * _weighted_sum(ab4, (f0, f1, f2, f3))
            if implicit:
                fp = rhs(t + dt, z1)
                z1 = z + h * _weighted_sum(am4, (fp, f0, f1, f2))
        else:
            z1 = rk_step(TABLEAUS["rk4"], rhs, t, z, dt)
        f_new = rhs(t + dt, z1)  # the trailing E of PECE; the next step's f_n
        return z1, None, (count + 1, (f_new, f0, f1, f2))

    return Stepper(init=init, step=step, order=4, adaptive=False, step_dense=None,
                   nfe_per_step=2 if implicit else 1, init_nfe=1)


_ADAMS_IMPLICIT = _make_adams_stepper(implicit=True)

# Every method name of the JAX package, with its declared evaluation counts.
STEPPERS = {
    "euler": _make_rk_stepper(TABLEAUS["euler"]),
    "midpoint": _make_rk_stepper(TABLEAUS["midpoint"]),
    "heun": _make_rk_stepper(TABLEAUS["heun"]),
    "heun3": _make_rk_stepper(HEUN3),
    "rk4": _make_rk_stepper(TABLEAUS["rk4"]),
    "bosh3": _make_rk_stepper(BOSH3),
    "dopri5": _make_dopri5_fsal(),
    "dopri5_nofsal": _make_rk_stepper(DOPRI5),
    "dopri8": _make_rk_stepper(DOPRI8),
    "adaptive_heun": _make_rk_stepper(ADAPTIVE_HEUN),
    "fehlberg2": _make_rk_stepper(FEHLBERG2),
    "reversible_heun": _make_reversible_heun(),
    "explicit_adams": _make_adams_stepper(implicit=False),
    "implicit_adams": _ADAMS_IMPLICIT,
    "fixed_adams": _ADAMS_IMPLICIT,  # the torchdiffeq alias of the ABM corrector
}


def unknown_method(name):
    """The JAX package's error for a method name it does not know (for an
    adjoint_method too: its solver configuration raises it)."""
    return ValueError(f"Unrecognised method={name!r}; expected one of {sorted(STEPPERS)}")
