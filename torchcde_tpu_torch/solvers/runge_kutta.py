"""Explicit fixed-step Runge–Kutta steps.

Port of the fixed-step part of ``torchcde_tpu/solvers/runge_kutta.py``:
``ButcherTableau``, ``rk_step`` and the euler, midpoint, heun and rk4
tableaus.  State is a tensor.  The adaptive, multistep and reversible methods
are ROADMAP queue 1 items 6, 8 and 11.
"""

from typing import NamedTuple


def _weighted_sum(coeffs, ks):
    """sum_i coeffs[i] * ks[i], skipping exact zeros."""
    total = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        term = c * k
        total = term if total is None else total + term
    return total


class ButcherTableau(NamedTuple):
    alpha: tuple  # c_2..c_s
    beta: tuple  # rows of the (strictly lower triangular) A matrix
    c_sol: tuple  # b


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


def rk_step(tableau: ButcherTableau, rhs, t0, z0, dt):
    """One explicit RK step of size dt from (t0, z0); returns z1."""
    ks = [rhs(t0, z0)]
    for alpha_i, beta_i in zip(tableau.alpha, tableau.beta):
        ti = t0 + alpha_i * dt
        zi = z0 + dt * _weighted_sum(beta_i, ks)
        ks.append(rhs(ti, zi))
    return z0 + dt * _weighted_sum(tableau.c_sol, ks)
