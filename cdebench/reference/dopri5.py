"""Dormand-Prince 5(4) with the proportional step-size controller.

As the package documents it (``NeuralCDEConfig``'s defaults, torchdiffeq's
semantics):

* the initial step is the Hairer-Wanner heuristic over the whole batch
  (root mean squares over every row and hidden channel);
* rows are solved in independent groups of ``group_lanes`` rows, each with
  one error norm (the root mean square of err / (atol + rtol max(|z|, |z1|))
  over its rows and hidden channels) and its own controller;
* a step is accepted when that norm is at most 1; the next step is the last
  one times safety * norm^(-1/5), clipped to [dfactor, ifactor] (to
  [dfactor, 1] after a rejection); a step shortened to land on t1 does not
  shrink the proposal; the first stage of a step is the last of the one
  accepted before it;
* gradients are those of the accepted steps with their sizes held fixed.
"""

import math

import torch

A = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
C = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
E = tuple(b5 - b4 for b5, b4 in zip(B5, B4))


def blocks(batch, solve_cfg):
    g = int(solve_cfg["group_lanes"])
    return [slice(r, min(r + g, batch)) for r in range(0, batch, g)]


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


def plan_batch(rhs, z0, t0, t1, model, solve_cfg):
    """The initial step over the whole batch (a host float)."""
    rtol, atol = model["rtol"], model["atol"]
    f0 = rhs(t0, z0)
    scale = atol + torch.abs(z0) * rtol
    d0, d1 = float(_rms(z0 / scale)), float(_rms(f0 / scale))
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    f1 = rhs(t0 + h0, z0 + h0 * f0)
    d2 = float(_rms((f1 - f0) / scale)) / h0
    dmax = max(d1, d2)
    h1 = max(h0 * 1e-3, 1e-6) if dmax <= 1e-15 else (0.01 / dmax) ** (1.0 / 6)
    return {"dt0": min(100 * h0, h1)}


def _combine(z, dt, coeffs, ks):
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            z = z + (dt * c) * k
    return z


def solve(rhs, z0, t0, t1, model, solve_cfg, plan):
    """z(t1) of one group and {"accepted", "attempted"}; NaN where the
    attempt budget ran out before t1."""
    rtol, atol = model["rtol"], model["atol"]
    safety, ifactor, dfactor = solve_cfg["safety"], solve_cfg["ifactor"], solve_cfg["dfactor"]
    cap = int(solve_cfg["max_attempts"])
    t, dt, z = t0, plan["dt0"], z0
    k0 = rhs(t, z)
    accepted = attempted = 0
    while t < t1 and attempted < cap:
        dt = max(dt, 1e-14)
        dt_c = min(dt, t1 - t)
        ks = [k0]
        for c, row in zip(C, A):
            ks.append(rhs(t + c * dt_c, _combine(z, dt_c, row, ks)))
        z1 = _combine(z, dt_c, B5, ks)
        err = dt_c * sum(c * k.detach() for c, k in zip(E, ks) if c != 0.0)
        zd, z1d = z.detach(), z1.detach()
        ratio = float(_rms(err / (atol + rtol * torch.maximum(torch.abs(zd), torch.abs(z1d)))))
        accept = ratio <= 1.0
        factor = safety * max(ratio, 1e-10) ** (-1.0 / 5)
        if not math.isfinite(factor):
            factor = dfactor
        dt_new = dt_c * min(max(factor, dfactor), ifactor if accept else 1.0)
        if accept and dt_c < dt:
            dt_new = max(dt, dt_new)
        if accept:
            z, k0, t = z1, ks[-1], t + dt_c
            accepted += 1
        dt = dt_new
        attempted += 1
    if t < t1:
        z = z * math.nan
    return z, {"rows": z0.shape[0], "accepted": accepted, "attempted": attempted}
