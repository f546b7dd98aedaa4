"""The classical fourth-order Runge-Kutta method at a fixed step.

Stages at t, t + h/2, t + h/2 and t + h; the solution is z + h (k1 + 2 k2 +
2 k3 + k4) / 6.  Rows are independent, so the batch runs in any blocks.
"""

BLOCK_ROWS = 4096


def blocks(batch, solve_cfg):
    return [slice(r, min(r + BLOCK_ROWS, batch)) for r in range(0, batch, BLOCK_ROWS)]


def plan_batch(rhs, z0, t0, t1, model, solve_cfg):
    return None


def solve(rhs, z0, t0, t1, model, solve_cfg, plan):
    """z(t1) and {"evaluations": ...}; the step divides each unit interval."""
    h = float(model["step_size"])
    steps = round((t1 - t0) / h)
    z = z0
    for i in range(steps):
        t = t0 + i * h
        k1 = rhs(t, z)
        k2 = rhs(t + h / 2, z + (h / 2) * k1)
        k3 = rhs(t + h / 2, z + (h / 2) * k2)
        k4 = rhs(t + h, z + h * k3)
        z = z + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    return z, {"rows": z0.shape[0], "evaluations": 4 * steps}
