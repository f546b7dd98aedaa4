"""O(1)-memory exact adjoint for the reversible Heun method.

Port of ``torchcde_tpu/solvers/reversible_adjoint.py``.  The update map

    f̂_n     = f(t_n, ŷ_n)
    ŷ_{n+1} = 2 y_n - ŷ_n + h f̂_n
    y_{n+1} = y_n + (h/2)(f̂_n + f(t_{n+1}, ŷ_{n+1}))

is algebraically invertible: the same map with h -> -h from (y_{n+1},
ŷ_{n+1}) returns (y_n, ŷ_n), in exact arithmetic, and to rounding in floating
point.  The backward pass rebuilds each interval's steps with the inverse map
from the state saved at the interval's end, and pulls the cotangents back
through each step's vector-Jacobian product (``torch.autograd.grad``): the
gradients are those of direct backpropagation through the same steps, with
only (y, ŷ) at the output times kept.

Gradients flow to z0, to the given tensors (``params``), and to ``ts`` when it
is a tensor that requires grad.
"""

import math

import numpy as np
import torch

from .integrate import host_times


def _n_steps(t0, t1, h):
    return int(math.ceil((float(t1) - float(t0)) / h - 1e-9))


def _times(t0, t1, j, h):
    """(t, t_next, dt) of step j of an interval, clamped to its end, in the
    times' precision."""
    sc = type(t0)
    t = min(t0 + sc(j * h), t1)
    t_next = min(t0 + sc((j + 1) * h), t1)
    return t, t_next, t_next - t


def _fwd_step(rhs, t, dt, y, yhat):
    fhat = rhs(t, yhat)
    yhat1 = 2 * y - yhat + dt * fhat
    fhat1 = rhs(t + dt, yhat1)
    return y + 0.5 * dt * (fhat + fhat1), yhat1


def _inv_step(rhs, t1, dt, y1, yhat1):
    """Exact inverse: (y_n, ŷ_n) from the state at t1 = t_n + dt."""
    f1 = rhs(t1, yhat1)
    yhat = 2 * y1 - yhat1 - dt * f1
    f0 = rhs(t1 - dt, yhat)
    return y1 - 0.5 * dt * (f1 + f0), yhat


class _ReversibleHeun(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, h, ts, z0, *params):
        # rhs: a FieldClosure (adjoint.py) whose params are ``params``.
        tv = host_times(ts, z0.dtype)
        y, yhat = z0, z0
        # f̂ is carried through each interval and across output times: each
        # step's f̂1 is evaluated at the next step's own t, so the forward
        # pays one evaluation per step.
        fhat = rhs(tv[0], z0)
        ys, yhats = [z0], [z0]
        for t0, t1 in zip(tv[:-1], tv[1:]):
            for j in range(_n_steps(t0, t1, h)):
                t, t_next, dt = _times(t0, t1, j, h)
                yhat1 = 2 * y - yhat + float(dt) * fhat
                fhat1 = rhs(t_next, yhat1)
                y = y + float(0.5 * dt) * (fhat + fhat1)
                yhat, fhat = yhat1, fhat1
            ys.append(y)
            yhats.append(yhat)
        ctx.rhs, ctx.h, ctx.ts = rhs, h, ts
        ys, yhats = torch.stack(ys), torch.stack(yhats)
        ctx.save_for_backward(ys, yhats)
        return ys

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ys, yhats = ctx.saved_tensors
        rhs, h, params = ctx.rhs, ctx.h, ctx.rhs.params
        tv = host_times(ctx.ts, ys.dtype)
        want_t = isinstance(ctx.ts, torch.Tensor) and ctx.needs_input_grad[2]
        ts_bar = np.zeros(len(tv), dtype=np.float64)
        a_y = torch.zeros_like(ys[0])
        a_yhat = torch.zeros_like(ys[0])
        a_params = [torch.zeros_like(p) for p in params]
        for i in range(len(tv) - 1, 0, -1):
            t0, t1 = tv[i - 1], tv[i]
            a_y = a_y + g[i]
            y, yhat = ys[i], yhats[i]
            for j in reversed(range(_n_steps(t0, t1, h))):
                t, t_next, dt = _times(t0, t1, j, h)
                with torch.no_grad():
                    y, yhat = _inv_step(rhs, t_next, float(dt), y, yhat)
                with torch.enable_grad():
                    y_, yhat_ = y.detach().requires_grad_(), yhat.detach().requires_grad_()
                    values = rhs.leaves()
                    leaves = [y_, yhat_, *values]

                    def field(tt, z):
                        return rhs(tt, z, values)

                    if want_t:
                        t_ = torch.tensor(t, dtype=ys.dtype, device=ys.device, requires_grad=True)
                        dt_ = torch.tensor(dt, dtype=ys.dtype, device=ys.device, requires_grad=True)
                        leaves += [t_, dt_]
                        outs = _fwd_step(field, t_, dt_, y_, yhat_)
                    else:
                        outs = _fwd_step(field, t, float(dt), y_, yhat_)
                    vjps = torch.autograd.grad(outs, leaves, (a_y, a_yhat), allow_unused=True,
                                               retain_graph=True)
                vjps = [torch.zeros_like(x) if v is None else v for v, x in zip(vjps, leaves)]
                a_y, a_yhat = vjps[0], vjps[1]
                a_params = [a + v for a, v in zip(a_params, vjps[2:2 + len(params)])]
                if want_t:
                    t_bar, dt_bar = (float(v) for v in vjps[-2:])
                    # t = t0 + j h unless clamped to t1; dt = t_next - t, with
                    # t_next clamped to t1 on the interval's last step.
                    t_clamped = (t0 + j * h) > t1
                    next_clamped = (t0 + (j + 1) * h) > t1
                    ddt = (dt_bar if t_clamped else 0.0) - (dt_bar if next_clamped else 0.0)
                    ts_bar[i - 1] += (0.0 if t_clamped else t_bar) + ddt
                    ts_bar[i] += (t_bar if t_clamped else 0.0) - ddt
        # ŷ_0 = y_0 = z0: both adjoints flow there.
        z0_bar = a_y + g[0] + a_yhat
        ts_grad = None
        if want_t:
            ts_grad = torch.as_tensor(ts_bar, dtype=ctx.ts.dtype, device=ctx.ts.device)
        return (None, None, ts_grad, z0_bar, *a_params)


def reversible_heun_solve(field, z0, ts, step_size):
    """Solve dz/dt = field(t, z) with the reversible Heun method and its exact
    adjoint; output time-leading, like ``odeint``.

    ``field``: a ``FieldClosure`` (see ``adjoint.closure_params``), whose
    params receive gradients.  Each interval [ts[i], ts[i + 1]] takes
    ceil((ts[i + 1] - ts[i]) / step_size) steps, the last one clamped to its
    end."""
    return _ReversibleHeun.apply(field, float(step_size), ts, z0, *field.params)
