"""The backsolve adjoint: O(1)-in-steps memory backpropagation.

Port of ``torchcde_tpu/solvers/adjoint.py``.  The forward solve keeps only the
outputs at ``ts``; the backward pass integrates the augmented adjoint ODE

    d/dt [z, a, a_theta] = [f, -a^T df/dz, -a^T df/dtheta]

in reverse over each output interval, restarting z from the saved forward
value at every output time.  The reverse solve runs ``odeint`` forwards in
s = -t on the augmented state flattened into one vector: the error norm of
the JAX package is the root mean square over all leaves of its pytree, which
is the same number.  Vector-Jacobian products come from
``torch.autograd.grad``.

Gradients flow to z0, to the given tensors (``params``), and to ``ts`` when it
is a tensor that requires grad.
"""

import warnings

import numpy as np
import torch

from .integrate import SolverConfig, host_times, odeint
from .terms import make_cde_rhs


def _reached(rhs, t0, z0, tensors):
    """The tensors that rhs(t0, z0) depends on, as the arrays a JAX trace of
    the vector field closes over."""
    tensors = [p for p in tensors if p.requires_grad]
    if not tensors:
        return []
    with torch.enable_grad():
        f = rhs(t0, z0.detach())
        grads = torch.autograd.grad(f, tensors, torch.ones_like(f), allow_unused=True)
    return [p for p, g in zip(tensors, grads) if g is not None]


def closure_params(func, X, t0, z0, adjoint_params=None):
    """The tensors that receive adjoint gradients.

    By default every tensor the vector field reads: ``func.parameters()``
    (for an ``nn.Module`` field) and the control's coefficient tensors, as
    the JAX package's closure conversion finds every array the field closes
    over.  ``adjoint_params`` narrows that set; if one of its tensors is not
    read by the field, the whole set is used, with the JAX package's
    warning."""
    rhs = make_cde_rhs(func, X)
    if adjoint_params is not None:
        wanted = list({id(p): p for p in adjoint_params}.values())
        found = _reached(rhs, t0, z0, wanted)
        if len(found) == len(wanted):
            return found
        warnings.warn(
            "Could not identify every adjoint_params entry among the "
            "arrays the vector field closes over; computing adjoint "
            "gradients for the full closure superset instead."
        )
    # The control's tensors first, as the JAX trace meets them.
    candidates = [v for v in vars(X).values()
                  if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if callable(getattr(func, "parameters", None)):
        candidates += list(func.parameters())
    return _reached(rhs, t0, z0, list({id(p): p for p in candidates}.values()))


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, cfg, adjoint_cfg, ts, z0, *params):
        zs = odeint(rhs, z0, ts, cfg, differentiable=False)
        ctx.rhs, ctx.adjoint_cfg, ctx.params = rhs, adjoint_cfg, params
        ctx.ts = ts
        ctx.save_for_backward(zs)
        return zs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (zs,) = ctx.saved_tensors
        rhs, params = ctx.rhs, ctx.params
        ts = host_times(ctx.ts, zs.dtype)
        shape, nz = zs.shape[1:], zs[0].numel()
        sizes = [nz, nz] + [p.numel() for p in params]

        def aug_rhs(s, aug):
            # s = -t; d/ds z = -f, d/ds a = +a^T df/dz, d/ds a_p = +a^T df/dp.
            z, a = aug[:nz].view(shape), aug[nz:2 * nz].view(shape)
            with torch.enable_grad():
                z_ = z.detach().requires_grad_()
                f = rhs(-s, z_)
                vjps = torch.autograd.grad(f, (z_,) + tuple(params), a, allow_unused=True)
            parts = [-f.detach()] + [torch.zeros_like(p) if v is None else v
                                     for v, p in zip(vjps, (z_,) + tuple(params))]
            return torch.cat([v.reshape(-1) for v in parts])

        want_t = isinstance(ctx.ts, torch.Tensor) and ctx.needs_input_grad[3]
        ts_bar = torch.zeros(len(ts), dtype=zs.dtype, device=zs.device) if want_t else None
        a = torch.zeros_like(zs[0])
        a_params = torch.zeros(sum(sizes[2:]), dtype=zs.dtype, device=zs.device)
        for i in range(len(ts) - 1, 0, -1):
            a = a + g[i]
            if want_t:
                # dL/dts[i] = g_i . f(ts[i], z_i): the readout-time sensitivity.
                ts_bar[i] = torch.sum(g[i] * rhs(ts[i], zs[i]))
            aug0 = torch.cat([zs[i].reshape(-1), a.reshape(-1), a_params])
            span = np.stack([-ts[i], -ts[i - 1]])
            aug1 = odeint(aug_rhs, aug0, span, ctx.adjoint_cfg, differentiable=False)[1]
            a, a_params = aug1[nz:2 * nz].view(shape), aug1[2 * nz:]
        if want_t:
            # dL/dts[0] = -a(t0) . f(t0, z0), with a(t0) excluding g_0.
            ts_bar[0] = -torch.sum(a * rhs(ts[0], zs[0]))
            ts_bar = ts_bar.to(ctx.ts.dtype)
        grads = [v.view(p.shape) for v, p in zip(torch.split(a_params, sizes[2:]), params)
                 ] if params else []
        return (None, None, None, ts_bar, a + g[0], *grads)


def odeint_adjoint(rhs, params, z0, ts, cfg: SolverConfig, adjoint_cfg: SolverConfig):
    """Solve dz/dt = rhs(t, z) with backsolve-adjoint gradients.

    ``params``: the tensors rhs reads that receive gradients (see
    ``closure_params``).  Output is time-leading, like ``odeint``."""
    return _OdeintAdjoint.apply(rhs, cfg, adjoint_cfg, ts, z0, *params)
