"""cdeint: the solver front-end.

Port of ``torchcde_tpu/solvers/cdeint.py::cdeint`` for dopri5 (adaptive, or
at a fixed step_size), euler, midpoint, heun and rk4, with direct
backpropagation or the backsolve adjoint, and for reversible Heun with its
exact adjoint (the torchsde backend's method):

    cdeint(X, func, z0, t, adjoint=True, backend="native", **kwargs)

solves z_t = z_{t0} + int_{t0}^t f(s, z_s) dX_s and returns z at each t[i]
with shape (..., len(t), hidden_channels).  The dispatch, the validation and
the error texts are the JAX package's.  What is not ported yet raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

import warnings

import numpy as np
import torch

from .adjoint import closure_params, odeint_adjoint
from .fused_dopri import try_fused_dopri5
from .fused_fixed import try_fused_fixed
from .fused_reversible_kernel import try_fused_reversible_heun
from .integrate import SolverConfig, host_times, odeint
from .reversible_adjoint import reversible_heun_solve
from .terms import make_cde_rhs

_FIXED_METHODS = ("euler", "midpoint", "heun", "rk4", "reversible_heun")


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to torchcde_tpu_torch yet (ROADMAP.md queue 1, '{item}')."
    )


def _shape(x):
    return tuple(x.shape)


def _check_compatability_per_tensor_base(control_gradient, z0):
    if _shape(control_gradient)[:-1] != _shape(z0)[:-1]:
        raise ValueError(
            "X.derivative did not return a tensor with the same number of batch dimensions as "
            "z0. X.derivative returned shape {} (meaning {} batch dimensions), whilst z0 has "
            "shape {} (meaning {} batch dimensions).".format(
                _shape(control_gradient),
                _shape(control_gradient)[:-1],
                _shape(z0),
                _shape(z0)[:-1],
            )
        )


def _check_compatability_per_tensor_forward(control_gradient, system, z0):
    _check_compatability_per_tensor_base(control_gradient, z0)
    if _shape(system)[:-2] != _shape(z0)[:-1]:
        raise ValueError(
            "func did not return a tensor with the same number of batch dimensions as z0. func "
            "returned shape {} (meaning {} batch dimensions), whilst z0 has shape {} (meaning {}"
            " batch dimensions).".format(
                _shape(system), _shape(system)[:-2], _shape(z0), _shape(z0)[:-1]
            )
        )
    if system.shape[-2] != z0.shape[-1]:
        raise ValueError(
            "func did not return a tensor with the same number of hidden channels as z0. func "
            "returned shape {} (meaning {} channels), whilst z0 has shape {} (meaning {} "
            "channels).".format(_shape(system), system.shape[-2], _shape(z0), z0.shape[-1])
        )
    if system.shape[-1] != control_gradient.shape[-1]:
        raise ValueError(
            "func did not return a tensor with the same number of input channels as X.derivative "
            "returned. func returned shape {} (meaning {} channels), whilst X.derivative "
            "returned shape {} (meaning {} channels).".format(
                _shape(system),
                system.shape[-1],
                _shape(control_gradient),
                control_gradient.shape[-1],
            )
        )


def _check_compatability_per_tensor_prod(control_gradient, vector_field, z0):
    _check_compatability_per_tensor_base(control_gradient, z0)
    if _shape(vector_field) != _shape(z0):
        raise ValueError(
            "func.prod did not return a tensor with the same shape as z0. func.prod returned "
            "shape {} whilst z0 has shape {}.".format(_shape(vector_field), _shape(z0))
        )


def _check_compatability(X, func, z0, t):
    """Probe the control and the field once and validate their shapes.

    Tuple states are ROADMAP item 11 (``TupleControl``) and raise."""
    if not hasattr(X, "derivative"):
        raise ValueError("X must have a 'derivative' method.")
    if isinstance(z0, (tuple, list)):
        raise _not_ported("A tuple/list state z0", "Rest of the solver surface")
    if not isinstance(z0, torch.Tensor):
        raise ValueError("z0 must either a tensor or a tuple/list of tensors.")
    t0 = t[0]
    with torch.no_grad():
        control_gradient = X.derivative(t0)
        if not isinstance(control_gradient, torch.Tensor):
            raise ValueError("z0 is a tensor and so X.derivative must return a tensor as well.")
        if hasattr(func, "prod"):
            vector_field = func.prod(t0, z0, control_gradient)
            if not isinstance(vector_field, torch.Tensor):
                raise ValueError("z0 is a tensor and so func.prod must return a tensor as well.")
            _check_compatability_per_tensor_prod(control_gradient, vector_field, z0)
        else:
            system = func(t0, z0)
            if not isinstance(system, torch.Tensor):
                raise ValueError("z0 is a tensor and so func must return a tensor as well.")
            _check_compatability_per_tensor_forward(control_gradient, system, z0)


def _knots_hint_of(X):
    """The control's knot count, sizing the default adaptive step budget."""
    grid = getattr(X, "grid_points", None)
    if grid is None:
        return None
    try:
        return int(np.shape(grid)[-1])
    except (TypeError, IndexError):
        return None


def _derive_fixed_adjoint_max_steps(adjoint_max_steps, adjoint_method,
                                    adjoint_step_size, t):
    """A fixed-step adjoint's per-interval step bound, derived from t."""
    if adjoint_max_steps is None and adjoint_method in _FIXED_METHODS:
        if adjoint_step_size is not None:
            tv = np.asarray(host_times(t, torch.float64), dtype=np.float64)
            return max(
                1,
                int(np.max(np.ceil(np.diff(tv, axis=-1) / float(adjoint_step_size) - 1e-9))),
            )
    return adjoint_max_steps


def cdeint(X, func, z0, t, adjoint=True, backend="native", **kwargs):
    r"""Solves a system of controlled differential equations.

    Solves z_t = z_{t_0} + \int_{t_0}^t f(s, z_s) dX_s.

    Arguments:
        X: a control with a ``derivative(t) -> (..., input_channels)`` method,
            e.g. ``CubicSpline`` or ``LinearInterpolation``.
        func: callable f(t, z) -> (..., hidden_channels, input_channels), or an
            object with a ``prod(t, z, dXdt) -> (..., hidden_channels)``
            method.  An ``MLPVectorField`` over a uniform ``CubicSpline`` lets
            dopri5 and knot-aligned fixed-step solves (reversible Heun
            among them) run as fused kernels; over a uniform
            ``LinearInterpolation``, dopri5 runs the adaptive kernel's
            linear-control mode.
        z0: initial state (..., hidden_channels).
        t: 1-D output times (strictly increasing); a NumPy array such as
            ``X.interval`` keeps the step plan on the host.
        adjoint: whether to backpropagate through the backsolve adjoint
            (``solvers/adjoint.py``) instead of through the solver's steps.
            Solves that the fused kernels take route to them either way:
            their backward walks the stored steps, within the adjoint's
            memory contract.  The backsolve gives gradients to z0, to
            ``func.parameters()`` (for an ``nn.Module`` field), to the
            control's coefficient tensors and to ``t`` when it is a tensor
            that requires grad.  ``method="reversible_heun"`` takes its exact
            adjoint instead (``solvers/reversible_adjoint.py``: the inverse
            map rebuilds the steps, so the gradients are those of direct
            backpropagation), with ``step_size`` defaulting to the largest
            output interval; the adjoint_method/rtol/atol/options are not
            consulted there.
        backend: "native", the alias "torchdiffeq", or "torchsde", whose
            default method is "midpoint" and whose "milstein" and
            "euler_heun" are "euler" (the diffusion of a CDE is zero).
        **kwargs: method (dopri5, euler, midpoint, heun, rk4,
            reversible_heun), rtol, atol, step_size or options={'step_size':
            ...}, dt (alias for step_size), max_steps, return_stats
            (adjoint=False only: returns ``(out, stats)``), adjoint_rtol/atol/
            method/options/params/max_steps.

    Returns:
        z at each t[i]: shape (..., len(t), hidden_channels).
    """
    kwargs = dict(kwargs)
    atol = kwargs.pop("atol", 1e-6)
    rtol = kwargs.pop("rtol", 1e-4)

    options = dict(kwargs.pop("options", {}) or {})
    step_size = kwargs.pop("step_size", None)
    if "step_size" in options:
        step_size = options.pop("step_size")
    dt = kwargs.pop("dt", None)
    if dt is not None and step_size is None:
        step_size = dt
    if options.pop("jump_t", None) is not None:
        raise _not_ported("options={'jump_t': ...}", "Rest of the solver surface")
    if options.pop("per_sample", False):
        raise _not_ported("options={'per_sample': True}", "Per-sample stepping")
    if "solver" in options:
        raise _not_ported("options={'solver': ...} (scipy_solver)", "Rest of the solver surface")
    if options:
        warnings.warn(f"Ignoring unsupported solver options: {sorted(options)}")

    if backend == "torchsde":
        method = kwargs.pop("method", "midpoint")
        # With no diffusion, milstein's and euler_heun's steps are Euler's.
        method = {"milstein": "euler", "euler_heun": "euler"}.get(method, method)
    elif backend in ("native", "torchdiffeq"):
        method = kwargs.pop("method", None) or "dopri5"
    else:
        raise ValueError(f"Unrecognised backend={backend}")
    if method == "scipy_solver":
        raise _not_ported("method='scipy_solver'", "Rest of the solver surface")
    if method not in _FIXED_METHODS + ("dopri5",):
        raise _not_ported(f"method={method!r}", "Rest of the solver surface")

    max_steps = kwargs.pop("max_steps", None)
    return_stats = kwargs.pop("return_stats", False)
    adjoint_rtol = kwargs.pop("adjoint_rtol", rtol)
    adjoint_atol = kwargs.pop("adjoint_atol", atol)
    adjoint_method = kwargs.pop("adjoint_method", method)
    adjoint_options = dict(kwargs.pop("adjoint_options", {}) or {})
    adjoint_step_size = adjoint_options.pop("step_size", step_size)
    adjoint_params = kwargs.pop("adjoint_params", None)
    adjoint_max_steps = kwargs.pop("adjoint_max_steps", max_steps)
    if kwargs:
        warnings.warn(f"Ignoring unsupported cdeint kwargs: {sorted(kwargs)}")
    if adjoint and adjoint_method not in _FIXED_METHODS + ("dopri5",):
        raise _not_ported(f"adjoint_method={adjoint_method!r}", "Rest of the solver surface")

    if not isinstance(t, np.ndarray):
        t = torch.as_tensor(t)
    if isinstance(step_size, torch.Tensor):
        step_size = float(step_size)
    if t.ndim == 1 and t.shape[0] > 1:
        if isinstance(t, np.ndarray):
            increasing = bool(np.all(np.diff(t) > 0))
        else:
            increasing = bool(torch.all(torch.diff(t) > 0))
        if not increasing:
            raise ValueError("t must be monotonically increasing.")

    _check_compatability(X, func, z0, t)

    knots_hint = _knots_hint_of(X)
    cfg = SolverConfig(method=method, rtol=rtol, atol=atol, step_size=step_size,
                       max_steps=max_steps, knots_hint=knots_hint)
    if return_stats and adjoint:
        raise ValueError(
            "return_stats=True requires adjoint=False (solver statistics are "
            "collected on the direct path)."
        )

    if adjoint and method == "reversible_heun":
        # The algebraically reversible stepper takes its exact O(1)-memory
        # adjoint, fused into the K8 kernel pair where the solve is
        # knot-aligned over an MLP field.
        if step_size is None:
            step_size = float(np.max(np.diff(host_times(t, torch.float64))))
        out = try_fused_reversible_heun(X, func, z0, t, step_size)
        if out is None:
            params = closure_params(func, X, t[0], z0, adjoint_params)
            out = reversible_heun_solve(make_cde_rhs(func, X), params, z0, t, step_size)
        return torch.movedim(out, 0, -2)

    adaptive_fused = method == "dopri5" and step_size is None
    out, stats = None, None
    if (adjoint and adjoint_params is None and adjoint_method == method
            and adjoint_step_size == step_size):
        # The fused kernels store only per-knot / per-accepted-step states,
        # within the adjoint's memory contract, and reverse the exact forward
        # computation; a fixed-step solve takes only the kernel (not the
        # streamed walk, whose autograd would keep every stage).
        if adaptive_fused:
            if adjoint_rtol == rtol and adjoint_atol == atol:
                out = try_fused_dopri5(X, func, z0, t, cfg)
        else:
            out = try_fused_fixed(X, func, z0, t, method, step_size, kernel_only=True)

    if out is None and adjoint:
        adjoint_cfg = SolverConfig(
            method=adjoint_method, rtol=adjoint_rtol, atol=adjoint_atol,
            step_size=adjoint_step_size,
            max_steps=_derive_fixed_adjoint_max_steps(
                adjoint_max_steps, adjoint_method, adjoint_step_size, t),
            knots_hint=knots_hint,
        )
        params = closure_params(func, X, t[0], z0, adjoint_params)
        out = odeint_adjoint(make_cde_rhs(func, X), params, z0, t, cfg, adjoint_cfg)
    elif out is None:
        if not return_stats:
            if method == "reversible_heun":
                # The K8 backward's inverse-map walk gives the gradients of
                # direct backpropagation through the steps.
                if step_size is not None:
                    out = try_fused_reversible_heun(X, func, z0, t, step_size)
            elif adaptive_fused:
                out = try_fused_dopri5(X, func, z0, t, cfg)
            else:
                out = try_fused_fixed(X, func, z0, t, method, step_size)
        if out is None:
            out = odeint(make_cde_rhs(func, X), z0, t, cfg, collect_stats=return_stats)
            if return_stats:
                out, stats = out
    # Time from leading to second-to-last.
    out = torch.movedim(out, 0, -2)
    if return_stats:
        return out, stats
    return out
