"""cdeint: the solver front-end, fixed-step methods.

Port of ``torchcde_tpu/solvers/cdeint.py::cdeint`` for euler, midpoint, heun
and rk4 with direct backpropagation (autograd through the steps, or the
fused kernel's backward):

    cdeint(X, func, z0, t, adjoint=True, backend="native", **kwargs)

solves z_t = z_{t0} + int_{t0}^t f(s, z_s) dX_s and returns z at each t[i]
with shape (..., len(t), hidden_channels).  The validation and its error
texts are the JAX package's.  What is not ported yet raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

import warnings

import numpy as np
import torch

from .fused_fixed import try_fused_fixed
from .integrate import SolverConfig, odeint
from .terms import make_cde_rhs

_FIXED_METHODS = ("euler", "midpoint", "heun", "rk4")


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


def cdeint(X, func, z0, t, adjoint=True, backend="native", **kwargs):
    r"""Solves a system of controlled differential equations.

    Solves z_t = z_{t_0} + \int_{t_0}^t f(s, z_s) dX_s.

    Arguments:
        X: a control with a ``derivative(t) -> (..., input_channels)`` method,
            e.g. ``CubicSpline``.
        func: callable f(t, z) -> (..., hidden_channels, input_channels), or an
            object with a ``prod(t, z, dXdt) -> (..., hidden_channels)``
            method.  An ``MLPVectorField`` lets knot-aligned solves run as
            one fused kernel.
        z0: initial state (..., hidden_channels).
        t: 1-D output times (strictly increasing); a NumPy array such as
            ``X.interval`` keeps the step plan on the host.
        adjoint: must be False in this port for now: gradients come from
            direct backpropagation.
        backend: "native", or the alias "torchdiffeq".
        **kwargs: method (euler, midpoint, heun, rk4), step_size or
            options={'step_size': ...}, dt (alias for step_size), max_steps,
            rtol and atol (accepted, unused by fixed-step methods).

    Returns:
        z at each t[i]: shape (..., len(t), hidden_channels).
    """
    kwargs = dict(kwargs)
    kwargs.pop("atol", None)
    kwargs.pop("rtol", None)

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
        raise _not_ported("backend='torchsde'", "Reversible Heun")
    if backend not in ("native", "torchdiffeq"):
        raise ValueError(f"Unrecognised backend={backend}")
    method = kwargs.pop("method", None) or "dopri5"
    if method == "scipy_solver":
        raise _not_ported("method='scipy_solver'", "Rest of the solver surface")
    if method == "reversible_heun":
        raise _not_ported("method='reversible_heun'", "Reversible Heun")
    if method in ("dopri5", "bosh3", "dopri8", "adaptive_heun", "fehlberg2"):
        raise _not_ported(f"Adaptive method={method!r}", "Adaptive solves and the adjoint")
    if method not in _FIXED_METHODS:
        raise _not_ported(f"method={method!r}", "Rest of the solver surface")

    max_steps = kwargs.pop("max_steps", None)
    if kwargs.pop("return_stats", False):
        raise _not_ported("return_stats=True", "Rest of the solver surface")
    for name in [k for k in kwargs if k.startswith("adjoint_")]:
        kwargs.pop(name)
    if kwargs:
        warnings.warn(f"Ignoring unsupported cdeint kwargs: {sorted(kwargs)}")
    if adjoint:
        raise _not_ported("adjoint=True", "Adaptive solves and the adjoint")

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

    out = try_fused_fixed(X, func, z0, t, method, step_size)
    if out is None:
        cfg = SolverConfig(method=method, step_size=step_size, max_steps=max_steps)
        out = odeint(make_cde_rhs(func, X), z0, t, cfg)
    # Time from leading to second-to-last.
    return torch.movedim(out, 0, -2)
