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

import copy
import warnings

import numpy as np
import torch

from .adjoint import FieldClosure, closure_params, odeint_adjoint
from .fused_dopri import try_fused_dopri5
from .fused_dopri_persample import try_fused_dopri5_per_sample
from .fused_fixed import try_fused_fixed
from .fused_reversible_kernel import try_fused_reversible_heun
from .integrate import SolverConfig, host_times, odeint
from .reversible_adjoint import reversible_heun_solve
from .runge_kutta import METHODS, unknown_method
from .terms import make_cde_rhs

_FIXED_METHODS = ("euler", "midpoint", "heun", "rk4", "reversible_heun")


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to torchcde_tpu_torch yet (ROADMAP.md queue 1, '{item}')."
    )


def _check_method(name, what="method"):
    """The JAX package's ValueError for an unknown name; a name of the JAX
    package that the port lacks is not ported yet."""
    if name in _FIXED_METHODS + ("dopri5",):
        return
    if name in METHODS:
        raise _not_ported(f"{what}={name!r}", "Rest of the solver surface")
    raise unknown_method(name)


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
    per_sample = options.pop("per_sample", False)
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
    _check_method(method)

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
    if adjoint:
        _check_method(adjoint_method, "adjoint_method")

    if not isinstance(t, np.ndarray):
        t = torch.as_tensor(t)
    if isinstance(step_size, torch.Tensor):
        step_size = float(step_size)
    if t.ndim == 1 and t.shape[0] > 1 and not _increasing(t):
        raise ValueError("t must be monotonically increasing.")

    if per_sample and t.ndim > 1:
        # Batched output times: validated against one row here, every row's
        # order in _cdeint_per_sample.
        _check_compatability(X, func, z0, t.reshape(-1, t.shape[-1])[0])
    else:
        _check_compatability(X, func, z0, t)

    if per_sample:
        return _cdeint_per_sample(
            X, func, z0, t, adjoint=adjoint, method=method, rtol=rtol, atol=atol,
            step_size=step_size, max_steps=max_steps, return_stats=return_stats,
            adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
            adjoint_method=adjoint_method, adjoint_step_size=adjoint_step_size,
            adjoint_params=adjoint_params, adjoint_max_steps=adjoint_max_steps)

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
            field = closure_params(func, X, t[0], z0, adjoint_params)
            out = reversible_heun_solve(field, z0, t, step_size)
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
        field = closure_params(func, X, t[0], z0, adjoint_params)
        out = odeint_adjoint(field, z0, t, cfg, adjoint_cfg)
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


def _increasing(t):
    """Whether every row of t (..., n) is strictly increasing."""
    if isinstance(t, np.ndarray):
        return bool(np.all(np.diff(t, axis=-1) > 0))
    return bool(torch.all(torch.diff(t.detach(), dim=-1) > 0))


class _Lanes:
    """The control of each lane of a flattened batch.

    As the JAX package's per-sample path maps the control's pytree: every
    tensor with three or more dimensions is batched, (..., n, channels),
    flattened to (batch, n, channels), and a lane reads its own row; the
    others (knot times, a control shared by every lane) are shared."""

    def __init__(self, X, batch):
        self.X, self.batch = X, batch
        self.rows = {}
        for name, v in vars(X).items():
            if isinstance(v, torch.Tensor) and v.ndim >= 3:
                v = v.reshape((-1,) + tuple(v.shape[-2:]))
                if v.shape[0] != batch:
                    raise ValueError(
                        "per_sample: the control's batch dimensions "
                        f"(flattened size {v.shape[0]}) must match the state's "
                        f"(flattened size {batch})."
                    )
                self.rows[name] = v

    def _with(self, pick):
        X = copy.copy(self.X)
        for name, v in self.rows.items():
            setattr(X, name, pick(v))
        return X

    def flat(self):
        """The control with every batched tensor flattened to (batch, n, C)."""
        return self._with(lambda v: v)

    def __getitem__(self, i):
        return self._with(lambda v: v[i])


def _every_control_tensor(field):
    """The lane's closure as the JAX package's per-sample adjoint builds it:
    every array of the control, its knot times too, is an explicit constant
    of the adjoint (JAX ``cdeint.py:728-743``), read or not, then the tensors
    the field closes over.  Their cotangents are part of the adjoint's
    augmented state, whose error norm counts them."""
    X = copy.copy(field.X)
    dtype = next(v for v in vars(X).values() if isinstance(v, torch.Tensor)).dtype
    for name, v in vars(X).items():
        if isinstance(v, np.ndarray):
            setattr(X, name, torch.as_tensor(v, dtype=dtype))
    controls = [v for v in vars(X).values() if isinstance(v, torch.Tensor)]
    own = {id(v) for v in vars(field.X).values()}
    return FieldClosure(field.func, X, controls + [p for p in field.params if id(p) not in own])


def _cdeint_per_sample(X, func, z0, t, *, adjoint, method, rtol, atol, step_size, max_steps,
                       return_stats, adjoint_rtol, adjoint_atol, adjoint_method,
                       adjoint_step_size, adjoint_params, adjoint_max_steps):
    """``options={'per_sample': True}``: every sample of the batch runs its
    own adaptive solve, with its own error norm, PI controller and accepted
    steps (torchode's design; JAX ``cdeint.py::_cdeint_per_sample``).

    Output times t may be batched, (..., n_times) matching the state's batch
    dimensions: each sample then reads out at (and integrates over) its own
    times.  ``return_stats`` reports each sample's counts, shaped like the
    batch.  An ``MLPVectorField`` over a uniform control takes the fused
    per-lane kernel K9 (``fused_dopri_persample.py``), for either
    ``adjoint``; otherwise each lane runs the general integrator (the JAX
    package's vmap of a one-sample solve with the fused routes off) or, with
    ``adjoint=True``, the backsolve adjoint, its field's tensors shared by
    the lanes (their gradients sum) and the control's its own."""
    if method in _FIXED_METHODS or step_size is not None:
        raise ValueError(
            "options={'per_sample': True} requires an adaptive method "
            f"(got method={method!r}"
            + (", step_size set" if step_size is not None else "")
            + "): fixed-step solves have no per-sample step control."
        )
    if not isinstance(z0, torch.Tensor) or z0.ndim < 2:
        raise ValueError(
            "options={'per_sample': True} needs a tensor state with at least "
            "one batch dimension (z0 of shape (..., hidden_channels))."
        )
    batch_shape = tuple(z0.shape[:-1])
    batch = int(np.prod(batch_shape))
    lanes = _Lanes(X, batch)
    z0f = z0.reshape(batch, z0.shape[-1])

    batched_t = t.ndim > 1
    if batched_t:
        t = t.reshape(-1, t.shape[-1])
        if t.shape[0] != batch:
            raise ValueError(
                "per_sample: batched output times must have the state's "
                f"batch dimensions (flattened size {t.shape[0]} vs {batch})."
            )
        if not _increasing(t):
            raise ValueError("t must be monotonically increasing.")

    if (method == "dopri5" and not return_stats
            and (not adjoint or (adjoint_params is None and adjoint_method == method
                                 and adjoint_rtol == rtol and adjoint_atol == atol
                                 and adjoint_step_size is None))):
        out = try_fused_dopri5_per_sample(
            lanes.flat(), func, z0f, None if batched_t else t, rtol=rtol, atol=atol,
            max_steps=max_steps, t_rows=t if batched_t else None)
        if out is not None:
            return torch.movedim(out, 0, -2).reshape(batch_shape + tuple(out.shape[:1])
                                                     + tuple(out.shape[2:]))

    cfg = SolverConfig(method=method, rtol=rtol, atol=atol, step_size=None,
                       max_steps=max_steps, knots_hint=_knots_hint_of(X))
    if adjoint:
        if return_stats:
            raise ValueError(
                "return_stats=True requires adjoint=False (solver statistics "
                "are collected on the direct path)."
            )
        adjoint_cfg = SolverConfig(
            method=adjoint_method, rtol=adjoint_rtol, atol=adjoint_atol,
            step_size=adjoint_step_size,
            max_steps=_derive_fixed_adjoint_max_steps(
                adjoint_max_steps, adjoint_method, adjoint_step_size, t),
            knots_hint=cfg.knots_hint,
        )
    outs, stats = [], []
    for i in range(batch):
        ti = t[i] if batched_t else t
        if adjoint:
            field = closure_params(func, lanes[i], ti[0], z0f[i], adjoint_params)
            if adjoint_params is None:
                field = _every_control_tensor(field)
            outs.append(odeint_adjoint(field, z0f[i], ti, cfg, adjoint_cfg))
            continue
        out = odeint(make_cde_rhs(func, lanes[i]), z0f[i], ti, cfg, collect_stats=return_stats)
        if return_stats:
            out, lane_stats = out
            stats.append(lane_stats)
        outs.append(out)
    out = torch.stack(outs).reshape(batch_shape + tuple(outs[0].shape))
    if return_stats:
        return out, {k: torch.tensor([s[k] for s in stats]).reshape(batch_shape)
                     for k in stats[0]}
    return out
