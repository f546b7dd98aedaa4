"""cdeint: the solver front-end.

Port of ``torchcde_tpu/solvers/cdeint.py::cdeint``: every method of the JAX
package (the adaptive dopri5, dopri5_nofsal, dopri8, bosh3, adaptive_heun
and fehlberg2; the fixed-step euler, midpoint, heun, heun3, rk4 and Adams
methods; reversible Heun with its exact adjoint), with direct
backpropagation or the backsolve adjoint, ``options={'jump_t': ...}``,
``options={'per_sample': True}``, tuple states over a ``TupleControl``, and
``method="scipy_solver"`` (host stepping by ``scipy.integrate.solve_ivp``):

    cdeint(X, func, z0, t, adjoint=True, backend="native", **kwargs)

solves z_t = z_{t0} + int_{t0}^t f(s, z_s) dX_s and returns z at each t[i]
with shape (..., len(t), hidden_channels).  The dispatch, the validation and
the error texts are the JAX package's.
"""

import warnings

import numpy as np
import torch

from .adjoint import closure_params, odeint_adjoint
from .fused_dopri import try_fused_dopri5
from .fused_dopri_persample import try_fused_dopri5_per_sample
from .fused_fixed import try_fused_fixed
from .fused_reversible_kernel import try_fused_reversible_heun
from ..utils.misc import host_array
from .integrate import SolverConfig, host_times, odeint
from .per_sample import _Lanes, solve_per_sample, time_rows
from .reversible_adjoint import reversible_heun_solve
from .runge_kutta import STEPPERS, unknown_method
from .terms import _matvec, make_cde_rhs

_FIXED_METHODS = ("euler", "midpoint", "heun", "heun3", "rk4",
                  "reversible_heun", "explicit_adams", "implicit_adams",
                  "fixed_adams")


def _check_method(name):
    """The JAX package's ValueError for a method name it does not know."""
    if name not in STEPPERS:
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


def _check_compatability_tuple(X, func, z0, t0):
    """The tuple-state branch of the check, with the JAX package's texts."""
    control_gradient = X.derivative(t0)
    if hasattr(func, "prod"):
        vector_field = func.prod(t0, z0, control_gradient)
    else:
        system = func(t0, z0)
    if not isinstance(control_gradient, (tuple, list)):
        raise ValueError("z0 is a tuple/list and so X.derivative must return a tuple/list as well.")
    if len(z0) != len(control_gradient):
        raise ValueError("z0 and X.derivative(t) must be tuples of the same length.")
    if hasattr(func, "prod"):
        if not isinstance(vector_field, (tuple, list)):
            raise ValueError("z0 is a tuple/list and so func.prod must return a tuple/list as well.")
        if len(z0) != len(vector_field):
            raise ValueError("z0 and func.prod(t, z, dXdt) must be tuples of the same length.")
        for cg, vf, z0_ in zip(control_gradient, vector_field, z0):
            _check_compatability_per_tensor_prod(cg, vf, z0_)
    else:
        if not isinstance(system, (tuple, list)):
            raise ValueError("z0 is a tuple/list and so func must return a tuple/list as well.")
        if len(z0) != len(system):
            raise ValueError("z0 and func(t, z) must be tuples of the same length.")
        for cg, sys_, z0_ in zip(control_gradient, system, z0):
            _check_compatability_per_tensor_forward(cg, sys_, z0_)


def _check_compatability(X, func, z0, t):
    """Probe the control and the field once and validate their shapes."""
    if not hasattr(X, "derivative"):
        raise ValueError("X must have a 'derivative' method.")
    if isinstance(z0, tuple):
        with torch.no_grad():
            _check_compatability_tuple(X, func, z0, t[0])
        return
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


class _PackedField:
    """A tuple-state vector field on one flat state: the members of z0 are
    packed, in order, into one vector, which this field unpacks for the
    user's ``func`` and whose derivative it packs again.  Every operation of
    the steppers, the controller (the error norm sums the squares of every
    member over their total count), the dense output and the adjoint is
    elementwise or a global sum, so the packed solve takes the JAX package's
    steps on its tuple."""

    def __init__(self, func, members):
        self.__wrapped__ = func
        self.shapes = [tuple(z.shape) for z in members]
        self.sizes = [z.numel() for z in members]

    def pack(self, members):
        return torch.cat([z.reshape(-1) for z in members])

    def unpack(self, z):
        """The members from the packed last axis of z (..., total)."""
        parts = torch.split(z, self.sizes, dim=-1)
        return tuple(p.reshape(p.shape[:-1] + s) for p, s in zip(parts, self.shapes))

    def prod(self, t, z, control_gradient):
        func, members = self.__wrapped__, self.unpack(z)
        if hasattr(func, "prod"):
            out = func.prod(t, members, control_gradient)
        else:
            out = [_matvec(f, cg) for f, cg in zip(func(t, members), control_gradient)]
        return self.pack(out)


def _pack_state(func, z0):
    """(the packed field, the packed z0) of a tuple state, whose members
    must share one dtype, as the JAX integrator's loops need."""
    dtypes = {z.dtype for z in z0}
    if len(dtypes) != 1:
        raise TypeError(
            "The members of a tuple state z0 must share one dtype; found "
            f"{sorted(str(d) for d in dtypes)}."
        )
    packed = _PackedField(func, z0)
    return packed, packed.pack(z0)


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
            method.  An ``MLPVectorField`` (with plain-tensor weights; a
            tensor-parallel one solves on the plain path) over a uniform
            ``CubicSpline`` lets
            dopri5 and knot-aligned fixed-step solves (reversible Heun
            among them) run as fused kernels; over a uniform
            ``LinearInterpolation``, dopri5 runs the adaptive kernel's
            linear-control mode.
        z0: initial state (..., hidden_channels), or a tuple of such states
            of one dtype, with a ``TupleControl`` and a field returning a
            tuple; the output is then a tuple too.
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
        **kwargs: method (any name of ``runge_kutta.STEPPERS``, or
            "scipy_solver" with options={'solver': ...}), rtol, atol,
            step_size or options={'step_size': ...}, dt (alias for
            step_size), options={'jump_t': ...} (derivative
            discontinuities that adaptive steps land on),
            options={'per_sample': True}, max_steps, return_stats
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
    jump_t = options.pop("jump_t", None)
    per_sample = options.pop("per_sample", False)
    scipy_solver_name = options.pop("solver", None)  # scipy_solver's option
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
    if method != "scipy_solver":
        _check_method(method)
        if adjoint:
            _check_method(adjoint_method)

    if not isinstance(t, np.ndarray):
        t = torch.as_tensor(t)
    if isinstance(step_size, torch.Tensor):
        step_size = float(step_size)
    if t.ndim == 1 and t.shape[0] > 1 and not _increasing(t):
        raise ValueError("t must be monotonically increasing.")

    if isinstance(z0, list):
        z0 = tuple(z0)
    if per_sample and t.ndim > 1:
        # Batched output times: validated against one row here, every row's
        # order in _cdeint_per_sample.
        _check_compatability(X, func, z0, t.reshape(-1, t.shape[-1])[0])
    else:
        _check_compatability(X, func, z0, t)

    if method == "scipy_solver":
        if per_sample:
            raise ValueError(
                "scipy_solver does not support options={'per_sample': True} "
                "(host-side whole-batch stepping has no per-sample control)."
            )
        if t.ndim > 1:
            raise ValueError(
                "scipy_solver requires 1-D output times t (batched t is a "
                "per_sample feature of the native adaptive solvers)."
            )
        return _cdeint_scipy(X, func, z0, t, rtol=rtol, atol=atol,
                             solver=scipy_solver_name or "RK45",
                             adjoint=adjoint, return_stats=return_stats)

    if per_sample:
        return _cdeint_per_sample(
            X, func, z0, t, adjoint=adjoint, method=method, rtol=rtol, atol=atol,
            step_size=step_size, max_steps=max_steps, return_stats=return_stats,
            jump_t=jump_t, adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
            adjoint_method=adjoint_method, adjoint_step_size=adjoint_step_size,
            adjoint_params=adjoint_params, adjoint_max_steps=adjoint_max_steps)

    # A tuple state runs packed into one tensor (``_PackedField``) and takes
    # no fused route, as the JAX package's kernels take tensor states only.
    packed = None
    if isinstance(z0, tuple):
        packed, z0 = _pack_state(func, z0)
        func = packed
    out = _cdeint_tensor(
        X, func, z0, t, adjoint=adjoint, method=method, rtol=rtol, atol=atol,
        step_size=step_size, max_steps=max_steps, return_stats=return_stats, jump_t=jump_t,
        fused=packed is None, adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
        adjoint_method=adjoint_method, adjoint_step_size=adjoint_step_size,
        adjoint_params=adjoint_params, adjoint_max_steps=adjoint_max_steps)
    stats = None
    if return_stats:
        out, stats = out
    # Time from leading to second-to-last.
    if packed is None:
        out = torch.movedim(out, 0, -2)
    else:
        out = tuple(torch.movedim(o, 0, -2) for o in packed.unpack(out))
    if return_stats:
        return out, stats
    return out


def _cdeint_tensor(X, func, z0, t, *, adjoint, method, rtol, atol, step_size, max_steps,
                   return_stats, jump_t, fused, adjoint_rtol, adjoint_atol, adjoint_method,
                   adjoint_step_size, adjoint_params, adjoint_max_steps):
    """The solve of a tensor state, time leading (with its stats when
    ``return_stats``).  ``fused=False`` declines every fused route."""
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
        # knot-aligned over an MLP field: with jump_t too, which its fixed
        # steps ignore, as in the JAX package.
        if jump_t is not None:
            warnings.warn(
                "options={'jump_t': ...} is ignored by fixed-step methods "
                "(reversible_heun): steps may straddle the declared "
                "derivative discontinuities."
            )
        if step_size is None:
            step_size = float(np.max(np.diff(host_times(t, torch.float64))))
        out = try_fused_reversible_heun(X, func, z0, t, step_size) if fused else None
        if out is None:
            field = closure_params(func, X, t[0], z0, adjoint_params)
            out = reversible_heun_solve(field, z0, t, step_size)
        return out

    adaptive_fused = method == "dopri5" and step_size is None
    fused = fused and jump_t is None
    out, stats = None, None
    if (adjoint and fused and adjoint_params is None and adjoint_method == method
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
        out = odeint_adjoint(field, z0, t, cfg, adjoint_cfg, jump_t)
    elif out is None:
        if fused and not return_stats:
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
            out = odeint(make_cde_rhs(func, X), z0, t, cfg, jump_t, collect_stats=return_stats)
            if return_stats:
                out, stats = out
    if return_stats:
        return out, stats
    return out


def _cdeint_scipy(X, func, z0, t, *, rtol, atol, solver, adjoint, return_stats):
    """``method="scipy_solver"``: host stepping by ``scipy.integrate.solve_ivp``
    (``options={'solver': ...}``, RK45 by default), the whole batch flattened
    into one ODE system.  The right-hand side runs on z0's device, one call
    per evaluation; there is no gradient graph."""
    import scipy.integrate

    if isinstance(z0, tuple):
        raise ValueError("scipy_solver supports a single tensor state (got a tuple).")
    if return_stats:
        raise ValueError("scipy_solver does not collect solver statistics.")
    if adjoint:
        warnings.warn(
            "scipy_solver runs on the host without a differentiable graph; "
            "adjoint=True is ignored (gradients are not supported)."
        )
    rhs = make_cde_rhs(func, X)
    shape, dtype, device = tuple(z0.shape), z0.dtype, z0.device
    t_np = np.asarray(host_times(t, torch.float64), dtype=np.float64)

    @torch.no_grad()
    def rhs_np(tt, yy):
        z = torch.as_tensor(yy.reshape(shape), dtype=dtype, device=device)
        dz = rhs(torch.as_tensor(tt, dtype=dtype, device=device), z)
        return host_array(dz).astype(np.float64).ravel()

    sol = scipy.integrate.solve_ivp(
        rhs_np, (t_np[0], t_np[-1]), host_array(z0).astype(np.float64).ravel(),
        t_eval=t_np, rtol=rtol, atol=atol, method=solver,
    )
    if not sol.success:
        raise RuntimeError(f"scipy_solver ({solver}) failed: {sol.message}")
    out = torch.as_tensor(sol.y.T.reshape((len(t_np),) + shape), dtype=dtype, device=device)
    return torch.movedim(out, 0, -2)


def _increasing(t):
    """Whether every row of t (..., n) is strictly increasing."""
    if isinstance(t, np.ndarray):
        return bool(np.all(np.diff(t, axis=-1) > 0))
    return bool(torch.all(torch.diff(t.detach(), dim=-1) > 0))


def _cdeint_per_sample(X, func, z0, t, *, adjoint, method, rtol, atol, step_size, max_steps,
                       return_stats, jump_t, adjoint_rtol, adjoint_atol, adjoint_method,
                       adjoint_step_size, adjoint_params, adjoint_max_steps):
    """``options={'per_sample': True}``: every sample of the batch runs its
    own adaptive solve, with its own error norm, PI controller and accepted
    steps (torchode's design; JAX ``cdeint.py::_cdeint_per_sample``).

    Output times t may be batched, (..., n_times) matching the state's batch
    dimensions: each sample then reads out at (and integrates over) its own
    times.  ``return_stats`` reports each sample's counts, shaped like the
    batch.  An ``MLPVectorField`` over a uniform control takes the fused
    per-lane kernel K9 (``fused_dopri_persample.py``), for either
    ``adjoint``, with dopri5 and no ``jump_t``; otherwise every lane runs in
    one lockstep solve of the general integrator (``per_sample.py``, the
    JAX package's vmap of a one-sample solve with the fused routes off), or,
    with ``adjoint=True``, of the backsolve adjoint, each lane with its own
    augmented state: the field's tensors are shared by the lanes (their
    gradients sum) and the control's rows are each lane's own."""
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
    lanes = _Lanes(X, batch, z0.device)
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

    if (method == "dopri5" and jump_t is None and not return_stats
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
    adjoint_cfg = None
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
    out = solve_per_sample(func, lanes, z0f, time_rows(t, batch, z0f), cfg, jump_t,
                           return_stats, adjoint_cfg, adjoint_params)
    if return_stats:
        out, stats = out
        stats = {k: v.reshape(batch_shape) for k, v in stats.items()}
    out = out.reshape(batch_shape + tuple(out.shape[1:]))
    if return_stats:
        return out, stats
    return out
