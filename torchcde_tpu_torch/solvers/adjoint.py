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
is a tensor that requires grad.  With ``jump_t``, the forward steps land on
the jumps and the reverse solve on their negated copies.
"""

import copy
import functools
import types
import warnings

import numpy as np
import torch

from ..utils.tuple_control import TupleControl
from .integrate import SolverConfig, host_jumps, host_times, odeint, warn_fixed_jumps
from .terms import _dtensor_type, make_cde_rhs


def control_tensors(X):
    """[(path, tensor)] of the control's tensors: its attributes by name, and
    a ``TupleControl``'s members' under their index."""
    if isinstance(X, TupleControl):
        return [((i,) + path, v) for i, c in enumerate(X.controls)
                for path, v in control_tensors(c)]
    return [((name,), v) for name, v in vars(X).items() if isinstance(v, torch.Tensor)]


def with_control_tensors(X, values):
    """A copy of the control that reads ``values`` ({path: tensor}) in place of
    the tensors at those paths."""
    X = copy.copy(X)
    if isinstance(X, TupleControl):
        X.controls = tuple(
            with_control_tensors(c, {p[1:]: v for p, v in values.items() if p[0] == i})
            for i, c in enumerate(X.controls))
        return X
    for (name,), v in values.items():
        setattr(X, name, v)
    return X


def _reached(rhs, t0, z0, tensors):
    """The tensors that rhs(t0, z0) depends on, as the arrays a JAX trace of
    the vector field closes over.  The graph is kept: the control's tensors
    may hang on a graph that the caller's backward pass still needs."""
    tensors = [p for p in tensors if p.requires_grad]
    if not tensors:
        return []
    with torch.enable_grad():
        f = rhs(t0, z0.detach())
        grads = torch.autograd.grad(f, tensors, torch.ones_like(f), allow_unused=True,
                                    retain_graph=True)
    return [p for p, g in zip(tensors, grads) if g is not None]


def _replaced(tup, i, value):
    """The tuple (or named tuple) tup with item i replaced by value."""
    items = list(tup)
    items[i] = value
    return tup._make(items) if hasattr(tup, "_make") else type(tup)(items)


class ClosureSlots:
    """Every tensor the vector field closes over, and where each is held, so
    that a call can read another tensor in its place (``call``).

    The search: a Python closure's cells, a bound method's object, the
    globals the code names, a ``functools.partial``'s arguments, an
    ``nn.Module``'s parameters, buffers and attributes, a callable object's
    or a plain object's attributes, and the items of every dict, list and
    tuple among them (weights held as the JAX package's pytrees).  Objects
    are searched three levels deep; containers add no level.  A tensor in a
    tuple is replaced by replacing the tuple where it is held; a tensor held
    where nothing can be replaced is ``stuck``."""

    def __init__(self, func):
        self.tensors, self.stuck = [], set()
        self.where, self._seen = {}, set()  # id(tensor) -> [(get, put)]
        self.base = []  # tensors every call reads (``gathered``)
        self.dtensor_of = {}  # id(a gathered tensor) -> its DTensor
        self._visit(func, 0, None)

    def _add(self, tensor, slot):
        if id(tensor) not in self.where:
            self.tensors.append(tensor)
            self.where[id(tensor)] = []
        if slot is None:
            self.stuck.add(id(tensor))
        else:
            self.where[id(tensor)].append(slot)

    @staticmethod
    def _item(table, key):
        return (lambda: table[key], lambda value: table.__setitem__(key, value))

    @staticmethod
    def _tuple_item(slot, i):
        if slot is None:
            return None
        get, put = slot
        return (lambda: get()[i], lambda value: put(_replaced(get(), i, value)))

    @staticmethod
    def _partial_arg(p, i):
        return (lambda: p.args[i],
                lambda value: p.__setstate__((p.func, _replaced(p.args, i, value), p.keywords,
                                              p.__dict__ or None)))

    def _visit(self, obj, depth, slot):
        if isinstance(obj, torch.Tensor):
            self._add(obj, slot)
            return
        if isinstance(obj, tuple):  # immutable: each holder replaces its own
            for i, v in enumerate(obj):
                self._visit(v, depth, self._tuple_item(slot, i))
            return
        if id(obj) in self._seen or depth > 3:
            return
        self._seen.add(id(obj))
        if isinstance(obj, (dict, list)):
            for key in (list(obj) if isinstance(obj, dict) else range(len(obj))):
                self._visit(obj[key], depth, self._item(obj, key))
        elif isinstance(obj, torch.nn.Module):
            modules = list(obj.modules())
            for table in [m._parameters for m in modules] + [m._buffers for m in modules]:
                for key, v in list(table.items()):
                    if v is not None:
                        self._add(v, self._item(table, key))
            for m in modules:
                table = vars(m)
                for key in [k for k in table if k not in _module_internals()]:
                    self._visit(table[key], depth + 1, self._item(table, key))
        elif isinstance(obj, functools.partial):
            self._visit(obj.func, depth + 1, None)
            for i, v in enumerate(obj.args):
                self._visit(v, depth + 1, self._partial_arg(obj, i))
            for key in list(obj.keywords):
                self._visit(obj.keywords[key], depth + 1, self._item(obj.keywords, key))
        elif hasattr(obj, "__wrapped__"):  # a wrapper of the user's field
            self._visit(obj.__wrapped__, depth, None)
        elif callable(obj):
            for cell in getattr(obj, "__closure__", None) or ():
                try:
                    v = cell.cell_contents
                except ValueError:  # an empty cell
                    continue
                self._visit(v, depth + 1, (lambda c=cell: c.cell_contents,
                                           lambda value, c=cell: setattr(c, "cell_contents",
                                                                         value)))
            self._visit(getattr(obj, "__self__", None), depth + 1, None)
            code, names = getattr(obj, "__code__", None), getattr(obj, "__globals__", {})
            for name in (code.co_names if code is not None else ()):
                if name in names:
                    self._visit(names[name], depth + 1, self._item(names, name))
            if not isinstance(obj, (types.FunctionType, types.MethodType, type)):
                self._attributes(obj, depth)  # a callable object's
        elif not isinstance(obj, (type, types.ModuleType)):
            self._attributes(obj, depth)  # e.g. a bound method's object

    def _attributes(self, obj, depth):
        table = getattr(obj, "__dict__", None)
        if isinstance(table, dict):
            for key in list(table):
                self._visit(table[key], depth + 1, self._item(table, key))

    def gathered(self):
        """These slots with each ``DTensor`` among the tensors replaced by its
        value whole on every rank (``parallel.comm.whole``, differentiable:
        its backward hands each rank its part of the cotangent), which every
        ``call`` reads where the ``DTensor`` is held: the field then computes
        on plain tensors, as ``torch.func.vmap`` needs.  Without a
        ``DTensor``, these slots themselves."""
        dtensor = _dtensor_type()
        if not any(isinstance(p, dtensor) for p in self.tensors):
            return self
        from ..parallel.comm import whole

        out = copy.copy(self)
        out.tensors, out.where, out.dtensor_of = [], dict(self.where), dict(self.dtensor_of)
        for p in self.tensors:
            if isinstance(p, dtensor):
                if id(p) in self.stuck:
                    raise ValueError(
                        "a tensor-parallel vector field holds a DTensor of shape "
                        f"{tuple(p.shape)} where it cannot be read whole (through no "
                        "closure cell, global, parameter, buffer, attribute, partial "
                        "argument, or dict, list or tuple item that can be replaced)."
                    )
                w = whole(p)
                out.where[id(w)], out.dtensor_of[id(w)] = self.where[id(p)], p
                out.base = out.base + [w]
                p = w
            out.tensors.append(p)
        return out

    def call(self, fn, tensors=(), values=()):
        """fn() with each of ``tensors`` read as the matching ``values`` (and
        the gathered tensors read whole where their ``DTensor``s are held)."""
        saved = []
        try:
            for tensor, value in list(zip(self.base, self.base)) + list(zip(tensors, values)):
                for get, put in self.where[id(tensor)]:
                    saved.append((put, get()))
                    put(value)
            return fn()
        finally:
            for put, old in reversed(saved):
                put(old)


@functools.lru_cache(maxsize=None)
def _module_internals():
    """The attributes every ``nn.Module`` has (its tables and hooks)."""
    return frozenset(vars(torch.nn.Module()))


def _closure_tensors(func):
    """Tensors the vector field closes over (``ClosureSlots``)."""
    return ClosureSlots(func).tensors


def _walk(roots, stops, keep):
    """Walks the autograd graph down from the (node, index) pairs ``roots``;
    returns {id: tensor} of the tensors of ``stops`` ({(node, index):
    tensor}) and of the leaves that it meets first on each path.  ``keep``
    holds every node met, so that node identities stay valid."""
    met, seen, todo = {}, set(), list(roots)
    while todo:
        node, idx = todo.pop()
        if node is None or (node, idx) in seen:
            continue
        seen.add((node, idx))
        keep.append(node)
        hit = stops.get((node, idx))
        if hit is not None:
            met[id(hit)] = hit
            continue
        variable = getattr(node, "variable", None)
        if isinstance(variable, torch.Tensor):  # an AccumulateGrad node: a leaf
            met[id(variable)] = variable
            continue
        todo.extend(node.next_functions)
    return met


def _frontier(f, controls, closed):
    """The tensors that receive the adjoint's gradients: a cut of the graph
    of f between f and every leaf that requires grad.

    The walk down from f stops at the control's tensors, at the tensors the
    field closes over and at leaves.  The control's tensors are read as
    independent inputs (``FieldClosure``), so each may lie upstream of
    another.  Any other member of the cut that is derived from another
    member is replaced by what lies below it, so that every leaf receives
    the gradient of each path once."""
    keep = []
    candidates = controls + closed
    stops = {(c.grad_fn, c.output_nr): c for c in reversed(candidates)
             if c.requires_grad and c.grad_fn is not None}
    cut = _walk([(f.grad_fn, 0)], stops, keep)
    independent = {id(c) for c in controls}
    while True:
        derived = None
        for c in cut.values():
            if c.grad_fn is None or id(c) in independent:
                continue
            others = {k: v for k, v in stops.items() if id(v) in cut and v is not c}
            below = _walk(list(c.grad_fn.next_functions), others, keep)
            if any(key in cut and key not in independent for key in below):
                derived = c
                break
        if derived is None:
            break
        del cut[id(derived)]
        stops = {k: v for k, v in stops.items() if v is not derived}
        cut.update(_walk(list(derived.grad_fn.next_functions), stops, keep))
    # The control's tensors first, as the JAX trace meets them, then the
    # field's: the order of the adjoint's augmented state, whose error norm
    # sums in that order.
    rank = {id(c): i for i, c in enumerate(candidates)}
    return sorted(cut.values(), key=lambda c: rank.get(id(c), len(rank)))


class FieldClosure:
    """The CDE right-hand side f(t, z) . dX/dt and the tensors that receive
    the adjoint's gradients (``params``).

    ``field(t, z, values)`` reads ``values`` in place of those params that
    are the control's attributes, and ``leaves()`` gives detached copies of
    them: a vector-Jacobian product then holds the others fixed, as the JAX
    package's closure-converted constants are independent inputs whose
    gradients its outer autodiff carries upstream.  So a control whose
    tensors hang on one another (a linear control's slopes on its knot
    values, a spline's rows on a knot tensor) passes each path's gradient
    once."""

    def __init__(self, func, X, params):
        self.func, self.X, self.params = func, X, list(params)
        paths = {id(v): path for path, v in control_tensors(X)}
        self._slots = [paths.get(id(p)) for p in self.params]

    def __call__(self, t, z, values=None):
        X = self.X
        if values is not None and any(self._slots):
            X = with_control_tensors(X, {path: v for path, v in zip(self._slots, values)
                                         if path is not None})
        return make_cde_rhs(self.func, X)(t, z)

    def leaves(self):
        return [p.detach().requires_grad_() if name is not None else p
                for name, p in zip(self._slots, self.params)]


def closure_params(func, X, t0, z0, adjoint_params=None):
    """The vector field's ``FieldClosure``: its right-hand side and the
    tensors that receive adjoint gradients.

    By default every tensor the field reads: the control's tensors and the
    tensors ``func`` closes over (its parameters and buffers, a closure's
    cells, a partial's arguments), and in place of any of the latter that
    hangs on another, or of one the search does not find, the leaves below
    it (see ``_frontier``), as the JAX package's closure conversion finds
    every array the field closes over.  ``adjoint_params`` narrows that set;
    if one of its tensors is not read by the field, the whole set is used,
    with the JAX package's warning."""
    rhs = make_cde_rhs(func, X)
    if isinstance(t0, torch.Tensor):
        t0 = t0.detach()  # the output times' gradient is the adjoint's own
    if adjoint_params is not None:
        wanted = list({id(p): p for p in adjoint_params}.values())
        found = _reached(rhs, t0, z0, wanted)
        if len(found) == len(wanted):
            return FieldClosure(func, X, found)
        warnings.warn(
            "Could not identify every adjoint_params entry among the "
            "arrays the vector field closes over; computing adjoint "
            "gradients for the full closure superset instead."
        )
    with torch.enable_grad():
        f = rhs(t0, z0.detach())
    if f.grad_fn is None:
        return FieldClosure(func, X, [])
    controls = [v for _path, v in control_tensors(X)]
    closed = [c for c in {id(c): c for c in _closure_tensors(func)}.values()
              if all(c is not v for v in controls)]
    return FieldClosure(func, X, _frontier(f, controls, closed))


def _whole(v):
    """A tensor-parallel parameter's cotangent, whole on every rank: the
    augmented state, and so the error norm and the step sequence, is then
    the same on every rank of the mesh."""
    if not isinstance(v, _dtensor_type()):
        return v
    from ..parallel.comm import whole

    return whole(v)


def _placed_like(whole, p):
    """``whole`` placed as the parameter p (this rank's part of a ``DTensor``)."""
    if not isinstance(p, _dtensor_type()):
        return whole
    from ..parallel.mesh import place_like

    return place_like(whole, p)


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, field, cfg, adjoint_cfg, jump_t, ts, z0, *params):
        zs = odeint(field, z0, ts, cfg, jump_t, differentiable=False)
        ctx.field, ctx.adjoint_cfg, ctx.jump_t = field, adjoint_cfg, jump_t
        ctx.ts = ts
        ctx.save_for_backward(zs)
        return zs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (zs,) = ctx.saved_tensors
        rhs, params = ctx.field, ctx.field.params
        ts = host_times(ctx.ts, zs.dtype)
        shape, nz = zs.shape[1:], zs[0].numel()
        sizes = [nz, nz] + [p.numel() for p in params]

        def aug_rhs(s, aug):
            # s = -t; d/ds z = -f, d/ds a = +a^T df/dz, d/ds a_p = +a^T df/dp.
            z, a = aug[:nz].view(shape), aug[nz:2 * nz].view(shape)
            with torch.enable_grad():
                z_ = z.detach().requires_grad_()
                leaves = rhs.leaves()
                f = rhs(-s, z_, leaves)
                # A param found below the field's tensors hangs on a graph
                # that the next evaluation walks again: keep it.
                vjps = torch.autograd.grad(f, [z_] + leaves, a, allow_unused=True,
                                           retain_graph=True)
            parts = [-f.detach()] + [
                torch.zeros(p.shape, dtype=p.dtype, device=p.device) if v is None
                else _whole(v) for v, p in zip(vjps, [z_] + leaves)]
            return torch.cat([v.reshape(-1) for v in parts])

        neg_jump = None
        if ctx.jump_t is not None:
            neg_jump = np.sort(-host_jumps(ctx.jump_t, zs.dtype))
            adjoint_stepper = ctx.adjoint_cfg.stepper()
            if not (adjoint_stepper.adaptive and ctx.adjoint_cfg.step_size is None):
                # Fixed steps ignore the jumps: warn once, not per interval.
                warn_fixed_jumps()
                neg_jump = None
        want_t = isinstance(ctx.ts, torch.Tensor) and ctx.needs_input_grad[4]
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
            aug1 = odeint(aug_rhs, aug0, span, ctx.adjoint_cfg, neg_jump,
                          differentiable=False)[1]
            a, a_params = aug1[nz:2 * nz].view(shape), aug1[2 * nz:]
        if want_t:
            # dL/dts[0] = -a(t0) . f(t0, z0), with a(t0) excluding g_0.
            ts_bar[0] = -torch.sum(a * rhs(ts[0], zs[0]))
            ts_bar = ts_bar.to(ctx.ts.dtype)
        grads = [_placed_like(v.view(p.shape), p)
                 for v, p in zip(torch.split(a_params, sizes[2:]), params)] if params else []
        return (None, None, None, None, ts_bar, a + g[0], *grads)


def odeint_adjoint(field, z0, ts, cfg: SolverConfig, adjoint_cfg: SolverConfig, jump_t=None):
    """Solve dz/dt = field(t, z) with backsolve-adjoint gradients.

    ``field``: a ``FieldClosure`` (see ``closure_params``), whose params
    receive gradients.  Output is time-leading, like ``odeint``."""
    return _OdeintAdjoint.apply(field, cfg, adjoint_cfg, jump_t, ts, z0, *field.params)
