"""Per-sample adaptive solves, every lane in one lockstep solve.

The port's counterpart of the JAX package's ``jax.vmap`` over a one-sample
solve (``torchcde_tpu/solvers/cdeint.py::_cdeint_per_sample``) and over a
one-sample backsolve adjoint (``_per_sample_adjoint``), for the solves that
the fused per-lane kernel K9 does not take.

Each lane keeps its own time, step size, error norm, PI controller, accepted
steps, output index, step budget and statistics, as (B,) tensors on the
device.  Each lockstep iteration takes one step of every lane still
integrating, at that lane's own t and dt, with the steppers of
``runge_kutta.py``; a lane that has finished takes a step of size 0 and a
rejected lane keeps its state, both by ``torch.where``.  The right-hand side
is the one-lane ``make_cde_rhs`` vmapped over the lanes
(``torch.func.vmap``): the field is called unbatched for each lane, as the
JAX package's contract says, and a field that vmap cannot take raises.  A
tensor-parallel field computes on its weights gathered whole once a solve
(``plain_field``).  The
host reads from the device once per iteration, to learn whether any lane is
still integrating (and how many output times the step passed).

The solver's own arithmetic on a lane does not depend on the batch: the
error norms sum in a fixed order, the controller's powers take one code
path for every lane (``_lane_sum``, ``_lane_pow``).  The field's products
round as the library's kernel for the batch's size rounds; on the card a
small batch runs beside copies of its first lane (``_MIN_LANES``), so that
in float64 a lane solved alone gives the same mesh.  Step sizes are outside autograd (the frozen mesh of
``integrate.py``); output times that require grad receive the JAX
integrator's gradient.  Without autograd on the card each iteration is a
replayed CUDA graph (``_Iterations``).  With ``adjoint=True`` each lane
backsolves its own augmented state (``_AdjointField``, ``_LockstepAdjoint``).
"""

import copy
import math
import warnings

import numpy as np
import torch

from ..utils.misc import numpy_dtype
from .adjoint import ClosureSlots, _walk
from .integrate import (_FIXED_DEFAULT_MAX_STEPS, _QUARTIC_MINV, _adaptive_max_steps, _clip,
                        _static_fixed_steps, _stats, host_jumps, warn_fixed_jumps)
from .runge_kutta import STEPPERS, rk_step
from .terms import _dtensor_type, make_cde_rhs

# Lockstep iterations and reads from the device since the last reset.
ITERATIONS = 0
HOST_READS = 0
# cuBLAS picks the kernel of a product by its number of rows, and kernels
# round otherwise: on a CUDA device a solve of fewer lanes runs beside
# copies of its first lane up to this many, so that a lane's field rounds as
# in a larger batch and a lane solved alone takes the steps it takes in its
# batch.  On an H100 (chip_smoke.py phase 39's probe, an MLP field at
# hidden 8, width 32) float64 rows round alike from 2 to 4096 rows, not
# for 1; float32 rows round otherwise at 256, 1024 and 4096 rows than at 64.
_MIN_LANES = {"cuda": 64}


def reset_counts():
    global ITERATIONS, HOST_READS
    ITERATIONS = HOST_READS = 0


def _read(values):
    """A read from the device: the iteration's flags, or a plan's times."""
    global HOST_READS
    HOST_READS += 1
    return values.tolist()


def _iteration():
    global ITERATIONS
    ITERATIONS += 1


class _Iterations:
    """Runs ``body(carry) -> (carry, extras, flags)`` once per lockstep
    iteration and reads ``flags`` back.  Without autograd on a CUDA device
    (an eager iteration launches a few hundred small kernels, and launching
    them is most of its time) the first iteration runs eagerly on a side
    stream, then the body is captured once as a CUDA graph whose carry lives
    in fixed buffers, and every later iteration replays it.  The body must
    then not read the host (``flags`` is read after it) and must keep its
    shapes; ``extras`` hold until the next iteration."""

    def __init__(self, body, carry):
        self.body, self.carry, self.graph = body, carry, None
        device = next(c for c in carry if c is not None).device
        self.graphed = device.type == "cuda" and not torch.is_grad_enabled()

    def __call__(self):
        _iteration()
        if not self.graphed:
            self.carry, extras, flags = self.body(self.carry)
            return self.carry, extras, _read(flags)
        if self.graph is None:
            return self._first()
        self.graph.replay()
        return self.carry, self.extras, _read(self.flags)

    def _first(self):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            carry, extras, flags = self.body(self.carry)
        torch.cuda.current_stream().wait_stream(stream)
        self.carry = tuple(None if c is None else c.clone() for c in carry)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            new, extras, self.flags = self.body(self.carry)
            # The carry's buffers take the new carry below: extras that are
            # those buffers are copied first.
            self.extras = tuple(e.clone() if any(e is c for c in self.carry) else e
                                for e in extras)
            for buffer, value in zip(self.carry, new):
                if buffer is not None:
                    buffer.copy_(value)
        return carry, extras, _read(flags)


class _Lanes:
    """The control of each lane of a flattened batch.

    As the JAX package's per-sample path maps the control's pytree: every
    tensor with three or more dimensions is batched, (..., n, channels),
    flattened to (batch, n, channels), and a lane reads its own row; the
    others (knot times, a control shared by every lane) are shared.  Host
    arrays (a default grid) become tensors on the rows' device, so that a
    lane's control reads no host memory."""

    def __init__(self, X, batch, device):
        self.X = X
        self.rows, self.shared = {}, {}
        for name, v in vars(X).items():
            if isinstance(v, np.ndarray):
                self.shared[name] = torch.as_tensor(v, device=device)
            elif isinstance(v, torch.Tensor) and v.ndim >= 3:
                v = v.reshape((-1,) + tuple(v.shape[-2:]))
                if v.shape[0] != batch:
                    raise ValueError(
                        "per_sample: the control's batch dimensions "
                        f"(flattened size {v.shape[0]}) must match the state's "
                        f"(flattened size {batch})."
                    )
                self.rows[name] = v
            elif isinstance(v, torch.Tensor):
                self.shared[name] = v

    def padded(self, pad):
        """The lanes and ``pad`` more, copies of lane 0 (outside autograd)."""
        lanes = copy.copy(self)
        lanes.rows = {n: torch.cat([v, v[:1].detach().expand((pad,) + v.shape[1:])])
                      for n, v in self.rows.items()}
        return lanes

    def names(self):
        """Every tensor of the control, in the order of its attributes."""
        return [n for n in vars(self.X) if n in self.rows or n in self.shared]

    def value(self, name):
        return self.rows[name] if name in self.rows else self.shared[name]

    def in_dim(self, name):
        return 0 if name in self.rows else None

    def lane(self, values):
        """The control of one lane, reading ``values`` ({name: tensor})."""
        X = copy.copy(self.X)
        for name, v in values.items():
            setattr(X, name, v)
        return X

    def flat(self):
        """The control with every batched tensor flattened to (batch, n, C)."""
        return self.lane(self.rows)

    def first(self):
        """Lane 0's control (its rows and the shared tensors)."""
        return self.lane({**self.shared, **{n: v[0] for n, v in self.rows.items()}})


def plain_field(func):
    """(the field to vmap, its ``ClosureSlots``) for a per-sample solve.

    vmap takes no ``DTensor`` operation, so a tensor-parallel field
    (``parallel.place_params``) computes on its weights whole: each
    ``DTensor`` it holds is gathered once, here, outside vmap
    (``ClosureSlots.gathered``), and every call of the field reads the whole
    tensor in its place.  A ``parallel.TensorParallelField`` is unwrapped to
    the field it wraps, which then runs on plain tensors.  The weights'
    gradients reach their ``DTensor`` shards through the gather's backward."""
    slots = ClosureSlots(func)
    if any(isinstance(p, _dtensor_type()) for p in slots.tensors):
        from ..parallel.mesh import TensorParallelField

        if isinstance(func, TensorParallelField):
            func = func.field
        slots = slots.gathered()
    return func, slots


class LaneField:
    """rhs(t, z) of every lane: the one-lane CDE right-hand side vmapped over
    t (B,) or (B, 1), z (B, D) and the control's rows.  ``slots``: the
    field's ``ClosureSlots`` (``plain_field``), if the caller has them."""

    def __init__(self, func, lanes, slots=None):
        if slots is None:
            func, slots = plain_field(func)
        names = lanes.names()
        self._values = [lanes.value(n) for n in names]

        def one(t, z, *values):
            X = lanes.lane(dict(zip(names, values)))
            return slots.call(lambda: make_cde_rhs(func, X)(t, z))

        self._vmapped = torch.func.vmap(
            one, in_dims=(0, 0) + tuple(lanes.in_dim(n) for n in names))

    def __call__(self, t, z):
        return self._vmapped(t.reshape(-1).contiguous(), z, *self._values)


# ------------------------------------------------------- lane arithmetic ----

def _lane_sum(x):
    """The sum over the last axis, in the same order for every lane whatever
    the batch: pairwise halves, zero-padded to a power of two."""
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _lane_pow(x, exponent):
    """x ** exponent elementwise.  PyTorch's CPU kernel rounds the vector
    body and the scalar tail of a tensor differently, so on the CPU the
    lanes are padded to whole vectors: every lane then takes the same path,
    whatever the batch."""
    if x.device.type != "cpu":
        return torch.pow(x, exponent)
    n = x.shape[0]
    padded = torch.cat([x, x.new_ones((-n) % 64)])
    return torch.pow(padded, exponent)[:n]


def _rms(x):
    return torch.sqrt(_lane_sum(torch.square(x)) / x.shape[-1])


def _error_ratio(err, rtol, atol, z0, z1):
    return _rms(err / (atol + rtol * torch.maximum(torch.abs(z0), torch.abs(z1))))


@torch.no_grad()
def _initial_step(rhs, t0, z0, order, rtol, atol, f0):
    """``integrate.select_initial_step`` for every lane: (B,)."""
    scale = atol + torch.abs(z0) * rtol
    d0 = _rms(z0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / torch.clamp(d1, min=1e-30))
    f1 = rhs(t0 + h0, z0 + h0[:, None] * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     _lane_pow(0.01 / torch.clamp(dmax, min=1e-30), 1.0 / (order + 1)))
    return torch.minimum(100 * h0, h1)


def _factor(ratio, order, cfg, accept):
    """``integrate._optimal_factor`` for every lane."""
    factor = cfg.safety * _lane_pow(torch.clamp(ratio, min=1e-10), -1.0 / order)
    factor = torch.where(torch.isfinite(factor), factor, cfg.dfactor)
    upper = torch.where(accept, cfg.ifactor, 1.0).to(factor.dtype)
    return torch.minimum(torch.clamp(factor, min=cfg.dfactor), upper)


def _select(mask, new, old):
    """new where mask (B,), else old, through a stepper's state."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
    if isinstance(new, tuple):
        return tuple(_select(mask, n, o) for n, o in zip(new, old))
    return new  # None, or the Adams step count (equal in every stepping lane)


def _h(dt, z):
    """The step sizes dt (B,) as the factor of the state z's rows: times and
    steps are planned in float32 for a half-precision state, whose products
    stay in its own dtype, as the host integrator's Python-float steps do."""
    return dt[:, None].to(z.dtype)


def _quartic(z0, z1, f0, f1, y_mid, dt, theta):
    """``integrate._interp_quartic`` for every lane at (B, E) thetas, dt (B,):
    (B, E, D)."""
    m = _QUARTIC_MINV
    h = _h(dt, z0)
    theta = theta.to(z0.dtype)
    rA = z1 - z0 - h * f0
    rB = h * (f1 - f0)
    rC = y_mid - z0 - (0.5 * h) * f0
    c4 = m[0][0] * rA + m[0][1] * rB + m[0][2] * rC
    c3 = m[1][0] * rA + m[1][1] * rB + m[1][2] * rC
    c2 = m[2][0] * rA + m[2][1] * rB + m[2][2] * rC
    th = theta[..., None]
    return (z0[:, None] + th * ((h * f0)[:, None]
                                + th * (c2[:, None] + th * (c3[:, None] + th * c4[:, None]))))


class _Jumps:
    """The next jump strictly after each lane's t (inf if none); ``t``: the
    jumps, sorted, on the state's device."""

    def __init__(self, t):
        self.t = t
        self._padded = torch.cat([t, t.new_full((1,), math.inf)])

    def after(self, t):
        return self._padded[torch.searchsorted(self.t, t.detach().contiguous(), right=True)]

    def negated(self):
        """The jumps of the reverse solve in s = -t."""
        return _Jumps(torch.flip(-self.t, dims=(0,)))


def _scatter_rows(z0, n, vals, cols):
    """(B, n, D): z0 in every row, then vals (B, E, D) at the rows cols
    (B, E); a column n marks an unused entry."""
    B, D = z0.shape
    out = z0[:, None, :].expand(B, n + 1, D)
    if vals:
        index = torch.cat(cols, dim=1)
        out = out.scatter(1, index[..., None].expand(-1, -1, D), torch.cat(vals, dim=1))
    return out[:, :n]


# ------------------------------------------------------------ the drivers ----

def _dense(rhs, z0, ts, dt, state, cfg, stepper, max_steps, jumps):
    """``integrate._integrate_adaptive_dense`` for every lane: one
    continuous solve over [ts[:, 0], ts[:, -1]], each accepted step writing
    the quartic dense output into the lane's output rows it passes.  Returns
    (out (B, n, D), attempted, accepted); a lane whose budget ran out is NaN
    everywhere."""
    B, n = ts.shape
    ts_d = ts.detach().contiguous()
    t_end = ts_d[:, -1]
    k = torch.ones(B, dtype=torch.long, device=z0.device)  # the next output row
    attempted = torch.zeros(B, dtype=torch.long, device=z0.device)
    active = torch.ones(B, dtype=torch.bool, device=z0.device)

    def body(carry):
        t, z, dt, state, k, attempted, accepted, active = carry
        with torch.no_grad():
            dt = torch.clamp(dt, min=1e-14)
            dt_c = torch.minimum(dt, t_end - t)
            if jumps is not None:
                dt_c = torch.minimum(dt_c, jumps.after(t) - t)
            if stepper.order > 5:  # land on every output time
                nxt = ts_d.gather(1, k.clamp(max=n - 1)[:, None])[:, 0]
                dt_c = torch.minimum(dt_c, torch.where(k < n, nxt, math.inf) - t)
            dt_c = torch.where(active, dt_c, 0.0)
        z1, err, state1, (f0, f1, y_mid) = stepper.step_dense(rhs, t[:, None], z,
                                                              _h(dt_c, z), state)
        with torch.no_grad():
            ratio = _error_ratio(err, cfg.rtol, cfg.atol, z, z1).to(dt.dtype)
            accept = (ratio <= 1.0) & active
            dt_new = dt_c * _factor(ratio, stepper.order, cfg, accept)
            # A step that was only short because it was clamped to the end
            # (or a jump) does not shrink the carried proposal.
            dt_new = torch.where(accept & (dt_c < dt), torch.maximum(dt, dt_new), dt_new)
            passed = torch.searchsorted(ts_d, (t.detach() + dt_c)[:, None], right=True)[:, 0]
            m = torch.where(accept, passed - k, 0)
            attempted = attempted + active
            accepted = accepted + accept
            dt = torch.where(active, dt_new, dt)
        t_next = torch.where(accept, t + dt_c, t)
        with torch.no_grad():
            active = (t_next < t_end) & (attempted < max_steps)
            flags = torch.stack([active.any().long(), m.max()])
        carry = (t_next, _select(accept, z1, z), dt, _select(accept, state1, state), k + m,
                 attempted, accepted, active)
        return carry, (t, z, z1, f0, f1, y_mid, dt_c, k, m), flags

    loop = _Iterations(body, (ts[:, 0], z0, dt, state, k, attempted, attempted.clone(), active))
    vals, cols = [], []
    while True:
        carry, (t, z, z1, f0, f1, y_mid, dt_c, k, m), (more, emitted) = loop()
        if emitted:
            span = torch.arange(emitted, device=z0.device)
            col = k[:, None] + span
            t_out = ts.gather(1, col.clamp(max=n - 1))
            theta = _clip((t_out - t[:, None]) / torch.clamp(dt_c, min=1e-30)[:, None], 0.0, 1.0)
            vals.append(_quartic(z, z1, f0, f1, y_mid, dt_c, theta))
            cols.append(torch.where(span < m[:, None], col, n))
        if not more:
            break
    t, attempted, accepted = carry[0], carry[5], carry[6]
    out = _scatter_rows(z0, n, vals, cols)
    incomplete = t.detach() < t_end
    out = torch.where(incomplete[:, None, None], torch.full_like(out, math.nan), out)
    return out, attempted, accepted


def _restart(rhs, z0, ts, dt, state, cfg, stepper, max_steps, jumps):
    """``integrate._advance_adaptive`` over every output interval, for
    steppers without a dense step: each lane lands on each of its output
    times, with a budget of max_steps for each interval.  Once a lane's
    budget runs out it is NaN from that output row on, and each later
    interval counts max_steps rejected attempts, as in the JAX package."""
    B, n = ts.shape
    idx = torch.zeros(B, dtype=torch.long, device=z0.device)  # integrating to row idx + 1
    alive = torch.ones(B, dtype=torch.bool, device=z0.device)

    def body(carry):
        t, t1, z, dt, state, idx, tries, attempted, accepted, alive, active = carry
        with torch.no_grad():
            dt = torch.clamp(dt, min=1e-14)
        # The clamps to t1 and to a jump stay differentiable, as in the JAX
        # package: output times receive their gradient through them.
        dt_c = torch.minimum(dt, t1 - t)
        if jumps is not None:
            dt_c = torch.minimum(dt_c, jumps.after(t) - t)
        dt_c = torch.where(active, dt_c, 0.0)
        z1, err, state1 = stepper.step(rhs, t[:, None], z, _h(dt_c, z), state)
        with torch.no_grad():
            ratio = _error_ratio(err, cfg.rtol, cfg.atol, z, z1).to(dt.dtype)
            accept = (ratio <= 1.0) & active
            h = dt_c.detach()
            dt_new = h * _factor(ratio, stepper.order, cfg, accept)
            dt_new = torch.where(accept & (h < dt), torch.maximum(dt, dt_new), dt_new)
            dt = torch.where(active, dt_new, dt)
            attempted = attempted + active
            accepted = accepted + accept
            tries = tries + active
        t = torch.where(accept, t + dt_c, t)
        z = _select(accept, z1, z)
        with torch.no_grad():
            reached = active & ~(t < t1)
            alive = alive & (reached | (tries < max_steps))
            col = torch.where(reached, idx + 1, n)
            idx = idx + reached
            tries = torch.where(reached, 0, tries)
            active = alive & (idx < n - 1)
            flags = torch.stack([active.any().long(), reached.any().long()])
        # The next interval starts at the output time itself.
        t = torch.where(reached, t1, t)
        t1 = ts.gather(1, (idx + 1).clamp(max=n - 1)[:, None])[:, 0]
        carry = (t, t1, z, dt, _select(accept, state1, state), idx, tries, attempted, accepted,
                 alive, active)
        return carry, (z, col), flags

    zero = torch.zeros_like(idx)
    loop = _Iterations(body, (ts[:, 0], ts[:, 1], z0, dt, state, idx, zero, zero.clone(),
                              zero.clone(), alive, alive.clone()))
    vals, cols = [], []
    while True:
        carry, (z, col), (more, landed) = loop()
        if landed:
            vals.append(z[:, None].clone())
            cols.append(col[:, None].clone())
        if not more:
            break
    idx, attempted, accepted, alive = carry[5], carry[7], carry[8], carry[9]
    out = _scatter_rows(z0, n, vals, cols)
    dead = ~alive
    rows = torch.arange(n, device=z0.device)
    out = torch.where((dead[:, None] & (rows > idx[:, None]))[..., None],
                      torch.full_like(out, math.nan), out)
    attempted = attempted + torch.where(dead, (n - 2 - idx) * max_steps, 0)
    return out, attempted, accepted


def _fixed_steps(ts, cfg):
    """``integrate._static_fixed_steps`` over every lane's times, capped."""
    steps = _static_fixed_steps(np.asarray(_read(ts.detach())), cfg.step_size)
    return min(steps, cfg.max_steps or _FIXED_DEFAULT_MAX_STEPS)


def _fixed_rk(rhs, z0, ts, cfg, stepper):
    """Stateless RK steps, clip(t1 - t, 0, step) in every interval of every
    lane; a lane whose interval is done takes steps of size 0."""
    B, n = ts.shape
    steps = _fixed_steps(ts, cfg)
    outs, z = [z0], z0
    taken = torch.zeros(B, dtype=torch.long, device=z0.device)
    for i in range(n - 1):
        t, t1 = ts[:, i], ts[:, i + 1]
        size = cfg.step_size if cfg.step_size is not None else t1 - t
        for _ in range(steps):
            dt = _clip(t1 - t, 0.0, size)
            z = rk_step(stepper.tableau, rhs, t[:, None], z, _h(dt, z))
            taken += dt.detach() > 0
            t = t + dt
        outs.append(z)
    return torch.stack(outs, dim=1), taken, taken


def _fixed_state(rhs, z0, ts, state, cfg, stepper):
    """Fixed steps of step_size (the last of each interval clamped) carrying
    the stepper's state, one step per interval without a step_size."""
    B, n = ts.shape
    steps = _fixed_steps(ts, cfg)
    outs, z = [z0], z0
    taken = torch.zeros(B, dtype=torch.long, device=z0.device)
    for i in range(n - 1):
        t, t1 = ts[:, i], ts[:, i + 1]
        size = cfg.step_size if cfg.step_size is not None else t1 - t
        count = torch.zeros_like(taken)
        active = torch.ones(B, dtype=torch.bool, device=z0.device)
        while True:
            _iteration()
            dt = torch.where(active, torch.minimum(t1 - t, torch.zeros_like(t) + size), 0.0)
            z1, _err, state1 = stepper.step(rhs, t[:, None], z, _h(dt, z), state)
            z = _select(active, z1, z)
            state = _select(active, state1, state)
            t = t + dt
            with torch.no_grad():
                count += active
                active = active & (t < t1) & (count < steps)
            if not _read(active.any()):
                break
        taken += count
        outs.append(z)
    return torch.stack(outs, dim=1), taken, taken


def lockstep_odeint(rhs, z0, ts, cfg, jumps=None, differentiable=True, collect_stats=False):
    """``integrate.odeint`` for every lane at once: dz/dt = rhs(t, z) with z0
    (B, D) from each lane's ts[:, 0], returning z at every ts[:, i]: (B, n, D).

    ``ts``: the output times of every lane, (B, n), in the state's dtype;
    ``jumps``: a ``_Jumps`` or None.  With ``collect_stats=True`` returns
    ``(out, stats)``, each statistic a (B,) tensor."""
    stepper = cfg.stepper()
    if cfg.method == "dopri5" and jumps is not None:
        # The cached first stage is not valid across a discontinuity.
        stepper = STEPPERS["dopri5_nofsal"]
    adaptive = stepper.adaptive and cfg.step_size is None
    init_nfe = stepper.init_nfe
    if ts.shape[1] < 2:  # nothing to integrate
        zero = torch.zeros(ts.shape[0], dtype=torch.long, device=z0.device)
        out, attempted, accepted = z0[:, None], zero, zero
        init_nfe += 2 if adaptive else 0
    elif stepper.tableau is not None and not adaptive:
        out, attempted, accepted = _fixed_rk(rhs, z0, ts, cfg, stepper)
    else:
        t0 = ts[:, 0]
        state = stepper.init(rhs, t0[:, None], z0)
        if adaptive:
            with torch.no_grad():
                f0 = state if stepper.init_nfe else rhs(t0, z0)
                dt0 = _initial_step(rhs, t0.detach(), z0.detach(), stepper.order, cfg.rtol,
                                    cfg.atol, f0.detach()).to(t0.dtype)
            init_nfe += 2  # the initial-step heuristic
            max_steps = _adaptive_max_steps(cfg, stepper.order, differentiable)
            driver = _dense if stepper.step_dense is not None else _restart
            out, attempted, accepted = driver(rhs, z0, ts, dt0, state, cfg, stepper, max_steps,
                                              jumps)
        else:
            out, attempted, accepted = _fixed_state(rhs, z0, ts, state, cfg, stepper)
    if not collect_stats:
        return out
    return out, _stats(attempted, accepted, init_nfe, stepper.nfe_per_step)


def time_rows(t, batch, z0):
    """The output times of every lane, (B, n), on the state's device in the
    precision the host integrator plans in (``utils.misc.numpy_dtype``: the
    state's, float32 for a bfloat16 or float16 state): batched rows, or one
    row shared by every lane."""
    plan = torch.from_numpy(np.zeros(0, numpy_dtype(z0.dtype))).dtype
    if isinstance(t, np.ndarray):
        t = torch.as_tensor(np.asarray(t).astype(numpy_dtype(z0.dtype)))
    t = t.to(dtype=plan, device=z0.device)
    return t.reshape(-1, t.shape[-1]).expand(batch, -1) if t.ndim == 1 else t


# ------------------------------------------------------------ the adjoint ----

def _hoisted(func, X, t0, z0, slots):
    """Those of the field's tensors (``slots``, its ``ClosureSlots``) that
    the right-hand side of the control X reads and that require grad: the
    constants the JAX package's closure conversion hoists out of the field.
    A gradient that reaches a tensor requiring grad neither through them nor
    through the control's tensors, or one held where a lane cannot read its
    own copy, cannot be passed per lane, and raises."""
    with torch.enable_grad():
        f = slots.call(lambda: make_cde_rhs(func, X)(t0.detach(), z0.detach()))
    if f.grad_fn is None:
        return []
    candidates = [v for v in vars(X).values() if isinstance(v, torch.Tensor)] + slots.tensors
    stops = {(c.grad_fn, c.output_nr): c for c in candidates
             if c.requires_grad and c.grad_fn is not None}
    met = _walk([(f.grad_fn, 0)], stops, [])
    controls = {id(v) for v in vars(X).values()}
    lost = [v for v in met.values()
            if id(v) not in controls and (id(v) not in slots.where or id(v) in slots.stuck)]
    if lost:
        raise ValueError(
            "options={'per_sample': True} with adjoint=True passes each tensor the "
            "vector field reads to every lane; the field reads "
            f"{len(lost)} tensor(s) that require grad (shapes "
            f"{[tuple(p.shape) for p in lost]}) through no closure cell, global, "
            "parameter, buffer, attribute, partial argument, or dict, list or "
            "tuple item among them that a lane can replace."
        )
    return [p for p in slots.tensors if id(p) in met]


class _AdjointField:
    """The tensors that receive the backsolve's gradients, and the per-lane
    vector-Jacobian products of the right-hand side with respect to the
    state and to them: ``torch.func.vjp`` of one lane, vmapped over the
    lanes.  The control's tensors come first (each lane its rows; shared
    tensors such as the knot times, read or not), then the tensors the field
    closes over, as the JAX package's per-sample adjoint orders its
    constants (JAX ``cdeint.py:728-743``)."""

    def __init__(self, func, lanes, z0, t0, adjoint_params):
        func, slots = plain_field(func)
        self.forward = LaneField(func, lanes, slots)
        names = lanes.names()
        closed = _hoisted(func, lanes.first(), t0, z0[0], slots)
        # (the control's name or None, the tensor adjoint_params names, the
        # tensor given to autograd: the lanes' rows or a shared tensor, in_dim)
        entries = [(n, getattr(lanes.X, n) if isinstance(getattr(lanes.X, n), torch.Tensor)
                    else lanes.value(n), lanes.value(n), lanes.in_dim(n)) for n in names]
        entries += [(None, slots.dtensor_of.get(id(p), p), p, None) for p in closed]
        if adjoint_params is not None:
            wanted = {id(p) for p in adjoint_params}
            chosen = [e for e in entries if id(e[1]) in wanted]
            if len({id(e[1]) for e in chosen}) < len(wanted):
                warnings.warn(
                    "Could not identify every adjoint_params entry among the "
                    "arrays the vector field closes over; computing adjoint "
                    "gradients for the full closure superset instead."
                )
            else:
                entries = chosen
        self.entries, self.slots, self.lanes = entries, slots, lanes
        self.params = [e[2] for e in entries]
        diff = {e[0] for e in entries if e[0] is not None}
        fixed = [n for n in names if n not in diff]
        ctrl = [e for e in entries if e[0] is not None]
        held = [e for e in entries if e[0] is None]

        def one(t, z, a, *values):
            fixed_values = values[:len(fixed)]

            def f(z, *primals):
                control = dict(zip(fixed, fixed_values))
                control.update(zip([e[0] for e in ctrl], primals[:len(ctrl)]))
                X = lanes.lane(control)
                return slots.call(lambda: make_cde_rhs(func, X)(t, z),
                                  [e[2] for e in held], primals[len(ctrl):])

            out, pull = torch.func.vjp(f, z, *values[len(fixed):])
            return (out,) + pull(a)

        # A gathered tensor (``plain_field``) enters the vjps as a leaf copy:
        # read itself there, the tensor that the gather's autograd function
        # made rounds some of the lanes' products otherwise than the
        # single-device field's weights do (measured on the CPU in float64).
        # Its gradient reaches it through ``_LockstepAdjoint``'s inputs.
        gathered = [e[2].detach().requires_grad_() if id(e[2]) in slots.dtensor_of else e[2]
                    for e in held]
        self._values = ([lanes.value(n) for n in fixed] + [e[2] for e in ctrl] + gathered)
        in_dims = ([lanes.in_dim(n) for n in fixed] + [e[3] for e in ctrl]
                   + [None] * len(held))
        self._vjp = torch.func.vmap(one, in_dims=(0, 0, 0) + tuple(in_dims))

    def vjp(self, t, z, a):
        """(f (B, D), [a^T df/dz (B, D)] + [a^T df/dp (B, *p.shape)])."""
        out = self._vjp(t.reshape(-1), z, a, *self._values)
        return out[0], list(out[1:])


class _LockstepAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, field, cfg, adjoint_cfg, jumps, ts, z0, *params):
        with torch.no_grad():
            zs = lockstep_odeint(field.forward, z0, ts, cfg, jumps, differentiable=False)
        ctx.field, ctx.adjoint_cfg, ctx.jumps = field, adjoint_cfg, jumps
        ctx.save_for_backward(ts, zs)
        return zs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ts, zs = ctx.saved_tensors
        field = ctx.field
        B, n, H = zs.shape
        shapes = [tuple(v.shape[1:]) if d == 0 else tuple(v.shape)
                  for _name, _p, v, d in field.entries]
        sizes = [int(np.prod(s)) for s in shapes]

        def aug_rhs(s, aug):
            # s = -t; d/ds z = -f, d/ds a = +a^T df/dz, d/ds a_p = +a^T df/dp.
            f, vjps = field.vjp(-s, aug[:, :H], aug[:, H:2 * H])
            return torch.cat([-f] + [v.reshape(B, -1).to(f.dtype) for v in vjps], dim=1)

        neg = None
        if ctx.jumps is not None:
            adjoint_stepper = ctx.adjoint_cfg.stepper()
            if adjoint_stepper.adaptive and ctx.adjoint_cfg.step_size is None:
                neg = ctx.jumps.negated()
            else:
                warn_fixed_jumps()  # once, not per interval
        want_t = ctx.needs_input_grad[4]
        ts_bar = torch.zeros_like(ts) if want_t else None
        a = torch.zeros_like(zs[:, 0])
        a_params = zs.new_zeros((B, sum(sizes)))
        for i in range(n - 1, 0, -1):
            a = a + g[:, i]
            if want_t:
                # dL/dts[i] = g_i . f(ts[i], z_i): the readout-time sensitivity.
                ts_bar[:, i] = _lane_sum(g[:, i] * field.forward(ts[:, i], zs[:, i]))
            aug0 = torch.cat([zs[:, i], a, a_params], dim=1)
            span = torch.stack([-ts[:, i], -ts[:, i - 1]], dim=1)
            aug1 = lockstep_odeint(aug_rhs, aug0, span, ctx.adjoint_cfg, neg,
                                   differentiable=False)[:, 1]
            a, a_params = aug1[:, H:2 * H], aug1[:, 2 * H:]
        if want_t:
            # dL/dts[0] = -a(t0) . f(t0, z0), with a(t0) excluding g_0.
            ts_bar[:, 0] = -_lane_sum(a * field.forward(ts[:, 0], zs[:, 0]))
        grads = []
        for (_name, _match, p, d), part, shape in zip(field.entries,
                                                      torch.split(a_params, sizes, dim=1), shapes):
            part = part.reshape((B,) + shape)
            grads.append(part if d == 0 else part.sum(0))
        return (None, None, None, None, ts_bar, a + g[:, 0], *grads)


# ------------------------------------------------------------- the solve ----

def solve_per_sample(func, lanes, z0, ts, cfg, jump_t=None, return_stats=False,
                     adjoint_cfg=None, adjoint_params=None):
    """Every lane of z0 (B, H) solved in lockstep over its output times ts
    (B, n): (B, n, H), with its per-lane statistics when ``return_stats``.
    With an ``adjoint_cfg``, gradients come from the per-lane backsolve
    adjoint: each lane's augmented state [z, a, a_params] under its own
    controller, the shared tensors' cotangents summed over the lanes at the
    end."""
    jumps = None
    if jump_t is not None:
        jumps = _Jumps(torch.as_tensor(host_jumps(jump_t, z0.dtype), device=z0.device))
    batch = z0.shape[0]
    pad = max(_MIN_LANES.get(z0.device.type, 0) - batch, 0)
    if pad:
        lanes = lanes.padded(pad)
        z0 = torch.cat([z0, z0[:1].detach().expand(pad, -1)])
        ts = torch.cat([ts, ts[:1].detach().expand(pad, -1)])
    if adjoint_cfg is None:
        out = lockstep_odeint(LaneField(func, lanes), z0, ts, cfg, jumps,
                              collect_stats=return_stats)
    else:
        field = _AdjointField(func, lanes, z0, ts[0, 0], adjoint_params)
        out = _LockstepAdjoint.apply(field, cfg, adjoint_cfg, jumps, ts, z0, *field.params)
    if not pad:
        return out
    if return_stats:
        return out[0][:batch], {k: v[:batch] for k, v in out[1].items()}
    return out[:batch]
