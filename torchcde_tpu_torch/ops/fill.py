"""NaN fill and observed-index scans (port of ``torchcde_tpu/ops/fill.py``).

``masked_fill`` carries the most recent observed entry of each of several
arrays forward (or backward) along an axis.  On a CUDA float32 or bfloat16
tensor it launches K3 (``ops/fill_kernel.py``); elsewhere it runs the plain
version ``masked_fill_scan`` (``ops/dispatch.py``'s rule).  Its gradient is
the analytic segment sum of the JAX custom VJP, whose inner fill goes
through the same dispatch, so on the card no plain fill runs.

Positions before the first observation (after the last one, in reverse)
receive the array's first (last) entry: that is the identity of the JAX
select-combine scan, and both the kernel and the plain version reproduce it
(``masked_fill_scan([5, 6, 7, 8, 9], [F, F, T, F, T])`` is
``[5, 5, 7, 7, 9]``).  The JAX docstring of ``masked_fill_scan`` says such
positions keep their own entries; the JAX code does not.
"""

import torch


def _iota_like(x, axis):
    axis = axis % x.ndim
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return torch.arange(x.shape[axis], device=x.device).reshape(shape).expand(x.shape)


def prev_observed_index(observed, axis=-2):
    """For each position, index of the most recent True at or before it; -1 if none."""
    marked = torch.where(observed, _iota_like(observed, axis), -1)
    return torch.cummax(marked, dim=axis % observed.ndim).values


def next_observed_index(observed, axis=-2):
    """For each position, index of the nearest True at or after it; size if none."""
    axis = axis % observed.ndim
    n = observed.shape[axis]
    marked = torch.where(observed, _iota_like(observed, axis), n)
    return torch.flip(torch.cummin(torch.flip(marked, [axis]), dim=axis).values, [axis])


def masked_fill_scan(values, observed, axis=-1, reverse=False):
    """The plain version of K3: each array of ``values`` takes, at every
    position, its entry at the most recent observed position (the nearest
    later one when ``reverse``); positions with none take the array's first
    (last) entry.  A gather at a scanned index, with no arithmetic, so it
    equals the JAX select-combine scan exactly."""
    single = not isinstance(values, (tuple, list))
    if single:
        values = (values,)
    axis = axis % observed.ndim
    n = observed.shape[axis]
    idx = _iota_like(observed, axis)
    if reverse:
        src = next_observed_index(observed, axis)
        src = torch.minimum(src, torch.full_like(src, n - 1))
    else:
        src = torch.cummax(torch.where(observed, idx, 0), dim=axis).values
    filled = tuple(torch.gather(v.expand(observed.shape), axis, src) for v in values)
    return filled[0] if single else filled


def fill_dispatch(values, observed, axis, reverse):
    """The fill of a tuple of arrays along any axis (moved last around the
    call): K3 for CUDA float32/bfloat16 tensors, the plain version
    otherwise (``fill_kernel.masked_fill_kernel`` decides)."""
    from .fill_kernel import masked_fill_kernel

    axis = axis % observed.ndim
    last = observed.ndim - 1
    moved = tuple(torch.movedim(v, axis, last) for v in values)
    outs = masked_fill_kernel(moved, torch.movedim(observed, axis, last), reverse)
    return tuple(torch.movedim(o, last, axis) for o in outs)


def _segment_sums(grads, observed, axis, reverse):
    """The VJP of the fill (``torchcde_tpu/ops/fill.py:119-144``).

    y_i is the value at the source serving i (the most recent observed
    position, or the boundary entry before any observation).  The cotangent
    of source j is the sum of g over the positions it serves: a directional
    cumulative sum minus its value at the next source, fetched with a
    sentinel-extended fill."""
    n = observed.shape[axis]

    def cumsum(g):
        if reverse:
            return torch.cumsum(g, dim=axis)
        return torch.flip(torch.cumsum(torch.flip(g, [axis]), dim=axis), [axis])

    def pad(x, value):
        shape = list(x.shape)
        shape[axis] = 1
        edge = torch.full(shape, value, dtype=x.dtype, device=x.device)
        return torch.cat([edge, x] if reverse else [x, edge], dim=axis)

    sums = tuple(cumsum(g) for g in grads)
    nexts = fill_dispatch(tuple(pad(s, 0) for s in sums), pad(observed, True), axis,
                          not reverse)
    start = 0 if reverse else 1
    idx = _iota_like(observed, axis)
    keep = observed | (idx == (n - 1 if reverse else 0))
    return tuple(torch.where(keep, s - torch.narrow(sn, axis, start, n), torch.zeros_like(s))
                 for s, sn in zip(sums, nexts))


class _MaskedFill(torch.autograd.Function):
    @staticmethod
    def forward(ctx, observed, axis, reverse, *values):
        ctx.save_for_backward(observed)
        ctx.axis, ctx.reverse = axis, reverse
        return fill_dispatch(values, observed, axis, reverse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        (observed,) = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[3:]) if need]
        out = [None] * len(grads)
        if wanted:
            sums = _segment_sums(tuple(grads[i] for i in wanted), observed, ctx.axis,
                                 ctx.reverse)
            for i, s in zip(wanted, sums):
                out[i] = s
        return (None, None, None, *out)


def masked_fill(values, observed, axis=-1, reverse=False):
    """Differentiable masked fill (``masked_fill_scan``'s semantics).

    values: an array or a tuple of arrays with the mask's shape; observed:
    bool.  K3 on CUDA float32/bfloat16 tensors, the plain version elsewhere;
    gradients by the analytic segment-sum VJP either way."""
    single = not isinstance(values, (tuple, list))
    vals = (values,) if single else tuple(values)
    vals = tuple(v.expand(observed.shape) for v in vals)
    out = _MaskedFill.apply(observed, axis % observed.ndim, bool(reverse), *vals)
    return out[0] if single else tuple(out)


def forward_fill(x, fill_index=-2):
    """Forward fills NaNs along ``fill_index`` (reference: misc.py:103-126).

    Leading NaNs (before any observation) stay NaN: they receive the first
    entry, which is itself NaN."""
    return masked_fill(x, ~torch.isnan(x), axis=fill_index % x.ndim)


def backward_fill(x, fill_index=-2):
    """Backward fills NaNs along ``fill_index``; trailing NaNs stay NaN."""
    axis = fill_index % x.ndim
    n = x.shape[axis]
    nxt = next_observed_index(~torch.isnan(x), axis=axis)
    gathered = torch.gather(x, axis, torch.clamp(nxt, max=n - 1))
    return torch.where(nxt <= n - 1, gathered, x)
