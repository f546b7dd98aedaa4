"""Sequence-sharded NaN-masked natural-cubic fit.

Port of ``torchcde_tpu/parallel/seq_masked.py``.  ``parallel.seq_pcr``
shards the dense tridiagonal solve; this module shards the whole masked
fit of ``interpolation/cubic.py`` (``_masked_coeffs_plain`` after the
``_version=1`` endpoint imputation), so series longer than one device hold
fit with the length axis over the ranks of one mesh dim.  Each rank runs
the body JAX runs inside ``shard_map``, talking through ``parallel.comm``:

* masked fills: the local fill (``ops.fill.masked_fill``, K3 on the card)
  plus one all-gather of per-shard (carry, seen) summaries, combined in
  plain unrolled code;
* element shifts: a one-element halo from the neighbour;
* the gappy tridiagonal solve, by SPIKE: each rank solves three local
  systems (the real right-hand side and unit responses to its two couplings
  across the boundary) in one launch of the gappy solve
  (``interpolation.cubic._MaskedSolve``, K5 on the card), all ranks gather
  six boundary scalars, every rank solves the small 2n interface system,
  and the local solutions recombine.  Empty shards (no observed rows) pass
  through exactly.

No rank holds the whole length: the output is a ``DTensor`` whose length
rows are split over ``axis`` in ``torch.chunk``'s layout (the last shard
holds one row fewer).

Every rank builds the same autograd graph: what depends on the rank's
coordinate enters as masks (``torch.where``), never as a Python branch, as
in the JAX bodies.  The backward's collectives then run in one order on
every rank (the autograd engine orders nodes by their creation).
"""

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..interpolation.cubic import _MaskedSolve, natural_cubic_coeffs
from ..ops.fill import masked_fill
from ..utils.misc import validate_input_path
from . import comm
from .seq_pcr import _contiguous_stride, local_rows, placements_for


def _local_seen(observed, reverse=False):
    """Prefix (suffix) OR along the local length axis (last axis)."""
    o = observed.to(torch.uint8)
    if reverse:
        return torch.flip(torch.cummax(torch.flip(o, [-1]), dim=-1).values, [-1]).bool()
    return torch.cummax(o, dim=-1).values.bool()


def _local_fill(values, observed, reverse=False):
    """The local fill through the differentiable dispatcher: K3 on the card."""
    out = masked_fill(tuple(values), observed, axis=-1, reverse=reverse)
    return out if isinstance(out, tuple) else (out,)


class _Shards:
    """The mesh dim that splits the length axis: its mesh, name, size and
    this rank's coordinate."""

    def __init__(self, mesh, axis):
        self.mesh, self.axis = mesh, axis
        self.n = comm.axis_size(mesh, axis)
        self.me = comm.axis_index(mesh, axis)

    def gather(self, x):
        return comm.all_gather(x, self.mesh, self.axis)

    def flag(self, value, like):
        """A constant bool tensor on ``like``'s device (a rank mask)."""
        return torch.tensor(bool(value), device=like.device)


def _shard_fill(values, observed, sh, reverse=False):
    """Global masked fill across shards: the local fill plus one gather of
    each shard's summary (its payloads at its latest observation and whether
    it has one), combined over the earlier (later, when ``reverse``) shards.
    Positions before the global first observation keep the local fill's."""
    filled = _local_fill(values, observed, reverse=reverse)
    seen = _local_seen(observed, reverse=reverse)
    edge = slice(0, 1) if reverse else slice(-1, None)
    any_local = seen[..., edge].to(filled[0].dtype)
    g = sh.gather(torch.stack([f[..., edge] for f in filled] + [any_local], dim=0))
    carry = [torch.zeros_like(f[..., edge]) for f in filled]
    carry_flag = torch.zeros_like(any_local)
    order = range(sh.n) if not reverse else range(sh.n - 1, -1, -1)
    for s in order:
        # Shards on the far side of this one (and itself) are masked out.
        upstream = s > sh.me if reverse else s < sh.me
        take = (g[s, -1] > 0.5) & upstream
        carry = [torch.where(take, g[s, i], c) for i, c in enumerate(carry)]
        carry_flag = torch.where(take, g[s, -1], carry_flag)
    use_carry = (~seen) & (carry_flag > 0.5)
    return tuple(torch.where(use_carry, c, f) for c, f in zip(carry, filled))


def _shift_from_prev(x, sh):
    """Global x[i - 1] (length last); zero before the global first element."""
    halo = comm.shift_from_prev(x[..., -1:].contiguous(), sh.mesh, sh.axis)
    return torch.cat([halo, x[..., :-1]], dim=-1)


def _shift_from_next(x, sh):
    """Global x[i + 1]; the global last element replicates itself."""
    halo = comm.shift_from_next(x[..., :1].contiguous(), sh.mesh, sh.axis)
    halo = torch.where(sh.flag(sh.me == sh.n - 1, x), x[..., -1:], halo)
    return torch.cat([x[..., 1:], halo], dim=-1)


def _reverse_count(observed, sh):
    """Number of observations at or after each position, globally."""
    counts = observed.to(torch.int64)
    local = torch.flip(torch.cumsum(torch.flip(counts, [-1]), dim=-1), [-1])
    gathered = sh.gather(counts.sum(dim=-1, keepdim=True))
    after = torch.zeros_like(local[..., :1])
    for s in range(sh.me + 1, sh.n):
        after = after + gathered[s]
    return local + after


def _first_other(flags, start, stop, step):
    """Per batch element, one-hots of the first non-empty shard walking
    ``range(start, stop, step)``: a list of (shard, bool tensor)."""
    taken = torch.zeros_like(flags[0])
    out = []
    for p in range(start, stop, step):
        out.append((p, flags[p] & ~taken))
        taken = taken | flags[p]
    return out


def _spike_gappy_solve(diag, rhs, hr, hr_prev, observed, sh):
    """Distributed gappy Thomas by SPIKE (``seq_masked.py:132-256``).

    The contract of ``interpolation.cubic._masked_thomas_observed`` with the
    length axis sharded; hr couples to the next observed row, hr_prev to the
    previous (both zero where that neighbour does not exist globally)."""
    obs_f = observed.to(diag.dtype)
    seen_fwd, seen_bwd = _local_seen(observed), _local_seen(observed, reverse=True)
    no = torch.zeros_like(observed[..., :1])
    is_first = observed & ~torch.cat([no, seen_fwd[..., :-1]], dim=-1)
    is_last = observed & ~torch.cat([seen_bwd[..., 1:], no], dim=-1)
    any_local = observed.any(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=diag.dtype, device=diag.device)

    # The local system keeps the interior couplings; the boundary rows'
    # couplings to other shards become right-hand sides (unit responses).
    lo_L = torch.where(is_first, hr_prev, zero).sum(dim=-1, keepdim=True)
    up_R = torch.where(is_last, hr, zero).sum(dim=-1, keepdim=True)
    hr_loc = torch.where(is_last, zero, hr)
    hrp_loc = torch.where(is_first, zero, hr_prev)
    e_L = torch.where(is_first, lo_L, zero)
    e_R = torch.where(is_last, up_R, zero)

    stacked = torch.stack([rhs, e_L, e_R], dim=0)
    shape = stacked.shape
    sol = _MaskedSolve.apply(diag.expand(shape), stacked, hr_loc.expand(shape),
                             hrp_loc.expand(shape), observed.expand(shape))
    x_p, x_l, x_r = sol[0], sol[1], sol[2]

    def at(mask, x):
        return torch.where(mask, x, zero).sum(dim=-1, keepdim=True)

    # Six boundary scalars per shard and the non-empty flag: (n, 7, ..., 1).
    g = sh.gather(torch.stack([
        at(is_first, x_p), at(is_last, x_p), at(is_first, x_l), at(is_last, x_l),
        at(is_first, x_r), at(is_last, x_r), any_local.to(diag.dtype)], dim=0))

    # The interface system, solved on every rank: unknowns
    # u = [xL_0, xR_0, ..., xL_{n-1}, xR_{n-1}] per batch element.
    n, m = sh.n, 2 * sh.n
    flags = [g[s, 6, ..., 0] > 0.5 for s in range(n)]
    ones, zeros = torch.ones_like(g[0, 0, ..., 0]), torch.zeros_like(g[0, 0, ..., 0])
    A = [[ones if r == c else zeros for c in range(m)] for r in range(m)]
    bvec = [zeros] * m
    for s in range(n):
        pLp, pRp, lLp, lRp, rLp, rRp = (g[s, q, ..., 0] for q in range(6))
        f_s = flags[s]
        bvec[2 * s] = torch.where(f_s, pLp, zero)
        bvec[2 * s + 1] = torch.where(f_s, pRp, zero)
        # Coupled to the previous non-empty shard p's xR and the next one q's xL.
        for p, hit in _first_other(flags, s - 1, -1, -1):
            A[2 * s][2 * p + 1] = A[2 * s][2 * p + 1] + torch.where(f_s & hit, lLp, zero)
            A[2 * s + 1][2 * p + 1] = A[2 * s + 1][2 * p + 1] + torch.where(f_s & hit, lRp, zero)
        for q, hit in _first_other(flags, s + 1, n, 1):
            A[2 * s][2 * q] = A[2 * s][2 * q] + torch.where(f_s & hit, rLp, zero)
            A[2 * s + 1][2 * q] = A[2 * s + 1][2 * q] + torch.where(f_s & hit, rRp, zero)
    A = torch.stack([torch.stack(row, dim=-1) for row in A], dim=-2)
    u = torch.linalg.solve(A, torch.stack(bvec, dim=-1)[..., None])[..., 0]

    # XL = xR of the previous non-empty shard; XR = xL of the next.
    XL, XR = zeros, zeros
    for s in range(n):
        xl_val, xr_val = zeros, zeros
        for p, hit in _first_other(flags, s - 1, -1, -1):
            xl_val = torch.where(hit, u[..., 2 * p + 1], xl_val)
        for q, hit in _first_other(flags, s + 1, n, 1):
            xr_val = torch.where(hit, u[..., 2 * q], xr_val)
        is_me = sh.flag(s == sh.me, u)
        XL = torch.where(is_me, xl_val, XL)
        XR = torch.where(is_me, xr_val, XR)
    x = x_p - XL[..., None] * x_l - XR[..., None] * x_r
    return x * obs_f


def _masked_coeffs_body(t_b, x, sh):
    """``interpolation.cubic._masked_coeffs_plain`` with every dependence
    along the length routed through the sharded primitives above.  Arrays
    (..., k_loc), length last; returns full-grid (a, b, two_c, three_d)."""
    observed = ~torch.isnan(x)
    x_safe = torch.where(observed, x, torch.zeros_like(x))

    # Next observed (value, time) strictly after each position; the global
    # last position takes t_last + 1 (no later observation).
    xn_inc, tn_inc = _shard_fill((x_safe, t_b), observed, sh, reverse=True)
    xn, tn = _shift_from_next(torch.stack([xn_inc, tn_inc]), sh)
    last_col = torch.arange(x.shape[-1], device=x.device) == x.shape[-1] - 1
    tn = torch.where(last_col & (sh.me == sh.n - 1), tn_inc + 1.0, tn)

    later_obs = _reverse_count(observed, sh)
    has_next = observed & (later_obs > 1)

    h = tn - t_b
    hr = torch.where(has_next, 1.0 / torch.where(has_next, h, torch.ones_like(h)), 0.0)
    six_pd_hr = 6 * (xn - x_safe) * hr
    pds = 0.5 * six_pd_hr * hr

    hr_f, pds_f = _shard_fill((hr, pds), observed, sh)
    hr_prev, pds_prev = _shift_from_prev(torch.stack([hr_f, pds_f]), sh)

    diag = 2 * (hr_prev + hr)
    diag = torch.where(observed & (diag > 0), diag, torch.ones_like(diag))
    rhs = pds_prev + pds

    kd = _spike_gappy_solve(diag, rhs, hr, hr_prev, observed, sh)

    (kdn_inc,) = _shard_fill((kd,), observed, sh, reverse=True)
    kdn = _shift_from_next(kdn_inc, sh)

    two_c0 = (six_pd_hr - 4 * kd - 2 * kdn) * hr
    three_d0 = (-six_pd_hr + 3 * (kd + kdn)) * hr * hr

    a_k, b_k, two_c_k, three_d_k, t_obs = _shard_fill(
        (x_safe, kd, two_c0, three_d0, t_b), observed, sh)
    offset = t_obs - t_b

    a = a_k + ((0.5 * two_c_k - three_d_k * offset / 3) * offset - b_k) * offset
    b = b_k + (three_d_k * offset - two_c_k) * offset
    two_c = two_c_k - 2 * three_d_k * offset
    return a, b, two_c, three_d_k


def _impute_body(x_loc, sh):
    """The ``_version=1`` endpoint imputation across shards
    (``seq_masked.py:346-372``): before the global first observation take
    the backward fill (the first observed value), after the last the
    forward fill.  Returns the imputed values and, per row, whether any
    shard observed it."""
    obs = ~torch.isnan(x_loc)
    safe = torch.where(obs, x_loc, torch.zeros_like(x_loc))
    (x_f,) = _shard_fill((safe,), obs, sh)
    (x_bwd,) = _shard_fill((safe,), obs, sh, reverse=True)
    gathered = sh.gather(obs.any(dim=-1, keepdim=True).to(torch.uint8)) > 0
    before = torch.zeros_like(gathered[0])
    after = torch.zeros_like(gathered[0])
    for s in range(sh.n):
        if s < sh.me:
            before = before | gathered[s]
        elif s > sh.me:
            after = after | gathered[s]
    seen_before = _local_seen(obs) | before
    seen_after = _local_seen(obs, reverse=True) | after
    xi = torch.where(torch.isnan(x_loc) & ~seen_before, x_bwd, x_loc)
    xi = torch.where(torch.isnan(xi) & ~seen_after, x_f, xi)
    return xi, gathered.any(dim=0)


def natural_cubic_coeffs_seq_sharded(x, t, mesh, axis="model", batch_axis=None):
    """NaN-masked natural cubic coefficients with the LENGTH axis sharded.

    The contract of ``natural_cubic_coeffs`` (x (..., length, channels),
    optional 1-D t, the ``_version=1`` endpoint imputation, packed output
    (..., length - 1, 4 * channels)) with the length split over ``mesh`` dim
    ``axis`` and the leading batch dim over ``batch_axis``.  x is a plain
    tensor (replicated) or a ``DTensor`` (length ``Shard`` or ``Replicate``
    on ``axis``).  Returns a ``DTensor``: the length rows over ``axis``, the
    batch over ``batch_axis``.  The length must divide by the number of
    shards."""
    t_arg = t
    t = validate_input_path(x, t)
    t = torch.as_tensor(t).to(dtype=x.dtype, device=x.device)
    dims = mesh.mesh_dim_names
    n_shards = comm.axis_size(mesh, axis)
    n_batch = 1 if batch_axis is None else comm.axis_size(mesh, batch_axis)
    length = x.shape[-2]
    out_shape = tuple(x.shape[:-2]) + (length - 1, 4 * x.shape[-1])
    if n_shards == 1 and n_batch == 1:
        # One shard: the single-device masked fit (K6/K7 on the card), which
        # has the same contract, without SPIKE's three local solves.
        full = comm.whole(x)
        out = natural_cubic_coeffs(full, t_arg)
        return DTensor.from_local(out, mesh, [Replicate()] * len(dims), run_check=False)
    if length % n_shards:
        raise ValueError(
            f"length {length} must divide the number of length shards "
            f"{n_shards} (pad the series; identity rows are safe)"
        )
    sh = _Shards(mesh, axis)
    k_loc = length // n_shards
    offsets = [r * k_loc for r in range(n_shards + 1)]
    x_loc = local_rows(x, mesh, axis, batch_axis, tuple(x.shape), offsets, length_dim=-2)
    t_loc = t[offsets[sh.me]:offsets[sh.me + 1]]

    xT = x_loc.transpose(-1, -2)  # (..., C, k_loc): length last
    t_b = t_loc.expand(xT.shape)
    xi, any_obs = _impute_body(xT, sh)
    a, b, two_c, three_d = _masked_coeffs_body(t_b, xi, sh)

    rows = k_loc - 1 if sh.me == n_shards - 1 else k_loc
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    coeffs = torch.stack([torch.where(any_obs, v, zero)[..., :rows]
                          for v in (a, b, two_c, three_d)], dim=-3)  # (..., 4, C, rows)
    coeffs = torch.movedim(coeffs, -1, -3)  # (..., rows, 4, C)
    coeffs = coeffs.reshape(coeffs.shape[:-2] + (coeffs.shape[-2] * coeffs.shape[-1],))
    return DTensor.from_local(coeffs, mesh,
                              placements_for(mesh, len(out_shape), axis, batch_axis, -2),
                              run_check=False, shape=torch.Size(out_shape),
                              stride=_contiguous_stride(out_shape))
