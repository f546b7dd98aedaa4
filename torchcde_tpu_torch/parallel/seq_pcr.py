"""Sequence-sharded tridiagonal solve: substructuring (SPIKE) and distributed PCR.

Port of ``torchcde_tpu/parallel/seq_pcr.py``.  The length axis of the
system is split over the ranks of one mesh dim (``axis``); each rank holds
its rows and runs the body that JAX runs inside ``shard_map``, talking
through ``parallel.comm``:

* ``method="spike"`` (default), the partition method: each rank drops its two
  couplings across the shard boundary, solves its local system for three
  right-hand sides at once (the particular solution and the two boundary
  spikes: one batched ``ops.tridiagonal.tridiagonal_solve``, K4 on the
  card), all-gathers six boundary scalars per batch row, solves the small
  2(n - 1) interface system (``torch.linalg.solve``) on every rank and
  combines.  With one shard it is the single-device solve, without the two
  spike right-hand sides, which are zero there.
* ``method="pcr"``, distributed parallel cyclic reduction: each level is
  local elementwise work plus a halo exchange with the neighbours (an
  s-row strip while the stride s is under the local length, whole chunks
  beyond).  The local length is padded to a power of two with identity
  rows, which never couple into real rows.

Every rank builds the same autograd graph (rank masks, not branches), so
that a backward's collectives run in one order on every rank.

Operands may be plain tensors, which count as replicated (each rank takes
its rows; a gradient reaches every rank whole, ``comm.replicated_input``),
or ``DTensor``s over ``mesh`` whose placement on ``axis`` is
``Shard`` of the last dim (each rank's rows are moved to the body's
layout) or ``Replicate``.  The solution is a ``DTensor`` with the length
over ``axis`` (``torch.chunk``'s layout) and the batch over ``batch_axis``.
"""

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..ops.tridiagonal import tridiagonal_solve
from . import comm


def chunk_offsets(length, n):
    """The row offsets of ``torch.chunk``'s split of ``length`` rows over n
    (the layout of a ``Shard`` placement)."""
    c = -(-length // n) if length else 0
    return [min(r * c, length) for r in range(n + 1)]


def placements_for(mesh, ndim, axis, batch_axis, length_dim=-1):
    """The placements of an array whose length dim is split over ``axis`` and
    whose leading dim is split over ``batch_axis``."""
    out = []
    for name in mesh.mesh_dim_names:
        if name == axis:
            out.append(Shard(length_dim % ndim))
        elif name == batch_axis:
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out


def local_rows(x, mesh, axis, batch_axis, shape, offsets, shift=0, length_dim=-1):
    """This rank's rows of x along ``length_dim``, in the layout ``offsets``
    (n + 1 offsets of the global rows, one span a rank of ``axis``), and its
    batch rows when ``batch_axis`` is set.  Working row i holds x's global
    row i - ``shift``; rows beyond x are left out (the caller pads).  x is a
    plain tensor broadcasting to ``shape`` (replicated) or a ``DTensor``."""
    me = mesh.get_local_rank(axis)
    L = x.shape[length_dim]
    lo, hi = (min(max(o - shift, 0), L) for o in (offsets[me], offsets[me + 1]))
    ld = length_dim % len(shape)
    if isinstance(x, DTensor):
        place = dict(zip(mesh.mesh_dim_names, x.placements))
        want_batch = Shard(0) if batch_axis is not None else Replicate()
        if batch_axis is not None and place[batch_axis] != want_batch:
            raise ValueError(f"a DTensor operand must be placed {want_batch} on {batch_axis!r}")
        on_axis = place[axis]
        # A replicated placement that the body splits: each rank's cotangent
        # covers its part only, so the gradient is a partial sum.
        local = x.to_local(grad_placements=[
            Partial() if name in (axis, batch_axis) and p == Replicate() else p
            for name, p in zip(mesh.mesh_dim_names, x.placements)])
        if on_axis == Shard(ld):
            src = chunk_offsets(L, comm.axis_size(mesh, axis))
            dst = [min(max(o - shift, 0), L) for o in offsets]
            local = torch.movedim(local, ld, -1)
            local = comm.relayout(local, mesh, axis, src, dst)
            return torch.movedim(local, -1, ld)
        if on_axis != Replicate():
            raise ValueError(f"a DTensor operand must be placed Shard({ld}) or Replicate() "
                             f"on {axis!r}, found {on_axis}")
        return local.narrow(ld, lo, hi - lo)
    split = [axis] + ([batch_axis] if batch_axis is not None else [])
    x = comm.replicated_input(x, mesh, split).expand(shape[:ld] + (L,) + shape[ld + 1:])
    if batch_axis is not None:
        nb, mb = comm.axis_size(mesh, batch_axis), mesh.get_local_rank(batch_axis)
        bo = chunk_offsets(x.shape[0], nb)
        x = x[bo[mb]:bo[mb + 1]]
    return x.narrow(ld, lo, hi - lo)


def _pad_rows(x, before, after, value):
    """x with ``before`` and ``after`` rows of ``value`` around its last
    axis (one concatenation on every rank, whatever the counts)."""
    def rows(count):
        return torch.full(x.shape[:-1] + (count,), value, dtype=x.dtype, device=x.device)

    return torch.cat([rows(before), x, rows(after)], dim=-1)


def _dist_pcr(b, up, lo, d, *, mesh, axis, k_loc, n_shards):
    """Local body: (..., k_loc) rows of this shard (``seq_pcr.py:36-79``).
    lo[i] couples global row i to i - s, up[i] to i + s; s doubles from 1."""
    k_glob = k_loc * n_shards
    me = comm.axis_index(mesh, axis)
    gidx = me * k_loc + torch.arange(k_loc, device=b.device)

    def from_prev(x, s):  # x_global[i - s]; zeros beyond the left edge
        if s < k_loc:
            halo = comm.shift_from_prev(x[..., k_loc - s:].contiguous(), mesh, axis)
            return torch.cat([halo, x[..., :k_loc - s]], dim=-1)
        return comm.shift_from_prev(x, mesh, axis, s // k_loc)

    def from_next(x, s):  # x_global[i + s]; zeros beyond the right edge
        if s < k_loc:
            halo = comm.shift_from_next(x[..., :s].contiguous(), mesh, axis)
            return torch.cat([x[..., s:], halo], dim=-1)
        return comm.shift_from_next(x, mesh, axis, s // k_loc)

    s = 1
    for _ in range(max(1, (k_glob - 1).bit_length())):
        d_prev, d_next = from_prev(d, s), from_next(d, s)
        # Edge shifts deliver zeros; mask on the global row index (and guard
        # the division so the untaken branch stays finite).
        alpha = torch.where(gidx >= s, -lo / torch.where(d_prev == 0, 1.0, d_prev), 0.0)
        beta = torch.where(gidx < k_glob - s, -up / torch.where(d_next == 0, 1.0, d_next), 0.0)
        d = d + alpha * from_prev(up, s) + beta * from_next(lo, s)
        b = b + alpha * from_prev(b, s) + beta * from_next(b, s)
        lo = alpha * from_prev(lo, s)
        up = beta * from_next(up, s)
        s *= 2
    return b / d


def _spike_local(b, up, lo, d, *, mesh, axis, n_shards):
    """Local substructuring body (``seq_pcr.py:95-161``): (..., m) rows."""
    lo0 = lo[..., :1]   # couples local row 0 to the left neighbour's last row
    upm = up[..., -1:]  # couples local row m - 1 to the right neighbour's row 0
    zero = torch.zeros_like(b[..., :1])
    lo_in = torch.cat([zero, lo[..., 1:]], dim=-1)
    up_in = torch.cat([up[..., :-1], zero], dim=-1)
    inner = torch.zeros_like(b[..., 1:-1])
    if b.shape[-1] == 1:
        e0, em = lo0, upm
    else:
        e0 = torch.cat([lo0, inner, zero], dim=-1)
        em = torch.cat([zero, inner, upm], dim=-1)
    rhs = torch.stack([b, e0, em], dim=0)  # one solve, three right-hand sides
    sol = tridiagonal_solve(rhs, up_in[..., :-1], d, lo_in[..., 1:], method="auto")
    xp, xl, xr = sol[0], sol[1], sol[2]

    # Interface data per shard: [xp0, xpm, xl0, xlm, xr0, xrm].
    iface = torch.stack([xp[..., 0], xp[..., -1], xl[..., 0], xl[..., -1],
                         xr[..., 0], xr[..., -1]], dim=-1)
    allif = comm.all_gather(iface, mesh, axis)  # (n, ..., 6)

    # The reduced system over y = [R_0, L_1, R_1, L_2, ..., L_{n-1}], where
    # L_j / R_j are shard j's first / last unknowns:
    #   R_j + xlm_j R_{j-1} + xrm_j L_{j+1} = xpm_j      (j = 0..n-2)
    #   L_j + xl0_j R_{j-1} + xr0_j L_{j+1} = xp0_j      (j = 1..n-1)
    # with R_{-1} = L_n = 0; solved densely on every rank.
    nI = 2 * (n_shards - 1)
    ones, zeros = torch.ones_like(allif[0, ..., 0]), torch.zeros_like(allif[0, ..., 0])
    M = [[ones if r == c else zeros for c in range(nI)] for r in range(nI)]
    g = [zeros] * nI
    for j in range(n_shards - 1):  # R_j rows at position 2j
        r = 2 * j
        if j >= 1:
            M[r][2 * (j - 1)] = allif[j, ..., 3]
        M[r][2 * j + 1] = allif[j, ..., 5]
        g[r] = allif[j, ..., 1]
    for j in range(1, n_shards):  # L_j rows at position 2j - 1
        r = 2 * j - 1
        M[r][2 * j - 2] = allif[j, ..., 2]
        if j <= n_shards - 2:
            M[r][2 * j + 1] = allif[j, ..., 4]
        g[r] = allif[j, ..., 0]
    M = torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)
    y = torch.linalg.solve(M, torch.stack(g, dim=-1)[..., None])[..., 0]

    # Rank masks, not branches: every rank builds the same graph.
    me = comm.axis_index(mesh, axis)
    r_prev = torch.where(torch.tensor(me >= 1, device=y.device),
                         y[..., min(max(2 * (me - 1), 0), nI - 1)], 0.0)
    l_next = torch.where(torch.tensor(me <= n_shards - 2, device=y.device),
                         y[..., min(max(2 * me + 1, 0), nI - 1)], 0.0)
    return xp - xl * r_prev[..., None] - xr * l_next[..., None]


def tridiagonal_solve_seq_sharded(b, A_upper, A_diagonal, A_lower, mesh, axis="model",
                                  batch_axis=None, method="spike"):
    """Solves Ax = b with the length axis split over ``mesh`` dim ``axis``.

    Same system convention and broadcasting as
    ``ops.tridiagonal.tridiagonal_solve``; ``batch_axis`` splits the leading
    batch dim as well (``axis="model", batch_axis="data"`` on a (data,
    model) mesh).  ``method``: "spike" (local solves and a small interface
    system; for diagonally dominant systems such as the natural-cubic fit's)
    or "pcr" (distributed cyclic reduction, unconditionally stable).
    Returns a ``DTensor`` (see the module docstring)."""
    shape = tuple(torch.broadcast_shapes(A_diagonal.shape, b.shape))
    k = shape[-1]
    n = comm.axis_size(mesh, axis)
    if method == "spike":
        k_loc = -(-k // n)
    elif method == "pcr":
        # Power-of-two local lengths, so every stride at or above the local
        # length lands on whole ranks.
        k_loc = 1 << max(0, math.ceil(math.log2(max(-(-k // n), 1))))
    else:
        raise ValueError(f"Unrecognised method={method!r}; expected 'spike' or 'pcr'")
    if n == 1 and (batch_axis is None or comm.axis_size(mesh, batch_axis) == 1):
        # One shard and no batch split: the single-device solve, without the
        # two spike right-hand sides, which are zero here.
        whole = [comm.whole(a) for a in (b, A_upper, A_diagonal, A_lower)]
        x = tridiagonal_solve(*whole, method="auto")
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    placements = placements_for(mesh, len(shape), axis, batch_axis)
    offsets = [r * k_loc for r in range(n + 1)]
    me = comm.axis_index(mesh, axis)

    def rows(x, shift=0):
        return local_rows(x, mesh, axis, batch_axis, shape, offsets, shift)

    bl, dl = rows(b), rows(A_diagonal)
    ul, ll = rows(A_upper), rows(A_lower, shift=1)
    real = min(offsets[me + 1], k) - min(offsets[me], k)
    # Identity rows (d = 1, couplings and right-hand side 0) pad each rank
    # to k_loc; the couplings past the last real row are zero, and so is
    # the lower coupling of global row 0.
    bl = _pad_rows(bl, 0, k_loc - real, 0.0)
    dl = _pad_rows(dl, 0, k_loc - real, 1.0)
    ul = _pad_rows(ul, 0, k_loc - ul.shape[-1], 0.0)
    ll = _pad_rows(ll, 1 if me == 0 else 0, k_loc - ll.shape[-1] - (1 if me == 0 else 0), 0.0)

    if n == 1:
        x = tridiagonal_solve(bl, ul[..., :-1], dl, ll[..., 1:], method="auto")
    elif method == "spike":
        x = _spike_local(bl, ul, ll, dl, mesh=mesh, axis=axis, n_shards=n)
    else:
        x = _dist_pcr(bl, ul, ll, dl, mesh=mesh, axis=axis, k_loc=k_loc, n_shards=n)
    x = comm.relayout(x[..., :real], mesh, axis, [min(o, k) for o in offsets],
                      chunk_offsets(k, n))
    return DTensor.from_local(x, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
