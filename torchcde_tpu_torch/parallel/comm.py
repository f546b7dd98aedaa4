"""The collectives of the sharded bodies, differentiable.

The JAX package's ``parallel/`` bodies run inside ``jax.shard_map`` and talk
through ``lax.axis_index``, ``lax.all_gather``, ``lax.ppermute`` and
``lax.psum``, which JAX differentiates.  This module gives the port's bodies
the same four along one dimension of a ``DeviceMesh``, each a
``torch.autograd.Function`` with the transpose as its backward:

* ``axis_index(mesh, dim)``: this rank's coordinate along ``dim``;
* ``all_gather(x, mesh, dim)``: (n, *x.shape), every rank's x; its backward
  is the reduce-scatter (sum) of the cotangent;
* ``shift_from_prev(x, mesh, dim, m)`` / ``shift_from_next``: the x of the
  rank m before (after) this one along ``dim``, zeros where there is none
  (a ``ppermute``); each one's backward is the opposite shift;
* ``psum(x, mesh, dim)``: the sum over ``dim`` of a value then used
  replicated: all-reduce forward, identity backward.  (PyTorch's
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the cotangent
  as well, which for a replicated output gives n times the gradient.)
* ``relayout(x, mesh, dim, src, dst)``: moves the rows of the last axis from
  one split over the ranks of ``dim`` to another;
* ``whole(x)``: a ``DTensor``'s value as a plain tensor on every rank
  (``Shard`` dims all-gathered through this module, ``Partial`` dims
  summed), differentiable.  ``DTensor.full_tensor`` all-gathers through
  ``torch.distributed`` itself, which over gloo faults on CUDA tensors;
* ``replicated_input(x, mesh, dims)``: a plain tensor that every rank holds
  whole and the body then splits over ``dims``: identity forward; backward,
  each rank's cotangent covers its own part, so they are summed over
  ``dims`` (all-reduce) to give every rank the whole gradient.

Transport.  NCCL carries CUDA tensors in every collective; it is the route
when each rank has its own card.  Gloo carries CUDA tensors only in
all-reduce and broadcast, so for every other collective over gloo (the
all-gather and the point-to-point shifts) a CUDA message is copied to the
host and back: ``STAGED_BYTES`` counts the bytes of those copies, both ways.
The computation stays on the card; only the message crosses.  Nothing here
picks a backend: the process group's is used as it is.
"""

import torch
import torch.distributed as dist

STAGED_BYTES = 0


def reset_staged_bytes():
    global STAGED_BYTES
    STAGED_BYTES = 0


def axis_index(mesh, dim):
    """This rank's coordinate along mesh dimension ``dim`` (a name)."""
    return mesh.get_local_rank(dim)


def axis_size(mesh, dim):
    """The number of ranks along mesh dimension ``dim`` (a name)."""
    return mesh.size(mesh.mesh_dim_names.index(dim))


def _stages(group, t):
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(group, t):
    """The tensor a collective of ``group`` can carry: a host copy of a
    CUDA tensor on gloo (counted), else ``t`` itself."""
    global STAGED_BYTES
    if _stages(group, t):
        STAGED_BYTES += t.numel() * t.element_size()
        return t.cpu()
    return t.contiguous()


def _from_wire(t, like):
    global STAGED_BYTES
    if t.device != like.device:
        STAGED_BYTES += t.numel() * t.element_size()
        return t.to(like.device)
    return t


def _all_reduce(x, group):
    """Sum over ``group`` in place of a fresh copy (all-reduce carries CUDA
    tensors on gloo and NCCL alike)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _gather(x, mesh, dim):
    group, n = mesh.get_group(dim), axis_size(mesh, dim)
    if n == 1:
        return x[None].clone()
    wire = _to_wire(group, x)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return _from_wire(torch.stack(parts), x)


def _exchange(sends, recv_from, like, mesh, dim):
    """Point-to-point: ``sends`` maps a destination coordinate along ``dim``
    to a tensor; one message of ``like``'s shape and dtype comes from each
    coordinate in ``recv_from``.  Returns {source coordinate: tensor}."""
    group = mesh.get_group(dim)
    stage = _stages(group, like)
    ops, got = [], {}
    for dst, t in sends.items():
        wire = _to_wire(group, t)
        ops.append(dist.P2POp(dist.isend, wire, dist.get_global_rank(group, dst), group))
    for src in recv_from:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if stage else like.device)
        got[src] = buf
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {src: _from_wire(buf, like) for src, buf in got.items()}


def _shift(x, mesh, dim, m):
    """x of the rank ``m`` places before this one along ``dim`` (m < 0: after);
    zeros where there is none."""
    n, me = axis_size(mesh, dim), mesh.get_local_rank(dim)
    sends = {me + m: x.contiguous()} if 0 <= me + m < n else {}
    recv = [me - m] if 0 <= me - m < n else []
    got = _exchange(sends, recv, x, mesh, dim)
    return got[me - m] if recv else torch.zeros_like(x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        # The reduce-scatter (sum): every rank's cotangent for this rank's x.
        me = ctx.mesh.get_local_rank(ctx.dim)
        if axis_size(ctx.mesh, ctx.dim) == 1:
            return g[0], None, None
        return _all_reduce(g, ctx.mesh.get_group(ctx.dim))[me], None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, m):
        ctx.mesh, ctx.dim, ctx.m = mesh, dim, m
        return _shift(x, mesh, dim, m)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.dim, -ctx.m), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        if axis_size(mesh, dim) == 1:
            return x.clone()
        return _all_reduce(x, mesh.get_group(dim))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for dim in ctx.dims:
            if axis_size(ctx.mesh, dim) > 1:
                g = _all_reduce(g, ctx.mesh.get_group(dim))
        return g, None, None


def replicated_input(x, mesh, dims):
    """x, whose gradient is summed over the mesh dims ``dims`` (see above)."""
    return _ReplicatedInput.apply(x, mesh, tuple(dims))


def all_gather(x, mesh, dim):
    """(n, *x.shape): the x of every rank along ``dim``, in coordinate order."""
    return _AllGather.apply(x, mesh, dim)


def shift_from_prev(x, mesh, dim, m=1):
    """The x of the rank m coordinates before this one; zeros on the first m."""
    return _Shift.apply(x, mesh, dim, int(m))


def shift_from_next(x, mesh, dim, m=1):
    """The x of the rank m coordinates after this one; zeros on the last m."""
    return _Shift.apply(x, mesh, dim, -int(m))


def psum(x, mesh, dim):
    """Sum over ``dim`` of a value used replicated afterwards (identity
    backward)."""
    return _Psum.apply(x, mesh, dim)


def _relayout(x, mesh, dim, src, dst):
    """Rows of the last axis held as ``src[r]:src[r + 1]`` on coordinate r
    go to ``dst[r]:dst[r + 1]``; x holds this rank's src rows."""
    n, me = axis_size(mesh, dim), mesh.get_local_rank(dim)
    lo, hi = dst[me], dst[me + 1]
    sends, recvs = {}, {}
    for r in range(n):
        a, b = max(src[me], dst[r]), min(src[me + 1], dst[r + 1])
        if a < b and r != me:
            sends[r] = x[..., a - src[me]:b - src[me]].contiguous()
        a, b = max(src[r], lo), min(src[r + 1], hi)
        if a < b:
            recvs[r] = (a, b)
    # Messages differ in length, so each goes through its own exchange of
    # one pair; the ranks walk the pairs in one order.
    pieces = {}
    if me in recvs:
        a, b = recvs[me]
        pieces[me] = x[..., a - src[me]:b - src[me]]
    for s in range(n):
        for r in range(n):
            if s == r:
                continue
            if s == me and r in sends:
                _exchange({r: sends[r]}, [], sends[r], mesh, dim)
            elif r == me and s in recvs:
                a, b = recvs[s]
                like = torch.empty(x.shape[:-1] + (b - a,), dtype=x.dtype, device=x.device)
                pieces[s] = _exchange({}, [s], like, mesh, dim)[s]
    out = [pieces[r] for r in sorted(pieces)]
    if not out:
        return x.new_zeros(x.shape[:-1] + (0,))
    return torch.cat(out, dim=-1)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, src, dst):
        ctx.args = (mesh, dim, src, dst)
        return _relayout(x, mesh, dim, src, dst)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, src, dst = ctx.args
        return _relayout(g.contiguous(), mesh, dim, dst, src), None, None, None, None


def relayout(x, mesh, dim, src, dst):
    """Moves the last axis's rows from the split ``src`` to ``dst`` (each a
    list of n + 1 increasing offsets over the coordinates of ``dim``)."""
    src, dst = tuple(int(v) for v in src), tuple(int(v) for v in dst)
    if src == dst:
        return x
    return _Relayout.apply(x, mesh, dim, src, dst)


class _GatherWhole(torch.autograd.Function):
    """A ``Shard(d)`` local part to the whole, then used replicated: the
    forward all-gathers along d (``torch.chunk``'s layout); the backward
    takes this rank's part of the cotangent, which every rank holds alike."""

    @staticmethod
    def forward(ctx, local, mesh, dim, d, size):
        n, me = axis_size(mesh, dim), axis_index(mesh, dim)
        c = -(-size // n)
        ctx.part = (d, min(me * c, size), local.shape[d])
        pad = c - local.shape[d]
        if pad:
            zeros = local.new_zeros(local.shape[:d] + (pad,) + local.shape[d + 1:])
            local = torch.cat([local, zeros], dim=d)
        parts = _gather(local.contiguous(), mesh, dim)  # (n, ...)
        return torch.cat(list(parts.unbind(0)), dim=d).narrow(d, 0, size)

    @staticmethod
    def backward(ctx, g):
        d, start, length = ctx.part
        return g.narrow(d, start, length), None, None, None, None


def whole(x):
    """The value of ``x`` (a ``DTensor``; anything else passes through) as a
    plain tensor, the same on every rank of its mesh, used replicated (the
    backward of a gathered dim takes this rank's part; of a summed dim, the
    cotangent itself)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh, placements = x.device_mesh, list(x.placements)
    local = x.to_local(grad_placements=[Replicate() if p.is_partial() else p
                                        for p in placements])
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Partial):
            local = psum(local, mesh, name)
        elif isinstance(p, Shard):
            local = _GatherWhole.apply(local, mesh, name, p.dim, x.shape[p.dim])
    return local
