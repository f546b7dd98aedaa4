"""Device-mesh scaling: data parallelism and tensor parallelism.

Port of ``torchcde_tpu/parallel/mesh.py``.  The JAX package builds a
``Mesh`` with ``data`` and ``model`` axes and lets XLA insert the
collectives.  The port runs one process per rank (``parallel.launch``),
joined by a ``torch.distributed`` process group, and a ``DeviceMesh`` with
dims ``("data", "model")``:

* data parallelism: each rank takes its rows of every global batch
  (``shard_batch``; the ``model`` ranks of one data slice take the same
  rows), and ``models.training.make_train_step(..., mesh=mesh)`` averages
  the gradients over ``data`` before the optimizer steps.  The parameters
  stay plain tensors, so each rank's solve takes its fused kernel on its
  shard.
* tensor parallelism of the vector field's width over ``model``:
  ``place_params`` turns the parameters a rule matches into ``DTensor``s
  over ``mesh["model"]``.  A field that holds them is called through
  ``replicated_call``: the state enters as a replicated ``DTensor``, the
  layers run as ``DTensor`` ops (the contraction over the width becomes an
  all-reduce) and the output leaves as a plain, replicated tensor.  The
  built-in ``MLPVectorField`` does this by itself; wrap a field of your own
  in ``TensorParallelField``.  The fused kernels decline such a field
  (``solvers.fused_fixed.admits_fused``).  ``torch.optim.Adam`` over a model
  that holds both plain tensors and ``DTensor``s needs ``foreach=False``:
  its foreach route refuses the mix.
"""

import fnmatch

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._pytree import tree_map

from . import comm

AXES = ("data", "model")


def make_mesh(data=None, model=1, devices=None, *, backend=None, device="cuda"):
    """Builds a (data, model) ``DeviceMesh`` over the ranks of the process
    group.

    ``devices``: the ranks in mesh order (default: every rank of the group,
    in order).  ``backend``: when no process group exists yet, the one to
    create (its address, rank and world size come from the environment, as
    ``torchrun`` sets them); with a group, None or the group's own.
    ``device``: ``"cuda"`` (the default) or ``"cpu"``, the device type the
    ranks compute on.  Nothing is chosen for the caller."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh builds a mesh of CUDA ranks by default, and "
                           "torch.cuda.is_available() is False: pass device='cpu'.")
    if not dist.is_initialized():
        if backend is None:
            raise RuntimeError("no process group: start the ranks with "
                               "parallel.launch.run_ranks, or pass backend= to create one "
                               "from the environment")
        dist.init_process_group(backend)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()!r}, "
                         f"not {backend!r}")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data}*{model} != {n} devices")
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices must list each of the group's {world} ranks once, "
                         f"found {ranks}")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=AXES)


def batch_sharding(mesh):
    """The placements of a batch: its leading axis split over ``data``,
    replicated over ``model``."""
    return (Shard(0), Replicate())


def replicated(mesh):
    return (Replicate(), Replicate())


def shard_batch(mesh, batch):
    """This rank's rows of a pytree of (batch, ...) tensors: the
    ``data``-th of ``mesh.size("data")`` equal parts.  Every ``model`` rank
    of a data slice gets the same rows."""
    n, me = mesh["data"].size(), mesh.get_local_rank("data")

    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} must divide over the {n} data shards")
        rows = x.shape[0] // n
        return x[me * rows:(me + 1) * rows]

    return tree_map(take, batch)


def param_sharding_rules(mesh, module, rules, default=Replicate()):
    """Rule-based tensor-parallel layout for any module's parameters.

    ``rules`` is a sequence of ``(pattern, placement)`` pairs; each
    parameter's name in ``module.named_parameters()`` ("func.linear1.weight",
    ...) is matched with ``fnmatch`` globs, the first match wins and
    unmatched parameters get ``default``.  Returns {name: placement} over
    ``mesh["model"]``.  A PyTorch weight is (out, in), the transpose of a JAX
    kernel: JAX's ``P(None, "model")`` on a kernel is ``Shard(0)`` here."""

    def placement_for(name):
        for pattern, placement in rules:
            if fnmatch.fnmatch(name, pattern):
                return placement
        return default

    return {name: placement_for(name) for name, _ in module.named_parameters()}


# Tensor-parallel rules for the built-in MLPVectorField: linear1 (hidden ->
# width) shards the width (its output rows), linear2 (width -> hidden *
# input) shards the width (its input columns), so the contraction over the
# width becomes an all-reduce over ``model``.
NEURAL_CDE_TP_RULES = (
    ("*func.linear1.weight", Shard(0)),
    ("*func.linear1.bias", Shard(0)),
    ("*func.linear2.weight", Shard(1)),
)


def neural_cde_param_sharding(mesh, module, rules=NEURAL_CDE_TP_RULES):
    """Tensor-parallel layout for the built-in Neural CDE vector field (or
    any module, by passing custom ``rules``: see param_sharding_rules)."""
    return param_sharding_rules(mesh, module, rules)


def place_params(mesh, module, rules=NEURAL_CDE_TP_RULES):
    """Turns each parameter a rule matches into a ``DTensor`` over
    ``mesh["model"]`` with the rule's placement, in place; returns
    ``module``.  Every rank must hold the same values (one seed): each keeps
    its own part, with no communication.  Unmatched parameters stay plain
    tensors.  On a mesh whose ``model`` dim has one rank nothing changes:
    data parallelism keeps plain parameters."""
    tp = mesh["model"]
    if tp.size() == 1:
        return module
    for name, placement in param_sharding_rules(mesh, module, rules, default=None).items():
        if placement is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        p = getattr(owner, leaf)
        dt = _place(p.detach(), tp, [placement])
        setattr(owner, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def _place(whole, mesh, placements):
    """A ``DTensor`` over ``mesh`` from the whole tensor every rank holds:
    each rank keeps its part (``torch.chunk``'s layout), no communication."""
    local = whole
    for i, placement in enumerate(placements):
        if isinstance(placement, Shard):
            n, me = mesh.size(i), mesh.get_coordinate()[i]
            parts = torch.chunk(local, n, dim=placement.dim)
            local = parts[me] if me < len(parts) else local.narrow(placement.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=whole.shape, stride=whole.contiguous().stride())


def place_like(whole, like):
    """``whole`` (the same on every rank) placed as the ``DTensor`` ``like``."""
    return _place(whole, like.device_mesh, list(like.placements))


def _mesh_of(module):
    for p in list(module.parameters()) + list(module.buffers()):
        if isinstance(p, DTensor):
            return p.device_mesh
    raise ValueError("the module holds no DTensor: place its parameters first (place_params)")


def replicated_call(module, t, z):
    """``module(t, z)`` for a module whose tensors are ``DTensor``s over one
    mesh: z enters as a replicated ``DTensor``, the module's plain tensors
    as replicated ``DTensor``s (gradients reach them), and the output leaves
    as a plain tensor, replicated on every rank of the mesh."""
    from torch.func import functional_call

    mesh = _mesh_of(module)
    lifted = {name: DTensor.from_local(p, mesh, [Replicate()], run_check=False)
              for name, p in list(module.named_parameters()) + list(module.named_buffers())
              if not isinstance(p, DTensor)}
    zd = DTensor.from_local(z, mesh, [Replicate()], run_check=False)
    out = functional_call(module, lifted, (t, zd), strict=False)
    return comm.whole(out)


class TensorParallelField(nn.Module):
    """Wraps a vector field of one's own whose parameters ``place_params``
    sharded, so that ``cdeint`` may call it with plain tensors."""

    def __init__(self, field):
        super().__init__()
        self.field = field

    def forward(self, t, z):
        return replicated_call(self.field, t, z)
