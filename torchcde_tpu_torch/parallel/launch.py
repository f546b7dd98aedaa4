"""Runs a function on several ranks, one process each.

``run_ranks(fn, world_size, backend=..., init_file=..., args=...)`` spawns
``world_size`` processes (``torch.multiprocessing.spawn``), joins them into
one ``torch.distributed`` process group over a ``file://`` store, calls
``fn(rank, world_size, *args)`` in each and returns the ranks' results, in
rank order, with every tensor in them turned into a numpy array.  The store
is a file rather than a TCP port, so that several runs at once (test
workers) never meet.  Each rank runs ``torch.set_num_threads(1)``: on the
CPU the ranks share the host's cores.

The backend is the caller's choice: ``"gloo"`` for CPU tensors or several
ranks on one card, ``"nccl"`` when each rank has its own card.  A rank that
raises makes ``run_ranks`` raise (``torch.multiprocessing.ProcessRaisedException``,
with that rank's traceback), and the other ranks are stopped.

``fn`` must be importable by name (a module-level function), because the
children start from a fresh interpreter and import it.
"""

import datetime
import faulthandler
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._pytree import tree_map


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(value, DTensor):
            raise TypeError("return the local shard or the full tensor, not a DTensor")
        return value.detach().cpu().numpy()
    return value


def _rank_main(rank, fn, world_size, backend, init_file, timeout, out_dir, args):
    # A rank that dies of a signal prints its Python stack first.
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = tree_map(_to_numpy, fn(rank, world_size, *args))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size, *, backend, init_file=None, args=(), timeout=300):
    """Calls ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    joined by ``backend``; returns the list of their results (tensors as
    numpy arrays).  ``init_file`` names the store's file, which must not
    exist yet (default: a new one in a temporary directory); ``timeout``
    bounds each collective, in seconds."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', found {backend!r}")
    with tempfile.TemporaryDirectory(prefix="torchcde_ranks_") as out_dir:
        if init_file is None:
            init_file = os.path.join(out_dir, "store")
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, backend, os.path.abspath(init_file), timeout,
                       out_dir, tuple(args)))
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


__all__ = ["run_ranks"]
