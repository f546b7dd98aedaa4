"""Profiling and checkpointing utilities.

Port of ``torchcde_tpu/utils/observability.py``:

* ``trace(log_dir)``: a ``torch.profiler`` trace of a block, over CPU and
  CUDA activity, written into ``log_dir`` as a Chrome-trace JSON file
  (chrome://tracing or ui.perfetto.dev open it).
* ``annotate(name)``: a named region on that timeline.
* ``device_profile(fn, *args)``: device time per op of ``fn(*args)``.
* ``save_checkpoint`` / ``load_checkpoint``: any tree of dicts, lists and
  tuples over tensors, arrays and Python scalars (a model's and an
  optimizer's ``state_dict``, coefficients) as one ``.npz`` file, its leaves
  in the JAX package's order, so that an npz written by either package loads
  in the other given a tree of the same structure.
"""

import collections
import contextlib
import os
import socket
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir, *, create_perfetto_link=False):
    """Profile a block: ``with trace('/tmp/profile'): train_step(...)``.

    Writes ``<host>.<pid>.<ns>.pt.trace.json`` into ``log_dir`` when the
    block ends.  ``create_perfetto_link`` is kept for the JAX package's
    signature; PyTorch has no such link, so ``True`` raises ``ValueError``.
    """
    if create_perfetto_link:
        raise ValueError(
            "create_perfetto_link=True has no PyTorch counterpart: open the "
            "written Chrome trace in ui.perfetto.dev instead")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name):
    """Named region for profile timelines (host, and the device work it issues)."""
    return record_function(name)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def device_profile(fn, *args, iters=3, warmup=True):
    """Run ``fn(*args)`` under ``torch.profiler`` and return a per-op
    accounting of device time:

        {"device_ms": total device-kernel ms per iteration,
         "bytes_per_iter": unique bytes of fn's tensor arguments and
                           outputs on the card,
         "gbps_cost_model": bytes_per_iter / device time,
         "ops": [(name, us_per_iter, None, None), ...]  # descending}

    The keys are the JAX package's.  Differences: the device time is the sum
    of the CUDA kernel events of the profile; memcpy and memset events are
    listed in ``ops`` but left out of the totals (as the JAX version leaves
    out its async copies).  PyTorch has no cost model, so ``bytes_per_iter``
    is the traffic lower bound the JAX docstring names: each unique tensor
    argument and output on the card counted once (tensors that ``fn``
    closes over, such as a model's parameters, are not seen), and each op's
    MB and GB/s are ``None``.  Needs a CUDA device: raises ``RuntimeError``
    without one.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_profile measures the CUDA card, and torch.cuda.is_available() "
            "is False")
    if warmup:
        fn(*args)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        outs = [fn(*args) for _ in range(iters)]
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")

    per_op = {}
    total_us = 0.0
    for e in events:
        dur = e.time_range.end - e.time_range.start
        if not e.name.startswith(("Memcpy", "Memset")):
            total_us += dur
        per_op[e.name] = per_op.get(e.name, 0.0) + dur
    seen = {}
    for tensor in _tensors((args, outs[-1])):
        if tensor.is_cuda:
            seen[(tensor.data_ptr(), tensor.nbytes)] = tensor.nbytes
    bytes_per_iter = float(sum(seen.values()))
    device_ms = total_us / 1e3 / iters
    ops = sorted(((name, us / iters, None, None) for name, us in per_op.items()),
                 key=lambda r: -r[1])
    return {
        "device_ms": device_ms,
        "bytes_per_iter": bytes_per_iter,
        "gbps_cost_model": (bytes_per_iter / 1e9) / (device_ms / 1e3) if device_ms else 0.0,
        "ops": ops,
    }


def _children(tree):
    """The subtrees of a node in the JAX package's leaf order (a dict's keys
    sorted, an OrderedDict's in insertion order), or None for a leaf."""
    if isinstance(tree, collections.OrderedDict):
        return list(tree.values())
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _leaves(tree):
    if tree is None:  # an empty subtree, as in the JAX package
        return []
    children = _children(tree)
    if children is None:
        return [tree]
    return [leaf for child in children for leaf in _leaves(child)]


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.is_floating_point() and leaf.dtype not in (torch.float16, torch.float32,
                                                           torch.float64):
            leaf = leaf.float()  # bfloat16 has no numpy dtype: store its float32 upcast
        return leaf.numpy()
    return np.asarray(leaf)


def _restore(like, arr):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype, device=like.device)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(arr, dtype=like.dtype)
    return type(like)(arr.item())


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    children = _children(like)
    if children is None:
        return _restore(like, next(leaves))
    if isinstance(like, collections.OrderedDict):
        return type(like)((k, _rebuild(v, leaves)) for k, v in like.items())
    if isinstance(like, dict):
        rebuilt = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return type(like)((k, rebuilt[k]) for k in like)
    rebuilt = [_rebuild(child, leaves) for child in children]
    if isinstance(like, tuple) and hasattr(like, "_fields"):  # a namedtuple
        return type(like)(*rebuilt)
    return type(like)(rebuilt)


def _npz_path(path):
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path, tree):
    """Saves a tree of tensors, arrays and scalars (parameters, optimizer
    state, coefficients) as ``path`` (``.npz`` appended if missing); returns
    ``"npz"``."""
    np.savez(_npz_path(path), *[_to_numpy(leaf) for leaf in _leaves(tree)])
    return "npz"


def load_checkpoint(path, like):
    """Restores a tree saved by ``save_checkpoint``; ``like`` gives the
    structure, and each leaf's type, dtype and device."""
    with np.load(_npz_path(path)) as data:
        n = len(_leaves(like))
        if len(data.files) != n:
            raise ValueError(
                f"the checkpoint holds {len(data.files)} leaves and `like` has {n}")
        arrays = [data[f"arr_{i}"] for i in range(n)]
    return _rebuild(like, iter(arrays))
