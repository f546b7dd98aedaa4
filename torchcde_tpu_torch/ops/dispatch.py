"""Kernel eligibility and the bf16 -> float32 upcast at the kernel boundary.

Port of ``torchcde_tpu/ops/pallas_dispatch.py``.  One rule for every kernel
of ``ops/`` (the fill, the tridiagonal solves and the masked cubic fit):

* a CUDA float32 or bfloat16 tensor launches the kernel; bfloat16 operands
  are upcast to float32 at the boundary and the result is cast back, because
  the kernels' divisions and carried recurrences need float32;
* a float64 tensor takes the plain path (the kernels compute float32 only,
  as the JAX kernels do);
* a CPU tensor takes the plain path.

The JAX predicate also carries TPU profitability thresholds (minimum batch
and length, ``k > 256 -> pcr``).  They size TPU vector lanes and VMEM; the
CUDA kernels, which pick their route from the row length, have no such
fixed cost, so the port has none of them (a deliberate divergence,
ROADMAP.md section 3).  The same
function is computed either way.  A failed build or launch raises: nothing
falls back.
"""

import torch

# The dtypes the kernels accept at their boundary; they compute in float32.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def runs_kernel(*tensors):
    """True when these tensors go to a kernel: all on a CUDA device and of a
    kernel dtype.  Boolean masks are not counted against the dtype."""
    floats = [t for t in tensors if t.dtype != torch.bool]
    return (all(t.is_cuda for t in tensors)
            and all(t.dtype in KERNEL_DTYPES for t in floats))


def upcast_kernel_operands(*arrays):
    """bfloat16 operands enter the kernels as float32; others pass through.

    Returns (arrays, restore) where ``restore(out)`` casts a result back to
    the first operand's original dtype."""
    orig = arrays[0].dtype
    if orig == torch.bfloat16:
        arrays = tuple(a.float() if a.dtype == torch.bfloat16 else a for a in arrays)
        return arrays, lambda out: out.to(orig)
    return arrays, lambda out: out


def check_operands(tensors, names, mask=None, dtypes=None):
    """Every kernel operand: float32 (or its entry in ``dtypes``, by name),
    contiguous, on the first one's CUDA device; ``mask``, where a kernel
    takes one, bool on the same device and contiguous.  Raises on anything
    the kernels do not take."""
    device = tensors[0].device
    dtypes = dtypes or {}
    checked = [(t, name, dtypes.get(name, torch.float32)) for t, name in zip(tensors, names)]
    if mask is not None:
        checked.append((mask, "observed", torch.bool))
    for t, name, dtype in checked:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must lie on {device}, found {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, found {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def scratch_buffer(floats, like):
    """A float32 device buffer of ``floats`` on ``like``'s device and its
    pointer, for a kernel's staged weights (None, None when it needs none)."""
    if not floats:
        return None, None
    buf = torch.empty(floats, dtype=torch.float32, device=like.device)
    return buf, buf.data_ptr()
