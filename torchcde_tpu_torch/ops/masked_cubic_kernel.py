"""K6/K7: the whole NaN-masked natural cubic fit as one CUDA kernel
(``csrc/masked_cubic.cu``).

Replaces the TPU's streaming fit (``torchcde_tpu/ops/masked_cubic_pallas.py``,
entries ``masked_natural_cubic_full`` and ``masked_natural_cubic_pallas``)
and its VMEM-resident single launch (``ops/masked_cubic_resident.py``, entry
``masked_natural_cubic_resident``); one kernel serves all three.  Its plain
version is ``interpolation.cubic._masked_fit_plain``: endpoint imputation,
then the masked pipeline.

* ``masked_natural_cubic(t, x, version)``: raw values x (..., k) with NaNs,
  times t (k,) -> (a, b, two_c, three_d), each (..., k - 1),
  differentiable; the kernel for CUDA float32/bfloat16 values (its
  gradient recomputes the plain pipeline: ``cubic._MaskedFitFused``), the
  plain version otherwise.  Rows without an observation are the caller's
  to mask;
* ``LAUNCHES``: the count of kernel launches.
"""

import ctypes

import torch

from .. import _build
from ..interpolation.cubic import _MaskedFitFused, _masked_fit_plain  # the plain version
from . import dispatch

LAUNCHES = 0


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_mc_declared", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mc_fit.argtypes = [p] * 13 + [ll, i, i, p]
        lib.mc_fit.restype = i
        lib.mc_scratch_positions.argtypes = [i]
        lib.mc_scratch_positions.restype = i
        lib.mc_error_string.argtypes = [i]
        lib.mc_error_string.restype = ctypes.c_char_p
        lib._mc_declared = True
    return lib


def launch(t, x, version):
    """One launch: x (n, k) and t (k,) float32, contiguous on one CUDA
    device.  Returns (a, b, two_c, three_d), each (n, k - 1)."""
    global LAUNCHES
    dispatch.check_operands((x, t), ("x", "t"))
    if x.ndim != 2 or t.shape != (x.shape[1],) or x.shape[1] < 2:
        raise ValueError("x must be (n, k) with k >= 2 and t (k,)")
    if version not in (0, 1):
        raise ValueError(f"version must be 0 or 1, got {version!r}")
    n, k = x.shape
    lib = _library()
    outs = [torch.empty((n, k - 1), dtype=x.dtype, device=x.device) for _ in range(4)]
    # Per-row intermediates, laid out in tiles by the kernel.
    size = n * lib.mc_scratch_positions(k)
    scratch = [torch.empty(size, dtype=x.dtype, device=x.device) for _ in range(6)]
    obs = torch.empty(size, dtype=torch.uint8, device=x.device)
    xs, hr, pds, sph, nd, nb = scratch
    ptrs = [a.data_ptr() for a in (x, t, *outs, xs, obs, hr, pds, sph, nd, nb)]
    with torch.cuda.device(x.device):
        rc = lib.mc_fit(*ptrs, n, k, int(version), dispatch.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"masked cubic fit kernel failed: {lib.mc_error_string(rc).decode()} "
                           f"(code {rc})")
    LAUNCHES += 1
    return tuple(outs)


def masked_natural_cubic(t, x, version):
    """The masked fit of raw values x (..., k) at times t (k,)."""
    if not dispatch.runs_kernel(x):
        return _masked_fit_plain(t.to(x.dtype), x, version)
    return _MaskedFitFused.apply(version, t, x)


def fit_on_card(t, x, version):
    """The kernel's forward for CUDA float32/bfloat16 values x (..., k)."""
    (x,), restore = dispatch.upcast_kernel_operands(x)
    shape = x.shape
    k = shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    out_shape = shape[:-1] + (k - 1,)
    if x2.shape[0] == 0:
        return tuple(restore(x.new_zeros(out_shape)) for _ in range(4))
    outs = launch(t.to(device=x.device, dtype=x.dtype).contiguous(), x2, version)
    return tuple(restore(o.reshape(out_shape)) for o in outs)
