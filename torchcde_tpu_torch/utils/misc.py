"""Input validation and small utilities.

Port of ``torchcde_tpu/utils/misc.py``.  The error texts are kept word for
word (the JAX package keeps them in parity with the torchcde reference on
purpose).  Default time grids are host NumPy constants: the fixed-step planner
(``solvers/fused_fixed.py``) reads the grid on the host every step, so it must
not live on the GPU.
"""

import numpy as np
import torch

_NUMPY_DTYPES = {
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


def numpy_dtype(dtype):
    """The NumPy dtype a host grid for ``dtype`` data is built in."""
    return np.dtype(_NUMPY_DTYPES.get(dtype, np.float32))


def host_array(t):
    """A tensor's values as a host NumPy array.  NumPy has no bfloat16, so a
    bfloat16 tensor is upcast to float32 first (exactly: every bfloat16 is a
    float32); the caller casts to the precision it plans in."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cheap_stack(tensors, axis):
    if len(tensors) == 1:
        return tensors[0].unsqueeze(axis)
    return torch.stack(tensors, dim=axis)


def stack_endpoints(t):
    """[t[0], t[-1]], staying on the host for NumPy grids."""
    if isinstance(t, np.ndarray):
        return np.stack([t[0], t[-1]])
    return torch.stack([t[0], t[-1]])


def validate_input_path(x, t):
    """Validates (x, t) and returns the (possibly defaulted) t.

    x is floating with layout (..., length, channels); t defaults to the host
    grid [0, 1, ..., length - 1]; t must be 1-D floating, strictly increasing,
    length-matching, and length >= 2.
    """
    if not torch.is_floating_point(x):
        raise ValueError("X must both be floating point.")
    if x.ndim < 2:
        raise ValueError(
            "X must have at least two dimensions, corresponding to time and "
            "channels. It instead has shape {}.".format(tuple(x.shape))
        )

    if t is None:
        t = np.linspace(0, x.shape[-2] - 1, x.shape[-2], dtype=numpy_dtype(x.dtype))

    if isinstance(t, np.ndarray):
        floating = np.issubdtype(t.dtype, np.floating)
    else:
        t = torch.as_tensor(t)
        floating = torch.is_floating_point(t)
    if not floating:
        raise ValueError("t must both be floating point.")
    if t.ndim != 1:
        raise ValueError("t must be one dimensional. It instead has shape {}.".format(tuple(t.shape)))

    if x.shape[-2] != t.shape[0]:
        raise ValueError(
            "The time dimension of X must equal the length of t. X has shape {} and t has "
            "shape {}, corresponding to time dimensions of {} and {} respectively.".format(
                tuple(x.shape), tuple(t.shape), x.shape[-2], t.shape[0]
            )
        )

    if t.shape[0] < 2:
        raise ValueError(
            "Must have a time dimension of size at least 2. It instead has shape {}, "
            "corresponding to a time dimension of size {}.".format(tuple(t.shape), t.shape[0])
        )

    if isinstance(t, np.ndarray):
        increasing = bool(np.all(np.diff(t) > 0))
    else:
        increasing = bool(torch.all(torch.diff(t) > 0))
    if not increasing:
        raise ValueError("t must be monotonically increasing.")

    return t
