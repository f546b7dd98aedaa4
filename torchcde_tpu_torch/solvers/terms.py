"""The CDE right-hand side: dz/dt = f(t, z) · dX/dt.

Port of ``torchcde_tpu/solvers/terms.py``.
"""

import functools
import itertools

import torch
from torch import nn


@functools.cache
def _dtensor_type():
    """The DTensor class, imported on first use (``NoneType`` where PyTorch
    has no ``torch.distributed``)."""
    if not torch.distributed.is_available():
        return type(None)
    from torch.distributed.tensor import DTensor

    return DTensor


def holds_dtensor(module):
    """True when a parameter or buffer of ``module`` is a ``DTensor``: the
    module is tensor-parallel (``parallel.place_params``)."""
    dtensor = _dtensor_type()
    return any(isinstance(p, dtensor)
               for p in itertools.chain(module.parameters(), module.buffers()))


class MLPVectorField(nn.Module):
    """The canonical Neural CDE vector field: Linear -> ReLU -> Linear -> tanh,
    reshaped to (..., hidden, input).

    Any callable with the same math works in ``cdeint``; this class also lets
    the fixed-step path run the whole solve in one kernel
    (``solvers/fused_fixed_kernel.py``), which needs the MLP's weights.
    ``linear1.weight`` (width, hidden) is the kernel's ``w1t``; the columns of
    the output are in the order h * input_channels + i.
    """

    def __init__(self, hidden_channels, input_channels, width, device=None, dtype=None):
        super().__init__()
        self.hidden_channels = int(hidden_channels)
        self.input_channels = int(input_channels)
        kw = dict(device=device, dtype=dtype)
        self.linear1 = nn.Linear(self.hidden_channels, width, **kw)
        self.linear2 = nn.Linear(width, self.hidden_channels * self.input_channels, **kw)

    def forward(self, t, z):
        if not isinstance(z, _dtensor_type()) and holds_dtensor(self):
            # Tensor-parallel weights: enter and leave through the replicated
            # wrapper, which calls this method again with a DTensor z.
            from ..parallel.mesh import replicated_call

            return replicated_call(self, t, z)
        h = torch.relu(self.linear1(z))
        h = torch.tanh(self.linear2(h))
        return h.reshape(h.shape[:-1] + (self.hidden_channels, self.input_channels))


def _matvec(vector_field, control_gradient):
    # (..., hidden, input) @ (..., input) -> (..., hidden), batch dims broadcasting.
    return torch.sum(vector_field * control_gradient[..., None, :], dim=-1)


def make_cde_rhs(func, X):
    """Builds rhs(t, z) = f(t, z) · dX/dt for the ODE reduction of the CDE."""
    is_prod = hasattr(func, "prod")

    def rhs(t, z):
        control_gradient = X.derivative(t)
        if is_prod:
            return func.prod(t, z, control_gradient)
        return _matvec(func(t, z), control_gradient)

    return rhs
