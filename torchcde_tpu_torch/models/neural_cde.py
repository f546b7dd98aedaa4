"""Neural CDE model (port of ``torchcde_tpu/models/neural_cde.py``).

    vector field: Linear -> ReLU -> Linear -> tanh, reshaped to
                  (..., hidden_channels, input_channels)
    NeuralCDE:    z0 = initial(X(t0));  z_T = cdeint(X, f, z0, interval);
                  pred = readout(z_T)

Mixed precision (``compute_dtype``, as in the JAX package): the parameters
stay float32 masters, which the optimizer updates; each forward casts them
and the coefficients to ``compute_dtype`` with autograd casts, so their
gradients come back float32 through the casts.
"""

import dataclasses
import math

import torch
from torch import nn

from ..interpolation import CubicSpline, LinearInterpolation
from ..solvers import cdeint
from ..solvers.terms import MLPVectorField


@dataclasses.dataclass(frozen=True)
class NeuralCDEConfig:
    input_channels: int
    hidden_channels: int
    output_channels: int
    width: int = 128
    interpolation: str = "cubic"
    solver: str = "dopri5"
    adjoint: bool = True
    rtol: float = 1e-4
    atol: float = 1e-6
    step_size: float = None
    compute_dtype: str = None  # e.g. "bfloat16"; None computes in the parameters' dtype


def make_control(coeffs, cfg: NeuralCDEConfig, t=None):
    if cfg.interpolation == "cubic":
        return CubicSpline(coeffs, t)
    if cfg.interpolation == "linear":
        return LinearInterpolation(coeffs, t)
    raise ValueError(f"Unknown interpolation {cfg.interpolation!r}")


def _compute_dtype(name):
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must name a floating torch dtype, found {name!r}")
    return dtype


class _Dense(nn.Module):
    """x @ weight.T + bias as two rounded steps, as the JAX package's dense
    layers compute (``nn.Linear`` adds the bias before it rounds, which in
    bfloat16 is another result).  weight (out, in) and bias are buffers."""

    def __init__(self, weight, bias):
        super().__init__()
        self.out_features, self.in_features = weight.shape
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    def forward(self, x):
        return x @ self.weight.t() + self.bias


def _linear_as(linear, dtype):
    """A view of ``linear`` that computes in ``dtype``: its weight and bias
    are the parameters' autograd casts.  Code that reads ``.weight`` (the
    fused kernels' packing) and the adjoint's search of a module's tensors
    both meet the cast tensors, and gradients reach the masters through the
    casts."""
    return _Dense(linear.weight.to(dtype), linear.bias.to(dtype))


def _field_as(field, dtype):
    """The same view of an ``MLPVectorField`` (see ``_linear_as``)."""
    view = MLPVectorField(field.hidden_channels, field.input_channels,
                          field.linear1.out_features, device="meta")
    view.linear1 = _linear_as(field.linear1, dtype)
    view.linear2 = _linear_as(field.linear2, dtype)
    return view


def _uniform_(linear, generator):
    """U(-1/sqrt(n_in), 1/sqrt(n_in)) for weight and bias, as the JAX init."""
    bound = 1.0 / math.sqrt(linear.in_features)
    with torch.no_grad():
        linear.weight.uniform_(-bound, bound, generator=generator)
        linear.bias.uniform_(-bound, bound, generator=generator)


class NeuralCDE(nn.Module):
    """Neural CDE: coeffs -> predictions (..., output).  The coefficients
    are (..., L', 4 * channels) for ``interpolation="cubic"`` and the knots
    (..., L, channels) for ``"linear"``.

    Built on the CUDA card unless ``device`` says otherwise (``device="cpu"``
    builds on the CPU); without a card the default raises.  The weights are
    drawn on the CPU from ``generator`` (a CPU generator, or the global CPU
    generator when None) and then moved, so one seed gives the same weights
    on every device.  With ``cfg.compute_dtype`` set, the parameters are the
    masters and the forward computes in that dtype (see the module
    docstring), which its output has too."""

    def __init__(self, cfg: NeuralCDEConfig, generator=None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if cfg.compute_dtype is not None:
            _compute_dtype(cfg.compute_dtype)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "NeuralCDE is built on the CUDA card by default, and "
                "torch.cuda.is_available() is False: pass device='cpu' to build "
                "it on the CPU."
            )
        self.cfg = cfg
        kw = dict(device="cpu", dtype=dtype)
        self.initial = nn.Linear(cfg.input_channels, cfg.hidden_channels, **kw)
        self.func = MLPVectorField(cfg.hidden_channels, cfg.input_channels,
                                   cfg.width, **kw)
        self.readout = nn.Linear(cfg.hidden_channels, cfg.output_channels, **kw)
        for linear in (self.initial, self.func.linear1, self.func.linear2,
                       self.readout):
            _uniform_(linear, generator)
        self.to(device)

    def forward(self, coeffs, t=None):
        cfg = self.cfg
        initial, func, readout = self.initial, self.func, self.readout
        if cfg.compute_dtype is not None:
            dtype = _compute_dtype(cfg.compute_dtype)
            initial, readout = _linear_as(initial, dtype), _linear_as(readout, dtype)
            func = _field_as(func, dtype)
            coeffs = coeffs.to(dtype)
        X = make_control(coeffs, cfg, t)
        interval = X.interval
        z0 = initial(X.evaluate(interval[0]))
        kwargs = {}
        if cfg.step_size is not None:
            kwargs["options"] = {"step_size": cfg.step_size}
        z_t = cdeint(X=X, func=func, z0=z0, t=interval,
                     adjoint=cfg.adjoint, method=cfg.solver, rtol=cfg.rtol,
                     atol=cfg.atol, **kwargs)
        return readout(z_t[..., -1, :])


def bce_with_logits(logits, labels):
    """Binary cross entropy on logits (mean over the batch)."""
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
