"""Handling irregular data with Neural CDEs, on the PyTorch port.

The port's counterpart of ``examples/irregular_data.py``: irregular
sampling, missing values and variable lengths are all handled in the
preprocessing; the model and the solver never see them.  CDEs are
reparameterisation-invariant, so time is just another data channel;
cumulative observation-count channels tell the model when each channel was
observed; padding by repeating the last row makes dX/dt = 0 past a sequence's
end, so the hidden state freezes there.  Then the same batch through a
rectilinear (causal) linear control, and through per-sample adaptive solves
that each end at their own sequence's last observation.

    python examples/torch_irregular_data.py                        (on the card)
"""

import numpy as np
import torch

import torchcde_tpu_torch as tt
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig


def irregular_data(seed=0):
    """A batch of 3 time series with per-channel observation times, missing
    values, and different lengths."""
    rng = np.random.default_rng(seed)
    batch = []
    for _ in range(3):
        length = int(rng.integers(5, 10))
        t = np.sort(rng.random(length)) * 5
        x1 = np.where(rng.random(length) < 0.7, rng.standard_normal(length), np.nan)
        x2 = np.where(rng.random(length) < 0.7, rng.standard_normal(length), np.nan)
        batch.append((t, x1, x2))
    return batch


def process_batch(batch):
    """Merge per-element channels onto a common padded grid with time and
    cumulative-observation channels."""
    processed = []
    max_len = max(len(t) for t, _x1, _x2 in batch)
    for t, x1, x2 in batch:
        obs1 = np.cumsum(~np.isnan(x1)).astype(np.float64)
        obs2 = np.cumsum(~np.isnan(x2)).astype(np.float64)
        row = np.stack([t, x1, x2, obs1, obs2], axis=-1)
        if len(t) < max_len:
            # Pad by repeating the final row, so dX/dt = 0 past the end and
            # the hidden state freezes.
            pad = np.repeat(row[-1:], max_len - len(t), axis=0)
            row = np.concatenate([row, pad], axis=0)
        processed.append(row)
    return np.stack(processed)


def main(device="cuda"):
    batch = irregular_data()
    x = torch.from_numpy(process_batch(batch)).float().to(device)
    print("padded batch shape:", tuple(x.shape))

    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(x)
    cfg = NeuralCDEConfig(
        input_channels=x.shape[-1], hidden_channels=8, output_channels=1,
        interpolation="cubic", solver="dopri5", adjoint=False,
    )
    model = NeuralCDE(cfg, generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        pred = model(coeffs)
    print("predictions:", pred.cpu().numpy().ravel())

    # The rectilinear (causal) variant for online inference: time must be a
    # channel; NaN times are forward-filled first.
    x_rect = tt.linear_interpolation_coeffs(x, rectilinear=0)
    cfg_lin = NeuralCDEConfig(
        input_channels=x.shape[-1], hidden_channels=8, output_channels=1,
        interpolation="linear", solver="rk4", adjoint=False, step_size=1.0,
    )
    model_lin = NeuralCDE(cfg_lin, generator=torch.Generator().manual_seed(1), device=device)
    with torch.no_grad():
        pred_lin = model_lin(x_rect)
    print("rectilinear predictions:", pred_lin.cpu().numpy().ravel())

    # Variable lengths without padding tricks: per-sample solves, each with
    # its own adaptive controller and its own output times, so every sequence
    # integrates exactly to its own final observation.
    X_cubic = tt.CubicSpline(coeffs)
    t_ends = torch.tensor([float(len(t) - 1) for t, _x1, _x2 in batch], device=device)
    t_spans = torch.stack([torch.zeros_like(t_ends), t_ends], dim=-1)
    z0 = 0.1 + torch.zeros(x.shape[0], 8, device=device)
    ones = torch.ones(1, x.shape[-1], device=device)

    def field(t, z):
        return torch.tanh(z)[..., None] * ones

    z_T = tt.cdeint(X=X_cubic, func=field, z0=z0, t=t_spans, method="dopri5",
                    adjoint=False, options=dict(per_sample=True))
    print("per-sample terminal states:", z_T[:, -1, 0].cpu().numpy().ravel())
    return pred


if __name__ == "__main__":
    main()
