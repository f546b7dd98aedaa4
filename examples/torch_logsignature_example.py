"""Neural RDE via the log-ODE method on long time series, on the PyTorch port.

The port's counterpart of ``examples/logsignature_example.py``: length-5000
spirals compressed into logsignature windows (depths 1/2/3 give 3/6/14
channels), a Neural CDE trained on the linear interpolation of the
transformed path with rk4 at step 1 and direct backpropagation, and the
accuracy and wall time per depth.  Over a linear control the fixed-step
solve runs as plain PyTorch ops (the fused fixed-step kernel takes cubic
controls only).

    python examples/torch_logsignature_example.py                  (on the card)
"""

import math
import time

import numpy as np
import torch

import torchcde_tpu_torch as tt
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, accuracy, make_train_step


def get_data(num_timepoints=5000, num_samples=64, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, num_timepoints)
    phase = rng.uniform(0, 2 * math.pi, size=(num_samples, 1))
    y = (rng.random(num_samples) > 0.5).astype(np.float32)
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    radius = 0.5 + t / (4 * math.pi)
    x1 = radius * np.cos(direction * t + phase)
    x2 = radius * np.sin(direction * t + phase)
    X = np.stack([np.broadcast_to(t, x1.shape), x1, x2], axis=-1).astype(np.float32)
    X += 0.01 * rng.standard_normal(X.shape).astype(np.float32)
    return torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)


def train_one(depth, window_length, train_X, train_y, test_X, test_y,
              num_epochs=3, lr=0.01, batch_size=32, seed=0):
    start = time.time()
    # The transform is the whole point: length L -> L / window steps of
    # logsignature_channels(c, depth) channels.
    train_logsig = tt.logsig_windows(train_X, depth, window_length)
    test_logsig = tt.logsig_windows(test_X, depth, window_length)
    print(f"depth {depth}: transformed shape {tuple(train_logsig.shape)}")

    cfg = NeuralCDEConfig(
        input_channels=train_logsig.shape[-1], hidden_channels=8, output_channels=1,
        interpolation="linear", solver="rk4", adjoint=False, step_size=1.0,
    )
    train_coeffs = tt.linear_interpolation_coeffs(train_logsig)
    test_coeffs = tt.linear_interpolation_coeffs(test_logsig)

    device = train_X.device
    model = NeuralCDE(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8))

    n = train_coeffs.shape[0]
    rng = np.random.default_rng(seed)
    for _epoch in range(num_epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        for i in range(max(1, n // batch_size)):
            idx = perm[i * batch_size : (i + 1) * batch_size]
            step(train_coeffs[idx], train_y[idx])
    acc = float(accuracy(model, test_coeffs, test_y))
    elapsed = time.time() - start
    return acc, elapsed


def main(num_timepoints=5000, window_length=50.0, num_epochs=3, device="cuda"):
    train_X, train_y = get_data(num_timepoints, seed=0, device=device)
    test_X, test_y = get_data(num_timepoints, seed=1, device=device)
    results = {}
    for depth in (1, 2, 3):
        acc, elapsed = train_one(
            depth, window_length, train_X, train_y, test_X, test_y, num_epochs
        )
        results[depth] = (acc, elapsed)
        print(f"depth {depth}: accuracy {acc:.3f}, {elapsed:.1f}s")
    return results


if __name__ == "__main__":
    main()
