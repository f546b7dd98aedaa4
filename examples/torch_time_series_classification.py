"""Spiral-chirality classification with a Neural CDE, on the PyTorch port.

The port's counterpart of ``examples/time_series_classification.py``:
clockwise vs counter-clockwise spirals, time as channel 0, Hermite cubic
coefficients computed once as the dataset, Adam and BCE-with-logits, and the
test accuracy reported.  The solve is adaptive dopri5 with the adjoint; on a
CUDA card it runs as the fused kernel pair K2.

    python examples/torch_time_series_classification.py            (on the card)
    python -c "import sys; sys.path.insert(0, 'examples'); \\
        import torch_time_series_classification as ex; ex.main(device='cpu')"
"""

import math
import time

import numpy as np
import torch

import torchcde_tpu_torch as tt
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, accuracy, make_train_step


def get_data(num_timepoints=100, num_samples=128, seed=0, device="cuda"):
    """Clockwise/counter-clockwise spirals; time is data channel 0."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, num_timepoints)
    phase = rng.uniform(0, 2 * math.pi, size=(num_samples, 1))
    y = (rng.random(num_samples) > 0.5).astype(np.float32)  # chirality label
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    radius = 0.5 + t / (4 * math.pi)
    x1 = radius * np.cos(direction * t + phase)
    x2 = radius * np.sin(direction * t + phase)
    X = np.stack([np.broadcast_to(t, x1.shape), x1, x2], axis=-1).astype(np.float32)
    X = X + 0.01 * rng.standard_normal(X.shape).astype(np.float32)
    return torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)


def main(num_epochs=10, batch_size=32, hidden_channels=8, lr=1e-3, seed=0, device="cuda"):
    train_X, train_y = get_data(num_samples=128, seed=seed, device=device)
    test_X, test_y = get_data(num_samples=128, seed=seed + 1, device=device)

    cfg = NeuralCDEConfig(
        input_channels=3, hidden_channels=hidden_channels, output_channels=1,
        interpolation="cubic", solver="dopri5", adjoint=True,
    )
    # The coefficients are the dataset: computed once, then batched.
    train_coeffs = tt.hermite_cubic_coefficients_with_backward_differences(train_X)
    test_coeffs = tt.hermite_cubic_coefficients_with_backward_differences(test_X)

    model = NeuralCDE(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    train_step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8))

    n = train_coeffs.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    rng = np.random.default_rng(seed)
    start = time.time()
    for epoch in range(num_epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        epoch_loss = 0.0
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size : (i + 1) * batch_size]
            epoch_loss += float(train_step(train_coeffs[idx], train_y[idx]))
        print(f"Epoch: {epoch}   Training loss: {epoch_loss / steps_per_epoch:.4f}")
    elapsed = time.time() - start

    acc = float(accuracy(model, test_coeffs, test_y))
    print(f"Test Accuracy: {acc:.4f}   ({elapsed:.1f}s train)")
    return acc


if __name__ == "__main__":
    main()
