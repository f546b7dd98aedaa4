"""Multi-rank Neural CDE training on the PyTorch port: data and tensor parallelism.

The port's counterpart of ``examples/parallel_training.py``: the batch split
over the mesh's ``data`` dim, the vector field's width over ``model`` (two
ranks when the world is even and at least 4), and the prefetching
``CoefficientDataLoader`` feeding every rank the same global batches, of
which each takes its rows.  One process per rank (``run_ranks``): rank r
computes on ``cuda:(r mod the number of cards)``, so several ranks may share
one card; ``backend="nccl"`` needs a card per rank, ``"gloo"`` takes any
layout (``parallel/comm.py`` says what it carries through the host).

    python examples/torch_parallel_training.py                      (on the card)
    python -c "import sys; sys.path.insert(0, 'examples'); \\
        import torch_parallel_training as ex; ex.main(device='cpu')"
"""

import math
import time

import numpy as np
import torch

from torchcde_tpu_torch.data import CoefficientDataLoader
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step
from torchcde_tpu_torch.parallel import make_mesh, place_params, shard_batch
from torchcde_tpu_torch.parallel.launch import run_ranks


def get_data(num_timepoints=50, num_samples=512, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, num_timepoints)
    phase = rng.uniform(0, 2 * math.pi, size=(num_samples, 1))
    y = (rng.random(num_samples) > 0.5).astype(np.float32)
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    x1 = np.cos(direction * t + phase)
    x2 = np.sin(direction * t + phase)
    X = np.stack([np.broadcast_to(t, x1.shape), x1, x2], axis=-1).astype(np.float32)
    return X, y


def _train_rank(rank, world_size, num_epochs, batch_size, model_axis, device):
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    mesh = make_mesh(data=world_size // model_axis, model=model_axis,
                     device=torch.device(device).type)
    if rank == 0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")

    X, y = get_data()
    cfg = NeuralCDEConfig(input_channels=3, hidden_channels=8, output_channels=1, width=128,
                          interpolation="cubic", solver="rk4", adjoint=False, step_size=1.0)
    model = NeuralCDE(cfg, generator=torch.Generator().manual_seed(0), device=device)
    place_params(mesh, model)
    # foreach=False: Adam's foreach route refuses a mix of plain tensors and
    # the DTensors of a tensor-parallel field.
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3, foreach=False)
    step = make_train_step(model, optimizer, mesh=mesh)

    losses = []
    start = time.time()
    for epoch in range(num_epochs):
        loader = CoefficientDataLoader(X, y, batch_size, interpolation="hermite", seed=epoch,
                                       device=device)
        total = 0.0
        for coeffs, labels in loader:
            total += float(step(*shard_batch(mesh, (coeffs, labels))))
        losses.append(total / len(loader))
        if rank == 0:
            print(f"epoch {epoch}: loss {losses[-1]:.4f}")
    if rank == 0:
        print(f"({time.time() - start:.1f}s, {world_size} ranks)")
    return np.array(losses)


def main(num_epochs=2, batch_size=None, world_size=4, backend="gloo", device="cuda"):
    """Trains on ``world_size`` ranks joined by ``backend``; returns rank 0's
    mean loss per epoch."""
    model_axis = 2 if world_size % 2 == 0 and world_size >= 4 else 1
    if batch_size is None:
        batch_size = 16 * (world_size // model_axis)
    results = run_ranks(_train_rank, world_size, backend=backend,
                        args=(num_epochs, batch_size, model_axis, device))
    return results[0]


if __name__ == "__main__":
    main()
