"""The port's examples run end to end on the CPU at reduced sizes.

The port of ``tests/test_example.py:12-35``, at the same sizes and with the
same checks, each example's ``main`` (or ``train_one``) given
``device="cpu"``.  The irregular example's outputs are held to finiteness,
as the JAX test holds them, not to JAX's values: on its control float64
adaptive solves part through mesh drift (ROADMAP.md section 3).  The
parallel example, which the JAX tests do not run, runs on four gloo ranks.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

torch.set_num_threads(1)


def test_time_series_classification():
    import torch_time_series_classification as ex

    acc = ex.main(num_epochs=2, batch_size=64, device="cpu")
    assert np.isfinite(acc)
    assert acc >= 0.5  # learns at least something in 2 epochs


def test_irregular_data():
    import torch_irregular_data as ex

    pred = ex.main(device="cpu")
    assert torch.isfinite(pred).all()


def test_logsignature_example():
    import torch_logsignature_example as ex

    train_X, train_y = ex.get_data(400, num_samples=32, seed=0, device="cpu")
    test_X, test_y = ex.get_data(400, num_samples=32, seed=1, device="cpu")
    acc, elapsed = ex.train_one(2, 20.0, train_X, train_y, test_X, test_y, num_epochs=2)
    assert np.isfinite(acc)


def test_parallel_training():
    """Four gloo ranks on the CPU, a (2, 2) mesh: data parallel over the
    batch, the field's width tensor-parallel over two ranks."""
    import torch_parallel_training as ex

    losses = ex.main(num_epochs=1, world_size=4, backend="gloo", device="cpu")
    assert losses.shape == (1,)
    assert np.isfinite(losses).all()
