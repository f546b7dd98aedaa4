"""Training step for Neural CDE models (port of ``torchcde_tpu/models/training.py``).

The per-batch computation: forward solve -> BCE-with-logits loss ->
gradient -> optimizer update.  ``torch.optim.Adam(params, lr, eps=1e-8)`` is
the update of ``optax.adam(lr)``: bias-corrected, eps outside the square root.
"""

import torch

from .neural_cde import bce_with_logits


def loss_fn(model, coeffs, labels):
    logits = model(coeffs)[..., 0]
    # Loss math in at least float32.
    ldt = torch.promote_types(logits.dtype, torch.float32)
    return bce_with_logits(logits.to(ldt), labels.to(ldt))


def make_train_step(model, optimizer):
    """Returns train_step(coeffs, labels) -> loss (a detached scalar tensor);
    each call updates the model's parameters in place."""

    def train_step(coeffs, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, coeffs, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


@torch.no_grad()
def accuracy(model, coeffs, labels):
    logits = model(coeffs)[..., 0]
    pred = (torch.sigmoid(logits) > 0.5).to(labels.dtype)
    return torch.mean((pred == labels).to(torch.float32))
