"""Training step for Neural CDE models (port of ``torchcde_tpu/models/training.py``).

The per-batch computation: forward solve -> BCE-with-logits loss ->
gradient -> optimizer update.  ``torch.optim.Adam(params, lr, eps=1e-8)`` is
the update of ``optax.adam(lr)``: bias-corrected, eps outside the square root.

With a mesh (``parallel.make_mesh``) each rank feeds its own rows of the
global batch (``parallel.shard_batch``); the step then averages every
gradient over the mesh's ``data`` dim before the optimizer steps, which with
equal shards is the gradient of the global mean loss that the JAX package's
jitted step takes on a sharded batch.
"""

import torch
import torch.distributed as dist

from .neural_cde import bce_with_logits


def loss_fn(model, coeffs, labels):
    logits = model(coeffs)[..., 0]
    # Loss math in at least float32.
    ldt = torch.promote_types(logits.dtype, torch.float32)
    return bce_with_logits(logits.to(ldt), labels.to(ldt))


def make_loss_fn(model):
    """``loss_fn(coeffs, labels)``: the model's mean BCE-with-logits loss on
    a batch (``loss_fn`` above).  The port of the JAX package's
    ``make_loss_fn(cfg)``, whose loss takes the parameters first: here the
    model holds them."""

    def bound(coeffs, labels):
        return loss_fn(model, coeffs, labels)

    return bound


def _average_over_data(model, loss, mesh):
    """All-reduces each gradient and the loss over the ``data`` dim and
    divides by its size.  A ``DTensor`` gradient (tensor parallelism) is
    reduced in its local shard, which every data slice holds alike."""
    from torch.distributed.tensor import DTensor

    n = mesh["data"].size()
    if n == 1:
        return loss
    group = mesh.get_group("data")
    for p in model.parameters():
        if p.grad is None:
            continue
        local = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
        dist.all_reduce(local, group=group)
        local.div_(n)
    loss = loss.clone()
    dist.all_reduce(loss, group=group)
    return loss / n


def make_train_step(model, optimizer, mesh=None):
    """Returns train_step(coeffs, labels) -> loss (a detached scalar tensor:
    the global batch's mean loss); each call updates the model's parameters
    in place.  ``mesh``: average the gradients over its ``data`` dim (each
    rank passes its own rows)."""

    def train_step(coeffs, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, coeffs, labels)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            loss = _average_over_data(model, loss, mesh)
        optimizer.step()
        return loss

    return train_step


@torch.no_grad()
def accuracy(model, coeffs, labels):
    logits = model(coeffs)[..., 0]
    pred = (torch.sigmoid(logits) > 0.5).to(labels.dtype)
    return torch.mean((pred == labels).to(torch.float32))
