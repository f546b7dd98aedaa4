"""What the benchmark hands the program, and what it takes from it.

The benchmark makes the inputs and the weights from the seed; the program
(``torchcde_tpu_torch``) computes the coefficients, as users precompute a
dataset, and runs the cell's entry.  The reference gets the same raw
spirals and initial weights and derives the rest itself.
"""

import torch

from cdebench.reference.model import fan_in, leaf_shapes
from cdebench.spiral import spiral_pool


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


# The draw that every seed's weights are a permutation of.
BASE_WEIGHTS_SEED = 20260127


def initial_weights(model, gen, device):
    """{leaf: float32 tensor}: one draw of U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    per leaf on the device, the same for every seed, with its hidden units and
    its state channels permuted by ``gen``.

    A permutation gives the same function in another order of its sums, so
    every seed gives the adaptive solver the same work (its steps depend on
    the field), in the way that a traffic mix gives every seed the same sizes
    in another order; the seed still changes every weight's place."""
    shapes = leaf_shapes(model)
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    base = torch.Generator(device=device)
    base.manual_seed(BASE_WEIGHTS_SEED)
    flat = torch.rand(sum(sizes), generator=base, device=device, dtype=torch.float32) * 2 - 1
    w = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        w[name] = (part * fan_in(name, shape, model) ** -0.5).reshape(shape)
    H, C, W = model["hidden_channels"], model["input_channels"], model["width"]
    ph = torch.randperm(H, generator=gen, device=device)
    pw = torch.randperm(W, generator=gen, device=device)
    w2 = w["func.linear2.weight"].reshape(H, C, W)[ph][:, :, pw]
    return {
        "initial.weight": w["initial.weight"][ph], "initial.bias": w["initial.bias"][ph],
        "func.linear1.weight": w["func.linear1.weight"][pw][:, ph],
        "func.linear1.bias": w["func.linear1.bias"][pw],
        "func.linear2.weight": w2.reshape(H * C, W).contiguous(),
        "func.linear2.bias": w["func.linear2.bias"].reshape(H, C)[ph].reshape(H * C),
        "readout.weight": w["readout.weight"][:, ph].contiguous(),
        "readout.bias": w["readout.bias"],
    }


def data(traffic, gen, device):
    return spiral_pool(traffic["pool"], traffic["batch"], traffic["length"], gen, device)


def build_model(config, weights, device):
    """The port's NeuralCDE at the configuration, holding ``weights``."""
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    model = NeuralCDE(NeuralCDEConfig(**config["model"]), device=device)
    with torch.no_grad():
        params = dict(model.named_parameters())
        if set(params) != set(weights):
            raise RuntimeError(f"the model's leaves {sorted(params)} are not {sorted(weights)}")
        for name, w in weights.items():
            params[name].copy_(w)
    return model


def coefficients(x):
    """The port's Hermite coefficients of every batch of the pool."""
    from torchcde_tpu_torch import hermite_cubic_coefficients_with_backward_differences

    return hermite_cubic_coefficients_with_backward_differences(x)
