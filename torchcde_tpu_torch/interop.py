"""Carrying weights from the JAX package's Neural CDE to ``NeuralCDE``.

The JAX parameters are a dict ``{"initial", "func1", "func2", "readout"}`` of
``{"w": (in, out), "b": (out,)}``; ``nn.Linear.weight`` is (out, in), so each
``w`` is transposed.  The vector field's output columns keep the JAX order
h * input_channels + i.
"""

import numpy as np
import torch

_MODULES = {
    "initial": "initial",
    "func1": "func.linear1",
    "func2": "func.linear2",
    "readout": "readout",
}


def from_jax_params(params_np):
    """JAX params (numpy arrays) -> a ``NeuralCDE`` state dict."""
    state = {}
    for jax_name, module in _MODULES.items():
        layer = params_np[jax_name]
        state[f"{module}.weight"] = torch.from_numpy(np.array(layer["w"]).T.copy())
        state[f"{module}.bias"] = torch.from_numpy(np.array(layer["b"]))
    return state
