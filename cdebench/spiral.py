"""The spiral traffic: clockwise and anticlockwise spirals, made on the device.

The arithmetic is ``spiral_data`` of ``chip_smoke.py:338-349`` (the same
function as ``bench.py:49-59``): times t in [0, 4 pi] as the first channel,
a random phase, a random chirality as the label, and a radius growing from
0.5 to 1.5.  It runs here with a ``torch.Generator`` on the device, in
float64, cast to float32 as the original does, for a whole pool of batches
in a few calls.
"""

import math

import torch


def spiral_pool(pool, batch, length, generator, device):
    """(x (pool, batch, length, 3) float32, labels (pool, batch) float32)."""
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.linspace(0.0, 4 * math.pi, length, **f64)
    phase = torch.rand((pool, batch, 1), generator=generator, **f64) * (2 * math.pi)
    y = (torch.rand((pool, batch), generator=generator, **f64) > 0.5).to(torch.float32)
    direction = torch.where(y > 0.5, 1.0, -1.0).to(torch.float64)[..., None]
    radius = 0.5 + t / (4 * math.pi)
    x1 = radius * torch.cos(direction * t + phase)
    x2 = radius * torch.sin(direction * t + phase)
    x = torch.stack([t.expand(x1.shape), x1, x2], dim=-1).to(torch.float32)
    return x, y
