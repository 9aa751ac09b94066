"""The policy's weights, made from the seed on the device.

One draw of normals for the whole parameter vector from a generator on
the device, in float32 (the type the configurations train and serve in):
each weight matrix scaled to a variance of 1 / fan-in (lecun normal), the
action head's by 0.01 more (the scale of the program's own start, an
orthogonal matrix of gain 0.01: a fresh policy that acts near the middle
of the thrust range), the biases and log_std zero. The program gets them
through load_state_dict, the reference as they are.
"""

from __future__ import annotations

import math

import torch

GAIN = {"actor_mean.weight": 0.01}


def make(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on device} for {name: shape}."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if len(shape) == 2:
            out[name] = (flat[off:off + n].view(shape)
                         * (GAIN.get(name, 1.0) / math.sqrt(shape[1])))
        else:
            out[name] = torch.zeros(shape, device=device)
        off += n
    return out
