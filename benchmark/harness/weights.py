"""The benchmark's weights: drawn on the device from the seed, in one call,
as float32 (the type the model keeps its parameters in), and handed to both
the system and the reference.

He-normal convolutions; the last convolution of each residual branch is
scaled by `BRANCH_GAIN`, so the pre-activation trunk's variance grows by
about 1 + BRANCH_GAIN^2 a unit instead of doubling; the heads give logits of
about `HEAD_STD` standard deviations, so the soft-argmax is neither uniform
nor one-hot. Batch norms get scales near 1, small biases and means, and
variances near 1, so eval mode normalises with statistics of its own.
"""
from __future__ import annotations

import math

import torch

from harness.traffic import torch_generator

BRANCH_GAIN = 0.3
HEAD_STD = 1.5


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


def make(shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device` for every entry of `shapes`."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=torch_generator(seed, device, stream=7), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight":
            gain = BRANCH_GAIN if name.endswith("conv3.weight") else 1.0
            std = math.sqrt(2.0 / _fan_in(shape)) * gain
            if name.startswith("head"):
                std = HEAD_STD / math.sqrt(_fan_in(shape))
            out[name] = z * std
        elif leaf == "scale":
            out[name] = 1.0 + 0.1 * z
        elif leaf == "var":
            out[name] = torch.exp(0.2 * z)
        else:  # bias, mean
            out[name] = 0.1 * z
    return out
