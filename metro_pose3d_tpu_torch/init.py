"""Seeded random init of `MetroModel`, with the flax model's initializers:
lecun-normal (truncated) conv and head kernels, zero biases, BN scale 1,
bias 0, mean 0, var 1. The numbers differ from flax's for the same seed;
the parameter tree and its distributions are the same."""
from __future__ import annotations

import math

import torch

from metro_pose3d_tpu_torch.config import ModelConfig
from metro_pose3d_tpu_torch.device import resolve_device
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.models.resnet import Conv

# std of a unit normal truncated to [-2, 2]: flax divides by it so the
# truncated draws keep variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def init_metro_model(cfg: ModelConfig, seed: int, device=None, train: bool = False) -> MetroModel:
    """A `MetroModel` with float32 weights drawn on the CPU from `seed`, moved
    to `device` (default: the card; a RuntimeError where CUDA is absent);
    built at the train phase and in train mode with `train=True`,
    else at the test phase in eval mode."""
    device = resolve_device(device)
    model = MetroModel(cfg, train=train)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                w = module.weight
                std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD  # fan_in = I*kh*kw
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
    # BatchNorm modules are built as scale 1, bias 0, mean 0, var 1
    return model.to(device).train(train)
