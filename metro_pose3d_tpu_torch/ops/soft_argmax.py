"""Soft-argmax decode of 2D and 3D (volumetric) heatmaps, in float32.

Softmax over the whole flattened volume of each joint, then the
probability-weighted mean of a normalized coordinate grid with cell centres
at (i + 0.5) / N (`metro_pose3d_tpu/ops/soft_argmax.py`). Returned
coordinates are always ordered (x, y[, z]): x indexes W, y indexes H, z
indexes D.

The expectation is taken without a matmul: the softmax's marginals along
each axis (float32 sums over the volume) times the axis grid, summed. A
float32 matmul on the card rounds its inputs to TF32 whenever the process
turns TF32 on (`torch.backends.cuda.matmul.allow_tf32`,
`torch.set_float32_matmul_precision("high")`), about 5e-4 relative, which
after the 2200 mm box scale costs millimetres; the reference pins
`precision=HIGHEST` for the same reason. Sums and elementwise products
keep float32 whatever those flags say.
"""
from __future__ import annotations

import torch


def _grid_1d(n: int, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


def _expect(marginal: torch.Tensor) -> torch.Tensor:
    """[B, N, J] marginal probabilities along an axis of N cells -> [B, J]."""
    return (marginal * _grid_1d(marginal.shape[1], marginal.device)[:, None]).sum(1)


def soft_argmax_2d(logits: torch.Tensor) -> torch.Tensor:
    """[B, H, W, J] logits -> [B, J, 2] expected (x, y) in (0, 1)."""
    b, h, w, j = logits.shape
    probs = torch.softmax(logits.float().reshape(b, h * w, j), dim=1).reshape(b, h, w, j)
    return torch.stack([_expect(probs.sum(1)), _expect(probs.sum(2))], dim=-1)


def soft_argmax_3d(logits: torch.Tensor) -> torch.Tensor:
    """[B, H, W, D, J] logits -> [B, J, 3] expected (x, y, z) in (0, 1)."""
    b, h, w, d, j = logits.shape
    probs = torch.softmax(logits.float().reshape(b, h * w * d, j), dim=1)
    probs = probs.reshape(b, h, w, d, j)
    pxy = probs.sum(3)  # [B, H, W, J]
    return torch.stack([_expect(pxy.sum(1)), _expect(pxy.sum(2)), _expect(probs.sum((1, 2)))],
                       dim=-1)
