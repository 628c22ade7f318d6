"""Horizontal-flip test-time augmentation (`metro_pose3d_tpu/ops/tta.py`).

The crop and its mirror run as one batch; the mirrored prediction is
un-mirrored (x negated or reflected, left/right joints swapped by the
joint mirror mapping) and averaged with the plain one.
"""
from __future__ import annotations

import torch


def flip_crop(crops: torch.Tensor) -> torch.Tensor:
    """Mirror [B, H, W, C] crops horizontally (x -> W-1-x)."""
    return crops.flip(2)


def unflip_pose3d(pose_mm: torch.Tensor, mirror_mapping: torch.Tensor) -> torch.Tensor:
    """Un-mirror a centred metric 3D pose: x -> -x, then the joint permutation.
    (No constant is copied to the device, so a CUDA graph can capture it.)"""
    flipped = torch.cat([-pose_mm[..., :1], pose_mm[..., 1:]], dim=-1)
    return flipped[..., mirror_mapping, :]


def unflip_pose2d(pose_px: torch.Tensor, mirror_mapping: torch.Tensor,
                  proc_side: int) -> torch.Tensor:
    """Un-mirror crop-pixel 2D predictions: x -> (S-1) - x, then the permutation."""
    x = (proc_side - 1) - pose_px[..., 0]
    flipped = torch.stack([x, pose_px[..., 1]], dim=-1)
    return flipped[..., mirror_mapping, :]


def unflip_pose25d(pose25d: torch.Tensor, mirror_mapping: torch.Tensor,
                   proc_side: int) -> torch.Tensor:
    """Un-mirror a 2.5D prediction (x, y crop pixels; z metric mm): x is
    image-aligned, so x -> (S-1) - x as for the 2D head; y and z stay; then
    the permutation."""
    x = (proc_side - 1) - pose25d[..., 0]
    flipped = torch.stack([x, pose25d[..., 1], pose25d[..., 2]], dim=-1)
    return flipped[..., mirror_mapping, :]
