"""The on-device half of the input pipeline
(`metro_pose3d_tpu/pipeline/device.py::device_augment`): uint8 source tiles
and per-example parameters in, normalized float crops out.

Train leg, in the reference's order: background composite (when the batch
carries "source_mask") -> K1 warp with its x1/255 epilogue -> K2 occluder
paste -> colour jitter -> normalize. The inference leg is one K1 launch with
the x1/255 + normalize epilogue fused into its store.
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.ops.color import color_jitter, composite_background, normalize
from metro_pose3d_tpu_torch.ops.occlusion import occlude_with_bank, pack_occluder_bank
from metro_pose3d_tpu_torch.ops.warp import warp_images


def example_spec(joint_count: int, tile_side: int, proc_side: int) -> dict:
    """Shape/dtype spec of one prepared example (the host -> device
    contract the loader keeps): key -> (shape, numpy dtype).

    Optional keys (present when background replacement is active, i.e. the
    loader was built with a background bank): "source_mask" (tile_side,
    tile_side) uint8 and "bg_params" (2,) float32. The loader adds "_pad"
    (batch,) float32 to each batch; the train step reads no such key.
    """
    j = joint_count
    return {
        "source": ((tile_side, tile_side, 3), np.uint8),
        "warp_h": ((3, 3), np.float32),
        "warp_k": ((4,), np.float32),
        "warp_dist": ((5,), np.float32),
        "coords3d_true": ((j, 3), np.float32),
        "coords2d_true": ((j, 2), np.float32),
        "joint_validity": ((j,), np.float32),
        "joint_validity_2d": ((j,), np.float32),
        "is_3d": ((), np.float32),
        "intrinsics": ((3, 3), np.float32),
        "color_params": ((4,), np.float32),
        "occ_params": ((2,), np.float32),
        "occ_affine": ((2, 3), np.float32),
    }


def pack_occluder_bank_for(bank_rgba01, device) -> torch.Tensor:
    """Upload the [N,T,T,4] float RGBA occluder bank once, as the uint8 RGBA
    bank the occluder paste samples."""
    return pack_occluder_bank(bank_rgba01).to(device)


def batch_to_device(batch: dict, device) -> dict:
    """Host batch (numpy arrays in the `example_spec` layout) -> tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def device_augment(batch: dict, proc_side: int, train: bool = False, occluder_bank=None,
                   background_bank=None, out_dtype=None):
    """{"source" [B,T,T,3] uint8, "warp_h" [B,3,3], "warp_k" [B,4],
    "warp_dist" [B,5], and for training "occ_params" [B,2] (enabled, bank
    index), "occ_affine" [B,2,3], "color_params" [B,4] (brightness,
    contrast, saturation, hue)} -> [B,S,S,3] crops in [-1, 1], float32 or,
    with `train=False`, in `out_dtype` (default float32; bf16 rounds the
    float32 result to nearest even).

    `occluder_bank`: uint8 [N,T2,T2,4] from `pack_occluder_bank_for`.
    `background_bank`: uint8 [N,T,T,3], used when the batch carries
    "source_mask" and "bg_params".
    """
    warp_args = (batch["warp_h"], batch["warp_k"], batch["warp_dist"], proc_side)
    if not train:
        return warp_images(batch["source"], *warp_args, epilogue="normalize",
                           out_dtype=out_dtype or torch.float32)
    if out_dtype not in (None, torch.float32):
        raise ValueError(f"the train leg gives float32 crops, not {out_dtype}")
    source = batch["source"]
    if background_bank is not None and "source_mask" in batch:
        source = composite_background(source, batch["source_mask"], background_bank,
                                      batch["bg_params"])
    crops = warp_images(source, *warp_args, epilogue="unit")
    if occluder_bank is not None:
        occ = batch["occ_params"]
        crops = occlude_with_bank(crops, occluder_bank, occ[:, 1].to(torch.int32),
                                  batch["occ_affine"], occ[:, 0])
    cp = batch["color_params"]
    crops = color_jitter(crops, cp[:, 0], cp[:, 1], cp[:, 2], cp[:, 3])
    return normalize(crops)
