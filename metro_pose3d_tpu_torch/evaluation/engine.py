"""Inference engine: uint8 crops (or tiles) in -> skeletons out
(`metro_pose3d_tpu/evaluation/engine.py`).

Normalization, backbone, heads, soft-argmax decode, flip TTA, bone-length
rescale and absolute reconstruction, in one call per batch. Flip TTA runs as
one doubled batch [crops; mirrored crops], so the convolutions see one
large batch instead of two.
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.config import Config, apply_matmul_precision
from metro_pose3d_tpu_torch.models.metro import MetroModel, get_decoder
from metro_pose3d_tpu_torch.ops.color import normalize
from metro_pose3d_tpu_torch.ops.decode import root_relative
from metro_pose3d_tpu_torch.ops.pose3d import reconstruct_absolute, rescale_to_bone_lengths
from metro_pose3d_tpu_torch.ops.tta import (
    flip_crop, unflip_pose2d, unflip_pose3d, unflip_pose25d,
)
from metro_pose3d_tpu_torch.pipeline.device import device_augment

TILE_KEYS = ("source", "warp_h", "warp_k", "warp_dist", "intrinsics")


def make_predict_fn(
    cfg: Config,
    mirror_mapping: np.ndarray,
    root_index: int = 0,
    flip_tta: bool | None = None,
    reconstruct: bool | None = None,
    bone_edges: np.ndarray | None = None,
    mean_bones: np.ndarray | None = None,
    from_tiles: bool = False,
):
    """Build the predict function.

    Signature of the returned fn:
      from_tiles=False: (model, crops_uint8 [B,S,S,3], intrinsics [B,3,3])
      from_tiles=True:  (model, batch dict with the keys of `TILE_KEYS`)
    Inputs are tensors on the model's device. Returns a dict with
    pose3d_rootrel (mm), pose2d_px, and pose3d_abs (mm, camera frame) when
    reconstruction is on. With `model_class="twofive"` (the 2.5D baseline)
    it returns pose25d (x, y crop px; z mm) and pose2d_px and reconstructs
    nothing: root-relative metric coordinates need a known root depth
    (`models.metro.twofive_backproject`). `model.matmul_precision` takes
    effect here, for the whole process.
    """
    apply_matmul_precision(cfg)
    mcfg = cfg.model
    is_twofive = mcfg.model_class == "twofive"
    decode = get_decoder(mcfg)
    flip_tta = cfg.eval.flip_tta if flip_tta is None else flip_tta
    reconstruct = cfg.eval.reconstruct_absolute if reconstruct is None else reconstruct
    weak = cfg.eval.reconstruction == "weak"
    use_bones = (cfg.eval.scale_recovery == "bone_lengths"
                 and bone_edges is not None and mean_bones is not None)
    host = {
        "mirror": torch.as_tensor(np.asarray(mirror_mapping), dtype=torch.long),
        "edges": None if bone_edges is None else torch.as_tensor(
            np.asarray(bone_edges), dtype=torch.long),
        "bones": None if mean_bones is None else torch.as_tensor(
            np.asarray(mean_bones), dtype=torch.float32),
    }
    per_device = {}

    def consts(device):
        if device not in per_device:
            per_device[device] = {k: None if v is None else v.to(device)
                                  for k, v in host.items()}
        return per_device[device]

    def forward(model: MetroModel, crops_norm, intrinsics):
        c = consts(crops_norm.device)
        b = crops_norm.shape[0]
        if flip_tta:
            both = torch.cat([crops_norm, flip_crop(crops_norm)], dim=0)
            p3, p2 = decode(*model(both), mcfg)
            if is_twofive:
                p3_m = unflip_pose25d(p3[b:], c["mirror"], mcfg.proc_side)
            else:
                p3_m = unflip_pose3d(p3[b:], c["mirror"])
            p2_m = unflip_pose2d(p2[b:], c["mirror"], mcfg.proc_side)
            pose3d = 0.5 * (p3[:b] + p3_m)
            pose2d = 0.5 * (p2[:b] + p2_m)
        else:
            pose3d, pose2d = decode(*model(crops_norm), mcfg)
        if is_twofive:
            return {"pose25d": pose3d, "pose2d_px": pose2d}

        pose3d_rel = root_relative(pose3d, root_index)
        if use_bones:
            pose3d_rel = rescale_to_bone_lengths(pose3d_rel, c["edges"], c["bones"])
        out = {"pose3d_rootrel": pose3d_rel, "pose2d_px": pose2d}
        if reconstruct:
            out["pose3d_abs"] = reconstruct_absolute(
                pose3d_rel, pose2d, intrinsics, weak_perspective=weak)
        return out

    if from_tiles:
        def predict(model, batch):
            # crops arrive in the model's compute dtype, so the flip, the
            # concatenation and the layout change move that and nothing wider
            crops = device_augment(batch, mcfg.proc_side, train=False, out_dtype=model.dtype)
            return forward(model, crops, batch["intrinsics"])
    else:
        def predict(model, crops_uint8, intrinsics):
            crops = normalize(crops_uint8.float() / 255.0)
            return forward(model, crops, intrinsics)

    return torch.inference_mode()(predict)


class PoseEstimator:
    """A model on its device bundled with the crop-in and tile-in predict fns."""

    def __init__(self, cfg: Config, model: MetroModel, joint_info, **kw):
        self.cfg = cfg
        self.model = model.eval()
        self.joint_info = joint_info
        self.device = next(model.parameters()).device
        root = joint_info.names.index("pelv") if "pelv" in joint_info.names else 0
        common = dict(mirror_mapping=joint_info.mirror_mapping, root_index=root, **kw)
        self._crops_fn = make_predict_fn(cfg, from_tiles=False, **common)
        self._tiles_fn = make_predict_fn(cfg, from_tiles=True, **common)

    def _to_device(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def predict_crops(self, crops_uint8, intrinsics) -> dict:
        """uint8 crops [B,S,S,3] + intrinsics [B,3,3] -> dict of tensors."""
        return self._crops_fn(self.model, self._to_device(crops_uint8),
                              self._to_device(intrinsics))

    def predict_tiles(self, batch: dict) -> dict:
        """Tile batch (`TILE_KEYS`: uint8 tiles + warp params + intrinsics)
        -> dict of tensors."""
        return self._tiles_fn(self.model, {k: self._to_device(batch[k]) for k in TILE_KEYS})
