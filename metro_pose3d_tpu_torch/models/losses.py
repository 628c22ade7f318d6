"""Training losses (`metro_pose3d_tpu/models/losses.py`): root-relative 3D
L1 plus 2D L1, masked per joint and per example for mixed 2D/3D batches.

  * 3D: L1 of root-relative metric coordinates (mm), mean over xyz, under
    `joint_validity * is_3d`, in metres (/1000). The root row is multiplied
    by 0, as the reference does, so its zero error has no subgradient.
  * 2D: L1 of crop-pixel coordinates / `proc_side` under
    `joint_validity_2d`; 2D-only rows (`is_3d` = 0) contribute only this.
  * With `train.absloss_weight > 0`: L1 of the absolute pose reconstructed
    from the two heads and the crop intrinsics, against the camera-frame
    ground truth, in metres.
  * `model_class="twofive"` (the 2.5D baseline): the 3D term is instead the
    L1 of x, y in crop pixels / `proc_side` plus the L1 of root-relative z /
    `box_size_mm`, the z term's root row multiplied by 0; no absolute loss.
Each term is a validity-weighted mean, safe when the mask is empty, over
the global batch where a `torch.distributed` process group is up.
"""
from __future__ import annotations

import torch

from metro_pose3d_tpu_torch.config import Config
from metro_pose3d_tpu_torch.models.metro import get_decoder
from metro_pose3d_tpu_torch.ops.decode import root_relative
from metro_pose3d_tpu_torch.ops.pose3d import reconstruct_absolute
from metro_pose3d_tpu_torch.parallel import mesh


def _masked_mean(err, mask):
    """Mean of `err` [B, J] under `mask` [B, J]; 0 when the mask is empty.
    Where a process group is up, the mean over the global batch, as the JAX
    package's over its data mesh: the sum and the count of valid entries
    are summed over the ranks (the sum with gradients), so ranks that hold
    other numbers of valid joints weigh as their joints do."""
    total, count = mesh.global_sum(torch.stack([(err * mask).sum(), mask.sum()]))
    return total / torch.clamp(count, min=1.0)


def compute_losses(logits3d, logits2d, batch, cfg: Config, root_index: int = 0):
    """-> (total loss, {"loss3d", "loss2d", ["loss_abs",] "loss"}), all
    float32 scalars. Batch tensors: coords3d_true [B,J,3] mm, coords2d_true
    [B,J,2] px, joint_validity [B,J], joint_validity_2d [B,J], is_3d [B],
    and intrinsics [B,3,3] when the absolute loss is on."""
    mcfg = cfg.model
    gt3d = batch["coords3d_true"].float()
    gt2d = batch["coords2d_true"].float()
    valid3d = batch["joint_validity"].float()
    valid2d = batch["joint_validity_2d"].float()
    is3d = batch["is_3d"].float()[:, None]
    root_mask = torch.ones(gt3d.shape[1], device=gt3d.device)
    root_mask[root_index] = 0.0

    metro = mcfg.model_class == "metro"
    pose, pose2d_px = get_decoder(mcfg)(logits3d, logits2d, mcfg)
    if metro:
        rel_pred = root_relative(pose, root_index)
        rel_gt = root_relative(gt3d, root_index)
        err3d = (rel_pred - rel_gt).abs().mean(-1) * root_mask  # [B, J] mm
        loss3d = _masked_mean(err3d, valid3d * is3d) / 1000.0
    else:  # the 2.5D image-aligned baseline
        pose25d = pose  # x, y crop px; z mm
        root = slice(root_index, root_index + 1)
        gt_z = (gt3d[..., 2] - gt3d[..., root, 2]) / mcfg.box_size_mm
        pred_z = (pose25d[..., 2] - pose25d[..., root, 2]) / mcfg.box_size_mm
        err = ((pose25d[..., :2] / mcfg.proc_side - gt2d / mcfg.proc_side).abs().mean(-1)
               + (pred_z - gt_z).abs() * root_mask)
        loss3d = _masked_mean(err, valid3d * is3d)
    err2d = (pose2d_px - gt2d).abs().mean(-1) / mcfg.proc_side
    loss2d = _masked_mean(err2d, valid2d)

    total = loss3d + cfg.train.loss_2d_weight * loss2d
    parts = {"loss3d": loss3d, "loss2d": loss2d}
    if cfg.train.absloss_weight > 0 and metro:
        abs_pred = reconstruct_absolute(rel_pred, pose2d_px, batch["intrinsics"].float())
        err_abs = (abs_pred - gt3d).abs().mean(-1)
        parts["loss_abs"] = _masked_mean(err_abs, valid3d * is3d) / 1000.0
        total = total + cfg.train.absloss_weight * parts["loss_abs"]
    parts["loss"] = total
    return total, parts
