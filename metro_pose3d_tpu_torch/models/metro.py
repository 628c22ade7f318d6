"""MeTRo model: backbone -> metric volumetric 3D head + 2D heatmap head
(`metro_pose3d_tpu/models/metro.py`).

    crops [B,S,S,3] -> trunk /16 dilated -> feats [B,C,h,w]
    -> 1x1 conv -> [B,h,w,J*D] -> reshape [B,h,w,D,J]    (3D head)
    -> 1x1 conv -> [B,h,w,J]                             (2D head)

The trunk is the ResNet that `model.backbone` names (`models/resnet.py`) or
an EfficientNetV2 (`efficientnetv2-l`, `efficientnetv2-tiny`:
`models/efficientnet.py`, eval-mode serving only).

`model_class="twofive"` is the 2.5D baseline: the same backbone and heads,
decoded as crop pixels (x, y) and metric depth (z) by `decode_twofive`.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from metro_pose3d_tpu_torch.config import ModelConfig
from metro_pose3d_tpu_torch.models import efficientnet
from metro_pose3d_tpu_torch.models.quantize import check_backbone
from metro_pose3d_tpu_torch.models.resnet import (
    RESNET_DEPTHS, ResNet, _make_conv, parse_quantize_extras,
)
from metro_pose3d_tpu_torch.ops.decode import heatmap_to_image, heatmap_to_metric
from metro_pose3d_tpu_torch.ops.soft_argmax import soft_argmax_2d, soft_argmax_3d

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_trunk(cfg: ModelConfig, dtype, train: bool) -> nn.Module:
    """The trunk `cfg.backbone` names; an EfficientNetV2 refuses training and
    `model.quantize`."""
    if cfg.backbone in efficientnet.TRUNKS:
        if train:
            raise ValueError(efficientnet.NOT_TRAINABLE)
        check_backbone(cfg)
        return efficientnet.EfficientNetV2(cfg, dtype)
    if cfg.backbone not in RESNET_DEPTHS:
        raise ValueError(f"unknown backbone {cfg.backbone!r}; known: "
                         f"{sorted(RESNET_DEPTHS) + sorted(efficientnet.TRUNKS)}")
    return ResNet(cfg, dtype)


class MetroModel(nn.Module):
    """The model at one phase's output stride, resolved at build time
    (`ModelConfig.at_phase`): the test stride by default, the train stride
    with `train=True`. The parameter tree is the same at either stride.
    Batch norm follows `.train()` / `.eval()`. With `model.quantize` it is the
    int8 serving graph (`models/quantize.py`), which `train=True` refuses;
    an EfficientNetV2 trunk refuses both."""

    def __init__(self, cfg: ModelConfig, train: bool = False):
        super().__init__()
        cfg = cfg.at_phase(train=train)
        if train and cfg.quantize != "none":
            raise ValueError("model.quantize is inference-only; training runs the bf16 graph")
        if cfg.model_class not in DECODERS:
            raise ValueError(f"model_class {cfg.model_class!r} not in {sorted(DECODERS)}")
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        self.backbone = build_trunk(cfg, self.dtype, train)
        c = self.backbone.out_channels
        # int8 1x1 heads under quantize_extras "heads", their input (the
        # features after bn_final and ReLU) calibrated like the block convs
        quant = cfg.quantize if "heads" in parse_quantize_extras(cfg.quantize_extras) else "none"
        self.head3d = _make_conv(c, cfg.num_joints * cfg.depth, 1, bias=True, dtype=self.dtype,
                                 quantize=quant)
        self.head2d = _make_conv(c, cfg.num_joints, 1, bias=True, dtype=self.dtype,
                                 quantize=quant)

    def forward(self, crops):
        """crops [B,S,S,3] normalized float -> (logits3d [B,h,w,D,J],
        logits2d [B,h,w,J]), both float32."""
        # an NHWC tensor permuted to NCHW is channels_last in memory
        x = crops.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.backbone(x)
        b, _, h, w = feats.shape
        j, d = self.cfg.num_joints, self.cfg.depth
        # the 3D head's channels split as [..., D, J] in NHWC order
        logits3d = self.head3d(feats).permute(0, 2, 3, 1).reshape(b, h, w, d, j)
        logits2d = self.head2d(feats).permute(0, 2, 3, 1)
        return logits3d.float(), logits2d.float()


def decode_metro(logits3d, logits2d, cfg: ModelConfig):
    """-> (pose3d_mm [B,J,3] centred metric, pose2d_px [B,J,2])."""
    pose3d_mm = heatmap_to_metric(soft_argmax_3d(logits3d), cfg.box_size_mm)
    pose2d_px = heatmap_to_image(soft_argmax_2d(logits2d), cfg.proc_side)
    return pose3d_mm, pose2d_px


def decode_twofive(logits3d, logits2d, cfg: ModelConfig):
    """2.5D baseline decode -> (pose25d [B,J,3]: x, y crop pixels and z metric
    mm, pose2d_px [B,J,2]). The volume's x and y axes are image-aligned, so
    the result depends on the person's scale in the crop."""
    coords3d = soft_argmax_3d(logits3d)
    xy_px = heatmap_to_image(coords3d[..., :2], cfg.proc_side)
    z_mm = (coords3d[..., 2:] - 0.5) * cfg.box_size_mm
    pose2d_px = heatmap_to_image(soft_argmax_2d(logits2d), cfg.proc_side)
    return torch.cat([xy_px, z_mm], dim=-1), pose2d_px


DECODERS = {"metro": decode_metro, "twofive": decode_twofive}


def get_decoder(cfg: ModelConfig):
    return DECODERS[cfg.model_class]


def twofive_backproject(pose25d, intrinsics, root_depth_mm):
    """Lift the 2.5D baseline's (u, v, z_rel) [B,J,3] to camera-frame mm with
    the crop intrinsics [B,3,3] and the person's root depth [B]: the
    dependence on distance that the metric volume removes."""
    z_abs = pose25d[..., 2:] + root_depth_mm[..., None, None]
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    cx = intrinsics[:, 0, 2][:, None, None]
    cy = intrinsics[:, 1, 2][:, None, None]
    x = (pose25d[..., 0:1] - cx) / fx * z_abs
    y = (pose25d[..., 1:2] - cy) / fy * z_abs
    return torch.cat([x, y, z_abs], dim=-1)
