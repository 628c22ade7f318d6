"""Model export and import (`metro_pose3d_tpu/export.py`): a crop-in,
skeleton-out inference bundle.

The bundle is `config.json`, in the JAX package's layout
(`{"config": <the config as a dict>, "joint_info": <name>}`, so either
package reads the other's config), and `model.pt`, the port's model state
dict (with each `QuantConv`'s calibrated `amax` under int8). `load_exported`
rebuilds the model on a device and returns `make_predict_fn`'s crop-in
function.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.device import resolve_device
from metro_pose3d_tpu_torch.evaluation.engine import make_predict_fn
from metro_pose3d_tpu_torch.geom.joints import get_joint_info
from metro_pose3d_tpu_torch.models.metro import MetroModel

WEIGHTS = "model.pt"


def export_model(cfg: Config, model: MetroModel, out_dir: str,
                 joint_info_name: str = "h36m_17") -> str:
    """Write `model` and `cfg` as a bundle into `out_dir`; returns it."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg), "joint_info": joint_info_name}, f,
                  indent=2)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(out_dir, WEIGHTS))
    return out_dir


def load_exported(out_dir: str, flip_tta: bool | None = None, device=None):
    """-> (cfg, model, predict_fn(model, crops_uint8 [B,S,S,3], intrinsics
    [B,3,3])), the model in eval mode on `device` (default: the card; a
    RuntimeError where CUDA is absent)."""
    with open(os.path.join(out_dir, "config.json")) as f:
        meta = json.load(f)
    flat = {f"{section}.{name}": str(value)
            for section, fields in meta["config"].items() for name, value in fields.items()}
    cfg = apply_overrides(Config(), flat)
    ji = get_joint_info(meta["joint_info"])
    model = MetroModel(cfg.model)
    state = torch.load(os.path.join(out_dir, WEIGHTS), map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    model = model.to(resolve_device(device)).eval()
    root = ji.names.index("pelv") if "pelv" in ji.names else 0
    fn = make_predict_fn(cfg, ji.mirror_mapping, root_index=root, flip_tta=flip_tta)
    return cfg, model, fn
