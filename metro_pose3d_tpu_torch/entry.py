"""Entry point on the flagship configuration (`__graft_entry__.entry`)."""
from __future__ import annotations

import torch

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.device import resolve_device
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.evaluation.engine import make_predict_fn
from metro_pose3d_tpu_torch.init import init_metro_model


def entry(device=None, seed: int = 0, batch_size: int = 4, quantize: str = "none"):
    """-> (fn, args): the crop-in predict fn of the default `Config()`
    (ResNet-50 @ 256, bf16, flip TTA, full reconstruction) and its
    arguments (model with seeded random weights, zero uint8 crops,
    intrinsics), all on `device` (default: the card; a RuntimeError where
    CUDA is absent). With `quantize="int8"` the model is the int8 serving
    graph, calibrated on two batches of seeded crops."""
    device = resolve_device(device)
    cfg = Config() if quantize == "none" else apply_overrides(
        Config(), {"model.quantize": quantize})
    model = init_metro_model(cfg.model, seed, device)
    side = cfg.model.proc_side
    if quantize != "none":
        from metro_pose3d_tpu_torch.models.quantize import calibrate

        gen = torch.Generator().manual_seed(seed)
        calibrate(model, [torch.rand((batch_size, side, side, 3), generator=gen) * 2 - 1
                          for _ in range(2)])
    crops = torch.zeros((batch_size, side, side, 3), dtype=torch.uint8, device=device)
    intr = torch.tensor([[1200.0, 0.0, 127.5], [0.0, 1200.0, 127.5], [0.0, 0.0, 1.0]],
                        device=device).expand(batch_size, 3, 3).contiguous()
    fn = make_predict_fn(cfg, H36M_17.mirror_mapping, root_index=0, flip_tta=True,
                         reconstruct=True)
    return fn, (model, crops, intr)
