"""Training state (`metro_pose3d_tpu/train/state.py`): the step count, the
model (float32 parameters and BN running statistics) and the Adam state.

`state_dict()` keys the Adam state by parameter name, as the model's own
state dict is keyed, so a checkpoint and a state converted from the JAX
package (`convert.train_state_from_flax`) load the same way.
"""
from __future__ import annotations

import dataclasses

import torch

from metro_pose3d_tpu_torch.config import Config
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.train.loop import make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: MetroModel
    optimizer: torch.optim.Adam

    def state_dict(self) -> dict:
        """{"step": int, "model": state dict, "adam": {param name: {"step",
        "exp_avg", "exp_avg_sq"}}}, tensors detached on their devices."""
        names = [name for name, _ in self.model.named_parameters()]
        opt = self.optimizer.state_dict()["state"]
        return {"step": self.step, "model": self.model.state_dict(),
                "adam": {names[i]: dict(s) for i, s in opt.items()}}

    def load_state_dict(self, d: dict) -> None:
        """Load `state_dict()`'s layout; every name must match. `d` is copied:
        training the state leaves it as it was."""
        self.model.load_state_dict(d["model"], strict=True)
        index = {name: i for i, (name, _) in enumerate(self.model.named_parameters())}
        unknown = set(d["adam"]) - set(index)
        if unknown:
            raise KeyError(f"Adam state for unknown parameters: {sorted(unknown)[:5]}")
        opt = self.optimizer.state_dict()
        # copies: the optimizer keeps the tensors it is given where their
        # dtype and device fit, and would update `d`'s in place
        opt["state"] = {index[name]: {k: v.clone() if torch.is_tensor(v) else v
                                      for k, v in s.items()}
                        for name, s in d["adam"].items()}
        # casts and moves each tensor as this optimizer keeps it
        self.optimizer.load_state_dict(opt)
        self.step = int(d["step"])


def create_train_state(cfg: Config, device=None, seed: int | None = None) -> TrainState:
    """Seeded random init (`init.py`) of the model at the train phase, in
    train mode, on `device` (default: the card; a RuntimeError where CUDA is
    absent), with a fresh Adam state. `seed` defaults to `train.seed`. With
    `train.backbone_init` the trunk then takes the leaves of that backbone
    `.npz` (`utils/convert_backbone.py`): the ImageNet warm start."""
    model = init_metro_model(cfg.model, cfg.train.seed if seed is None else seed, device,
                             train=True)
    if cfg.train.backbone_init:
        from metro_pose3d_tpu_torch.utils.convert_backbone import (
            apply_backbone_init, load_backbone_npz,
        )

        apply_backbone_init(model, load_backbone_npz(cfg.train.backbone_init))
    return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model))
