"""The system under test: the port `metro_pose3d_tpu_torch`, built as its
users build it, from the configuration file's `port` settings. The harness
takes from it the serving and training entry points and its kernel names;
nothing else of the benchmark imports it."""
from __future__ import annotations

import numpy as np
import torch


def port_config(cfg: dict):
    """The port's `Config` from the configuration file: its `port` overrides
    on the defaults, checked against the file's sizes."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides

    pc = apply_overrides(Config(), cfg["port"])
    m, e, t = pc.model, pc.eval, pc.train
    got = {"backbone": m.backbone, "preactivation": m.preactivation,
           "stride_position": m.stride_position, "conv_padding": m.conv_padding,
           "proc_side": m.proc_side, "stride": m.stride, "depth": m.depth,
           "num_joints": m.num_joints, "box_size_mm": m.box_size_mm,
           "bn_epsilon": m.bn_epsilon, "bn_momentum": m.bn_momentum,
           "compute_dtype": m.compute_dtype, "quantize": m.quantize,
           "flip_tta": e.flip_tta, "reconstruct_absolute": e.reconstruct_absolute,
           "base_lr": t.base_lr, "warmup_steps": t.warmup_steps,
           "lr_decay_rate": t.lr_decay_rate, "lr_decay_steps": t.lr_decay_steps,
           "grad_clip_norm": t.grad_clip_norm, "loss_2d_weight": t.loss_2d_weight,
           "batch_size": t.batch_size, "batch_size_2d": t.batch_size_2d}
    wrong = {k: (v, cfg[k]) for k, v in got.items() if k in cfg and v != cfg[k]}
    if wrong:
        raise ValueError(f"the port's Config differs from the configuration file: {wrong}")
    return pc


def joint_info(cfg: dict):
    from metro_pose3d_tpu_torch.geom.joints import H36M_17

    if list(H36M_17.names) != cfg["joint_names"]:
        raise ValueError("the port's H36M_17 joints are not the configuration's joint_names")
    return H36M_17


def build_model(cfg: dict, device, train: bool):
    from metro_pose3d_tpu_torch.models.metro import MetroModel

    return MetroModel(port_config(cfg).model, train=train).to(device)


def parameter_shapes(model) -> dict:
    """The model's weights and statistics that the benchmark fills (the int8
    calibration's `amax` buffers are the system's own)."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith(".amax")}


def load_weights(model, weights: dict) -> None:
    state = model.state_dict()
    with torch.no_grad():
        for k, v in weights.items():
            state[k].copy_(v)
        for k, v in state.items():
            if k.endswith(".amax"):
                v.zero_()  # calibration starts from 0, as after init


class Server:
    """`PoseEstimator` over the model (`est`, which the kind calls), with a
    client's output staging: `fetch` enqueues the copies of its outputs
    into the next of `slots` pinned host buffers, `collect` waits for them."""

    OUTPUTS = ("pose3d_rootrel", "pose2d_px", "pose3d_abs")

    def __init__(self, cfg: dict, traffic: dict, model, slots: int):
        from metro_pose3d_tpu_torch.evaluation.engine import PoseEstimator

        self.est = PoseEstimator(port_config(cfg), model.eval(), joint_info(cfg))
        b, j = traffic["batch"], cfg["num_joints"]
        shapes = {"pose3d_rootrel": (b, j, 3), "pose2d_px": (b, j, 2), "pose3d_abs": (b, j, 3)}
        pin = torch.cuda.is_available() and next(model.parameters()).is_cuda
        self.slots = [{k: torch.empty(s, pin_memory=pin) for k, s in shapes.items()}
                      for _ in range(slots)]
        self.turn = 0

    def fetch(self, out: dict):
        """-> (host buffers, event): non-blocking copies into the next slot."""
        slot = self.slots[self.turn % len(self.slots)]
        self.turn += 1
        for k in self.OUTPUTS:
            slot[k].copy_(out[k], non_blocking=True)
        ev = None
        if out[self.OUTPUTS[0]].is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        return slot, ev

    @staticmethod
    def collect(slot: dict, ev) -> dict:
        if ev is not None:
            ev.synchronize()
        return {k: np.array(v) for k, v in slot.items()}


def calibrate(model, crops_u8: list, device) -> None:
    """The system's int8 calibration on the benchmark's crops, normalised
    to [-1, 1] as the system's crop-in path normalises them."""
    from metro_pose3d_tpu_torch.models.quantize import calibrate as run

    run(model, [torch.from_numpy(c).to(device).float() / 255.0 * 2.0 - 1.0 for c in crops_u8])


class Trainer:
    """The step of `train/loop.py::make_train_step` over a `TrainState`."""

    def __init__(self, cfg: dict, traffic: dict, model, pool: dict):
        from metro_pose3d_tpu_torch.train.loop import make_optimizer, make_train_step
        from metro_pose3d_tpu_torch.train.state import TrainState

        pc = port_config(cfg)
        root = cfg["joint_names"].index("pelv")
        self.state = TrainState(step=traffic["start_step"], model=model.train(),
                                optimizer=make_optimizer(pc, model))
        self.step_fn = make_train_step(pc, root_index=root, occluder_bank=pool["occluders"],
                                       background_bank=pool["backgrounds"])

    def step(self, batch: dict) -> dict:
        return self.step_fn(self.state, batch)

    def named_parameters(self):
        return self.state.model.named_parameters()

    def first_moment(self, p) -> torch.Tensor:
        return self.state.optimizer.state[p]["exp_avg"]


def kernel_library_loaded() -> None:
    """Build (first run in a checkout) or load the system's CUDA kernels."""
    from metro_pose3d_tpu_torch.kernels import build

    build.load()

