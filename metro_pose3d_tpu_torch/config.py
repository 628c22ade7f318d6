"""Typed configuration tree + CLI overrides.

The port's own copy of the JAX package's `config.py`: the same frozen
dataclasses with the same fields and defaults (a test compares the two trees
field by field, and a JSON written by either package's `config_to_json`
loads in the other), `apply_overrides` with dotted paths such as
``model.depth=8``, `parse_cli` for ``--model.depth=8`` flags,
`config_to_json` and `ModelConfig.at_phase`.

Fields that steer TPU-only machinery are kept so that one configuration
file serves both packages. The port refuses `train.fused_steps > 1`, and
ignores `aug.warp_sampler`, `aug.warp_newton_iters`, `train.fused_adam`,
`mesh.*` and the host-pipeline fields of `data`. Of the int8 fields it runs
`model.quantize`, `quantize_calib`, `quantize_stages`, `quantize_extras`
and `quantize_fused`, and validates `quantize_1x1_dot` and
`quantize_layout` without effect (they choose between TPU emitters of the
same integer sums).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from metro_pose3d_tpu_torch import reference_constants as C


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_class: str = "metro"      # "metro" | "twofive" (2.5D baseline)
    backbone: str = "resnet50"      # resnet50/101/152 (bottleneck), resnet18/
                                    # 34 (basic block), "tiny" (tests);
                                    # port only: "efficientnetv2-l" and
                                    # "efficientnetv2-tiny" (tests), eval-mode
                                    # serving in bf16/float32, SAME padding
                                    # (models/efficientnet.py); the ResNet
                                    # fields preactivation, stride_position
                                    # and the quantize_* tuning do not apply
    preactivation: bool = True      # ResNet v2 (preact) vs v1.5
    conv_padding: str = "same"      # "same" (TF parity) | "torch"/"keras"
                                    # (for converted ImageNet weights; they
                                    # differ only in the pool pad value)
    stride_position: str = "last"   # "last" (TF slim v2 / Keras V2, the
                                    # reference's backbone) | "first"
                                    # (torchvision layout)
    v2_biases: bool = False         # slim/Keras v2 bias placement (conv3 +
                                    # projection + stem)
    proc_side: int = C.PROC_SIDE
    stride: int = C.STRIDE          # output stride (dilated final stage)
    # Phase-specific output strides. Dilation changes conv spacing and no
    # parameter shape, so one parameter tree can train at a coarse stride
    # and evaluate at a fine one. 0 = use `stride`. Resolved by `at_phase`.
    stride_train: int = 0
    stride_test: int = 0
    depth: int = C.DEPTH            # depth slices of the volumetric heatmap
    box_size_mm: float = C.BOX_SIZE_MM
    num_joints: int = 17
    compute_dtype: str = "bfloat16"  # parameters stay float32
    matmul_precision: str = ""      # "" (platform default) | "highest"
                                    # (see `apply_matmul_precision`)
    # The int8 serving path (models/quantize.py): "none" | "int8" | "calib"
    # | "calib:<pct>", with a calibration pass (`quantize.calibrate`) first.
    # quantize_1x1_dot and quantize_layout are checked as the JAX package
    # checks them and have no effect: they pick one of two TPU emitters of
    # the same integer sums, and the port has one emitter for each conv.
    quantize: str = "none"
    quantize_calib: str = "p99.9"
    quantize_stages: str = "all"
    quantize_extras: str = ""
    quantize_fused: bool = True
    quantize_1x1_dot: str = "all"
    quantize_layout: str = "nhwc"
    bn_momentum: float = C.BN_MOMENTUM
    bn_epsilon: float = C.BN_EPSILON
    # 0 = batch norm over the whole batch. >0 = ghost BN: train statistics
    # per `bn_group_size` examples (models/resnet.py BatchNorm).
    bn_group_size: int = 0

    @property
    def heatmap_side(self) -> int:
        return self.proc_side // self.stride

    def at_phase(self, train: bool) -> "ModelConfig":
        """Resolve stride_train/stride_test into a concrete `stride`.
        Every model-construction site calls this, so the phase fields never
        leak past model build time. Returns self when no phase override is
        set."""
        s = (self.stride_train if train else self.stride_test) or self.stride
        if s == self.stride and not (self.stride_train or self.stride_test):
            return self
        return dataclasses.replace(self, stride=s, stride_train=0, stride_test=0)


@dataclasses.dataclass(frozen=True)
class AugConfig:
    shift_frac: float = C.AUG_SHIFT_FRAC
    scale_down: float = C.AUG_SCALE_DOWN
    scale_up: float = C.AUG_SCALE_UP
    rot_max_deg: float = C.AUG_ROT_MAX_DEG
    flip_prob: float = C.AUG_FLIP_PROB
    occlude_prob: float = C.AUG_OCCLUDE_PROB
    # side (px) of the device-resident occluder RGBA tiles
    occluder_tile_side: int = 96
    color_prob: float = C.AUG_COLOR_PROB
    brightness_max: float = 0.125   # additive, on [0,1]-scaled intensities
    contrast_range: float = 0.25
    saturation_range: float = 0.25
    hue_max: float = 0.05           # fraction of a full hue revolution
    background_prob: float = 0.7    # 3DHP green-screen replacement
    # sampler choice and Newton iterations of the JAX package's warp; the
    # port has one warp (ops/warp.py) and ignores both
    warp_sampler: str = "auto"
    warp_newton_iters: int = 3


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"      # h36m | mpi_inf_3dhp | mpii | synthetic
    dataset_2d: str = ""            # auxiliary 2D dataset (e.g. "mpii")
    data_root: str = "/data"
    cache_dir: str = "/data/cache"
    source_side: int = 512          # fixed host->device source-tile side
    workers: int = 4
    pool_type: str = "thread"       # "thread" | "process" host workers
    host_prep: str = "auto"         # crop-parameter engine: auto|native|python
    test_box_expansion: float = C.TEST_BOX_EXPANSION
    # augmentation asset roots; empty -> procedural banks
    occluder_root: str = ""
    background_root: str = ""
    # > 0: prepare this many host batches once and cycle them for the whole
    # run (a measurement aid: the examples repeat with their augmentations)
    cycle_batches: int = 0
    synthetic_n_train: int = 512
    synthetic_n_test: int = 64


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64            # global batch
    batch_size_2d: int = 32         # auxiliary 2D examples per global batch
    num_steps: int = 400_000
    base_lr: float = C.ADAM_LR
    lr_schedule: str = "exp_decay"  # "exp_decay" | "cosine" | "constant"
    lr_decay_steps: int = 100_000
    lr_decay_rate: float = 0.33
    warmup_steps: int = 1_000
    loss_2d_weight: float = C.LOSS_2D_WEIGHT
    absloss_weight: float = 0.0     # optional absolute-pose aux loss
    grad_clip_norm: float = 1.0     # global-norm gradient clip (0 = off)
    fused_adam: bool = False        # selects nothing in the port
    fused_steps: int = 1            # > 1 is refused by the port
    seed: int = 0
    checkpoint_every: int = 2_000
    # > 0: trace this many consecutive train steps into <logdir>/profile
    profile_steps: int = 0
    keep_checkpoints: int = 3
    log_every: int = 100
    validate_every: int = 10_000
    validate_batches: int = 4
    logdir: str = "/tmp/metro_tpu_runs/default"
    load_path: str = ""             # warm-start checkpoint
    backbone_init: str = ""         # ImageNet-pretrained backbone params


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 128
    flip_tta: bool = True
    scale_recovery: str = "metric"  # "metric" | "bone_lengths"
    reconstruct_absolute: bool = True
    reconstruction: str = "full"    # "full" perspective LSQ | "weak"
    pred_path: str = ""             # where --test dumps predictions (.npz)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1             # the JAX package's device mesh; ignored


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    aug: AugConfig = dataclasses.field(default_factory=AugConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def apply_matmul_precision(cfg: "Config") -> None:
    """Honor `model.matmul_precision` as torch's global setting: "highest"
    turns TF32 off for float32 matrix products and cuDNN convolutions, so
    float32 numbers on the card match the CPU's to roundoff. The setting is
    the process's, as `jax_default_matmul_precision` is; `train()` and
    `make_predict_fn` call this."""
    if cfg.model.matmul_precision == "highest":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _coerce(value: str, target_type):
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is Optional[str]:
        return value
    return target_type(value)


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply {"model.depth": "8", ...} dotted-path overrides (immutably)."""
    grouped: dict = {}
    for path, value in overrides.items():
        section, _, field = path.partition(".")
        if not field:
            raise ValueError(f"override must be section.field, got {path!r}")
        grouped.setdefault(section, {})[field] = value

    updates = {}
    for section, fields in grouped.items():
        sub = getattr(cfg, section)
        field_types = {f.name: f.type for f in dataclasses.fields(sub)}
        coerced = {}
        for name, raw in fields.items():
            if name not in field_types:
                raise ValueError(f"unknown config field {section}.{name}")
            current = getattr(sub, name)
            coerced[name] = _coerce(str(raw), type(current))
        updates[section] = dataclasses.replace(sub, **coerced)
    return dataclasses.replace(cfg, **updates)


def parse_cli(argv) -> tuple[Config, list]:
    """Parse ``--section.field=value`` overrides; returns (config, rest)."""
    overrides, rest = {}, []
    for arg in argv:
        if arg.startswith("--") and "=" in arg and "." in arg.split("=", 1)[0]:
            key, _, value = arg[2:].partition("=")
            overrides[key] = value
        else:
            rest.append(arg)
    return apply_overrides(Config(), overrides), rest


def config_to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)
