"""EfficientNetV2 trunk (Tan & Le, "EfficientNetV2: Smaller Models and Faster
Training", ICML 2021, arXiv:2104.00298) under MeTRo's heads, for eval-mode
serving.

EfficientNetV2-L is the backbone of MeTRAbs (Sarandi et al., T-BIOM 2021,
arXiv:2007.07227; isarandi/metrabs, the `metrabs_eff2l_*` models). The block
table is `v2_l_block` of google/automl `efficientnetv2/effnetv2_configs.py`:

    stage  block         k  stride  expand  in -> out  repeats  SE
    stem   conv+BN+SiLU  3  2       -       3 -> 32    1        -
    1      Fused-MBConv  3  1       1       32 -> 32   4        -
    2      Fused-MBConv  3  2       4       32 -> 64   7        -
    3      Fused-MBConv  3  2       4       64 -> 96   7        -
    4      MBConv        3  2       4       96 -> 192  10       0.25
    5      MBConv        3  1       6       192 -> 224 19       0.25
    6      MBConv        3  2       6       224 -> 384 25       0.25
    7      MBConv        3  1       6       384 -> 640 7        0.25
    top    conv+BN+SiLU  1  1       -       640 -> 1280 1       -

A stage's stride and `in` width apply to its first block; later blocks take
stride 1 and `out -> out`. Every conv pads as XLA/Keras SAME and has no
bias; batch norm follows each (eps and momentum from the config), SiLU is
x * sigmoid(x), and a block adds its input to its output where its stride is
1 and its widths are equal.
  Fused-MBConv, expand 1: conv3 k x k (the stride) -> bn3 -> SiLU.
  Fused-MBConv, expand e: conv1 k x k to e*in (the stride) -> bn1 -> SiLU
      -> conv3 1x1 to out -> bn3.
  MBConv: conv1 1x1 to e*in -> bn1 -> SiLU -> conv2 depthwise k x k (the
      stride) -> bn2 -> SiLU -> squeeze-excitation (the mean over H, W ->
      se_reduce 1x1 with bias to max(1, int(in * se)) -> SiLU -> se_expand
      1x1 with bias back to e*in -> sigmoid -> a product with the input)
      -> conv3 1x1 to out -> bn3.
The squeeze width follows the block's input width, not the expanded one.
Every block's last conv is `conv3`. The SE's two FCs are 1x1 `Conv`s, as
Keras builds them, so no matrix product enters the device code. The
depthwise conv runs the port's kernel on the card (`ops/dwconv.py`, through
`Conv` with `groups`); batch norm and its SiLU run `ops/bn.py`'s. A forward
first casts every dense conv's parameters and computes every batch norm's
multiplier in one pass each (`EfficientNetV2.derived`) and hands them to the
modules, so that the host's launches stay under the card's work.

Output stride: the cumulative stride counts from the stem's 2; once it
reaches `model.stride`, a later stage drops its stride and it and every later
stage dilate their k > 1 convs instead, all of the stage's blocks alike (the
rule of `ResNet` with `stride_position="first"`, torchvision's
`replace_stride_with_dilation`). At stride 16 stage 6 drops its stride and
stages 6 and 7 dilate by 2: a 256 px crop gives a 16 x 16 heatmap.

Not the published network: MeTRo's two 1x1 heads (`models/metro.py`) take
the 1280-wide features in place of ImageNet's classifier; the dilation
above; stochastic depth, which acts only in training, is absent. Training
and the int8 serving mode are not ported for this trunk: `MetroModel(...,
train=True)`, `make_train_step` and `model.quantize` refuse it.
`efficientnetv2-tiny` is a small trunk of the same blocks for the CPU tests.

Names: `stem`, `bn_stem`, `stage{s}_block{i}.{conv1,bn1,conv2,bn2,se_reduce,
se_expand,conv3,bn3}`, `top`, `bn_top`. Spans (`utils/profiling.py`):
`effv2.fused` around the Fused-MBConv stages of a forward, `effv2.mbconv`
around the MBConv stages, `effv2.se` around each SE gate; the counter
`effv2.expanded_bytes` adds the bytes of the expand and depthwise convs'
outputs that the blocks write (conv1 of an expanding block, conv2 of an
MBConv).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from metro_pose3d_tpu_torch.config import ModelConfig
from metro_pose3d_tpu_torch.models.resnet import BatchNorm, Conv
from metro_pose3d_tpu_torch.utils.profiling import count, span

EXPANDED_BYTES = "effv2.expanded_bytes"
NOT_TRAINABLE = ("training is not ported for the EfficientNetV2 trunks (no stochastic depth, "
                 "no training reference); they serve in eval mode")


@dataclasses.dataclass(frozen=True)
class Stage:
    fused: bool  # Fused-MBConv, else MBConv
    k: int
    stride: int
    expand: int
    cin: int
    cout: int
    repeats: int
    se: float  # MBConv: the squeeze ratio of the input width; Fused-MBConv: 0, no gate


@dataclasses.dataclass(frozen=True)
class Trunk:
    stem: int
    stages: tuple
    top: int


TRUNKS = {
    "efficientnetv2-l": Trunk(32, (
        Stage(True, 3, 1, 1, 32, 32, 4, 0.0),
        Stage(True, 3, 2, 4, 32, 64, 7, 0.0),
        Stage(True, 3, 2, 4, 64, 96, 7, 0.0),
        Stage(False, 3, 2, 4, 96, 192, 10, 0.25),
        Stage(False, 3, 1, 6, 192, 224, 19, 0.25),
        Stage(False, 3, 2, 6, 224, 384, 25, 0.25),
        Stage(False, 3, 1, 6, 384, 640, 7, 0.25)), 1280),
    # every block kind, a stride-1 stage that widens, and (at stride 16) a
    # dilated stage with a residual block
    "efficientnetv2-tiny": Trunk(8, (
        Stage(True, 3, 1, 1, 8, 8, 2, 0.0),
        Stage(True, 3, 2, 4, 8, 16, 2, 0.0),
        Stage(False, 3, 2, 4, 16, 24, 2, 0.25),
        Stage(False, 3, 1, 6, 24, 32, 1, 0.25),
        Stage(False, 3, 2, 6, 32, 40, 2, 0.25),
        Stage(False, 3, 2, 6, 40, 48, 2, 0.25)), 64),
}


def stage_plan(stages, output_stride: int) -> list:
    """-> [(stride, dilation)] of each stage at the output stride: the
    stem's 2 first, a stage's stride dropped, and the dilation doubled, once
    the cumulative stride has reached `output_stride`."""
    current, dilation, plan = 2, 1, []
    for st in stages:
        stride = st.stride
        if stride > 1 and current >= output_stride:
            dilation *= stride
            stride = 1
        elif stride > 1:
            current *= stride
        plan.append((stride, dilation))
    return plan


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class FusedMBConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, dilation: int, expand: int,
                 bn: dict, dtype):
        super().__init__()
        self.expand = expand
        self.residual = stride == 1 and cin == cout
        if expand != 1:
            mid = cin * expand
            self.conv1 = Conv(cin, mid, k, stride, dilation, dtype=dtype)
            self.bn1 = BatchNorm(mid, **bn, dtype=dtype)
            self.conv3 = Conv(mid, cout, 1, dtype=dtype)
        else:
            self.conv3 = Conv(cin, cout, k, stride, dilation, dtype=dtype)
        self.bn3 = BatchNorm(cout, **bn, dtype=dtype)

    def forward(self, x, d: dict):
        if self.expand == 1:
            h = self.bn3(self.conv3(x, d[self.conv3]), act="silu", mul=d.get(self.bn3))
        else:
            h = self.conv1(x, d[self.conv1])
            count(EXPANDED_BYTES, _nbytes(h))
            h = self.conv3(self.bn1(h, act="silu", mul=d.get(self.bn1)), d[self.conv3])
            h = self.bn3(h, mul=d.get(self.bn3))
        return x + h if self.residual else h


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, dilation: int, expand: int,
                 se: float, bn: dict, dtype):
        super().__init__()
        mid = cin * expand
        self.residual = stride == 1 and cin == cout
        self.conv1 = Conv(cin, mid, 1, dtype=dtype)
        self.bn1 = BatchNorm(mid, **bn, dtype=dtype)
        self.conv2 = Conv(mid, mid, k, stride, dilation, dtype=dtype, groups=mid)
        self.bn2 = BatchNorm(mid, **bn, dtype=dtype)
        squeeze = max(1, int(cin * se))
        self.se_reduce = Conv(mid, squeeze, 1, bias=True, dtype=dtype)
        self.se_expand = Conv(squeeze, mid, 1, bias=True, dtype=dtype)
        self.conv3 = Conv(mid, cout, 1, dtype=dtype)
        self.bn3 = BatchNorm(cout, **bn, dtype=dtype)

    def forward(self, x, d: dict):
        h = self.conv1(x, d[self.conv1])
        dw = self.conv2(self.bn1(h, act="silu", mul=d.get(self.bn1)))
        count(EXPANDED_BYTES, _nbytes(h) + _nbytes(dw))
        h = self.bn2(dw, act="silu", mul=d.get(self.bn2))
        with span("effv2.se"):
            g = self.se_reduce(h.mean((2, 3), keepdim=True), d[self.se_reduce])
            g = self.se_expand(F.silu(g), d[self.se_expand])
            h = h * torch.sigmoid(g)
        h = self.bn3(self.conv3(h, d[self.conv3]), mul=d.get(self.bn3))
        return x + h if self.residual else h


def check_supported(cfg: ModelConfig) -> None:
    if cfg.backbone not in TRUNKS:
        raise ValueError(f"unknown EfficientNetV2 trunk {cfg.backbone!r}; known: {sorted(TRUNKS)}")
    if cfg.conv_padding != "same":
        raise ValueError(f"the EfficientNetV2 trunks pad as XLA SAME: conv_padding 'same', got "
                         f"{cfg.conv_padding!r}")
    if cfg.v2_biases:
        raise ValueError("v2_biases places ResNet v2 biases; the EfficientNetV2 trunks have none")


class EfficientNetV2(nn.Module):
    """Fully convolutional EfficientNetV2 trunk: [B,3,S,S] -> features
    [B, top, S / stride, S / stride]."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        trunk = TRUNKS[cfg.backbone]
        bn = {"eps": cfg.bn_epsilon, "momentum": cfg.bn_momentum,
              "group_size": cfg.bn_group_size}
        self.dtype = dtype
        self.stem = Conv(3, trunk.stem, 3, 2, dtype=dtype)
        self.bn_stem = BatchNorm(trunk.stem, **bn, dtype=dtype)
        self.fused_blocks, self.mbconv_blocks = [], []
        for s, (st, (stride, dilation)) in enumerate(
                zip(trunk.stages, stage_plan(trunk.stages, cfg.stride)), start=1):
            for i in range(st.repeats):
                cin, b_stride = (st.cin, stride) if i == 0 else (st.cout, 1)
                if st.fused:
                    block = FusedMBConv(cin, st.cout, st.k, b_stride, dilation, st.expand, bn,
                                        dtype)
                else:
                    block = MBConv(cin, st.cout, st.k, b_stride, dilation, st.expand, st.se, bn,
                                   dtype)
                name = f"stage{s}_block{i + 1}"
                self.add_module(name, block)
                (self.fused_blocks if st.fused else self.mbconv_blocks).append(name)
        self.top = Conv(trunk.stages[-1].cout, trunk.top, 1, dtype=dtype)
        self.bn_top = BatchNorm(trunk.top, **bn, dtype=dtype)
        self.out_channels = trunk.top
        self.dense = [m for m in self.modules() if isinstance(m, Conv) and m.groups == 1]
        self.norms = [m for m in self.modules() if isinstance(m, BatchNorm)]

    def derived(self) -> dict:
        """{module: what its forward derives from its parameters}: each dense
        conv's (weight, bias) in the compute dtype (`Conv.casts`) and, in eval
        mode, each batch norm's multiplier (`BatchNorm.multipliers`), for all
        of them at once: about a dozen launches, where the modules one by one
        would take about 1,100 (EfficientNetV2-L), the same bits. Derived
        anew at every forward; nothing is kept between calls."""
        d = Conv.casts(self.dense)
        if not self.training:
            d.update(BatchNorm.multipliers(self.norms))
        return d

    def forward(self, x):
        d = self.derived()
        x = self.bn_stem(self.stem(x.to(self.dtype), d[self.stem]), act="silu",
                         mul=d.get(self.bn_stem))
        with span("effv2.fused"):
            for name in self.fused_blocks:
                x = getattr(self, name)(x, d)
        with span("effv2.mbconv"):
            for name in self.mbconv_blocks:
                x = getattr(self, name)(x, d)
        return self.bn_top(self.top(x, d[self.top]), act="silu", mul=d.get(self.bn_top))
