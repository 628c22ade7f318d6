"""ResNet backbone with a dilated final stage: v2 (pre-activation) or v1.5,
bottleneck or basic blocks, in three padding conventions.

Port of `metro_pose3d_tpu/models/resnet.py`: resnet50/101/152 and tiny
(bottleneck), resnet18/34 (basic block); `preactivation` True (v2) or False
(v1.5: `bn_stem` + ReLU before the pool, BN after every conv, ReLU after
the add, no `bn_final`); `conv_padding` "same" | "torch" | "keras"; either
`stride_position`; `v2_biases` (bias on the stem and on the convs that no BN
follows); the int8 serving path (`model.quantize`, `models/quantize.py`):
its convs are `QuantConv`s with the same parameter names and an `amax`
buffer each, in the stages of `quantize_stages`, with the stem and heads
under `quantize_extras`, and the fused pre-activation bottleneck under
`quantize_fused`. The space-to-depth stem is not ported.
Parameters are float32 and cast to the compute dtype inside each op, as
flax does with `param_dtype=float32`; batch norm follows `module.train()` /
`.eval()`.
Module and parameter names follow the flax tree (`conv_stem`, `bn_stem`,
`stage{s}_block{i}.{bn_pre,proj,bn_proj,conv1..3,bn1..3}`, `bn_final`), so a
flax checkpoint converts by name (`metro_pose3d_tpu_torch/convert.py`).

Tensors are NCHW in `torch.channels_last` memory format (NHWC in memory).
With "same", convolutions pad like XLA "SAME": for stride 2 the pad is
uneven (7x7/2: 2 low, 3 high; 3x3/2 on even inputs: 0 low, 1 high), which
torch's `padding="same"` refuses, so those convs pad explicitly first. With
"torch" or "keras" a strided conv with k > 1 pads (k-1)//2 * dilation on both
sides, as torchvision and Keras do, which shifts its output grid by one
pixel; the stem pool follows with the window of the same name
(`ops/pool.py`). The two differ only in the pool's pad value.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from metro_pose3d_tpu_torch.config import ModelConfig
from metro_pose3d_tpu_torch.ops import bn as bn_op
from metro_pose3d_tpu_torch.ops.dwconv import depthwise_conv
from metro_pose3d_tpu_torch.ops.pool import stem_max_pool
from metro_pose3d_tpu_torch.parallel import mesh

RESNET_DEPTHS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "tiny": (1, 1, 1, 1),  # for tests
}
# Backbones that use the basic (two 3x3) block instead of the bottleneck.
BASIC_BLOCK = {"resnet18", "resnet34"}
CONV_PADDINGS = ("same", "torch", "keras")
BASE_WIDTHS = {"tiny": 8}  # default 64


def _same_pads(size: int, k: int, stride: int, dilation: int):
    """(low, high) XLA SAME padding of one spatial dimension."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Square convolution (flax `nn.Conv` semantics): float32 `weight` and
    `bias`, cast to the compute dtype in `forward`. Padding is XLA SAME,
    except that with `conv_padding` "torch" or "keras" a strided conv with
    k > 1 pads (k-1)//2 * dilation on both sides (`_conv_pad` in the JAX
    package). With `groups` = cin = cout > 1 (the depthwise conv of an
    MBConv block, no bias) it runs `ops/dwconv.py::depthwise_conv`: the
    port's kernel on CUDA, its plain twin on the CPU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
                 bias: bool = False, dtype=torch.float32, conv_padding: str = "same",
                 groups: int = 1):
        super().__init__()
        self.k, self.stride, self.dilation, self.dtype = k, stride, dilation, dtype
        if groups > 1 and (groups != cin or cin != cout or bias):
            raise ValueError(f"a grouped conv is depthwise here (groups = cin = cout, no bias), "
                             f"got groups {groups}, {cin} -> {cout}, bias {bias}")
        self.groups = groups
        self.symmetric = conv_padding in ("torch", "keras") and stride > 1 and k > 1
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def pads(self, h: int, w: int):
        """(top, bottom, left, right) zero padding for an h x w input."""
        if self.symmetric:
            p = (self.k - 1) // 2 * self.dilation
            return p, p, p, p
        return (*_same_pads(h, self.k, self.stride, self.dilation),
                *_same_pads(w, self.k, self.stride, self.dilation))

    @staticmethod
    def casts(convs) -> dict:
        """{conv: (weight, bias)} of the dense convs `convs` (one compute
        dtype) in that dtype, cast in one pass: a cat of their float32
        parameters and one cast, the same bits as each conv's own. A trunk
        of several hundred small convs (EfficientNetV2) casts so at each
        forward, where a cast a parameter would take as many launches."""
        dtypes = {m.dtype for m in convs}
        if len(dtypes) != 1 or any(m.groups > 1 for m in convs):
            raise ValueError(f"Conv.casts takes dense convs of one dtype, got {dtypes}")
        params = [p for m in convs for p in (m.weight, m.bias) if p is not None]
        flat = torch.cat([p.reshape(-1) for p in params]).to(dtypes.pop())
        cast = iter([t.view(p.shape) for t, p in zip(flat.split([p.numel() for p in params]),
                                                     params)])
        return {m: (next(cast), None if m.bias is None else next(cast)) for m in convs}

    def forward(self, x, cast=None):
        """`cast`: (weight, bias) already in the compute dtype, where the
        caller cast them with other convs' (`Conv.casts`)."""
        if self.groups > 1:
            return depthwise_conv(x, self.weight, self.stride, self.dilation,
                                  self.pads(*x.shape[2:]))
        if cast is None:
            cast = self.weight.to(self.dtype), None if self.bias is None else self.bias.to(
                self.dtype)
        weight, bias = cast
        top, bottom, left, right = self.pads(*x.shape[2:])
        if (top, left) == (bottom, right):
            return F.conv2d(x, weight, bias, self.stride, (top, left), self.dilation)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, weight, bias, self.stride, 0, self.dilation)


class BatchNorm(nn.Module):
    """Batch norm with flax's parameter names and arithmetic, in float32,
    cast to the compute dtype at the end.

    eval(): the running statistics, (x - mean) * (rsqrt(var + eps) * scale)
    + bias (flax `nn.BatchNorm`), through `ops/bn.py::batch_norm_act`: the
    plain chain on the CPU, one kernel on CUDA; x must be in the compute
    dtype (TypeError otherwise, on every device).
    train(): the batch moments as flax computes them, mean(x) and the "fast"
    variance max(mean(x^2) - mean^2, 0), with gradients through both; the
    running statistics become m * ra + (1 - m) * batch with m = momentum and
    the biased variance (`F.batch_norm` would take 1 - m and the unbiased
    variance). With `group_size > 0` (ghost BN, `GhostBatchNorm` in the JAX
    package) each group of examples normalises with its own moments, in that
    module's order and without the clip, and the running statistics get the
    full-batch moments composed from the groups.
    Where a `torch.distributed` process group is up, "the batch" is the
    global batch, as under the JAX package's data mesh: the moments are
    summed over the ranks (`parallel/mesh.py`), so the running statistics
    stay the same on every rank, and ghost BN groups are groups of the
    global batch, as in the JAX package: a group may take rows of several
    ranks. Without a group no collective is issued.
    `forward(x, act=...)` applies the activation `act` to the result:
    "none", "relu" (F.relu, the ResNet trunks) or "silu" (F.silu, the
    EfficientNetV2 trunk), in eval mode in the same pass.
    """

    def __init__(self, c: int, eps: float, momentum: float = 0.99, group_size: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.eps, self.momentum, self.group_size, self.dtype = eps, momentum, group_size, dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    @staticmethod
    def _multiplier(var, scale, eps: float):
        return torch.rsqrt(var + eps) * scale

    @staticmethod
    def multipliers(norms) -> dict:
        """{norm: rsqrt(var + eps) * scale} of the batch norms `norms` (one
        eps), eval mode's multipliers, computed in one pass over their
        concatenated vectors: the same bits as each module's own."""
        eps = {m.eps for m in norms}
        if len(eps) != 1:
            raise ValueError(f"BatchNorm.multipliers takes batch norms of one eps, got {eps}")
        mul = BatchNorm._multiplier(torch.cat([m.var for m in norms]),
                                    torch.cat([m.scale for m in norms]), eps.pop())
        return dict(zip(norms, mul.split([m.var.numel() for m in norms])))

    def forward(self, x, act: str = "none", mul=None):
        """`mul`: eval mode's multiplier, where the caller computed it with
        other batch norms' (`BatchNorm.multipliers`)."""
        if not self.training:
            if x.dtype != self.dtype:
                raise TypeError(f"eval batch norm takes its compute dtype {self.dtype}, got "
                                f"{x.dtype}")
            if mul is None:
                mul = self._multiplier(self.var, self.scale, self.eps)
            return bn_op.batch_norm_act(x, self.mean, mul, self.bias, act)
        if mul is not None:
            raise ValueError("a multiplier is eval mode's; train mode computes the batch's")
        bn_op.check_act(act)
        shape = (1, -1, 1, 1)
        xf = x.float()
        if self.group_size > 0:
            y, mean, var = self._ghost(xf)
        else:
            mean, mean2 = self._moments(xf)
            var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
            mul = torch.rsqrt(var + self.eps) * self.scale
            y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return bn_op.activation(y.to(self.dtype), act)

    @staticmethod
    def _moments(xf):
        """-> (mean(x), mean(x^2)) per channel over the batch: the global
        batch where a process group is up (each rank's sums, summed over the
        ranks with gradients, over the global count)."""
        if not mesh.in_group():
            return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
        c = xf.shape[1]
        count = xf.new_full((1,), float(xf.numel() // c))
        sums = mesh.global_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                          (xf * xf).sum(dim=(0, 2, 3)), count]))
        return sums[:c] / sums[-1], sums[c:-1] / sums[-1]

    def _ghost(self, xf):
        """-> (normalised x, full-batch mean, full-batch variance), with the
        JAX package's rule over the global batch of B rows (rank r holds rows
        [r b, (r + 1) b), as `parallel/distributed.py::local_batch_slice`
        deals them): groups of gs = min(group_size, B) rows, ValueError
        unless gs divides B. Where gs divides the local batch every group
        lies inside one rank (always so without a process group): the groups
        are normalised on the rank, and one collective, without gradients,
        gathers their moments for the running statistics. Otherwise
        `_spanning_groups` sums each group's moments over the ranks."""
        b = xf.shape[0]
        rank, world = mesh.process_index_count()
        total = b * world
        gs = min(self.group_size, total)
        if total % gs:
            raise ValueError(f"batch {total} not divisible by bn group size {gs}")
        if b % gs:
            return self._spanning_groups(xf, rank * b, gs, total // gs)
        xg = xf.reshape(b // gs, gs, *xf.shape[1:])
        gmean = xg.mean(dim=(1, 3, 4))  # [G, C]
        gmean2 = (xg * xg).mean(dim=(1, 3, 4))
        gvar = gmean2 - gmean * gmean
        mean = gmean.repeat_interleave(gs, dim=0)[:, :, None, None]
        var = gvar.repeat_interleave(gs, dim=0)[:, :, None, None]
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        if not mesh.in_group():
            full_mean = gmean.mean(dim=0)
            return y, full_mean, gmean2.mean(dim=0) - full_mean * full_mean
        with torch.no_grad():
            c = xf.shape[1]
            n_groups = xf.new_full((1,), float(b // gs))
            sums = mesh.global_sum(torch.cat([gmean.sum(dim=0), gmean2.sum(dim=0), n_groups]))
            full_mean = sums[:c] / sums[-1]
            return y, full_mean, sums[c:-1] / sums[-1] - full_mean * full_mean

    def _spanning_groups(self, xf, first: int, gs: int, n_groups: int):
        """Ghost BN where groups cross rank boundaries: this rank's rows are
        global rows [first, first + b). Each rank writes the sums of x and
        x^2 and the element count of its share of every group into one
        [G, 2C + 1] buffer (zero for the groups it holds no row of); one
        `global_sum`, with gradients, adds the buffers; every row normalises
        with its own group's moments, and the running statistics take the
        mean of the G groups' moments, as the JAX package's do."""
        b, c, h, w = xf.shape
        g0, g1 = first // gs, (first + b - 1) // gs  # the groups of this rank's rows
        spans = [(max(g * gs, first) - first, min((g + 1) * gs, first + b) - first)
                 for g in range(g0, g1 + 1)]
        parts = []
        for lo, hi in spans:
            seg = xf[lo:hi]
            parts.append(torch.cat([seg.sum(dim=(0, 2, 3)), (seg * seg).sum(dim=(0, 2, 3)),
                                    xf.new_full((1,), float((hi - lo) * h * w))]))
        sums = mesh.global_sum(torch.cat([xf.new_zeros(g0, 2 * c + 1), torch.stack(parts),
                                          xf.new_zeros(n_groups - 1 - g1, 2 * c + 1)]))
        gmean = sums[:, :c] / sums[:, -1:]  # [G, C]
        gmean2 = sums[:, c:-1] / sums[:, -1:]
        gvar = gmean2 - gmean * gmean
        view = (1, -1, 1, 1)
        y = torch.cat([(xf[lo:hi] - gmean[g0 + i].view(view))
                       * torch.rsqrt(gvar[g0 + i] + self.eps).view(view)
                       for i, (lo, hi) in enumerate(spans)])
        y = y * self.scale.view(view) + self.bias.view(view)
        with torch.no_grad():
            full_mean = gmean.mean(dim=0)
            return y, full_mean, gmean2.mean(dim=0) - full_mean * full_mean


QUANTIZE_LAYOUTS = ("nhwc", "nchw")


def parse_quantize_extras(extras: str) -> frozenset:
    """Validate `model.quantize_extras` ("" or csv of stem/heads)."""
    toks = frozenset(t.strip() for t in extras.split(",") if t.strip())
    unknown = toks - {"stem", "heads"}
    if unknown:
        raise ValueError(
            f"unknown quantize_extras {sorted(unknown)}; valid: stem, heads")
    return toks


def _make_conv(cin, cout, k, stride=1, dilation=1, bias=False, dtype=torch.float32,
               conv_padding="same", quantize="none"):
    """Block conv factory: `Conv`, or the int8 / calibration `QuantConv`
    (`models/quantize.py`) with the same parameter names."""
    if quantize == "none":
        return Conv(cin, cout, k, stride, dilation, bias, dtype, conv_padding)
    from metro_pose3d_tpu_torch.models.quantize import QuantConv

    return QuantConv(cin, cout, k, stride, dilation, bias, dtype, conv_padding, mode=quantize)


def _shortcut(x, strides: int):
    """A strided unit that keeps its width subsamples, it does not project."""
    return x if strides == 1 else x[:, :, ::strides, ::strides]


class Bottleneck(nn.Module):
    """Bottleneck unit: pre-activation (ResNet v2) or post-activation (v1.5)."""

    def __init__(self, cin: int, features: int, strides: int, dilation: int,
                 bn: dict, dtype, preact: bool = True, conv_padding: str = "same",
                 v2_biases: bool = False, quantize: str = "none", quantize_fused: bool = True):
        super().__init__()
        out = features * 4
        self.out_channels = out
        self.strides, self.preact = strides, preact
        self.change = cin != out
        # int8: the two junctions inside a pre-activation unit run fused
        # (dequant, BN affine, ReLU and requant in one elementwise pass), and
        # the activations between its convs stay int8; the residual stream
        # stays in the compute dtype
        self.fused = preact and quantize != "none" and quantize_fused
        conv = dict(dtype=dtype, conv_padding=conv_padding, quantize=quantize)
        inner_bn = BatchNorm
        if self.fused:
            from metro_pose3d_tpu_torch.models.quantize import BNAffine as inner_bn
        if preact:
            self.bn_pre = BatchNorm(cin, **bn, dtype=dtype)
        if self.change:
            self.proj = _make_conv(cin, out, 1, strides, bias=preact and v2_biases, **conv)
            if not preact:
                self.bn_proj = BatchNorm(out, **bn, dtype=dtype)
        self.conv1 = _make_conv(cin, features, 1, **conv)
        self.bn1 = inner_bn(features, **bn, dtype=dtype)
        self.conv2 = _make_conv(features, features, 3, strides, dilation, **conv)
        self.bn2 = inner_bn(features, **bn, dtype=dtype)
        self.conv3 = _make_conv(features, out, 1, bias=preact and v2_biases, **conv)
        if not preact:
            self.bn3 = BatchNorm(out, **bn, dtype=dtype)

    def forward(self, x):
        if self.preact:
            h = self.bn_pre(x, act="relu")
            shortcut = self.proj(h) if self.change else _shortcut(x, self.strides)
            if self.fused and self.conv1.mode == "int8":  # not while calibrating
                # quantize (QK2) -> conv1 with junction 1 in its epilogue ->
                # conv2 with junction 2 in its epilogue -> conv3 dequant, all
                # QK1: no int32 sum reaches device memory
                h = self.conv1.requant_out(self.conv1.quantize_input(h), self.bn1.affine(),
                                           self.conv2)
                h = self.conv2.requant_out(h, self.bn2.affine(), self.conv3)
                return shortcut + self.conv3.forward_int8(h)
            h = self.bn1(self.conv1(h), act="relu")
            h = self.bn2(self.conv2(h), act="relu")
            return shortcut + self.conv3(h)
        shortcut = self.bn_proj(self.proj(x)) if self.change else _shortcut(x, self.strides)
        h = self.bn1(self.conv1(x), act="relu")
        h = self.bn2(self.conv2(h), act="relu")
        h = self.bn3(self.conv3(h))
        return F.relu(shortcut + h)


class BasicBlock(nn.Module):
    """Basic unit (two 3x3 convs) of resnet18/34, pre- or post-activation."""

    def __init__(self, cin: int, features: int, strides: int, dilation: int,
                 bn: dict, dtype, preact: bool = True, conv_padding: str = "same",
                 v2_biases: bool = False, quantize: str = "none", quantize_fused: bool = True):
        super().__init__()
        self.out_channels = features
        self.strides, self.preact = strides, preact
        self.change = cin != features
        # int8 junctions stay unfused here, as in the JAX package
        conv = dict(dtype=dtype, conv_padding=conv_padding, quantize=quantize)
        if preact:
            self.bn_pre = BatchNorm(cin, **bn, dtype=dtype)
        if self.change:
            self.proj = _make_conv(cin, features, 1, strides, bias=preact and v2_biases, **conv)
            if not preact:
                self.bn_proj = BatchNorm(features, **bn, dtype=dtype)
        self.conv1 = _make_conv(cin, features, 3, strides, dilation, **conv)
        self.bn1 = BatchNorm(features, **bn, dtype=dtype)
        self.conv2 = _make_conv(features, features, 3, 1, dilation, bias=preact and v2_biases,
                                **conv)
        if not preact:
            self.bn2 = BatchNorm(features, **bn, dtype=dtype)

    def forward(self, x):
        if self.preact:
            h = self.bn_pre(x, act="relu")
            shortcut = self.proj(h) if self.change else _shortcut(x, self.strides)
            h = self.bn1(self.conv1(h), act="relu")
            return shortcut + self.conv2(h)
        shortcut = self.bn_proj(self.proj(x)) if self.change else _shortcut(x, self.strides)
        h = self.bn1(self.conv1(x), act="relu")
        h = self.bn2(self.conv2(h))
        return F.relu(shortcut + h)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.backbone not in RESNET_DEPTHS:
        raise ValueError(f"unknown backbone {cfg.backbone!r}; known: {sorted(RESNET_DEPTHS)}")
    if cfg.conv_padding not in CONV_PADDINGS:
        raise ValueError(f"unknown conv_padding {cfg.conv_padding!r}; known: {CONV_PADDINGS}")
    # the JAX package's checks of the quantize fields, with its messages
    if cfg.quantize_layout not in QUANTIZE_LAYOUTS:
        raise ValueError(f"unknown quantize_layout {cfg.quantize_layout!r}")
    parse_quantize_extras(cfg.quantize_extras)
    if cfg.quantize == "none":
        return
    from metro_pose3d_tpu_torch.models.quantize import check_1x1_dot_policy, check_mode

    check_mode(cfg.quantize)
    _quantized_stages(cfg)
    if cfg.quantize == "int8":
        check_1x1_dot_policy(cfg.quantize_1x1_dot)
        if cfg.quantize_layout == "nchw" and cfg.quantize_stages != "all":
            raise ValueError(
                "quantize_layout='nchw' transposes the whole trunk once; mixed bf16/int8 "
                "stages would need per-stage transposes - use quantize_stages='all' "
                "(or layout='nhwc')")
        if cfg.quantize_layout == "nchw" and cfg.backbone in BASIC_BLOCK:
            raise ValueError("quantize_layout='nchw' supports bottleneck variants only")


def _quantized_stages(cfg: ModelConfig):
    """The 1-based stage numbers whose convs are quantized ("all" or csv)."""
    if cfg.quantize_stages == "all":
        return range(1, len(RESNET_DEPTHS[cfg.backbone]) + 1)
    return {int(s) for s in cfg.quantize_stages.split(",") if s}


class ResNet(nn.Module):
    """Fully convolutional ResNet trunk: [B,3,S,S] -> features."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        depths = RESNET_DEPTHS[cfg.backbone]
        base = BASE_WIDTHS.get(cfg.backbone, 64)
        bn = {"eps": cfg.bn_epsilon, "momentum": cfg.bn_momentum,
              "group_size": cfg.bn_group_size}
        block_cls = BasicBlock if cfg.backbone in BASIC_BLOCK else Bottleneck
        self.dtype, self.preact = dtype, cfg.preactivation
        # the pool's alignment follows the convs' padding
        self.pool_mode = cfg.conv_padding
        # the stem joins the int8 graph only under quantize_extras "stem":
        # its input is the normalized crop, roughly zero-mean, so symmetric
        # int8 uses the full signed range there
        stem_quant = (cfg.quantize if "stem" in parse_quantize_extras(cfg.quantize_extras)
                      else "none")
        self.conv_stem = _make_conv(3, base, 7, 2, bias=cfg.v2_biases, dtype=dtype,
                                    conv_padding=cfg.conv_padding, quantize=stem_quant)
        if not self.preact:
            self.bn_stem = BatchNorm(base, **bn, dtype=dtype)

        # Stage strides for the output stride: once the cumulative stride
        # reaches it, later stages dilate instead. With "last" (TF slim v2)
        # each stage downsamples in its last unit, and a stage whose stride
        # is dropped still runs at the previous rate; with "first"
        # (torchvision) stage s > 1 downsamples in its first unit.
        current_stride, dilation = 4, 1
        last_pos = cfg.stride_position == "last"
        quantized = _quantized_stages(cfg) if cfg.quantize != "none" else ()
        self.blocks = []
        cin = base
        for stage, n_blocks in enumerate(depths):
            features = base * 2 ** stage
            if last_pos:
                stage_stride = 2 if stage < len(depths) - 1 else 1
            else:
                stage_stride = 1 if stage == 0 else 2
            stage_dil = dilation
            if stage_stride > 1 and current_stride >= cfg.stride:
                dilation *= stage_stride
                if not last_pos:
                    stage_dil = dilation
                stage_stride = 1
            elif stage_stride > 1:
                current_stride *= stage_stride
            strided_unit = n_blocks - 1 if last_pos else 0
            stage_quant = cfg.quantize if stage + 1 in quantized else "none"
            for i in range(n_blocks):
                name = f"stage{stage + 1}_block{i + 1}"
                block = block_cls(cin, features, stage_stride if i == strided_unit else 1,
                                  stage_dil, bn, dtype, preact=self.preact,
                                  conv_padding=cfg.conv_padding, v2_biases=cfg.v2_biases,
                                  quantize=stage_quant, quantize_fused=cfg.quantize_fused)
                self.add_module(name, block)
                self.blocks.append(name)
                cin = block.out_channels
        if self.preact:  # v2: final BN + ReLU
            self.bn_final = BatchNorm(cin, **bn, dtype=dtype)
        self.out_channels = cin

    def forward(self, x):
        x = self.conv_stem(x.to(self.dtype))
        if not self.preact:
            x = self.bn_stem(x, act="relu")
        x = stem_max_pool(x, self.pool_mode)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.bn_final(x, act="relu") if self.preact else x
