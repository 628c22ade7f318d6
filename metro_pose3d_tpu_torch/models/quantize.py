"""Post-training int8 quantization of the serving path
(`metro_pose3d_tpu/models/quantize.py`).

  - weights: symmetric per-output-channel int8, scaled from the float32
    parameters at each call, so any checkpoint serves;
  - activations: symmetric per-tensor int8 with static scales: a calibration
    pass (`calibrate`) records each quantized conv's input scale numerator in
    its `amax` buffer (the flax "quant" collection), as the running max of
    |x| ("calib", `quantize_calib="absmax"`) or of per-batch |x| percentiles
    ("calib:<pct>", `"p<pct>"`); the int8 graph takes sa = max(amax, 1e-6) / 127;
  - compute: int8 x int8 -> int32 convolutions, dequantized by sa * sw[c].

The arithmetic is the reference's, step by step, in float32 and in its
order (`ops/int8.py` holds the kernels and their twins):
  sa  = max(amax, 1e-6) / 127
  xq  = clip(round(x.f32 / sa), -127, 127)               true division, half to even
  sw  = max|W| over (kh, kw, cin) / 127,  swc = max(sw, 1e-12)
  wq  = clip(round(W / swc), -127, 127)
  junction (the fused bottleneck, in the epilogue of the conv before it):
        m = (a * scale_in) / sa,  y = acc.f32 * m + c / sa,  ReLU, round, clip
  dequant: (acc.f32 * (sa * swc)).to(dtype) + bias.to(dtype)

Inference only: `MetroModel(cfg, train=True)` refuses `model.quantize`.
`model.quantize_1x1_dot` and `model.quantize_layout` are validated as the JAX
package validates them and change nothing here: they route the same integer
sums to one of two TPU emitters (a dot or a conv; NHWC or NCHW), which are
bit-exact to each other, and the port has one emitter for each conv class.
"""
from __future__ import annotations

import torch

from metro_pose3d_tpu_torch.models.efficientnet import TRUNKS as EFFICIENTNET_TRUNKS
from metro_pose3d_tpu_torch.models.resnet import BatchNorm, Conv
from metro_pose3d_tpu_torch.ops.int8 import int8_conv, int8_elementwise
from metro_pose3d_tpu_torch.utils.profiling import count, span


class BNAffine(BatchNorm):
    """Batch norm (the same `scale`, `bias`, `mean`, `var`) that can also
    return its inference affine: `affine()` -> (a, c), bn(v) = a * v + c, with
    a = scale * rsqrt(var + eps) and c = bias - a * mean. The fused int8
    bottleneck folds it into a junction; calibration runs it as batch norm."""

    def affine(self):
        a = self.scale * torch.rsqrt(self.var + self.eps)
        return a, self.bias - a * self.mean


def check_backbone(model_cfg) -> None:
    """int8 serving covers the ResNet trunks: an EfficientNetV2 trunk (its
    depthwise convs, squeeze-excitation gates and SiLU junctions have no int8
    form here) with `model.quantize` raises."""
    if model_cfg.quantize != "none" and model_cfg.backbone in EFFICIENTNET_TRUNKS:
        raise ValueError(f"model.quantize={model_cfg.quantize!r} is not ported for the "
                         f"EfficientNetV2 trunk {model_cfg.backbone!r}; it serves in bf16 or "
                         "float32 (model.quantize='none')")


def check_mode(mode: str) -> None:
    if mode == "int8" or mode == "calib":
        return
    if mode.startswith("calib:"):
        float(mode.split(":", 1)[1])
        return
    raise ValueError(f"unknown quantize mode {mode!r}; valid: int8, calib, calib:<pct>")


class QuantConv(Conv):
    """`Conv` (the same `weight`, `bias`) with an `amax` buffer (a float32
    scalar, the flax "quant" collection), in `mode` "int8", "calib" (absmax)
    or "calib:<pct>" (running max of per-batch percentiles of |x|). A
    calibrating conv records from its input and then convolves as `Conv`.
    `calibrate` sets the mode of every conv of a model for its pass.

    int8 `forward(x)` quantizes x (QK2), then convolves and dequantizes in
    one QK1 launch, 1 x 1 convs included. With `out_mode="acc"` it returns
    the int32 accumulator and its per-channel scale sa * swc instead, for a
    junction (`quantize_input` with `pre_affine`). The fused bottleneck
    keeps its int32 sums out of device memory: `requant_out` runs the
    junction into the next conv in QK1's epilogue.
    """

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
                 bias: bool = False, dtype=torch.float32, conv_padding: str = "same",
                 mode: str = "int8"):
        super().__init__(cin, cout, k, stride, dilation, bias, dtype, conv_padding)
        check_mode(mode)
        self.mode = mode
        self.register_buffer("amax", torch.zeros(()))

    def input_scale(self) -> torch.Tensor:
        """sa = max(amax, 1e-6) / 127, a float32 scalar."""
        return torch.clamp_min(self.amax, 1e-6) / 127.0

    def int8_weights(self):
        """-> (wq OHWI int8 [Cout, k, k, Cin], swc float32 [Cout]), made
        anew at each call (span `int8.weights`, counter `int8.weight_bytes`)."""
        with span("int8.weights"):
            w = self.weight.float()
            swc = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
            wq = torch.clamp(torch.round(w / swc.view(-1, 1, 1, 1)), -127.0, 127.0)
            wq = wq.to(torch.int8).permute(0, 2, 3, 1).contiguous()
        count("int8.weight_bytes", wq.numel())
        return wq, swc

    def quantize_input(self, x, pre_affine=None, pre_relu: bool = True) -> torch.Tensor:
        """The int8 input: x quantized by sa, or, with `pre_affine`, the
        junction of the previous conv's (acc, scale) into it."""
        sa = self.input_scale()
        if pre_affine is None:
            return int8_elementwise("quantize", x.contiguous(memory_format=torch.channels_last),
                                    sa)
        acc, scale_in = x
        a, c = pre_affine
        return int8_elementwise("junction", acc, (a * scale_in) / sa, c / sa, relu=pre_relu)

    def conv_acc(self, xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
        """int8 input -> int32 accumulator [B, Cout, OH, OW] channels_last (QK1)."""
        return int8_conv(xq, wq, self.stride, self.dilation, self.pads(*xq.shape[2:]))

    def dequant_out(self, xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor):
        """int8 input -> this conv's output in the compute dtype: QK1 with its
        dequant epilogue."""
        return int8_conv(xq, wq, self.stride, self.dilation, self.pads(*xq.shape[2:]),
                         "dequant", scale, self.bias, out_dtype=self.dtype)

    def forward(self, x, out_mode: str = "dequant"):
        if self.mode != "int8":
            self._record(x)
            return super().forward(x)
        xq = self.quantize_input(x)
        wq, swc = self.int8_weights()
        scale = self.input_scale() * swc
        if out_mode == "acc":
            if self.bias is not None:
                raise ValueError("out_mode='acc' does not support bias")
            return self.conv_acc(xq, wq), scale
        return self.dequant_out(xq, wq, scale)

    def requant_out(self, xq: torch.Tensor, affine, next_conv: "QuantConv") -> torch.Tensor:
        """A conv of the fused bottleneck, int8 in, with the junction into
        `next_conv` in its epilogue (QK1 requant): batch norm's affine (a, c)
        and the ReLU after it, quantized by next_conv's input scale,
        m = (a * (sa * swc)) / sa_next, b = c / sa_next (the JAX junction's
        arithmetic in its order, scale_in = sa * swc first). -> next_conv's
        int8 input."""
        wq, swc = self.int8_weights()
        a, c = affine
        sa_next = next_conv.input_scale()
        m = (a * (self.input_scale() * swc)) / sa_next
        return int8_conv(xq, wq, self.stride, self.dilation, self.pads(*xq.shape[2:]),
                         "requant", m, c / sa_next)

    def forward_int8(self, xq: torch.Tensor) -> torch.Tensor:
        """An input already quantized for this conv (by the previous conv's
        requant epilogue) -> the output in the compute dtype."""
        wq, swc = self.int8_weights()
        return self.dequant_out(xq, wq, self.input_scale() * swc)

    @torch.no_grad()
    def _record(self, x: torch.Tensor) -> None:
        ax = x.abs().float()
        if ":" in self.mode:
            stat = percentile_like_jnp(ax, float(self.mode.split(":", 1)[1]))
        else:
            stat = ax.max()
        self.amax.copy_(torch.maximum(self.amax, stat))


def percentile_like_jnp(x: torch.Tensor, pct: float) -> torch.Tensor:
    """`jnp.percentile(x, pct)` (method "linear") over all of x, as the
    installed jax computes it when called with the percentile as a value, as
    the reference's calibration calls it: XLA folds the division by 100 into
    the position, pos = float32(pct) * ((float32(n) - 1) / 100); its floor
    and ceil, clamped to [0, n - 1], pick two sorted elements, weighted by
    1 - (pos - floor) and pos - floor; all in float32. Above 2**24 elements
    n and the position round, so the elements read are the ones jax reads,
    not the exact percentile's. NaN anywhere gives NaN. (`torch.quantile`
    refuses inputs above 2**24 elements.)"""
    a = x.reshape(-1).float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    last = f32(a.numel()) - 1
    pos = f32(pct) * (last / 100)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lo = int(torch.clamp(low, f32(0), last))
    hi = int(torch.clamp(high, f32(0), last))
    # the two order statistics from the nearer end, by one top-k (selected
    # by many blocks on CUDA, where `kthvalue` works a slice in one block)
    n = a.numel()
    if n - lo <= hi + 1:
        top = torch.topk(a, n - lo, largest=True, sorted=True).values
        lo_v, hi_v = top[n - lo - 1], top[n - hi - 1]
    else:
        bottom = torch.topk(a, hi + 1, largest=False, sorted=True).values
        lo_v, hi_v = bottom[lo], bottom[hi]
    out = lo_v * low_w.to(a.device) + hi_v * high_w.to(a.device)
    return torch.where(torch.isnan(a).any(), torch.full_like(out, float("nan")), out)


def check_1x1_dot_policy(policy: str) -> None:
    """Raise on a `model.quantize_1x1_dot` policy the JAX package refuses
    ("none", "all" and "cin>=N" are valid). The policy routes 1x1 convs to
    one of two TPU emitters of the same integer sums
    (`metro_pose3d_tpu/models/quantize.py::dot_1x1_applies`); the port has
    one, so the policy changes nothing here."""
    if policy not in ("none", "", "all") and not policy.startswith("cin>="):
        raise ValueError(
            f"unknown quantize_1x1_dot policy {policy!r}; valid: none, all, cin>=N")
    if policy.startswith("cin>="):
        try:
            int(policy[5:])
        except ValueError as e:
            raise ValueError(f"bad quantize_1x1_dot threshold {policy!r}") from e


def calib_mode(model_cfg) -> str:
    """The quantize mode of the calibration pass for the config's
    `quantize_calib` estimator ("absmax" -> "calib"; "p99.9" -> "calib:99.9")."""
    est = getattr(model_cfg, "quantize_calib", "absmax")
    if est == "absmax":
        return "calib"
    if est.startswith("p"):
        pct = float(est[1:])
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"quantize_calib percentile out of range: {est!r}")
        return f"calib:{est[1:]}"
    raise ValueError(f"unknown quantize_calib estimator {est!r}")


def calibrate(model, crop_batches, n_batches: int | None = None):
    """Run calibration batches (normalized crops [B, S, S, 3], tensors or
    arrays) through `model` with every `QuantConv` in its calibration mode:
    `model.cfg.quantize` if that is "calib[:<pct>]", else
    `calib_mode(model.cfg)`. Each conv's `amax` takes the running max from
    its current value (0 after init). The modes and the train/eval state are
    restored afterwards. Returns the model."""
    convs = [m for m in model.modules() if isinstance(m, QuantConv)]
    if not convs:
        raise ValueError("calibration needs a model built with model.quantize != 'none'")
    cfg = model.cfg
    mode = cfg.quantize if cfg.quantize.startswith("calib") else calib_mode(cfg)
    device = next(model.parameters()).device
    saved, was_training = [c.mode for c in convs], model.training
    ran = False
    try:
        for c in convs:
            c.mode = mode
        model.eval()
        with torch.no_grad():
            for i, crops in enumerate(crop_batches):
                if n_batches is not None and i >= n_batches:
                    break
                model(torch.as_tensor(crops).to(device))
                ran = True
    finally:
        for c, m in zip(convs, saved):
            c.mode = m
        model.train(was_training)
    if not ran:
        raise ValueError("calibration needs at least one batch")
    return model


def calibrate_on_dataset(cfg, model, dataset, n_batches: int = 8):
    """Calibrate `model` (built with `model.quantize="int8"`, on its device)
    on the dataset's deterministic eval crops, the input distribution it
    will serve: the test split through the loader, K1's warp with its
    `normalize` epilogue (`pipeline.device.device_augment`), then
    `calibrate` over the first `n_batches` batches. Returns the model."""
    from metro_pose3d_tpu_torch.pipeline.device import device_augment
    from metro_pose3d_tpu_torch.pipeline.loader import batch_iterator

    device = next(model.parameters()).device
    it = batch_iterator(
        dataset.test_example, dataset.n_test, dataset.joint_info,
        cfg.eval.batch_size, cfg.model.proc_side, cfg.data.source_side,
        aug_cfg=None, shuffle=False, max_epochs=1, drop_remainder=False,
        n_workers=cfg.data.workers, box_expansion=cfg.data.test_box_expansion,
        pool_type=cfg.data.pool_type, host_prep=cfg.data.host_prep,
    )

    def crops():
        for _, batch in zip(range(n_batches), it):
            tiles = {k: torch.from_numpy(batch[k]).to(device)
                     for k in ("source", "warp_h", "warp_k", "warp_dist")}
            yield device_augment(tiles, cfg.model.proc_side, train=False, out_dtype=model.dtype)

    try:
        return calibrate(model, crops())
    finally:
        it.close()
