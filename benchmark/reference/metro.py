"""Plain PyTorch reference of MeTRo (Sarandi et al., FG 2020) on a ResNet v2
backbone, written from the paper's description and the configuration file's
sizes, for the benchmark's correctness checks.

It imports nothing of the system under test. It takes the benchmark's
weights (a dict keyed by the names below) and the benchmark's inputs, and
works out everything else itself: the crop warp, normalisation, the
backbone, both heads, the soft-argmax decode, flip test-time augmentation,
root-relative and absolute poses, the training augmentation, the losses,
the gradient clip and Adam, and, for the int8 serving mode, the calibration
scales and the quantised arithmetic.

Precision: float32 throughout, with TF32 off (`no_tf32`). `precision`
selects how the forward rounds:
  "float32"  not at all;
  "fp8"      at each point where a bf16 configuration keeps a value in
             bf16 (the crops, every weight and output of a convolution,
             batch norm's outputs, the residual sums): the value to
             float8_e4m3 and, in training, its gradient to float8_e5m2, each
             with a per-tensor scale (the bf16 cells' control);
  "int8"     the post-training quantisation of the int8 serving mode, 127
             levels a side; "int4" the same with 7 (its control).

Layout: NCHW float32. Parameter names: `backbone.conv_stem.weight`,
`backbone.stage{s}_block{i}.{bn_pre,proj,conv1,bn1,conv2,bn2,conv3}.*`,
`backbone.bn_final.*`, `head3d.*`, `head2d.*`; a batch norm holds `scale`,
`bias`, `mean`, `var`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3),
          "tiny": (1, 1, 1, 1)}
WIDTHS = {"tiny": 8}  # the first stage's bottleneck width; 64 otherwise
LEVELS = {"int8": 127.0, "int4": 7.0}
FP8_MAX = 448.0  # largest finite float8_e4m3fn
FP8_E5M2_MAX = 57344.0  # largest finite float8_e5m2


@contextlib.contextmanager
def no_tf32():
    """float32 products and convolutions in float32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ architecture
def conv_specs(cfg: dict) -> list:
    """Every convolution of the backbone in execution order:
    dicts of name, cin, cout, k, stride, dilation, role ("stem", "proj",
    "conv1", "conv2", "conv3"). ResNet v2 with each stage's stride on its last
    unit; once the output stride is reached, later stages dilate instead."""
    depths = DEPTHS[cfg["backbone"]]
    base = WIDTHS.get(cfg["backbone"], 64)
    specs = [dict(name="backbone.conv_stem", cin=3, cout=base, k=7, stride=2, dilation=1,
                  role="stem")]
    current, dilation, cin = 4, 1, base
    for s, n in enumerate(depths):
        width = base * 2 ** s
        stride = 2 if s < len(depths) - 1 else 1
        stage_dil = dilation
        if stride > 1 and current >= cfg["stride"]:
            dilation *= stride
            stride = 1
        elif stride > 1:
            current *= stride
        for i in range(n):
            pre = f"backbone.stage{s + 1}_block{i + 1}"
            st = stride if i == n - 1 else 1
            if cin != width * 4:
                specs.append(dict(name=f"{pre}.proj", cin=cin, cout=width * 4, k=1, stride=st,
                                  dilation=1, role="proj"))
            specs += [dict(name=f"{pre}.conv1", cin=cin, cout=width, k=1, stride=1, dilation=1,
                           role="conv1"),
                      dict(name=f"{pre}.conv2", cin=width, cout=width, k=3, stride=st,
                           dilation=stage_dil, role="conv2"),
                      dict(name=f"{pre}.conv3", cin=width, cout=width * 4, k=1, stride=1,
                           dilation=1, role="conv3")]
            cin = width * 4
    return specs


def blocks(cfg: dict) -> list:
    """-> [(prefix, has_proj, stride)] of every bottleneck unit, in order."""
    specs = conv_specs(cfg)
    names = {s["name"] for s in specs}
    return [(s["name"][:-len(".conv2")], s["name"][:-len("conv2")] + "proj" in names,
             s["stride"]) for s in specs if s["role"] == "conv2"]


def feature_channels(cfg: dict) -> int:
    return WIDTHS.get(cfg["backbone"], 64) * 2 ** (len(DEPTHS[cfg["backbone"]]) - 1) * 4


def parameter_shapes(cfg: dict) -> dict:
    """name -> shape of every weight and batch-norm statistic."""
    shapes = {}

    def bn(prefix, c):
        for leaf in ("scale", "bias", "mean", "var"):
            shapes[f"{prefix}.{leaf}"] = (c,)

    for spec in conv_specs(cfg):
        shapes[spec["name"] + ".weight"] = (spec["cout"], spec["cin"], spec["k"], spec["k"])
        pre = spec["name"].rsplit(".", 1)[0]
        if spec["role"] == "conv1":
            bn(f"{pre}.bn_pre", spec["cin"])
            bn(f"{pre}.bn1", spec["cout"])
        elif spec["role"] == "conv2":
            bn(f"{pre}.bn2", spec["cout"])
    c = feature_channels(cfg)
    bn("backbone.bn_final", c)
    j, d = cfg["num_joints"], cfg["depth"]
    shapes["head3d.weight"], shapes["head3d.bias"] = (j * d, c, 1, 1), (j * d,)
    shapes["head2d.weight"], shapes["head2d.bias"] = (j, c, 1, 1), (j,)
    return shapes


def is_statistic(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


# ------------------------------------------------------------------ numerics
def same_pads(size: int, k: int, stride: int, dilation: int):
    """(low, high) padding of XLA's SAME."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _round(x, dtype, top):
    scale = torch.clamp_min(x.abs().amax(), 1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """float8 training's rounding: values to e4m3, their gradients to e5m2,
    each with a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


def conv(x, w, stride=1, dilation=1):
    k = w.shape[-1]
    top, bottom = same_pads(x.shape[2], k, stride, dilation)
    left, right = same_pads(x.shape[3], k, stride, dilation)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, None, stride, 0, dilation)


def bn_eval(x, p, prefix, eps):
    a = torch.rsqrt(p[f"{prefix}.var"] + eps) * p[f"{prefix}.scale"]
    return (x - p[f"{prefix}.mean"].view(1, -1, 1, 1)) * a.view(1, -1, 1, 1) \
        + p[f"{prefix}.bias"].view(1, -1, 1, 1)


def bn_train(x, p, prefix, eps, stats, momentum):
    """Batch statistics as flax takes them (the "fast" variance, clipped at
    0); the running statistics in `stats` move by `momentum`."""
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    y = (x - mean.view(1, -1, 1, 1)) * (torch.rsqrt(var + eps) * p[f"{prefix}.scale"]).view(
        1, -1, 1, 1) + p[f"{prefix}.bias"].view(1, -1, 1, 1)
    with torch.no_grad():
        stats[f"{prefix}.mean"] = momentum * stats[f"{prefix}.mean"] + (1 - momentum) * mean
        stats[f"{prefix}.var"] = momentum * stats[f"{prefix}.var"] + (1 - momentum) * var
    return y


def max_pool_same(x):
    """3x3 window, stride 2, SAME padding filled with -inf."""
    top, bottom = same_pads(x.shape[2], 3, 2, 1)
    left, right = same_pads(x.shape[3], 3, 2, 1)
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)


def percentile(x, pct: float):
    """The linear-interpolation percentile of all of x, with the position
    rounded as float32 computes float32(pct) * ((n - 1) / 100)."""
    a = x.reshape(-1).float()
    n = a.numel()
    last = np.float32(n) - np.float32(1)
    pos = np.float32(pct) * (last / np.float32(100))
    lo, hi = int(np.clip(np.floor(pos), 0, last)), int(np.clip(np.ceil(pos), 0, last))
    w_hi = np.float32(pos - np.floor(pos))
    top = torch.topk(a, n - lo, largest=True, sorted=True).values
    lo_v, hi_v = top[n - lo - 1], top[n - hi - 1]
    return lo_v * float(np.float32(1) - w_hi) + hi_v * float(w_hi)


def weight_quant(w, levels):
    """Symmetric per-output-channel quantisation -> (integer-valued w, scale [Cout])."""
    s = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / levels, 1e-12)
    return torch.clamp(torch.round(w / s.view(-1, 1, 1, 1)), -levels, levels), s


def act_scale(amax, levels):
    return torch.clamp_min(amax, 1e-6) / levels


def act_quant(x, sa, levels):
    return torch.clamp(torch.round(x / sa), -levels, levels)


# ------------------------------------------------------------------ forward
class Forward:
    """One forward pass of the model in eval or train mode.

    `amax` (name -> scalar tensor) holds the calibrated input statistics of
    the quantised convolutions (int8/int4); `record` collects them instead
    (calibration: the float path, each conv's input statistic appended)."""

    def __init__(self, cfg, p, train=False, stats=None, precision="float32", amax=None,
                 record=None):
        self.cfg, self.p, self.train = cfg, p, train
        self.stats, self.precision, self.amax, self.record = stats, precision, amax, record
        self.eps, self.momentum = cfg["bn_epsilon"], cfg["bn_momentum"]
        self.specs = {s["name"]: s for s in conv_specs(cfg)}

    def q(self, x):
        """The rounding of a value that a bf16 configuration keeps in bf16."""
        return _Fp8.apply(x) if self.precision == "fp8" else x

    def bn(self, x, prefix):
        if self.train:
            return self.q(bn_train(x, self.p, prefix, self.eps, self.stats, self.momentum))
        return self.q(bn_eval(x, self.p, prefix, self.eps))

    def conv(self, x, name):
        s = self.specs[name]
        quantised = s["role"] != "stem"  # the stem stays in the float path
        if self.record is not None and quantised:
            self.record.setdefault(name, []).append(percentile(x.abs(), self.cfg["calib_pct"]))
        if self.precision in LEVELS and quantised:
            return self.qconv(x, name)
        return self.q(conv(x, self.q(self.p[name + ".weight"]), s["stride"], s["dilation"]))

    def int_conv(self, q, name):
        """Integer-valued input -> (integer sums, their scale sa * sw [Cout])."""
        s, lv = self.specs[name], LEVELS[self.precision]
        wq, sw = weight_quant(self.p[name + ".weight"], lv)
        acc = conv(q, wq, s["stride"], s["dilation"])
        return acc, (act_scale(self.amax[name], lv) * sw).view(1, -1, 1, 1)

    def qconv(self, x, name):
        """Quantised input, integer products, dequantised by sa * sw."""
        q = act_quant(x, act_scale(self.amax[name], LEVELS[self.precision]),
                      LEVELS[self.precision])
        acc, scale = self.int_conv(q, name)
        return acc * scale

    def junction(self, acc, scale, bn_prefix, next_name):
        """The fused path between two quantised convs: the sums dequantised,
        batch norm's affine, ReLU, quantised for the next conv, as one
        multiply and one add an element: acc * (a * scale / sa') + c / sa'."""
        lv = LEVELS[self.precision]
        p = self.p
        a = p[f"{bn_prefix}.scale"] * torch.rsqrt(p[f"{bn_prefix}.var"] + self.eps)
        c = p[f"{bn_prefix}.bias"] - a * p[f"{bn_prefix}.mean"]
        sa_n = act_scale(self.amax[next_name], lv)
        y = acc * ((a.view(1, -1, 1, 1) * scale) / sa_n) + (c / sa_n).view(1, -1, 1, 1)
        return torch.clamp(torch.round(F.relu(y)), -lv, lv)

    def block(self, x, pre, has_proj, stride):
        h = F.relu(self.bn(x, f"{pre}.bn_pre"))
        shortcut = self.conv(h, f"{pre}.proj") if has_proj else x[:, :, ::stride, ::stride]
        if self.precision in LEVELS:
            lv = LEVELS[self.precision]
            q = act_quant(h, act_scale(self.amax[f"{pre}.conv1"], lv), lv)
            q = self.junction(*self.int_conv(q, f"{pre}.conv1"), f"{pre}.bn1", f"{pre}.conv2")
            q = self.junction(*self.int_conv(q, f"{pre}.conv2"), f"{pre}.bn2", f"{pre}.conv3")
            acc, scale = self.int_conv(q, f"{pre}.conv3")
            return shortcut + acc * scale
        h = F.relu(self.bn(self.conv(h, f"{pre}.conv1"), f"{pre}.bn1"))
        h = F.relu(self.bn(self.conv(h, f"{pre}.conv2"), f"{pre}.bn2"))
        return self.q(shortcut + self.conv(h, f"{pre}.conv3"))

    def __call__(self, crops_nhwc):
        """[B,S,S,3] normalised crops -> (logits3d [B,h,w,D,J], logits2d [B,h,w,J])."""
        x = self.q(crops_nhwc.permute(0, 3, 1, 2).float())
        x = self.conv(x, "backbone.conv_stem")
        x = max_pool_same(x)
        for pre, has_proj, stride in blocks(self.cfg):
            x = self.block(x, pre, has_proj, stride)
        feats = F.relu(self.bn(x, "backbone.bn_final"))
        b, _, h, w = feats.shape
        j, d = self.cfg["num_joints"], self.cfg["depth"]
        q = self.q
        l3 = q(F.conv2d(feats, q(self.p["head3d.weight"]), q(self.p["head3d.bias"])))
        l2 = q(F.conv2d(feats, q(self.p["head2d.weight"]), q(self.p["head2d.bias"])))
        return l3.permute(0, 2, 3, 1).reshape(b, h, w, d, j), l2.permute(0, 2, 3, 1)


def calibrate(cfg, p, crop_batches) -> dict:
    """The serving mode's calibration: each quantised conv's input statistic
    (the `calib_pct` percentile of |x| of each batch), its running max over
    the batches, on the float32 eval forward. -> name -> amax."""
    record = {}
    with torch.no_grad():
        for crops in crop_batches:
            Forward(cfg, p, record=record)(crops)
    return {name: torch.stack(v).amax() for name, v in record.items()}


# ------------------------------------------------------------------ decode
def _expect(marginal):
    n = marginal.shape[1]
    grid = (torch.arange(n, dtype=torch.float32, device=marginal.device) + 0.5) / n
    return (marginal * grid[:, None]).sum(1)


def soft_argmax_3d(logits):
    b, h, w, d, j = logits.shape
    p = torch.softmax(logits.reshape(b, h * w * d, j), dim=1).reshape(b, h, w, d, j)
    pxy = p.sum(3)
    return torch.stack([_expect(pxy.sum(1)), _expect(pxy.sum(2)), _expect(p.sum((1, 2)))], -1)


def soft_argmax_2d(logits):
    b, h, w, j = logits.shape
    p = torch.softmax(logits.reshape(b, h * w, j), dim=1).reshape(b, h, w, j)
    return torch.stack([_expect(p.sum(1)), _expect(p.sum(2))], -1)


def decode(cfg, l3, l2):
    """-> (pose3d mm centred in the metric cube, pose2d crop px)."""
    return ((soft_argmax_3d(l3) - 0.5) * cfg["box_size_mm"],
            soft_argmax_2d(l2) * cfg["proc_side"] - 0.5)


def mirror_mapping(names) -> list:
    out = []
    for n in names:
        other = {"l": "r", "r": "l"}.get(n[0], "") + n[1:] if n[0] in "lr" else n
        out.append(names.index(other) if other in names else names.index(n))
    return out


def reconstruct_absolute(p3, p2, k):
    """Least-squares camera-frame translation of a root-relative metric pose
    from its 2D projection (full perspective), through the 3x3 normal
    equations with a relative Tikhonov term and two refinements."""
    b, j, _ = p3.shape
    fx, fy = k[:, 0, 0][:, None], k[:, 1, 1][:, None]
    cx, cy, skew = k[:, 0, 2][:, None], k[:, 1, 2][:, None], k[:, 0, 1][:, None]
    y = (p2[..., 1] - cy) / fy
    x = (p2[..., 0] - cx - skew * y) / fx
    w = torch.full((b, j), 1.0 / j, device=p3.device)
    bx, by = x * p3[..., 2] - p3[..., 0], y * p3[..., 2] - p3[..., 1]
    sw, swx, swy = w.sum(-1), (w * x).sum(-1), (w * y).sum(-1)
    swxx = (w * (x * x + y * y)).sum(-1)
    z = torch.zeros_like(sw)
    ata = torch.stack([torch.stack([sw, z, -swx], -1), torch.stack([z, sw, -swy], -1),
                       torch.stack([-swx, -swy, swxx], -1)], -2)
    tr = ata[:, 0, 0] + ata[:, 1, 1] + ata[:, 2, 2]
    ata = ata + (1e-6 * tr + 1e-9)[:, None, None] * torch.eye(3, device=p3.device)

    def rhs(rx, ry):
        return torch.stack([(w * rx).sum(-1), (w * ry).sum(-1),
                            (w * (-x * rx - y * ry)).sum(-1)], -1)

    t = torch.linalg.solve(ata, rhs(bx, by))
    for _ in range(2):
        t = t + torch.linalg.solve(ata, rhs(bx - (t[:, 0:1] - x * t[:, 2:3]),
                                            by - (t[:, 1:2] - y * t[:, 2:3])))
    return p3 + t[:, None, :]


# ------------------------------------------------------------------ input side
def normalize(x01):
    return x01 * 2.0 - 1.0


def warp_unit(src_u8, h, kv, dist, side):
    """Crop warp: output pixel (x, y) -> ray H (x, y, 1) -> perspective
    divide -> the source camera's distortion (k1, k2, p1, p2, k3) -> its
    intrinsics -> bilinear sample of the uint8 source, zero outside it and
    where the ray is not in front (z <= 1e-9); -> [B,S,S,3] in [0, 1]."""
    b, th, tw, _ = src_u8.shape
    dev = src_u8.device
    g = torch.arange(side, dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    hm = h.float().reshape(b, 9, 1, 1)
    rx = hm[:, 0] * xs + hm[:, 1] * ys + hm[:, 2]
    ry = hm[:, 3] * xs + hm[:, 4] * ys + hm[:, 5]
    rz = hm[:, 6] * xs + hm[:, 7] * ys + hm[:, 8]
    front = rz > 1e-9
    rz = torch.where(front, rz, torch.ones_like(rz))
    xn, yn = rx / rz, ry / rz
    k1, k2, p1, p2, k3 = (dist[:, i].float().view(b, 1, 1) for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    kv = kv.float()
    u = xd * kv[:, 0].view(b, 1, 1) + kv[:, 2].view(b, 1, 1)
    v = yd * kv[:, 1].view(b, 1, 1) + kv[:, 3].view(b, 1, 1)
    out = bilinear(src_u8.float(), u, v) * front[..., None]
    return out * (1.0 / 255.0)


def bilinear(img, u, v):
    """img [B,H,W,C] float sampled at (u, v) [B,S,S], pixel centres at
    integers, zero outside."""
    b, hh, ww, c = img.shape
    flat = img.reshape(b, hh * ww, c)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    out = 0.0
    for dy, dx, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                       (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
        lin = (torch.where(inside, yi, 0.0) * ww + torch.where(inside, xi, 0.0)).long()
        vals = torch.gather(flat, 1, lin.reshape(b, -1, 1).expand(-1, -1, c)).reshape(
            *lin.shape, c)
        out = out + (wt * inside)[..., None] * vals
    return out


def occlude(crops, bank_u8, params, affine):
    """Paste occluder idx (params[:, 1]) of the uint8 RGBA bank where
    params[:, 0] is 1, through the crop px -> tile px affine."""
    b, s = crops.shape[:2]
    n, t = bank_u8.shape[:2]
    idx = params[:, 1].long()
    on = params[:, 0].float() * ((idx >= 0) & (idx < n)).float()
    tiles = bank_u8[idx.clamp(0, n - 1)].float() * (1.0 / 255.0)
    g = torch.arange(s, dtype=torch.float32, device=crops.device)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    a = affine.float().reshape(b, 6, 1, 1)
    u = a[:, 0] * xs + a[:, 1] * ys + a[:, 2]
    v = a[:, 3] * xs + a[:, 4] * ys + a[:, 5]
    rgba = bilinear(tiles, u, v) * on.view(b, 1, 1, 1)
    alpha = rgba[..., 3:4]
    return crops * (1.0 - alpha) + rgba[..., :3] * alpha


_RGB2YIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                     [0.211, -0.523, 0.312]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def color_jitter(x, cp):
    """Brightness (added), contrast (about 0.5), saturation (about the luma),
    hue (rotation of the YIQ chroma plane); clipped to [0, 1]."""
    br, ct, sat, hue = (cp[:, i].float().view(-1, 1, 1, 1) for i in range(4))
    x = (x + br - 0.5) * ct + 0.5
    luma = (x * torch.tensor([0.299, 0.587, 0.114], device=x.device)).sum(-1, keepdim=True)
    x = luma + (x - luma) * sat
    yiq = torch.einsum("ij,bhwj->bhwi", torch.from_numpy(_RGB2YIQ).to(x.device), x)
    c, s = torch.cos(hue[..., 0]), torch.sin(hue[..., 0])
    i, q = yiq[..., 1] * c - yiq[..., 2] * s, yiq[..., 1] * s + yiq[..., 2] * c
    yiq = torch.stack([yiq[..., 0], i, q], -1)
    rgb = torch.einsum("ij,bhwj->bhwi", torch.from_numpy(_YIQ2RGB).to(x.device), yiq)
    return torch.clamp(rgb, 0.0, 1.0)


def composite(src_u8, mask_u8, bank_u8, params):
    """Replace the background where params[:, 0] is 1: source * alpha +
    bank[params[:, 1]] * (1 - alpha), rounded half to even to uint8."""
    on = params[:, 0].float().view(-1, 1, 1, 1)
    idx = params[:, 1].long().clamp(0, bank_u8.shape[0] - 1)
    src = src_u8.float()
    alpha = (mask_u8.float() / 255.0)[..., None]
    out = src * alpha + bank_u8[idx].float() * (1.0 - alpha)
    return torch.clamp(torch.round(src + on * (out - src)), 0, 255)


# ------------------------------------------------------------------ serving
def predict(cfg, p, crops_norm, intrinsics, names, precision="float32", amax=None):
    """Normalised crops [B,S,S,3] -> {"pose3d_rootrel", "pose2d_px",
    "pose3d_abs"} with flip test-time augmentation."""
    b, s = crops_norm.shape[:2]
    fwd = Forward(cfg, p, precision=precision, amax=amax)
    both = torch.cat([crops_norm, crops_norm.flip(2)])
    p3, p2 = decode(cfg, *fwd(both))
    mm = mirror_mapping(list(names))
    p3m = torch.cat([-p3[b:, :, :1], p3[b:, :, 1:]], -1)[:, mm]
    p2m = torch.stack([(s - 1) - p2[b:, :, 0], p2[b:, :, 1]], -1)[:, mm]
    pose3d = 0.5 * (p3[:b] + p3m)
    pose2d = 0.5 * (p2[:b] + p2m)
    root = list(names).index("pelv")
    rel = pose3d - pose3d[:, root:root + 1]
    return {"pose3d_rootrel": rel, "pose2d_px": pose2d,
            "pose3d_abs": reconstruct_absolute(rel, pose2d, intrinsics.float())}


def crops_from_u8(crops_u8):
    return normalize(crops_u8.float() / 255.0)


def crops_from_tiles(batch, side):
    return normalize(warp_unit(batch["source"], batch["warp_h"], batch["warp_k"],
                               batch["warp_dist"], side))


# ------------------------------------------------------------------ training
def augment(cfg, batch, occ_bank, bg_bank):
    src = batch["source"]
    if bg_bank is not None and "source_mask" in batch:
        src = composite(src, batch["source_mask"], bg_bank, batch["bg_params"])
    x = warp_unit(src, batch["warp_h"], batch["warp_k"], batch["warp_dist"], cfg["proc_side"])
    if occ_bank is not None:
        x = occlude(x, occ_bank, batch["occ_params"], batch["occ_affine"])
    return normalize(color_jitter(x, batch["color_params"]))


def losses(cfg, l3, l2, batch, root):
    """L1 of root-relative metric joints (m) under 3D validity, plus the
    weighted L1 of 2D joints / crop side under 2D validity."""
    p3, p2 = decode(cfg, l3, l2)
    rel = p3 - p3[:, root:root + 1]
    gt = batch["coords3d_true"].float()
    gt_rel = gt - gt[:, root:root + 1]
    mask_root = torch.ones(gt.shape[1], device=gt.device)
    mask_root[root] = 0.0
    m3 = batch["joint_validity"].float() * batch["is_3d"].float()[:, None]
    e3 = (rel - gt_rel).abs().mean(-1) * mask_root
    l3d = (e3 * m3).sum() / torch.clamp(m3.sum(), min=1.0) / 1000.0
    m2 = batch["joint_validity_2d"].float()
    e2 = (p2 - batch["coords2d_true"].float()).abs().mean(-1) / cfg["proc_side"]
    l2d = (e2 * m2).sum() / torch.clamp(m2.sum(), min=1.0)
    return l3d + cfg["loss_2d_weight"] * l2d


def learning_rate(cfg, count: int) -> float:
    """Linear warm-up from 0, then exponential decay (not staircased)."""
    base, warm = cfg["base_lr"], cfg["warmup_steps"]
    if count < warm:
        return base * count / warm
    c = count - warm
    return base if c <= 0 else base * cfg["lr_decay_rate"] ** (c / cfg["lr_decay_steps"])


def train_steps(cfg, weights, batches, occ_bank, bg_bank, root, start_step,
                precision="float32"):
    """Steps of batch-statistics training from `weights`, one per batch:
    augmentation, forward, losses, gradients, the global-norm clip (no
    epsilon), Adam (0.9, 0.999, 1e-8). -> {"losses": [...], "grad_norms": [the
    unclipped global norm of each step], "first_grads":
    {name: clipped gradient of step 1}, "params": {name: after the last step}}."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in weights.items() if not is_statistic(k)}
    stats = {k: v.detach().clone().float() for k, v in weights.items() if is_statistic(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "grad_norms": []}
    for t, batch in enumerate(batches, start=1):
        with torch.no_grad():
            crops = augment(cfg, batch, occ_bank, bg_bank)
        l3, l2 = Forward(cfg, {**params, **stats}, train=True, stats=stats,
                         precision=precision)(crops)
        loss = losses(cfg, l3, l2, batch, root)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            out["grad_norms"].append(float(norm))
            clip = cfg["grad_clip_norm"]
            if clip > 0 and norm >= clip:
                grads = [g / norm * clip for g in grads]
            if t == 1:
                out["first_grads"] = {k: g.clone() for k, g in zip(params, grads)}
            lr = learning_rate(cfg, start_step + t - 1)
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                mhat = m[k] / (1 - 0.9 ** t)
                vhat = v2[k] / (1 - 0.999 ** t)
                p -= lr * mhat / (torch.sqrt(vhat) + 1e-8)
        del l3, l2, loss, grads, crops
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out
