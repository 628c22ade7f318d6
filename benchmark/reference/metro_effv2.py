"""Plain PyTorch reference of MeTRo's heads on an EfficientNetV2 trunk, for the
benchmark's correctness checks of the EfficientNetV2 configurations.

The trunk is written from Tan & Le, "EfficientNetV2: Smaller Models and
Faster Training" (ICML 2021, arXiv:2104.00298) and the block strings of
google/automl `efficientnetv2/effnetv2_configs.py` (`v2_l_block`), which the
configuration file holds as automl writes them (`blocks`;
"r4_k3_s1_e1_i32_o32_c1": 4 repeats, kernel 3, stride 1, expansion 1, 32 ->
32 channels, conv type 1, that is Fused-MBConv; "se0.25" a squeeze ratio),
with the stem's and the top's widths (`stem_width`, `top_width`). Every
conv pads as TF SAME and has no bias, each is followed by batch norm, the
activation is SiLU x * sigmoid(x), and a block adds its input where its
stride is 1 and its widths are equal. Fused-MBConv: a k x k conv to e * in with the stride, BN,
SiLU, then a 1x1 conv to out and BN (with e = 1 the k x k conv goes to out
and its BN takes the SiLU). MBConv: 1x1 to e * in, BN, SiLU; depthwise k x k
with the stride, BN, SiLU; squeeze-excitation (mean over H and W, 1x1 with
bias to max(1, int(in * se)), SiLU, 1x1 with bias to e * in, sigmoid, a
product); 1x1 to out, BN. Stem: 3x3 / 2 conv, BN, SiLU; top: 1x1 to 1280,
BN, SiLU.

Departures from the published network, all three the system's too:
  - MeTRo's two 1x1 heads (a J * D metric volume, J 2D maps) take the top's
    features in place of ImageNet's pooling and classifier;
  - output stride `stride` (16 at 256 px): once the stride counted from the
    stem's 2 reaches it, a stage drops its stride, and it and every later
    stage dilate their k > 1 convs, doubling the dilation for each dropped
    stride (at 16: stage 6 drops its stride, stages 6 and 7 dilate by 2);
  - no stochastic depth: it acts in training only, and this is the eval
    forward.

It imports nothing of the system under test; it shares the MeTRo parts
(decode, flip test-time augmentation, reconstruction, the crop warp, the
fp8 control's rounding) with `reference/metro.py`. Precision: float32 with
TF32 off (`no_tf32`); `precision` "fp8" rounds to float8_e4m3 with a
per-tensor scale at each point where a bf16 configuration keeps a value in
bf16 (the crops, each weight, conv output, batch norm output, activation,
squeeze-excitation value and residual sum): the bf16 cell's control. There
is no int8 form.

Layout: NCHW float32. Parameter names: `backbone.stem.weight`,
`backbone.bn_stem.*`, `backbone.stage{s}_block{i}.{conv1,bn1,conv2,bn2,
se_reduce,se_expand,conv3,bn3}.*` (the last conv of a block is `conv3`),
`backbone.top.weight`, `backbone.bn_top.*`, `head3d.*`, `head2d.*`; a batch
norm holds `scale`, `bias`, `mean`, `var`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.metro import (  # noqa: F401  (crops_from_*, LEVELS, no_tf32: the kinds call them)
    LEVELS, _Fp8, bn_eval, crops_from_tiles, crops_from_u8, decode, mirror_mapping, no_tf32,
    reconstruct_absolute, same_pads,
)


def decode_block(text: str) -> dict:
    """automl's block string -> repeats, k, stride, expand, cin, cout, se,
    fused."""
    out = {"se": 0.0, "fused": False}
    for part in text.split("_"):
        if part.startswith("se"):
            out["se"] = float(part[2:])
        elif part[0] == "c":
            out["fused"] = int(part[1:]) == 1
        else:
            key = {"r": "repeats", "k": "k", "s": "stride", "e": "expand", "i": "cin",
                   "o": "cout"}[part[0]]
            out[key] = int(part[1:])
    return out


# ------------------------------------------------------------------ architecture
def blocks(cfg: dict) -> list:
    """Every block in order: dicts of name, fused, k, stride, dilation,
    expand, cin, cout, se, squeeze, residual, in_side, out_side."""
    side = -(-cfg["proc_side"] // 2)  # after the stem
    reached, dilation, out = 2, 1, []
    for s, text in enumerate(cfg["blocks"], start=1):
        b = decode_block(text)
        stride = b["stride"]
        if stride > 1 and reached >= cfg["stride"]:
            dilation, stride = dilation * stride, 1
        elif stride > 1:
            reached *= stride
        for i in range(b["repeats"]):
            cin, st = (b["cin"], stride) if i == 0 else (b["cout"], 1)
            o = -(-side // st)
            out.append(dict(name=f"backbone.stage{s}_block{i + 1}", fused=b["fused"], k=b["k"],
                            stride=st, dilation=dilation, expand=b["expand"], cin=cin,
                            cout=b["cout"], se=b["se"], squeeze=max(1, int(cin * b["se"])),
                            residual=st == 1 and cin == b["cout"], in_side=side, out_side=o))
            side = o
    return out


def conv_specs(cfg: dict) -> list:
    """Every convolution of the trunk in execution order: dicts of name, cin,
    cout, k, stride, dilation, groups, bias, role ("stem", "expand",
    "depthwise", "se_reduce", "se_expand", "project", "top"), in_side,
    out_side (the SE's 1x1 convs run on the pooled 1 x 1 map)."""
    stem_out = -(-cfg["proc_side"] // 2)
    specs = [dict(name="backbone.stem", cin=3, cout=cfg["stem_width"], k=3, stride=2,
                  dilation=1, groups=1, bias=False, role="stem", in_side=cfg["proc_side"],
                  out_side=stem_out)]

    def add(name, cin, cout, k, stride, dilation, role, in_side, out_side, groups=1,
            bias=False):
        specs.append(dict(name=name, cin=cin, cout=cout, k=k, stride=stride, dilation=dilation,
                          groups=groups, bias=bias, role=role, in_side=in_side,
                          out_side=out_side))

    side = stem_out
    for b in blocks(cfg):
        pre, mid, o = b["name"], b["cin"] * b["expand"], b["out_side"]
        if b["fused"] and b["expand"] == 1:
            add(f"{pre}.conv3", b["cin"], b["cout"], b["k"], b["stride"], b["dilation"],
                "project", b["in_side"], o)
        elif b["fused"]:
            add(f"{pre}.conv1", b["cin"], mid, b["k"], b["stride"], b["dilation"], "expand",
                b["in_side"], o)
            add(f"{pre}.conv3", mid, b["cout"], 1, 1, 1, "project", o, o)
        else:
            add(f"{pre}.conv1", b["cin"], mid, 1, 1, 1, "expand", b["in_side"], b["in_side"])
            add(f"{pre}.conv2", mid, mid, b["k"], b["stride"], b["dilation"], "depthwise",
                b["in_side"], o, groups=mid)
            add(f"{pre}.se_reduce", mid, b["squeeze"], 1, 1, 1, "se_reduce", 1, 1, bias=True)
            add(f"{pre}.se_expand", b["squeeze"], mid, 1, 1, 1, "se_expand", 1, 1, bias=True)
            add(f"{pre}.conv3", mid, b["cout"], 1, 1, 1, "project", o, o)
        side = o
    last = blocks(cfg)[-1]["cout"]
    add("backbone.top", last, cfg["top_width"], 1, 1, 1, "top", side, side)
    return specs


def bn_shapes(cfg: dict) -> list:
    """Every batch norm of one crop's forward in order: dicts of name, c,
    side (its input's H = W), act ("silu" or "none")."""
    out = []
    for s in conv_specs(cfg):
        if s["role"] in ("se_reduce", "se_expand"):
            continue
        pre, leaf = s["name"].rsplit(".", 1)
        bn = {"stem": "backbone.bn_stem", "top": "backbone.bn_top"}.get(
            s["role"], f"{pre}.bn{leaf[-1]}")
        fused_e1 = s["role"] == "project" and s["k"] > 1
        act = "none" if s["role"] == "project" and not fused_e1 else "silu"
        out.append(dict(name=bn, c=s["cout"], side=s["out_side"], act=act))
    return out


def feature_channels(cfg: dict) -> int:
    return cfg["top_width"]


def head_side(cfg: dict) -> int:
    return conv_specs(cfg)[-1]["out_side"]


def parameter_shapes(cfg: dict) -> dict:
    """name -> shape of every weight and batch-norm statistic."""
    shapes = {}
    bns = {b["name"]: b["c"] for b in bn_shapes(cfg)}
    for s in conv_specs(cfg):
        shapes[s["name"] + ".weight"] = (s["cout"], s["cin"] // s["groups"], s["k"], s["k"])
        if s["bias"]:
            shapes[s["name"] + ".bias"] = (s["cout"],)
    for name, c in bns.items():
        for leaf in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.{leaf}"] = (c,)
    c, j, d = feature_channels(cfg), cfg["num_joints"], cfg["depth"]
    shapes["head3d.weight"], shapes["head3d.bias"] = (j * d, c, 1, 1), (j * d,)
    shapes["head2d.weight"], shapes["head2d.bias"] = (j, c, 1, 1), (j,)
    return shapes


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one crop's forward: two a multiply-add of every
    convolution (the depthwise and the squeeze-excitation ones included) and
    of both 1x1 heads."""
    macs = sum(s["out_side"] ** 2 * s["cout"] * s["k"] ** 2 * s["cin"] // s["groups"]
               for s in conv_specs(cfg))
    h = head_side(cfg)
    heads = h * h * feature_channels(cfg) * cfg["num_joints"] * (cfg["depth"] + 1)
    return 2 * (macs + heads)


# ------------------------------------------------------------------ forward
def conv(x, w, stride=1, dilation=1, groups=1, bias=None):
    """TF SAME padding, then the convolution."""
    k = w.shape[-1]
    top, bottom = same_pads(x.shape[2], k, stride, dilation)
    left, right = same_pads(x.shape[3], k, stride, dilation)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, bias, stride, 0, dilation, groups)


def silu(x):
    return x * torch.sigmoid(x)


class Forward:
    """One eval forward of the model; `precision` "float32" or "fp8"."""

    def __init__(self, cfg, p, precision="float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"the EfficientNetV2 reference has no {precision!r} form")
        self.cfg, self.p, self.precision = cfg, p, precision
        self.eps = cfg["bn_epsilon"]
        self.specs = {s["name"]: s for s in conv_specs(cfg)}

    def q(self, x):
        """The rounding of a value that a bf16 configuration keeps in bf16."""
        return _Fp8.apply(x) if self.precision == "fp8" else x

    def conv(self, x, name):
        s, q = self.specs[name], self.q
        bias = q(self.p[name + ".bias"]) if s["bias"] else None
        return q(conv(x, q(self.p[name + ".weight"]), s["stride"], s["dilation"], s["groups"],
                      bias))

    def bn(self, x, prefix, act=False):
        y = self.q(bn_eval(x, self.p, prefix, self.eps))
        return self.q(silu(y)) if act else y

    def block(self, x, b):
        pre = b["name"]
        if b["fused"] and b["expand"] == 1:
            h = self.bn(self.conv(x, f"{pre}.conv3"), f"{pre}.bn3", act=True)
        elif b["fused"]:
            h = self.bn(self.conv(x, f"{pre}.conv1"), f"{pre}.bn1", act=True)
            h = self.bn(self.conv(h, f"{pre}.conv3"), f"{pre}.bn3")
        else:
            q = self.q
            h = self.bn(self.conv(x, f"{pre}.conv1"), f"{pre}.bn1", act=True)
            h = self.bn(self.conv(h, f"{pre}.conv2"), f"{pre}.bn2", act=True)
            g = q(h.mean(dim=(2, 3), keepdim=True))
            g = q(silu(self.conv(g, f"{pre}.se_reduce")))
            h = q(h * q(torch.sigmoid(self.conv(g, f"{pre}.se_expand"))))
            h = self.bn(self.conv(h, f"{pre}.conv3"), f"{pre}.bn3")
        return self.q(x + h) if b["residual"] else h

    def __call__(self, crops_nhwc):
        """[B,S,S,3] normalised crops -> (logits3d [B,h,w,D,J], logits2d [B,h,w,J])."""
        x = self.q(crops_nhwc.permute(0, 3, 1, 2).float())
        x = self.bn(self.conv(x, "backbone.stem"), "backbone.bn_stem", act=True)
        for b in blocks(self.cfg):
            x = self.block(x, b)
        feats = self.bn(self.conv(x, "backbone.top"), "backbone.bn_top", act=True)
        b, _, h, w = feats.shape
        j, d = self.cfg["num_joints"], self.cfg["depth"]
        q = self.q
        l3 = q(F.conv2d(feats, q(self.p["head3d.weight"]), q(self.p["head3d.bias"])))
        l2 = q(F.conv2d(feats, q(self.p["head2d.weight"]), q(self.p["head2d.bias"])))
        return l3.permute(0, 2, 3, 1).reshape(b, h, w, d, j), l2.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ serving
def predict(cfg, p, crops_norm, intrinsics, names, precision="float32", amax=None):
    """Normalised crops [B,S,S,3] -> {"pose3d_rootrel", "pose2d_px",
    "pose3d_abs"} with flip test-time augmentation (`amax` is the int8
    calibration's, which this model has not)."""
    b, s = crops_norm.shape[:2]
    both = torch.cat([crops_norm, crops_norm.flip(2)])
    p3, p2 = decode(cfg, *Forward(cfg, p, precision)(both))
    mm = mirror_mapping(list(names))
    p3m = torch.cat([-p3[b:, :, :1], p3[b:, :, 1:]], -1)[:, mm]
    p2m = torch.stack([(s - 1) - p2[b:, :, 0], p2[b:, :, 1]], -1)[:, mm]
    pose3d = 0.5 * (p3[:b] + p3m)
    pose2d = 0.5 * (p2[:b] + p2m)
    root = list(names).index("pelv")
    rel = pose3d - pose3d[:, root:root + 1]
    return {"pose3d_rootrel": rel, "pose2d_px": pose2d,
            "pose3d_abs": reconstruct_absolute(rel, pose2d, intrinsics.float())}
