"""Shapes of the work, from the configuration's sizes and the traffic's
batch: what the model FLOPs and the kernels' rooflines are counted from."""
from __future__ import annotations

from harness import spec
from reference.metro import conv_specs, feature_channels

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def rows(cfg: dict, traffic: dict) -> int:
    """Crops the backbone sees an iteration (the traffic's kind says)."""
    return spec.kind(traffic["kind"]).rows(cfg, traffic)


def items(traffic: dict) -> int:
    """Crops a user gets an iteration."""
    return spec.kind(traffic["kind"]).items(traffic)


def crop_bytes(cfg: dict, traffic: dict) -> int:
    """Bytes of a crop element as the crop warp (K1) writes it."""
    return DTYPE_BYTES[spec.kind(traffic["kind"]).crop_dtype(cfg)]


def conv_shapes(cfg: dict) -> list:
    """conv_specs with the input and output sides of each conv of one crop
    (SAME padding: out = ceil(in / stride)); the stem pool halves the side
    between the stem and the first unit."""
    side = cfg["proc_side"]
    out = []
    block_in = None
    for s in conv_specs(cfg):
        if s["role"] == "stem":
            h = side
        elif s["role"] in ("proj", "conv1"):
            h = block_in
        elif s["role"] == "conv2":
            h = block_in
        else:  # conv3 follows conv2's output
            h = -(-block_in // prev_stride)
        o = -(-h // s["stride"])
        out.append({**s, "in_side": h, "out_side": o})
        if s["role"] == "stem":
            block_in = -(-o // 2)  # the 3x3/2 pool
        if s["role"] == "conv2":
            prev_stride = s["stride"]
        if s["role"] == "conv3":
            block_in = o
    return out


def macs(s: dict) -> int:
    return s["out_side"] ** 2 * s["cout"] * s["k"] ** 2 * s["cin"]


def head_side(cfg: dict) -> int:
    return cfg["proc_side"] // cfg["stride"]


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one crop's forward: two a multiply-add of every
    convolution and of both 1x1 heads."""
    h = head_side(cfg)
    heads = h * h * feature_channels(cfg) * cfg["num_joints"] * (cfg["depth"] + 1)
    return 2 * (sum(macs(s) for s in conv_shapes(cfg)) + heads)


def iteration_flops(cfg: dict, traffic: dict) -> int:
    """An iteration's forwards, a train step's backward counted as two more."""
    return spec.kind(traffic["kind"]).FLOP_PASSES * forward_flops(cfg) * rows(cfg, traffic)


def peak_type(cfg: dict) -> str:
    return "int8" if cfg.get("quantize", "none") == "int8" else cfg["compute_dtype"]
