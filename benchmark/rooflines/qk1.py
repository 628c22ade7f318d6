"""The int8 convolution (QK1) on the int8 serving path: every quantised conv
of a backbone forward, one launch each. Bytes: the int8 input and weights
read once, the output written once (int8 where the junction into the next
conv is its epilogue, conv1 and conv2; the compute dtype where it
dequantises, conv3 and the projection) and the per-channel vectors (scale
and offset, or scale). Operations: two int8 operations a multiply-add."""
from harness import shapes

NAMES = ("int8_conv_",)
REQUANT = ("conv1", "conv2")


def launches(cfg: dict, traffic: dict) -> list:
    rows = shapes.rows(cfg, traffic)
    out = []
    for s in shapes.conv_shapes(cfg):
        if s["role"] == "stem":
            continue
        requant = s["role"] in REQUANT
        x = rows * s["cin"] * s["in_side"] ** 2
        w = s["cout"] * s["k"] ** 2 * s["cin"]
        y = rows * s["cout"] * s["out_side"] ** 2 * (
            1 if requant else shapes.DTYPE_BYTES[cfg["compute_dtype"]])
        vectors = s["cout"] * 4 * (2 if requant else 1)
        out.append((x + w + y + vectors, 2 * rows * shapes.macs(s), "int8"))
    return out
