"""The int8 quantize (QK2) on the int8 serving path: the input of each unit's
first conv and of each projection, quantised once each (20 launches a
ResNet-50 forward); the compute-dtype input read once and the int8 output
written once, one float32 division an element."""
from harness import shapes

NAMES = ("int8_elementwise_kernel",)


def launches(cfg: dict, traffic: dict) -> list:
    rows = shapes.rows(cfg, traffic)
    item = shapes.DTYPE_BYTES[cfg["compute_dtype"]]
    out = []
    for s in shapes.conv_shapes(cfg):
        if s["role"] in ("conv1", "proj"):
            n = rows * s["cin"] * s["in_side"] ** 2
            out.append((n * (item + 1), n, "float32"))
    return out
