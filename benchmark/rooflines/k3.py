"""The stem's 3x3/2 max pool (K3), forward: the stem's output read once
and the pooled map written once; nine comparisons an output element."""
from harness import shapes

NAMES = ("maxpool3x3s2_kernel",)


def launches(cfg: dict, traffic: dict) -> list:
    rows = shapes.rows(cfg, traffic)
    stem = shapes.conv_shapes(cfg)[0]
    c, h = stem["cout"], stem["out_side"]
    o = -(-h // 2)
    item = shapes.DTYPE_BYTES[cfg["compute_dtype"]]
    n_in, n_out = rows * c * h * h, rows * c * o * o
    return [((n_in + n_out) * item, 9 * n_out, "float32")]
