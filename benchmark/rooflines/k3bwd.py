"""The stem max pool's backward (training): the pool's input and the
incoming gradient read once, the input gradient written once; nine
comparisons an incoming gradient element."""
from harness import shapes

NAMES = ("maxpool3x3s2_bwd_kernel",)


def launches(cfg: dict, traffic: dict) -> list:
    rows = shapes.rows(cfg, traffic)
    stem = shapes.conv_shapes(cfg)[0]
    c, h = stem["cout"], stem["out_side"]
    o = -(-h // 2)
    item = shapes.DTYPE_BYTES[cfg["compute_dtype"]]
    n_x, n_g = rows * c * h * h, rows * c * o * o
    return [((2 * n_x + n_g) * item, 9 * n_g, "float32")]
