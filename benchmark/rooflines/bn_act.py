"""The eval batch norm and its activation (`bn_act`, one launch a batch norm):
each element read once and written once in the compute dtype, and the three
float32 per-channel vectors (mean, mul, bias) read once; three float32
operations an element for the affine, four more for a SiLU (negation,
exponential, add, division). The batch norms and their shapes are the
configuration's reference's (`bn_shapes`)."""
from harness import shapes, spec

NAMES = ("bn_act_nhwc_kernel", "bn_act_flat_kernel")
OPS = {"none": 3, "relu": 4, "silu": 7}


def launches(cfg: dict, traffic: dict) -> list:
    rows = shapes.rows(cfg, traffic)
    item = shapes.DTYPE_BYTES[cfg["compute_dtype"]]
    out = []
    for b in spec.reference(cfg).bn_shapes(cfg):
        n = rows * b["c"] * b["side"] ** 2
        out.append((2 * n * item + 3 * 4 * b["c"], OPS[b["act"]] * n, "float32"))
    return out
