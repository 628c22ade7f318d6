"""The port's depthwise conv (`dwconv`, one launch an MBConv block): the input
read once and the output written once in the compute dtype, and the k * k
taps of each channel; two float32 operations (a product and a sum) a tap of
each output element. The convs and their sides are the configuration's
reference's (`conv_specs`, role "depthwise")."""
from harness import shapes, spec

NAMES = ("dwconv_nhwc_kernel",)


def launches(cfg: dict, traffic: dict) -> list:
    rows = shapes.rows(cfg, traffic)
    item = shapes.DTYPE_BYTES[cfg["compute_dtype"]]
    out = []
    for s in spec.reference(cfg).conv_specs(cfg):
        if s["role"] != "depthwise":
            continue
        n_in, n_out = rows * s["cin"] * s["in_side"] ** 2, rows * s["cout"] * s["out_side"] ** 2
        taps = s["k"] ** 2
        out.append(((n_in + n_out + taps * s["cout"]) * item, 2 * taps * n_out, "float32"))
    return out
