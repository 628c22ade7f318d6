"""The occluder paste (K2, training): the float32 crops read and written
once, the uint8 RGBA bank and the per-crop index, placement and flag read
once; about 40 float32 operations a crop pixel."""
from harness import shapes

NAMES = ("occluder_paste_kernel",)


def launches(cfg: dict, traffic: dict) -> list:
    b, s = shapes.items(traffic), cfg["proc_side"]
    bank = traffic["occluders"] * traffic["occluder_side"] ** 2 * 4
    per_crop = 4 + 6 * 4 + 4  # int32 index, float32 [2,3] placement, float32 flag
    return [(2 * b * s * s * 3 * 4 + bank + b * per_crop, 40 * b * s * s, "float32")]
