"""The crop warp (K1): each uint8 source tile and its warp parameters read
once, each crop pixel written once (serving: in the compute dtype with the
normalize epilogue; training: float32 in [0, 1]); about 60 float32
operations an output pixel for its ray, distortion and bilinear blend."""
from harness import shapes

NAMES = ("warp_crop_kernel",)
PARAMS = 9 + 4 + 5  # H, K, distortion: float32 a crop


def launches(cfg: dict, traffic: dict) -> list:
    b = shapes.items(traffic)
    t, s = traffic["tile_side"], cfg["proc_side"]
    out_item = shapes.crop_bytes(cfg, traffic)
    n_bytes = b * t * t * 3 + b * PARAMS * 4 + b * s * s * 3 * out_item
    return [(n_bytes, 60 * b * s * s, "float32")]
