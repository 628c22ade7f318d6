"""Tile-in serving: each batch `batch` uint8 source tiles [B,T,T,3] with warp
parameters and intrinsics, host numpy arrays, through
`PoseEstimator.predict_tiles` (the crop warp K1 on the device)."""
from harness import traffic as gen
from harness.camera import crop_params
from harness.serving import Serving


class Kind(Serving):
    @staticmethod
    def make_batch(r, traffic: dict, side: int) -> dict:
        b, tile = traffic["batch"], traffic["tile_side"]
        h, k, d, intr = crop_params(r, b, tile, side)
        return {"source": gen.uint8_noise(r, (b, tile, tile, 3)), "warp_h": h, "warp_k": k,
                "warp_dist": d, "intrinsics": intr}

    @staticmethod
    def call(est, batch: dict) -> dict:
        return est.predict_tiles(batch)

    @staticmethod
    def reference_crops(ref, batch: dict, side: int):
        return ref.crops_from_tiles(batch, side)
