"""Crop-in serving: each batch `batch` uint8 crops [B,S,S,3] with their
intrinsics, host numpy arrays, through `PoseEstimator.predict_crops`."""
from harness import traffic as gen
from harness.camera import crop_params
from harness.serving import Serving


class Kind(Serving):
    @staticmethod
    def make_batch(r, traffic: dict, side: int) -> dict:
        b = traffic["batch"]
        _, _, _, intr = crop_params(r, b, traffic["tile_side"], side)
        return {"crops": gen.uint8_noise(r, (b, side, side, 3)), "intrinsics": intr}

    @staticmethod
    def call(est, batch: dict) -> dict:
        return est.predict_crops(batch["crops"], batch["intrinsics"])

    @staticmethod
    def reference_crops(ref, batch: dict, side: int):
        return ref.crops_from_u8(batch["crops"])
