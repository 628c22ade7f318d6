"""MPII 2D-pose reader (`metro_pose3d_tpu/data/mpii.py`; the port keeps its
own copy).

2D-only auxiliary supervision: 16 joints, no camera calibration. Each
example gets a pinhole camera of fixed field of view with a centered
principal point, so the same crop path applies; only the 2D head trains on
these examples (`is_3d = 0` in the prepared batch).

It reads the layout that `scripts/prepare_mpii.py` writes from the official
mpii_human_pose_v1_u12_1.mat:

    $DATA_ROOT/mpii/annotations.npz with arrays
        image_paths [N], coords2d [N,16,2] px, valid [N,16] bool,
        bboxes [N,4]
"""
from __future__ import annotations

import os

import numpy as np

from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import MPII_16
from metro_pose3d_tpu_torch.pipeline.crops import Example
from metro_pose3d_tpu_torch.utils import improc


class MpiiDataset:
    joint_info = MPII_16
    root_joint = "pelv"

    def __init__(self, data_root: str, fov_degrees: float = 55.0):
        self.root = os.path.join(data_root, "mpii")
        path = os.path.join(self.root, "annotations.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"MPII annotations not found at {path}; run scripts/prepare_mpii.py first."
            )
        ann = np.load(path, allow_pickle=True)
        self.image_paths = ann["image_paths"]
        self.coords2d = ann["coords2d"].astype(np.float64)
        self.valid = ann["valid"].astype(bool)
        self.bboxes = ann["bboxes"].astype(np.float64)
        self.fov = fov_degrees

    @property
    def n_train(self):
        return len(self.image_paths)

    n_test = 0

    def train_example(self, i: int) -> Example:
        img = improc.imread_cached(os.path.join(self.root, str(self.image_paths[i])))
        cam = Camera.from_fov(self.fov, img.shape)
        return Example(
            image=np.ascontiguousarray(img),
            bbox=self.bboxes[i],
            camera=cam,
            image_coords=self.coords2d[i],
            joint_validity=self.valid[i],
        )

    def test_example(self, i: int) -> Example:
        raise IndexError("MPII has no test split with public annotations")
