"""MPI-INF-3DHP reader (`metro_pose3d_tpu/data/mpi_inf_3dhp.py`; the port
keeps its own copy).

Train: the 8 training subjects' sequences from the chest-height cameras
(0, 1, 2, 4, 5, 6, 7, 8 in the official annot.mat convention), the 17-joint
subset of the 28-joint annotation, with the green-screen foreground masks
for background replacement. Test: the official TS1-TS6 sets with their
valid-frame lists; evaluation uses the 14-joint subset and the "universal"
(height-normalized) skeleton.

It reads the preprocessed layout that `scripts/prepare_3dhp.py` writes:

    $DATA_ROOT/3dhp/annotations_{train,test}.npz with arrays
        image_paths [N], world_coords [N,17,3] mm, valid [N] bool
        intrinsics [N,3,3], rotations [N,3,3], positions [N,3]
        mask_paths [N] ('' when absent), univ_scale [N] + activities [N]
        (test only)

Masks are read as cv2's IMREAD_GRAYSCALE reads them, without cv2
(`utils.improc.imread_gray`).
"""
from __future__ import annotations

import os

import numpy as np

from metro_pose3d_tpu_torch.geom import boxes as boxlib
from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import MPI3DHP_17
from metro_pose3d_tpu_torch.pipeline.crops import Example
from metro_pose3d_tpu_torch.utils import improc

# indices of the 17 MeTRo joints within the official 28-joint annotation
ANNOT28_TO_17 = np.array(
    [7, 5, 14, 15, 16, 9, 10, 11, 23, 24, 25, 18, 19, 20, 4, 3, 6], np.int32
)
CHEST_HEIGHT_CAMERAS = (0, 1, 2, 4, 5, 6, 7, 8)
# official test-set activity classes 1..7 (annot_data.mat
# `activity_annotation`) -> the protocol's per-activity table rows
ACTIVITY_NAMES = (
    "Stand/Walk", "Exercise", "Sit(Chair)", "Reach/Crouch",
    "OnFloor", "Sports", "Misc",
)


class Mpi3dhpDataset:
    joint_info = MPI3DHP_17
    root_joint = "pelv"
    has_masks = True  # green-screen foreground masks -> background replacement

    def __init__(self, data_root: str):
        self.root = os.path.join(data_root, "3dhp")
        self._train = self._load("annotations_train.npz")
        self._test = self._load("annotations_test.npz")

    def _load(self, fname):
        path = os.path.join(self.root, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"3DHP annotations not found at {path}; run scripts/prepare_3dhp.py first."
            )
        ann = dict(np.load(path, allow_pickle=True))
        if "valid" in ann:
            keep = ann["valid"].astype(bool)
            ann = {k: v[keep] if len(v) == len(keep) else v for k, v in ann.items()}
        return ann

    @property
    def n_train(self):
        return len(self._train["image_paths"])

    @property
    def n_test(self):
        return len(self._test["image_paths"])

    def _example(self, ann, idx: int) -> Example:
        img = improc.imread_cached(os.path.join(self.root, str(ann["image_paths"][idx])))
        cam = Camera(
            intrinsic_matrix=ann["intrinsics"][idx],
            rot_world_to_cam=ann["rotations"][idx],
            optical_center=ann["positions"][idx],
            world_up=(0.0, 0.0, 1.0),
        )
        world = ann["world_coords"][idx].astype(np.float64)
        px = cam.world_to_image(world)
        bbox = boxlib.expand(boxlib.bb_of_points(px), 1.25)
        mask = None
        mask_path = str(ann["mask_paths"][idx]) if "mask_paths" in ann else ""
        if mask_path:
            # a missing or damaged mask leaves the example without one, as
            # cv2.imread's None does in the reference; a file of a kind the
            # port does not read raises
            try:
                mask = improc.imread_gray(os.path.join(self.root, mask_path)) > 127
            except (FileNotFoundError, improc.CorruptImage):
                mask = None
        return Example(image=np.ascontiguousarray(img), bbox=bbox, camera=cam,
                       world_coords=world, mask=mask)

    def train_example(self, i: int) -> Example:
        return self._example(self._train, i)

    def test_example(self, i: int) -> Example:
        return self._example(self._test, i)

    def test_group_label(self, i: int) -> str:
        """The per-activity table's row: the official activity class where
        the shard carries one, else the TS1..TS6 sequence label."""
        if "activities" in self._test:
            act = str(self._test["activities"][i])
            if act:
                return act
        path = str(self._test["image_paths"][i])
        for part in path.split(os.sep):
            if part.startswith("TS"):
                return part
        return "unknown"

    def test_univ_scale(self, i: int):
        """Per-example universal-skeleton scale (the univ_annot3 / annot3
        norm ratio), which multiplies the root-relative GT for the
        height-normalized variant. None where the shard has no universal
        annotations: the dump then omits the key, so the scorer does not
        report universal numbers that merely repeat the others."""
        if "univ_scale" in self._test:
            return float(self._test["univ_scale"][i])
        return None
