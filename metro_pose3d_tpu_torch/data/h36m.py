"""Human3.6M reader (`metro_pose3d_tpu/data/h36m.py`; the port keeps its own
copy).

Protocol: train subjects S1/S5/S6/S7/S8 (every 5th frame), test S9/S11
(every 64th frame, the standard protocol-2 sampling); the 17-joint
skeleton; GT boxes from the projected joints where the layout has none.

It reads the preprocessed layout that `scripts/prepare_h36m.py` writes on a
machine with the official release:

    $DATA_ROOT/h36m/annotations.npz  with arrays
        image_paths [N]      (relative to $DATA_ROOT/h36m/)
        world_coords [N,17,3] float32 mm
        bboxes [N,4] float32 (optional; derived from projections if absent)
        subjects [N] int, frame_indices [N] int
        intrinsics [N,3,3], rotations [N,3,3], positions [N,3] float32
        distortions [N,5] float32
    $DATA_ROOT/h36m/<image_paths[i]>

Frames load lazily per example through `utils.improc.imread_cached` (JPEG
through the C decoder, PNG without cv2).
"""
from __future__ import annotations

import os

import numpy as np

from metro_pose3d_tpu_torch.geom import boxes as boxlib
from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.pipeline.crops import Example
from metro_pose3d_tpu_torch.utils import improc

TRAIN_SUBJECTS = (1, 5, 6, 7, 8)
TEST_SUBJECTS = (9, 11)
TRAIN_FRAME_STEP = 5
TEST_FRAME_STEP = 64


class H36MDataset:
    joint_info = H36M_17
    root_joint = "pelv"

    def __init__(self, data_root: str, frame_step_train=TRAIN_FRAME_STEP,
                 frame_step_test=TEST_FRAME_STEP):
        self.root = os.path.join(data_root, "h36m")
        path = os.path.join(self.root, "annotations.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"H36M annotations not found at {path}; run scripts/prepare_h36m.py "
                "against the official release first."
            )
        ann = np.load(path, allow_pickle=True)
        self.image_paths = ann["image_paths"]
        self.world_coords = ann["world_coords"].astype(np.float64)
        self.subjects = ann["subjects"]
        self.frame_indices = ann["frame_indices"]
        self.intrinsics = ann["intrinsics"].astype(np.float64)
        self.rotations = ann["rotations"].astype(np.float64)
        self.positions = ann["positions"].astype(np.float64)
        self.distortions = (
            ann["distortions"].astype(np.float64)
            if "distortions" in ann
            else np.zeros((len(self.image_paths), 5))
        )
        self.bboxes = ann["bboxes"].astype(np.float64) if "bboxes" in ann else None

        is_train = np.isin(self.subjects, TRAIN_SUBJECTS)
        is_test = np.isin(self.subjects, TEST_SUBJECTS)
        self.train_ids = np.nonzero(is_train & (self.frame_indices % frame_step_train == 0))[0]
        self.test_ids = np.nonzero(is_test & (self.frame_indices % frame_step_test == 0))[0]

    @property
    def n_train(self):
        return len(self.train_ids)

    @property
    def n_test(self):
        return len(self.test_ids)

    def _example(self, idx: int) -> Example:
        img = improc.imread_cached(os.path.join(self.root, str(self.image_paths[idx])))
        cam = Camera(
            intrinsic_matrix=self.intrinsics[idx],
            rot_world_to_cam=self.rotations[idx],
            optical_center=self.positions[idx],
            distortion_coeffs=self.distortions[idx],
            world_up=(0.0, 0.0, 1.0),  # H36M world is z-up
        )
        world = self.world_coords[idx]
        if self.bboxes is not None:
            bbox = self.bboxes[idx]
        else:
            px = cam.world_to_image(world)
            bbox = boxlib.expand(boxlib.bb_of_points(px), 1.25)
        return Example(image=np.ascontiguousarray(img), bbox=bbox, camera=cam,
                       world_coords=world)

    def train_example(self, i: int) -> Example:
        return self._example(int(self.train_ids[i]))

    def test_example(self, i: int) -> Example:
        return self._example(int(self.test_ids[i]))

    def test_group_label(self, i: int) -> str:
        """Action name for the per-action MPJPE table (image paths are
        images/S<subj>/<Action>.<camera>/frame_*.jpg)."""
        path = str(self.image_paths[int(self.test_ids[i])])
        seq = os.path.basename(os.path.dirname(path))
        return canonical_action(seq.split(".")[0])


# The 15 protocol actions under their canonical table names. Export paths
# spell some differently (the official release uses "TakingPhoto" and
# "WalkingDog" for S1 but "Photo" and "WalkDog" elsewhere), so names merge
# through an explicit alias table and an unknown one raises instead of
# silently making a new table row.
CANONICAL_ACTIONS = frozenset({
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Photo",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking", "Waiting",
    "Walking", "WalkingDog", "WalkTogether",
})
_ACTION_ALIASES = {
    "WalkDog": "WalkingDog",
    "TakingPhoto": "Photo",
    "WalkingTogether": "WalkTogether",
}


def canonical_action(action: str) -> str:
    """Merge an H36M sequence action name ("WalkDog 1") to its canonical
    protocol-table row ("WalkingDog"); raises on unknown spellings."""
    base = action.split(" ")[0]  # drop the take suffix ("Walking 1")
    base = _ACTION_ALIASES.get(base, base)
    if base not in CANONICAL_ACTIONS:
        raise ValueError(
            f"unknown H36M action {action!r} (base {base!r}); known: "
            f"{sorted(CANONICAL_ACTIONS)} + aliases {sorted(_ACTION_ALIASES)}"
        )
    return base
