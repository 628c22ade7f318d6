"""3DPW reader, multi-person and in the wild (`metro_pose3d_tpu/data/tdpw.py`;
the port keeps its own copy).

It reads the official release layout:

    $DATA_ROOT/3dpw/sequenceFiles/{train,validation,test}/<seq>.pkl
    $DATA_ROOT/3dpw/imageFiles/<seq>/image_%05d.jpg

Each sequence pickle (python-2 era; ``encoding='latin1'``) carries per-actor
SMPL joint positions in world metres (``jointPositions`` [F, 72]), per-frame
camera extrinsics (``cam_poses`` [F, 4, 4], world->cam), shared intrinsics
(``cam_intrinsics`` [3, 3]) and per-actor validity (``campose_valid``).

Two access modes:
* per person, `train_example(i)` / `test_example(i)`: the single-crop
  protocol of `data.datasets.PoseDataset`, GT boxes from projected joints;
* per frame, `test_frame(i)` -> (image, boxes [P,4], camera, world [P,24,3]):
  every person of a frame under one camera, for multi-person mode.

Coordinates are converted to millimetres on load.
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from metro_pose3d_tpu_torch.geom import boxes as boxlib
from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import SMPL_24
from metro_pose3d_tpu_torch.pipeline.crops import Example
from metro_pose3d_tpu_torch.utils import improc


def _load_sequence(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _camera_from_pose(
    cam_pose: np.ndarray, intrinsics: np.ndarray, world_up=(0.0, -1.0, 0.0)
) -> Camera:
    """4x4 world->cam extrinsic (translation already in mm) + K -> Camera.

    `_index_sequence` converts the release's metre translations to mm once,
    at parse time; scaling again here would move the optical centre of every
    sequence whose camera translates (every real handheld sequence).
    """
    rc = cam_pose[:3, :3]
    tc = cam_pose[:3, 3]
    return Camera(
        intrinsic_matrix=intrinsics,
        rot_world_to_cam=rc,
        optical_center=-rc.T @ tc,  # mm
        world_up=world_up,
    )


def _sequence_up(world_joints) -> np.ndarray:
    """The world's 'up' direction, from the skeletons themselves: the mean
    pelvis->head direction over every actor and frame of the sequence
    (people stand upright far more often than not). 3DPW's world-frame
    convention is not documented reliably, and a wrong sign would turn every
    crop upside down. Falls back to (0, -1, 0), the initial camera frame's
    convention, for a degenerate sequence."""
    head = SMPL_24.index_of("head")
    pelv = SMPL_24.index_of("pelv")
    vecs = np.concatenate([j[:, head] - j[:, pelv] for j in world_joints], axis=0)
    up = vecs.mean(0)
    norm = np.linalg.norm(up)
    if norm < 1e-6:
        return np.array([0.0, -1.0, 0.0])
    return up / norm


class Tdpw3Dataset:
    """3DPW. `split`: train | validation | test (official protocol: test)."""

    joint_info = SMPL_24
    root_joint = "pelv"

    def __init__(self, data_root: str, train_split="train", test_split="test"):
        self.root = os.path.join(data_root, "3dpw")
        seq_dir = os.path.join(self.root, "sequenceFiles")
        if not os.path.isdir(seq_dir):
            raise FileNotFoundError(
                f"3DPW sequences not found under {seq_dir}; see scripts/get_3dpw.sh"
            )
        self._frames = {"train": [], "test": []}
        self._persons = {"train": [], "test": []}
        for split, name in (("train", train_split), ("test", test_split)):
            for path in sorted(glob.glob(os.path.join(seq_dir, name, "*.pkl"))):
                self._index_sequence(path, split)

    def _index_sequence(self, path: str, split: str):
        seq = _load_sequence(path)
        seq_name = seq["sequence"]
        joints = [
            np.asarray(jp, np.float64).reshape(-1, 24, 3) * 1000.0
            for jp in seq["jointPositions"]
        ]
        valid = [np.asarray(v).astype(bool) for v in seq["campose_valid"]]
        cam_poses = np.asarray(seq["cam_poses"], np.float64).copy()
        cam_poses[:, :3, 3] *= 1000.0  # translation metres -> mm
        intr = np.asarray(seq["cam_intrinsics"], np.float64)
        world_up = _sequence_up(joints)
        for f in range(cam_poses.shape[0]):
            actors = [a for a in range(len(joints)) if valid[a][f]]
            if not actors:
                continue
            rec = {
                "seq": seq_name,
                "image": os.path.join(
                    self.root, "imageFiles", seq_name, f"image_{f:05d}.jpg"
                ),
                "cam_pose": cam_poses[f],
                "intrinsics": intr,
                "world": np.stack([joints[a][f] for a in actors]),
                "actors": actors,
                "world_up": world_up,
            }
            self._frames[split].append(rec)
            for k in range(len(actors)):
                self._persons[split].append((len(self._frames[split]) - 1, k))

    # ------------------------------------------------- per-person protocol
    @property
    def n_train(self):
        return len(self._persons["train"])

    @property
    def n_test(self):
        return len(self._persons["test"])

    def _person_example(self, split: str, i: int) -> Example:
        frame_idx, k = self._persons[split][i]
        rec = self._frames[split][frame_idx]
        img = improc.imread_cached(rec["image"])
        cam = _camera_from_pose(rec["cam_pose"], rec["intrinsics"], rec["world_up"])
        world = rec["world"][k]
        px = cam.world_to_image(world)
        bbox = boxlib.expand(boxlib.bb_of_points(px), 1.15)
        return Example(image=img, bbox=bbox, camera=cam, world_coords=world)

    def train_example(self, i: int) -> Example:
        return self._person_example("train", i)

    def test_example(self, i: int) -> Example:
        return self._person_example("test", i)

    # ------------------------------------------------- per-frame protocol
    @property
    def n_test_frames(self):
        return len(self._frames["test"])

    def test_frame(self, i: int):
        """-> (image RGB uint8, boxes [P,4], Camera, world [P,24,3] mm, seq)."""
        rec = self._frames["test"][i]
        img = improc.imread_cached(rec["image"])
        cam = _camera_from_pose(rec["cam_pose"], rec["intrinsics"], rec["world_up"])
        boxes = np.stack(
            [
                boxlib.expand(boxlib.bb_of_points(cam.world_to_image(w)), 1.15)
                for w in rec["world"]
            ]
        )
        return img, boxes, cam, rec["world"], rec["seq"]
