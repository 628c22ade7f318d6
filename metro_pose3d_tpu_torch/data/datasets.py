"""Dataset registry: `get_dataset(name)` (`metro_pose3d_tpu/data/datasets.py`;
the port keeps its own copy).

Every dataset exposes the same protocol (duck-typed `PoseDataset`):
  joint_info    : JointInfo
  root_joint    : name of the root (pelvis) joint
  n_train/n_test: split sizes
  train_example(i) / test_example(i) -> pipeline.crops.Example
and may set `has_masks = True` when its examples carry foreground masks
(3DHP green screen), which turns on background replacement in `train()`.

Only the synthetic dataset is ported; the readers of H36M, MPI-INF-3DHP,
MPII and 3DPW are queue 1 item 5 of ROADMAP.md.
"""
from __future__ import annotations

from typing import Protocol

from metro_pose3d_tpu_torch.geom.joints import JointInfo
from metro_pose3d_tpu_torch.pipeline.crops import Example

NOT_PORTED = ("h36m", "mpi_inf_3dhp", "mpii", "3dpw")


class PoseDataset(Protocol):
    joint_info: JointInfo
    root_joint: str
    n_train: int
    n_test: int

    def train_example(self, i: int) -> Example: ...

    def test_example(self, i: int) -> Example: ...


def get_dataset(name: str, data_root: str = "/data", **kwargs) -> PoseDataset:
    if name == "synthetic":
        from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(**kwargs)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"the {name!r} reader is not ported yet (ROADMAP.md queue 1 item 5)")
    raise KeyError(f"unknown dataset {name!r}")
