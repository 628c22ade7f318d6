"""Dataset registry: `get_dataset(name)` (`metro_pose3d_tpu/data/datasets.py`;
the port keeps its own copy).

Every dataset exposes the same protocol (duck-typed `PoseDataset`):
  joint_info    : JointInfo
  root_joint    : name of the root (pelvis) joint
  n_train/n_test: split sizes
  train_example(i) / test_example(i) -> pipeline.crops.Example
and may set `has_masks = True` when its examples carry foreground masks
(3DHP green screen), which turns on background replacement in `train()`.

The readers of H36M, MPI-INF-3DHP, MPII and 3DPW read the layouts of the
`scripts/prepare_*.py` converters (3DPW: its release layout) and raise
FileNotFoundError where the files are missing.
"""
from __future__ import annotations

from typing import Protocol

from metro_pose3d_tpu_torch.geom.joints import JointInfo
from metro_pose3d_tpu_torch.pipeline.crops import Example

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
    if name == "h36m":
        from metro_pose3d_tpu_torch.data.h36m import H36MDataset

        return H36MDataset(data_root, **kwargs)
    if name == "mpi_inf_3dhp":
        from metro_pose3d_tpu_torch.data.mpi_inf_3dhp import Mpi3dhpDataset

        return Mpi3dhpDataset(data_root, **kwargs)
    if name == "mpii":
        from metro_pose3d_tpu_torch.data.mpii import MpiiDataset

        return MpiiDataset(data_root, **kwargs)
    if name == "3dpw":
        from metro_pose3d_tpu_torch.data.tdpw import Tdpw3Dataset

        return Tdpw3Dataset(data_root, **kwargs)
    raise KeyError(f"unknown dataset {name!r}")
