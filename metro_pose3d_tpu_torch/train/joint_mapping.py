"""Cross-dataset joint remapping for mixed 2D/3D supervision
(`metro_pose3d_tpu/train/joint_mapping.py`; the port keeps its own copy).

The model predicts ONE joint convention (the 3D dataset's). Auxiliary 2D
examples (MPII) are remapped by joint NAME onto that convention; names
without a counterpart become invalid joints.
"""
from __future__ import annotations

import numpy as np

from metro_pose3d_tpu_torch.geom.joints import JointInfo


def name_mapping(src: JointInfo, dst: JointInfo) -> np.ndarray:
    """dst-index -> src-index (or -1 when the dst joint has no src match)."""
    src_idx = {n: i for i, n in enumerate(src.names)}
    return np.array([src_idx.get(n, -1) for n in dst.names], np.int32)


def remap_prepared(prepared: dict, mapping: np.ndarray) -> dict:
    """Remap a prepared example's joint-indexed arrays into the dst space."""
    safe = np.maximum(mapping, 0)
    has = (mapping >= 0).astype(np.float32)
    out = dict(prepared)
    out["coords2d_true"] = prepared["coords2d_true"][safe].astype(np.float32)
    out["coords3d_true"] = prepared["coords3d_true"][safe].astype(np.float32)
    out["joint_validity"] = prepared["joint_validity"][safe] * has
    out["joint_validity_2d"] = prepared["joint_validity_2d"][safe] * has
    return out
