"""Protocol metrics: MPJPE / PA-MPJPE (H36M), PCK@150 / AUC (3DHP), in numpy
on dumped predictions (`metro_pose3d_tpu/evaluation/metrics.py`; the port
keeps its own copy)."""
from __future__ import annotations

import numpy as np

from metro_pose3d_tpu_torch import reference_constants as C
from metro_pose3d_tpu_torch.geom.procrustes import procrustes_align


def mpjpe(pred, gt, valid=None):
    """Mean per-joint position error (mm) over valid joints.

    pred, gt: [N, J, 3] root-relative mm; valid: optional [N, J] bool.
    """
    err = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1)
    if valid is None:
        return float(err.mean())
    valid = np.asarray(valid, bool)
    return float(err[valid].mean())


def pa_mpjpe(pred, gt, valid=None):
    """MPJPE after per-example Procrustes (similarity) alignment."""
    aligned = procrustes_align(np.asarray(pred), np.asarray(gt))
    return mpjpe(aligned, gt, valid)


def root_align(pose, root_index=0):
    pose = np.asarray(pose)
    return pose - pose[..., root_index : root_index + 1, :]


def pck(pred, gt, threshold_mm=C.PCK_THRESHOLD_MM, valid=None):
    """Percentage of correct keypoints under `threshold_mm` (3DHP protocol)."""
    err = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1)
    correct = err <= threshold_mm
    if valid is None:
        return float(correct.mean() * 100)
    valid = np.asarray(valid, bool)
    return float(correct[valid].mean() * 100)


def auc(pred, gt, thresholds_mm=C.AUC_THRESHOLDS_MM, valid=None):
    """Area under the PCK curve over `thresholds_mm` (3DHP protocol)."""
    err = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1)
    if valid is not None:
        err = err[np.asarray(valid, bool)]
    return float(np.mean([np.mean(err <= t) for t in thresholds_mm]) * 100)


def per_group_table(values_per_example, group_labels):
    """Aggregate a per-example metric by group (H36M action / 3DHP activity).

    Returns (dict group -> mean, overall mean over examples).
    """
    values = np.asarray(values_per_example, np.float64)
    labels = np.asarray(group_labels)
    table = {str(g): float(values[labels == g].mean()) for g in np.unique(labels)}
    return table, float(values.mean())
