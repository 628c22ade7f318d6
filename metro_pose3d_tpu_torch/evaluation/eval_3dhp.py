"""Offline MPI-INF-3DHP protocol evaluation on dumped predictions
(`metro_pose3d_tpu/evaluation/eval_3dhp.py`; the port keeps its own copy).

Usage: python -m metro_pose3d_tpu_torch.evaluation.eval_3dhp --pred-path=preds.npz
Official protocol: the 14-joint subset, PCK@150mm and AUC (thresholds
0..150mm), per activity when labels are present, and the universal-skeleton
variant when the dump carries `univ_scale` (predictions are then expected to
be bone-length rescaled upstream, `eval.scale_recovery=bone_lengths`).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from metro_pose3d_tpu_torch.evaluation.metrics import auc, mpjpe, pck, per_group_table, root_align
from metro_pose3d_tpu_torch.geom.joints import MPI3DHP_EVAL_14_INDICES
from metro_pose3d_tpu_torch.reference_constants import AUC_THRESHOLDS_MM, PCK_THRESHOLD_MM


def evaluate(pred_path: str, joint_subset=MPI3DHP_EVAL_14_INDICES) -> dict:
    data = np.load(pred_path, allow_pickle=True)
    pred = root_align(data["pose3d_rootrel"])[:, joint_subset]
    gt = root_align(data["gt3d_rootrel"])[:, joint_subset]
    valid = data["valid"][:, joint_subset] if "valid" in data else None

    result = {
        "pck_150": pck(pred, gt, valid=valid),
        "auc": auc(pred, gt, valid=valid),
        "mpjpe": mpjpe(pred, gt, valid),
    }
    if "univ_scale" in data:
        # universal-skeleton protocol: the GT rescaled onto the
        # height-normalized skeleton; only the GT changes here
        gt_univ = gt * np.asarray(data["univ_scale"], np.float32)[:, None, None]
        result["pck_150_univ"] = pck(pred, gt_univ, valid=valid)
        result["auc_univ"] = auc(pred, gt_univ, valid=valid)
        result["mpjpe_univ"] = mpjpe(pred, gt_univ, valid)
    # `predict_dataset` stores group labels under "actions" for every
    # dataset; old dumps spell them "activities"
    group_key = "actions" if "actions" in data else (
        "activities" if "activities" in data else None
    )
    if group_key is not None:
        err = np.linalg.norm(pred - gt, axis=-1)
        labels = np.asarray(data[group_key])
        # the per-activity table averages per example (the mean over that
        # example's valid joints, then over the activity's examples), while
        # the headline numbers pool every valid joint: where validity varies
        # the rows do not reconcile exactly with the headline
        ths = np.asarray(AUC_THRESHOLDS_MM, np.float64)
        curve = err[..., None] <= ths  # [N, J, T]
        if valid is not None:
            v = np.asarray(valid, bool)
            # examples with no valid eval joint are left out of the table
            correct = (np.where(v, err <= PCK_THRESHOLD_MM, 0.0).sum(-1)
                       / np.maximum(v.sum(-1), 1) * 100)
            auc_ex = (np.where(v[..., None], curve, 0.0).sum(1)
                      / np.maximum(v.sum(-1), 1)[:, None]).mean(-1) * 100
            has_valid = v.any(-1)
            correct, labels = correct[has_valid], labels[has_valid]
            auc_ex = auc_ex[has_valid]
        else:
            correct = (err <= PCK_THRESHOLD_MM).mean(-1) * 100
            auc_ex = curve.mean((1, 2)) * 100
        table, _ = per_group_table(correct, labels)
        result["per_activity_pck"] = table
        auc_table, _ = per_group_table(auc_ex, labels)
        result["per_activity_auc"] = auc_table
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred-path", required=True)
    args = parser.parse_args(argv)
    print(json.dumps(evaluate(args.pred_path), indent=2))


if __name__ == "__main__":
    main()
