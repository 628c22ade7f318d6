"""Offline H36M protocol evaluation on dumped predictions
(`metro_pose3d_tpu/evaluation/eval_h36m.py`; the port keeps its own copy).

Usage: python -m metro_pose3d_tpu_torch.evaluation.eval_h36m --pred-path=preds.npz
Computes root-aligned MPJPE and PA-MPJPE, overall and (when the predictions
file carries `actions`) per action, per joint, and the absolute MPJPE when
the dump has absolute poses.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from metro_pose3d_tpu_torch.evaluation.metrics import mpjpe, pa_mpjpe, per_group_table, root_align


def evaluate(pred_path: str) -> dict:
    data = np.load(pred_path, allow_pickle=True)
    pred = root_align(data["pose3d_rootrel"])
    gt = root_align(data["gt3d_rootrel"])
    valid = data["valid"] if "valid" in data else None

    per_example = np.linalg.norm(pred - gt, axis=-1)
    # guarded means: an example with no valid joint (a fully truncated crop)
    # or a joint invalid in every example is left out, not turned into a NaN
    # that poisons its per-action or per-joint row
    if valid is not None:
        v = valid.astype(bool)
        per_example_mean = (np.where(v, per_example, 0.0).sum(-1)
                            / np.maximum(v.sum(-1), 1))
        example_ok = v.any(-1)
        per_joint = (np.where(v, per_example, 0.0).sum(0)
                     / np.maximum(v.sum(0), 1))
        # a joint valid in no example has no data: NaN (visible), not 0.0 mm
        # (which reads as a perfect prediction)
        per_joint = np.where(v.any(0), per_joint, np.nan)
    else:
        per_example_mean = per_example.mean(-1)
        example_ok = np.ones(len(per_example), bool)
        per_joint = per_example.mean(0)

    result = {
        "mpjpe": mpjpe(pred, gt, valid),
        "pa_mpjpe": pa_mpjpe(pred, gt, valid),
    }
    if "actions" in data:
        table, _ = per_group_table(
            per_example_mean[example_ok], np.asarray(data["actions"])[example_ok]
        )
        result["per_action_mpjpe"] = table
    if "joint_names" in data:
        # None (JSON null) marks a joint with no valid data anywhere: a NaN
        # is not strict JSON
        result["per_joint_mpjpe"] = {
            str(name): (float(v) if np.isfinite(v) else None)
            for name, v in zip(data["joint_names"], per_joint)
        }
    if "pose3d_abs" in data and "gt3d_abs" in data:
        result["abs_mpjpe"] = mpjpe(data["pose3d_abs"], data["gt3d_abs"], valid)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred-path", required=True)
    args = parser.parse_args(argv)
    print(json.dumps(evaluate(args.pred_path), indent=2))


if __name__ == "__main__":
    main()
