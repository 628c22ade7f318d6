"""Offline 3DPW evaluation: MPJPE / PA-MPJPE (+ absolute MPJPE), per sequence
(`metro_pose3d_tpu/evaluation/eval_3dpw.py`; the port keeps its own copy).

Predictions carry one row per person instance, grouped by sequence. Dump
format (np.savez):
    pose3d      [N, 24, 3]  root-relative mm (camera frame)
    pose3d_abs  [N, 24, 3]  absolute mm (camera frame; optional)
    gt3d        [N, 24, 3]  root-relative GT mm
    gt3d_abs    [N, 24, 3]  absolute GT mm (optional)
    seq         [N]         sequence name per instance
"""
from __future__ import annotations

import numpy as np

from metro_pose3d_tpu_torch.evaluation.metrics import mpjpe, pa_mpjpe, per_group_table
from metro_pose3d_tpu_torch.geom.joints import SMPL_EVAL_14_INDICES


def evaluate_3dpw(pred_path: str, joints14: bool = False) -> dict:
    data = np.load(pred_path, allow_pickle=True)
    pred = data["pose3d"]
    gt = data["gt3d"]
    seq = data["seq"]
    if joints14:
        pred = pred[:, SMPL_EVAL_14_INDICES]
        gt = gt[:, SMPL_EVAL_14_INDICES]

    per_example = np.linalg.norm(pred - gt, axis=-1).mean(-1)
    table, _ = per_group_table(per_example, seq)
    result = {
        "mpjpe": mpjpe(pred, gt),
        "pa_mpjpe": pa_mpjpe(pred, gt),
        "per_sequence_mpjpe": table,
        "n_instances": int(len(pred)),
    }
    if "pose3d_abs" in data and "gt3d_abs" in data:
        result["abs_mpjpe"] = mpjpe(data["pose3d_abs"], data["gt3d_abs"])
    return result


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred-path", required=True)
    p.add_argument("--joints14", action="store_true",
                   help="evaluate the 14-joint LSP-style subset")
    args = p.parse_args(argv)
    print(json.dumps(evaluate_3dpw(args.pred_path, args.joints14), indent=2))


if __name__ == "__main__":
    main()
