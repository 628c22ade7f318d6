"""Truncation-robustness evaluation (`metro_pose3d_tpu/evaluation/truncation.py`;
the MeTRo paper's headline experiment).

The person box is cut from the bottom by a growing fraction (the crop then
covers only the top of the person), and the whole skeleton's root-relative
MPJPE is measured at each level. A metric-scale volumetric head degrades
gracefully, since joints outside the crop still decode at metric
positions; image-aligned (2.5D) heads collapse, because their x/y axes
cannot point outside the crop.

    from metro_pose3d_tpu_torch.evaluation.truncation import evaluate_truncation
    table = evaluate_truncation(cfg, model, dataset, fractions=(0, .2, .4))
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.config import Config
from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, make_predict_fn
from metro_pose3d_tpu_torch.evaluation.metrics import mpjpe
from metro_pose3d_tpu_torch.evaluation.predict import lift_twofive
from metro_pose3d_tpu_torch.pipeline.loader import prepare_one, stack_examples


def truncate_box(bbox, fraction: float):
    """Cut `fraction` of the box height from the bottom (legs first)."""
    x, y, w, h = (float(v) for v in bbox)
    return np.array([x, y, w, h * (1.0 - fraction)])


def evaluate_truncation(cfg: Config, model, dataset, fractions=(0.0, 0.1, 0.2, 0.3, 0.4, 0.5),
                        n_examples: int | None = 64) -> dict:
    """-> {fraction: {"mpjpe", "n_visible", "mpjpe_visible", "mpjpe_hidden"}},
    on the model's device.

    `mpjpe_hidden` is the error over the joints that project outside the
    truncated crop (the truncation-robustness signal); `mpjpe_visible`
    isolates the joints inside it. A 2.5D model (`model_class="twofive"`)
    is lifted with the ground-truth root depth, as `predict_dataset` lifts
    it, so that both model classes compare root-relative on equal footing.
    """
    ji = dataset.joint_info
    root = ji.names.index(dataset.root_joint)
    fn = make_predict_fn(cfg, ji.mirror_mapping, root_index=root, from_tiles=True,
                         reconstruct=False)
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    n = min(n_examples or dataset.n_test, dataset.n_test)
    results = {}
    try:
        for frac in fractions:
            prepared = []
            for i in range(n):
                ex = dataset.test_example(i)
                ex.bbox = truncate_box(ex.bbox, frac)
                prepared.append(prepare_one(ex, ji, cfg.model.proc_side, cfg.data.source_side,
                                            None, (0, 0, i), 4,
                                            box_expansion=cfg.data.test_box_expansion))
            batch = stack_examples(prepared)
            dev_batch = {k: torch.from_numpy(batch[k]).to(device) for k in TILE_KEYS}
            pred = {k: v.float().cpu().numpy() for k, v in fn(model, dev_batch).items()}
            if "pose25d" in pred:
                lift_twofive(pred, batch, root)
            rel_pred = pred["pose3d_rootrel"]
            gt = batch["coords3d_true"]
            rel_gt = gt - gt[:, root : root + 1]
            visible = batch["joint_validity_2d"] > 0.5  # projects inside the truncated crop
            valid = batch["joint_validity"] > 0.5
            row = {"mpjpe": mpjpe(rel_pred, rel_gt, valid), "n_visible": float(visible.mean())}
            if (valid & visible).any():
                row["mpjpe_visible"] = mpjpe(rel_pred, rel_gt, valid & visible)
            if (valid & ~visible).any():
                row["mpjpe_hidden"] = mpjpe(rel_pred, rel_gt, valid & ~visible)
            results[float(frac)] = row
    finally:
        model.train(was_training)
    return results


def main(argv=None, device=None):
    """`python -m metro_pose3d_tpu_torch.evaluation.truncation --data.dataset=...`:
    the table of the checkpoint under `train.load_path` (or `train.logdir`),
    as JSON. Runs on the card unless `device` names another."""
    import json
    import sys

    from metro_pose3d_tpu_torch.config import parse_cli
    from metro_pose3d_tpu_torch.main import _get_dataset, _load_model

    cfg, _ = parse_cli(sys.argv[1:] if argv is None else argv)
    dataset = _get_dataset(cfg, cfg.data.dataset)
    model = _load_model(cfg, dataset, device)
    print(json.dumps(evaluate_truncation(cfg, model, dataset), indent=2))


if __name__ == "__main__":
    main()
