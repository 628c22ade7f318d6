"""Command line of the port (`metro_pose3d_tpu/main.py`): train, test,
score, multi-person prediction, the truncation table and export.

  python -m metro_pose3d_tpu_torch.main --train --data.dataset=h36m \
      --train.logdir=/tmp/run1 --train.num_steps=400000
  python -m metro_pose3d_tpu_torch.main --test --eval.pred_path=preds.npz ...
  python -m metro_pose3d_tpu_torch.main --eval-h36m --eval.pred_path=preds.npz
  python -m metro_pose3d_tpu_torch.main --eval-3dhp --eval.pred_path=preds.npz
  python -m metro_pose3d_tpu_torch.main --eval-3dpw --eval.pred_path=preds.npz
  python -m metro_pose3d_tpu_torch.main --test-multiperson --data.dataset=3dpw ...
  python -m metro_pose3d_tpu_torch.main --eval-truncation --data.dataset=h36m ...
  python -m metro_pose3d_tpu_torch.main --export=model_dir ...

Config overrides are dotted flags (`--section.field=value`, see config.py);
`--train` dumps the whole config into the logdir. The model runs on the GPU.
Data-parallel training over N processes, one a card:

  torchrun --nproc_per_node=N -m metro_pose3d_tpu_torch.main --train ...
"""
from __future__ import annotations

import dataclasses
import sys


def _get_dataset(cfg, name):
    """The dataset `name` from the registry; the synthetic one takes its
    split sizes from `data.synthetic_n_train` / `synthetic_n_test`."""
    from metro_pose3d_tpu_torch.data.datasets import get_dataset

    kwargs = {}
    if name == "synthetic":
        kwargs = dict(n_train=cfg.data.synthetic_n_train, n_test=cfg.data.synthetic_n_test)
    return get_dataset(name, cfg.data.data_root, **kwargs)


def _load_model(cfg, dataset=None, device=None):
    """The model of the latest checkpoint under `train.load_path` (or
    `train.logdir`; seeded random weights where there is none), in eval mode
    on `device` (default: the card).

    Checkpoints carry no int8 scales: the weights are restored into a train
    state built with `quantize="none"`, and under `model.quantize="int8"` the
    int8 model is then calibrated on `dataset` (`calibrate_on_dataset`), which
    a mode without a dataset cannot do."""
    from metro_pose3d_tpu_torch.device import resolve_device
    from metro_pose3d_tpu_torch.models.metro import MetroModel
    from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
    from metro_pose3d_tpu_torch.train.state import create_train_state

    quantize = cfg.model.quantize
    if quantize == "int8" and dataset is None:
        raise ValueError(
            "model.quantize=int8 needs calibration data; this mode has no dataset to "
            "calibrate on — run --export first or use a dataset-driven mode "
            "(--test/--test-multiperson/...)")
    device = resolve_device(device)
    cfg_fp = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantize="none"))
    state = create_train_state(cfg_fp, device)
    logdir = cfg.train.load_path or cfg.train.logdir
    state, step = Checkpointer(logdir).restore(state)
    if step == 0:
        print(f"warning: no checkpoint under {logdir}; using random init")
    # the test phase's model (its output stride) on the trained weights; an
    # int8 model's `amax` buffers are not in the checkpoint
    model = MetroModel(cfg.model)
    missing, unexpected = model.load_state_dict(state.model.state_dict(), strict=False)
    if unexpected or any(not k.endswith(".amax") for k in missing):
        raise KeyError(f"checkpoint and model disagree: missing {missing[:3]}, "
                       f"unexpected {unexpected[:3]}")
    model = model.to(device).eval()
    if quantize == "int8":
        from metro_pose3d_tpu_torch.models.quantize import calibrate_on_dataset

        calibrate_on_dataset(cfg, model, dataset)
    return model


def main(argv=None, device=None) -> int:
    """Run the mode that `argv` (default: the command line) names; prints
    this module's usage and returns 1 without one. The model runs on the card
    unless `device` names another ("cpu" in the tests).

    First the process joins the job that a launcher describes
    (`parallel.distributed.initialize_distributed`: under `torchrun
    --nproc_per_node=N` every process is a rank; without a launcher's
    environment it does nothing); the group it made ends with the mode.
    Under a group, `--train` trains data-parallel, `--test` predicts a block
    of the split on each rank and rank 0 writes the gathered dump, and the
    other modes run on rank 0 alone."""
    from metro_pose3d_tpu_torch.parallel.distributed import initialize_distributed

    created = initialize_distributed(device=device)
    try:
        return _run_mode(argv, device)
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_mode(argv, device) -> int:
    from metro_pose3d_tpu_torch.config import apply_matmul_precision, parse_cli
    from metro_pose3d_tpu_torch.parallel.distributed import process_index_count

    cfg, rest = parse_cli(sys.argv[1:] if argv is None else argv)
    modes = {a for a in rest if a.startswith("--")}
    apply_matmul_precision(cfg)

    if "--train" in modes:
        from metro_pose3d_tpu_torch.train.trainer import train

        dataset = _get_dataset(cfg, cfg.data.dataset)
        dataset2d = _get_dataset(cfg, cfg.data.dataset_2d) if cfg.data.dataset_2d else None
        train(cfg, dataset, dataset2d, device=device)
        return 0

    if "--test" in modes:
        from metro_pose3d_tpu_torch.evaluation.predict import (
            _check_joint_count, gather_predictions, predict_dataset, save_predictions,
        )

        dataset = _get_dataset(cfg, cfg.data.dataset)
        # before calibration: a skeleton mismatch fails before minutes of work
        _check_joint_count(cfg, dataset.joint_info)
        # each rank its block; rank 0 writes them all
        result = gather_predictions(
            predict_dataset(cfg, _load_model(cfg, dataset, device), dataset))
        if result is not None:
            path = cfg.eval.pred_path or f"{cfg.train.logdir}/predictions.npz"
            save_predictions(result, path)
            print(f"saved predictions to {path}")
        return 0

    if process_index_count()[0] != 0:
        return 0  # the other modes are one process's work, which rank 0 does

    scorers = {"--eval-h36m": "eval_h36m", "--eval-3dhp": "eval_3dhp", "--eval-3dpw": "eval_3dpw"}
    for mode, module in scorers.items():
        if mode in modes:
            import importlib

            scorer = importlib.import_module(f"metro_pose3d_tpu_torch.evaluation.{module}")
            scorer.main(["--pred-path", cfg.eval.pred_path])
            return 0

    if "--test-multiperson" in modes:
        # frame-wise multi-person prediction (BASELINE configuration 5, 3DPW)
        from metro_pose3d_tpu_torch.evaluation.predict import (
            _check_joint_count, predict_multiperson_dataset, save_predictions,
        )

        dataset = _get_dataset(cfg, cfg.data.dataset)
        _check_joint_count(cfg, dataset.joint_info)  # before calibration
        result = predict_multiperson_dataset(cfg, _load_model(cfg, dataset, device), dataset)
        path = cfg.eval.pred_path or f"{cfg.train.logdir}/predictions_mp.npz"
        save_predictions(result, path)
        print(f"saved multi-person predictions to {path}")
        return 0

    if "--eval-truncation" in modes:
        import json

        from metro_pose3d_tpu_torch.evaluation.truncation import evaluate_truncation

        dataset = _get_dataset(cfg, cfg.data.dataset)
        table = evaluate_truncation(cfg, _load_model(cfg, dataset, device), dataset)
        print(json.dumps(table, indent=2))
        return 0

    export = [a for a in rest if a.startswith("--export=")]
    if export:
        from metro_pose3d_tpu_torch.export import export_model

        # an int8 bundle ships calibrated scales, from the dataset's eval crops
        dataset = _get_dataset(cfg, cfg.data.dataset) if cfg.model.quantize == "int8" else None
        export_model(cfg, _load_model(cfg, dataset, device), export[0].split("=", 1)[1])
        return 0

    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
