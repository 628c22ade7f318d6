"""The `--test` path: deterministic tile crops -> predict (with flip TTA) ->
.npz dump (`metro_pose3d_tpu/evaluation/predict.py`; the port keeps its own
copy).

Evaluation stays two-phase, as in the reference's `--test` path: dump the
predictions, then score them offline (`eval_h36m`, `eval_3dhp`,
`eval_3dpw`), so the protocol scripts never touch the model. Prediction runs
tile-in serving (`engine.make_predict_fn(from_tiles=True)`) on the model's
device: the loader prepares source tiles on the host, K1 warps and
normalizes them on the device, then the backbone, heads, TTA, bone-length
rescale and absolute reconstruction run in one call per batch. Where
`torch.distributed` is initialized, each process takes a contiguous block of
the test split (`host_block`) and dumps it with its `example_offset`;
`gather_predictions` concatenates the blocks on rank 0 into the dump one
process makes.

`predict_multiperson_dataset` is the frame-wise protocol (3DPW): each test
frame's boxes through `multiperson.MultiPersonEstimator.estimate_stream`,
one dump row per person.
"""
from __future__ import annotations

import functools
import logging
import os
import time

import numpy as np
import torch

from metro_pose3d_tpu_torch.config import Config, apply_matmul_precision
from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, make_predict_fn
from metro_pose3d_tpu_torch.multiperson import MultiPersonEstimator
from metro_pose3d_tpu_torch.parallel.distributed import process_index_count
from metro_pose3d_tpu_torch.pipeline.loader import batch_iterator, prefetch

log = logging.getLogger("metro_torch.predict")


def _check_joint_count(cfg: Config, joint_info) -> None:
    """Fail early when the model head and the dataset skeleton disagree
    (say the default 17-joint model on 3DPW's SMPL-24 GT), instead of with a
    broadcast error deep in the flip-TTA average."""
    n_ds = len(joint_info.names)
    if cfg.model.num_joints != n_ds:
        raise ValueError(
            f"model.num_joints={cfg.model.num_joints} but the dataset's "
            f"skeleton has {n_ds} joints ({joint_info.names[:3]}...). Pass "
            f"--model.num_joints={n_ds} (and a checkpoint trained on that "
            "skeleton) or evaluate on a matching dataset."
        )


def _offset_test_example(dataset, offset: int, i: int):
    """Module-level (picklable) accessor: process-pool loaders ship this
    with the dataset instead of an unpicklable closure."""
    return dataset.test_example(offset + i)


def host_block(n_total: int, host_id: int, host_count: int) -> tuple:
    """(offset, n): the contiguous block of `n_total` examples that process
    `host_id` of `host_count` predicts. Blocks are ceil(n_total /
    host_count) long, earlier processes take the remainder, and a late
    process may get an empty block."""
    per = -(-n_total // host_count)
    offset = min(host_id * per, n_total)
    return offset, min(per, n_total - offset)


def compute_mean_bones(dataset, n_examples: int = 512) -> np.ndarray:
    """Mean bone lengths (mm) over the train split's world-space GT: the
    target skeleton of `eval.scale_recovery="bone_lengths"`."""
    edges = dataset.joint_info.bones
    n = min(n_examples, dataset.n_train)
    acc = np.zeros(len(edges), np.float64)
    count = 0
    for i in range(n):
        w = dataset.train_example(i).world_coords
        if w is None:
            continue
        acc += np.linalg.norm(w[edges[:, 0]] - w[edges[:, 1]], axis=-1)
        count += 1
    if count == 0:
        raise ValueError("dataset has no 3D ground truth to average bones over")
    return (acc / count).astype(np.float32)


def lift_twofive(pred: dict, batch: dict, root: int) -> dict:
    """Lift a 2.5D-baseline prediction to camera-frame and root-relative mm,
    in place: (u, v, z_centred) is back-projected with the GT root depth,
    the convention for image-aligned baselines."""
    from metro_pose3d_tpu_torch.models.metro import twofive_backproject

    p25 = np.asarray(pred["pose25d"])
    z_rel = p25[..., 2] - p25[:, root : root + 1, 2]
    p25 = np.concatenate([p25[..., :2], z_rel[..., None]], -1)
    root_depth = batch["coords3d_true"][:, root, 2]
    abs3d = twofive_backproject(
        torch.from_numpy(p25), torch.from_numpy(np.asarray(batch["intrinsics"])),
        torch.from_numpy(np.ascontiguousarray(root_depth)),
    ).numpy()
    pred["pose3d_abs"] = abs3d
    pred["pose3d_rootrel"] = abs3d - abs3d[:, root : root + 1]
    return pred


def make_dataset_predict_fn(cfg: Config, dataset, mean_bones=None):
    """Build the tile-in predict fn for a dataset's skeleton once, for
    callers that predict again and again (training validation): pass it to
    `predict_dataset(..., predict_fn=...)`."""
    ji = dataset.joint_info
    root = ji.names.index(dataset.root_joint)
    if mean_bones is None and cfg.eval.scale_recovery == "bone_lengths":
        mean_bones = compute_mean_bones(dataset)
    return make_predict_fn(
        cfg, ji.mirror_mapping, root_index=root, from_tiles=True,
        bone_edges=ji.bones if mean_bones is not None else None,
        mean_bones=mean_bones,
    )


def predict_dataset(
    cfg: Config,
    model,
    dataset,
    mean_bones=None,
    n_examples: int | None = None,
    predict_fn=None,
    stats: dict | None = None,
    replicate_hosts: bool = False,
) -> dict:
    """Run the test split through `model`, on the model's device; returns
    a dict of stacked numpy arrays (`save_predictions` writes it).

    Row i of the dump is example `example_offset + i` (recorded in the
    result): with `torch.distributed` initialized each process predicts its
    `host_block`, and the processes' dumps concatenate in rank order.
    `predict_fn` reuses a fn from `make_dataset_predict_fn`.
    `replicate_hosts=True` makes every process predict the whole split
    (training validation, so that every process takes the same best
    checkpoint). The model runs in eval mode and is left in the mode it came
    in. `stats`, when given, is
    filled with the batch count, the wall seconds of the loop and the
    seconds it waited for the loader.
    """
    ji = dataset.joint_info
    _check_joint_count(cfg, ji)
    root = ji.names.index(dataset.root_joint)
    fn = predict_fn if predict_fn is not None else make_dataset_predict_fn(
        cfg, dataset, mean_bones=mean_bones)
    device = next(model.parameters()).device
    n_total = dataset.n_test if n_examples is None else min(n_examples, dataset.n_test)
    if replicate_hosts:
        offset, n = 0, n_total
    else:
        offset, n = host_block(n_total, *process_index_count())
    it = batch_iterator(
        functools.partial(_offset_test_example, dataset, offset),
        n, ji, cfg.eval.batch_size,
        cfg.model.proc_side, cfg.data.source_side, aug_cfg=None,
        shuffle=False, max_epochs=1, drop_remainder=False,
        n_workers=cfg.data.workers, box_expansion=cfg.data.test_box_expansion,
        pool_type=cfg.data.pool_type, host_prep=cfg.data.host_prep,
    )
    outs = {"pose3d_rootrel": [], "pose3d_abs": [], "pose2d_px": []}
    gts = {"gt3d_rootrel": [], "gt3d_abs": [], "valid": []}
    n_batches = -(-n // cfg.eval.batch_size)
    was_training = model.training
    model.eval()
    t_start = t0 = time.perf_counter()
    waited = 0.0
    try:
        for batch_i, batch in enumerate(prefetch(it)):
            waited += time.perf_counter() - t0
            if batch_i % 20 == 0:
                log.info("predict batch %d/%d", batch_i + 1, n_batches)
            keep = batch.pop("_pad") > 0.5
            dev_batch = {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
                         for k in TILE_KEYS}
            pred = {k: v.cpu().numpy() for k, v in fn(model, dev_batch).items()}
            if "pose25d" in pred:
                lift_twofive(pred, batch, root)
            for k in outs:
                if k in pred:
                    outs[k].append(pred[k][keep])
            gt_abs = batch["coords3d_true"][keep]
            gts["gt3d_abs"].append(gt_abs)
            gts["gt3d_rootrel"].append(gt_abs - gt_abs[:, root : root + 1])
            gts["valid"].append(batch["joint_validity"][keep] > 0.5)
            t0 = time.perf_counter()
    finally:
        model.train(was_training)
    if stats is not None:
        stats.update(batches=n_batches, wall_s=time.perf_counter() - t_start,
                     loader_wait_s=waited)
    result = {k: np.concatenate(v) for k, v in {**outs, **gts}.items() if v}
    if hasattr(dataset, "test_group_label"):
        # a deterministic unshuffled pass: row i is example offset + i
        result["actions"] = np.array(
            [dataset.test_group_label(offset + i) for i in range(n)]
        )
    if hasattr(dataset, "test_univ_scale"):
        # the 3DHP universal-skeleton scale of each example; None means the
        # shard has no universal annotations, and then the key is left out so
        # that the scorer cannot label duplicate numbers as the universal
        # protocol. An empty block (a late process) must not emit the key
        # that the other processes' dumps leave out.
        scales = [dataset.test_univ_scale(offset + i) for i in range(n)]
        if scales and all(s is not None for s in scales):
            result["univ_scale"] = np.array(scales, np.float32)
    result["joint_names"] = np.array(ji.names)
    result["example_offset"] = np.int64(offset)
    return result


def gather_predictions(result: dict):
    """The processes' `predict_dataset` blocks concatenated in rank order on
    rank 0 -> the single-process dump there (`example_offset` 0), None on
    the other ranks; `result` itself without a process group. A block that
    holds no rows (a late process) adds nothing, and a key goes into the
    dump only where every block with rows has it (`univ_scale`)."""
    rank, world = process_index_count()
    if world == 1:
        return result
    blocks = [None] * world if rank == 0 else None
    torch.distributed.gather_object(result, blocks, dst=0)
    if rank != 0:
        return None
    full = [b for b in blocks if "gt3d_abs" in b]
    if not full:
        return blocks[0]
    keys = set.intersection(*(set(b) for b in full)) - {"joint_names", "example_offset"}
    merged = {k: np.concatenate([b[k] for b in full]) for k in full[0] if k in keys}
    merged["joint_names"] = blocks[0]["joint_names"]
    merged["example_offset"] = np.int64(0)
    return merged


def predict_multiperson_dataset(cfg: Config, model, dataset, n_frames: int | None = None,
                                mean_bones=None) -> dict:
    """Frame-wise multi-person prediction (BASELINE configuration 5; 3DPW)
    on the model's device.

    `dataset` exposes `joint_info`, `root_joint`, `n_test_frames` and
    `test_frame(i) -> (image, boxes, camera, world [P,J,3], seq)`. Returns
    the `eval_3dpw` dump layout, one row per person: pose3d (root-relative),
    pose3d_abs, gt3d, gt3d_abs (mm, in the frame's camera) and seq.
    """
    apply_matmul_precision(cfg)
    ji = dataset.joint_info
    _check_joint_count(cfg, ji)
    root = ji.names.index(dataset.root_joint)
    est = MultiPersonEstimator(
        cfg, model, ji, root_name=dataset.root_joint,
        bone_edges=ji.bones if mean_bones is not None else None, mean_bones=mean_bones)
    n = dataset.n_test_frames if n_frames is None else min(n_frames, dataset.n_test_frames)
    rows = {"pose3d": [], "pose3d_abs": [], "gt3d": [], "gt3d_abs": [], "seq": []}
    meta: list = []

    def frames():
        for i in range(n):
            image, boxes, cam, world, seq = dataset.test_frame(i)
            meta.append((cam, world, seq, len(boxes)))
            yield image, boxes, cam

    # the stream reads frames ahead of its results, so meta[i] is filled
    # before result i arrives
    for i, out in enumerate(est.estimate_stream(frames())):
        cam, world, seq, n_boxes = meta[i]
        gt_abs = np.stack([cam.world_to_camera(w) for w in world])
        rows["pose3d"].append(out["pose3d_rootrel"])
        rows["pose3d_abs"].append(out["pose3d_abs"])
        rows["gt3d"].append(gt_abs - gt_abs[:, root : root + 1])
        rows["gt3d_abs"].append(gt_abs)
        rows["seq"].extend([seq] * n_boxes)
    return {
        "pose3d": np.concatenate(rows["pose3d"]),
        "pose3d_abs": np.concatenate(rows["pose3d_abs"]),
        "gt3d": np.concatenate(rows["gt3d"]).astype(np.float32),
        "gt3d_abs": np.concatenate(rows["gt3d_abs"]).astype(np.float32),
        "seq": np.asarray(rows["seq"]),
    }


def save_predictions(result: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **result)
    return path
