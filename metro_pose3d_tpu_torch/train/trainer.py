"""Training loop (`metro_pose3d_tpu/train/trainer.py`), in one process or
data-parallel over the processes of a `torch.distributed` process group:
feeds the step from datasets through the host input pipeline, runs it, and
keeps the books: `config.json`, the metric writer (`utils/writers.py`:
`history.jsonl`, appended at every log step and validation, and TensorBoard
where it imports) and `history.json` (the whole run, written at the end),
checkpoints every `checkpoint_every` steps with auto-resume, validation
MPJPE on the test split every `validate_every` steps with the best
checkpoint kept apart (`Checkpointer.save_if_best`), `data.cycle_batches`
and a `torch.profiler` trace of `profile_steps` steps into `<logdir>/profile`.

The feed: `mixed_batch_iterator` (per-example crop prep on loader threads or
processes, in the C or the numpy engine) -> `prefetch` (a thread that keeps
two batches ready) -> `batch_to_device`. On resume the loader passes over the
batches the run already trained on without preparing their examples, as the
JAX loader's `skip_batches` does.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from metro_pose3d_tpu_torch.config import Config, apply_matmul_precision, config_to_json
from metro_pose3d_tpu_torch.device import resolve_device
from metro_pose3d_tpu_torch.evaluation.metrics import mpjpe
from metro_pose3d_tpu_torch.evaluation.predict import make_dataset_predict_fn, predict_dataset
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.parallel.distributed import (
    in_group, local_batch_slice, process_index_count,
)
from metro_pose3d_tpu_torch.pipeline.backgrounds import get_background_bank
from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
from metro_pose3d_tpu_torch.pipeline.loader import batch_iterator, prefetch, stack_examples
from metro_pose3d_tpu_torch.pipeline.occluders import get_occluder_bank
from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
from metro_pose3d_tpu_torch.train.joint_mapping import name_mapping, remap_prepared
from metro_pose3d_tpu_torch.train.loop import make_lr_schedule, make_train_step
from metro_pose3d_tpu_torch.train.state import create_train_state
from metro_pose3d_tpu_torch.utils.profiling import trace
from metro_pose3d_tpu_torch.utils.writers import make_metric_writer

log = logging.getLogger("metro_torch.train")


def mixed_batch_iterator(cfg: Config, dataset, dataset2d=None, n_backgrounds=0,
                         skip_batches=0, n_occluders=1, host_id=0, host_count=1):
    """Yield host batches: `train.batch_size` 3D rows (+ `batch_size_2d`
    2D rows remapped by joint name when an auxiliary 2D dataset is given).
    The two sizes are global: process `host_id` of `host_count` prepares
    `size / host_count` rows of each from its share of the examples, in the
    order [3D rows, 2D rows]; the global batch is the processes' batches in
    process order, as the JAX package's. Sizes the processes cannot split
    evenly raise ValueError.
    `n_backgrounds` > 0 adds green-screen mask/params rows to EVERY batch
    (maskless examples get a no-op all-foreground mask). `skip_batches`
    passes over the first batches of the schedule without preparing them
    (resume). `n_occluders` is the real size of the occluder bank, so the
    sampled indices cover all of it. A 3D-only batch keeps the loader's
    "_pad"; a merged one drops it, as the JAX package's does."""
    ji = dataset.joint_info

    def loader(ds, batch_size, seed):
        per, _ = local_batch_slice(batch_size, host_id, host_count)
        return batch_iterator(
            ds.train_example, ds.n_train, ds.joint_info, per, cfg.model.proc_side,
            cfg.data.source_side, aug_cfg=cfg.aug, seed=seed, n_workers=cfg.data.workers,
            host_id=host_id, host_count=host_count,
            n_backgrounds=n_backgrounds, skip_batches=skip_batches, n_occluders=n_occluders,
            pool_type=cfg.data.pool_type, host_prep=cfg.data.host_prep)

    it3d = loader(dataset, cfg.train.batch_size, cfg.train.seed)
    if dataset2d is None or cfg.train.batch_size_2d == 0:
        yield from it3d
        return
    mapping = name_mapping(dataset2d.joint_info, ji)
    it2d = loader(dataset2d, cfg.train.batch_size_2d, cfg.train.seed + 1)
    try:
        for b3, b2 in zip(it3d, it2d):
            rows = [remap_prepared({k: b2[k][i] for k in b2 if k != "_pad"}, mapping)
                    for i in range(len(b2["is_3d"]))]
            b2r = stack_examples(rows)
            yield {k: np.concatenate([b3[k], b2r[k]]) for k in b3 if k != "_pad"}
    finally:  # shut both loaders' pools down now, not when collected
        it3d.close()
        it2d.close()


def validate(cfg: Config, model, dataset, n_batches: Optional[int] = None,
             predict_fn=None) -> float:
    """Validation MPJPE (mm, root-relative) over the first `n_batches`
    (default `train.validate_batches`) eval batches of the test split, on
    the model's device and in eval mode (the model's mode is restored).
    Pass `predict_fn` from `make_dataset_predict_fn` when validating again
    and again. Every process predicts the same examples (`replicate_hosts`),
    so that all keep the same best checkpoint."""
    if n_batches is None:
        n_batches = cfg.train.validate_batches
    n = min(cfg.eval.batch_size * n_batches, dataset.n_test)
    result = predict_dataset(cfg, model, dataset, n_examples=n, replicate_hosts=True,
                             predict_fn=predict_fn)
    return mpjpe(result["pose3d_rootrel"], result["gt3d_rootrel"], result["valid"])


def _prior_history(logdir: str, start_step: int) -> list:
    """Rows logged up to the resume point, from the append-only jsonl
    stream; rows past it describe steps the resumed run does again."""
    rows = []
    try:
        with open(os.path.join(logdir, "history.jsonl")) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # a line cut short by a kill mid-write
                if row.get("step", 0) <= start_step:
                    rows.append(row)
    except OSError as e:
        log.warning("could not recover the pre-resume history: %s", e)
    return rows


def _check_supported(cfg: Config) -> None:
    if cfg.train.fused_steps > 1:
        raise NotImplementedError("train.fused_steps > 1 is not ported (measured null)")


def train(cfg: Config, dataset, dataset2d=None, max_steps: Optional[int] = None,
          occluder_root: Optional[str] = None, background_root: Optional[str] = None,
          device=None):
    """Train to `train.num_steps` (or `max_steps`) on `dataset` (and the 2D
    `dataset2d`, remapped by joint name) -> the final `TrainState`.

    The occluder bank is `get_occluder_bank(occluder_root or
    data.occluder_root)` (procedural without VOC), its real size passed to
    the loader. With `aug.background_prob` > 0 and `dataset.has_masks` the
    background bank is `get_background_bank(background_root or
    data.background_root, data.source_side)` and the loader ships masks and
    background parameters; otherwise no bank is built. Every
    `train.validate_every` steps the current weights are validated on
    `dataset`'s test split (`validate`). device: default the card; a
    RuntimeError where CUDA is absent.

    Where a `torch.distributed` process group is up
    (`parallel.distributed.initialize_distributed`), every process calls
    this and trains data-parallel: it prepares its share of the global
    batch (`mixed_batch_iterator`), the step reduces over the ranks
    (`train.loop.make_train_step`), and process 0 alone writes the logdir.
    """
    _check_supported(cfg)
    device = resolve_device(device)
    occluder_bank = get_occluder_bank(occluder_root or cfg.data.occluder_root or None,
                                      tile_side=cfg.aug.occluder_tile_side)
    bg_bank = None
    if cfg.aug.background_prob > 0 and getattr(dataset, "has_masks", False):
        bg_bank = get_background_bank(background_root or cfg.data.background_root or None,
                                      side=cfg.data.source_side)

    rank, world = process_index_count()

    def feed(skip_batches):
        return mixed_batch_iterator(
            cfg, dataset, dataset2d, n_backgrounds=0 if bg_bank is None else len(bg_bank),
            skip_batches=skip_batches, n_occluders=len(occluder_bank), host_id=rank,
            host_count=world)

    root = dataset.joint_info.names.index(dataset.root_joint)
    return _run(cfg, feed, occluder_bank, bg_bank, max_steps, root, device, dataset)


def _train_on_batches(cfg: Config, batches: Iterator[dict],
                      occluder_bank: Optional[np.ndarray] = None,
                      max_steps: Optional[int] = None, root_index: int = 0, device=None,
                      background_bank: Optional[np.ndarray] = None, val_dataset=None):
    """`train` fed with ready host batches instead of a dataset, for tests
    and smoke runs that make their own batches (numpy, in the
    `pipeline/device.py::example_spec` layout).

    occluder_bank: float RGBA [N,T,T,4] in [0, 1] (default as `train`'s).
    background_bank: uint8 [N,T,T,3]; with `aug.background_prob` > 0 and a
    first batch that carries "source_mask" it defaults to the bank `train`
    would build; otherwise none is built or used. On resume the first
    `start_step` batches of `batches` are discarded. val_dataset: the
    dataset that in-loop validation predicts, needed where
    `train.validate_every` falls within the run. Under a process group each
    process passes its own rows of every global batch.
    """
    _check_supported(cfg)
    batches = iter(batches)
    device = resolve_device(device)
    if occluder_bank is None:
        occluder_bank = get_occluder_bank(cfg.data.occluder_root or None,
                                          tile_side=cfg.aug.occluder_tile_side)
    first = next(batches, None)
    batches = itertools.chain([] if first is None else [first], batches)
    if cfg.aug.background_prob > 0 and first is not None and "source_mask" in first:
        if background_bank is None:
            background_bank = get_background_bank(cfg.data.background_root or None,
                                                  side=cfg.data.source_side)
    else:
        background_bank = None
    return _run(cfg, lambda skip: itertools.islice(batches, skip, None), occluder_bank,
                background_bank, max_steps, root_index, device, val_dataset)


def _run(cfg: Config, feed: Callable[[int], Iterator[dict]], occluder_bank: np.ndarray,
         background_bank: Optional[np.ndarray], max_steps: Optional[int], root_index: int,
         device: torch.device, val_dataset=None):
    """The loop of `train`: `feed(k)` gives the host batches from the k-th
    on (k = the restored step, or 0 with `data.cycle_batches`);
    `val_dataset` is the dataset that validation predicts.

    Under a process group process 0 alone writes `config.json`, the metric
    writer, `history.json`, the checkpoints (every process waits at a
    barrier after each save) and the profile; every process restores the
    same checkpoint, validates the same examples and keeps process 0's
    validation MPJPE, so that all take the same best-checkpoint decision."""
    t = cfg.train
    total = min(t.num_steps, max_steps or t.num_steps)
    validating = bool(t.validate_every) and t.validate_every <= total
    if validating and val_dataset is None:
        raise ValueError(f"train.validate_every={t.validate_every} falls within the run's "
                         f"{total} steps, but no dataset to validate on was given")
    apply_matmul_precision(cfg)
    parallel = in_group()
    primary = process_index_count()[0] == 0
    os.makedirs(t.logdir, exist_ok=True)
    if primary:
        with open(os.path.join(t.logdir, "config.json"), "w") as f:
            f.write(config_to_json(cfg))

    state = create_train_state(cfg, device)
    ckpt = Checkpointer(t.logdir, t.keep_checkpoints)
    state, start_step = ckpt.restore(state)
    if start_step:
        log.info("resumed from step %d", start_step)
    bg_bank = None
    if background_bank is not None:
        bg_bank = torch.from_numpy(np.ascontiguousarray(background_bank)).to(device)
        log.info("background replacement on: bank of %d tiles", len(background_bank))
    step_fn = make_train_step(cfg, root_index,
                              occluder_bank=pack_occluder_bank_for(occluder_bank, device),
                              background_bank=bg_bank)

    src = feed(0 if cfg.data.cycle_batches > 0 else start_step)
    if cfg.data.cycle_batches > 0:
        # device-resident batches served round-robin; the phase follows the step
        buf = [batch_to_device(next(src), device) for _ in range(cfg.data.cycle_batches)]
        it = (buf[i % len(buf)] for i in range(start_step, total))
    else:
        # prepare exactly the batches this run trains on, two ahead of the step
        it = (batch_to_device(b, device)
              for b in prefetch(itertools.islice(src, max(total - start_step, 0))))

    val_fn = val_model = None
    if validating:
        # built once, and reused by every validation
        val_fn = make_dataset_predict_fn(cfg, val_dataset)
        # the weights are validated at the test phase's output stride
        if cfg.model.at_phase(train=False) != cfg.model.at_phase(train=True):
            val_model = MetroModel(cfg.model).to(device).eval()

    lr_sched = make_lr_schedule(cfg)
    history = _prior_history(t.logdir, start_step) if start_step else []
    writer = make_metric_writer(t.logdir, primary)
    # past the first steps
    prof_at = start_step + 3 if t.profile_steps > 0 and primary else None
    prof = None
    t_last, n_since, wait = time.perf_counter(), 0, 0.0
    try:
        done = start_step
        while done < total:
            if prof_at is not None and done == prof_at:
                prof = contextlib.ExitStack()
                prof.enter_context(trace(os.path.join(t.logdir, "profile"),
                                         device if device.type == "cuda" else None))
            t_wait = time.perf_counter()
            batch = next(it)
            wait += time.perf_counter() - t_wait
            metrics = step_fn(state, batch)
            n_since += int(batch["is_3d"].shape[0])
            done += 1
            if prof is not None and done - prof_at >= t.profile_steps:
                _stop_profiler(prof, t.logdir)
                prof, prof_at = None, None

            if done % t.log_every == 0 or done == total:
                scalars = {k: float(v) for k, v in metrics.items()}  # syncs
                dt = time.perf_counter() - t_last
                scalars["crops_per_sec"] = n_since / dt
                # the share of the wall time the loop waited for a host batch
                # and its copy to the device
                scalars["loader_wait_share"] = wait / dt
                scalars["learning_rate"] = float(lr_sched(done - 1))
                log.info("step %d loss=%.4f (3d=%.4f 2d=%.4f) |g|=%.2f %.1f crops/s, "
                         "%.0f%% waiting for data", done, scalars["loss"], scalars["loss3d"],
                         scalars["loss2d"], scalars["grad_norm"], scalars["crops_per_sec"],
                         100 * scalars["loader_wait_share"])
                writer.write_scalars(done, scalars)
                history.append({"step": done, **scalars})
                t_last, n_since, wait = time.perf_counter(), 0, 0.0
            if done % t.checkpoint_every == 0 or done == total:
                if primary:
                    ckpt.save(done, state)
                if parallel:
                    dist.barrier()

            if t.validate_every and done % t.validate_every == 0:
                t_val = time.perf_counter()
                if val_model is not None:
                    val_model.load_state_dict(state.model.state_dict())
                val = validate(cfg, val_model or state.model, val_dataset, predict_fn=val_fn)
                if parallel:  # process 0's reading decides for all
                    val_t = torch.tensor([val], dtype=torch.float64, device=device)
                    dist.broadcast(val_t, src=0)
                    val = float(val_t)
                val_s = time.perf_counter() - t_val
                t_last += val_s  # the logged rates count training only
                log.info("step %d validation MPJPE %.2f mm (%.1f s)", done, val, val_s)
                writer.write_scalars(done, {"val_mpjpe": val})
                history.append({"step": done, "val_mpjpe": val})
                if primary and ckpt.save_if_best(done, state, val):
                    log.info("step %d new best checkpoint (%.2f mm)", done, val)
                if parallel:
                    dist.barrier()
    finally:
        _close(src)
        writer.close()
    if prof is not None:  # the run ended inside the traced window
        _stop_profiler(prof, t.logdir)
    ckpt.wait()
    if primary:
        with open(os.path.join(t.logdir, "history.json"), "w") as f:
            json.dump(history, f)
    return state


def _close(src) -> None:
    """Shut the loader's pools down now rather than when it is collected."""
    if hasattr(src, "close"):
        try:
            src.close()
        except ValueError:
            pass  # still running in the prefetch thread (the run failed); it ends with it


def _stop_profiler(prof: contextlib.ExitStack, logdir: str) -> None:
    """End the `utils/profiling.py::trace` window, which writes its trace."""
    prof.close()
    log.info("wrote a torch.profiler trace to %s", os.path.join(logdir, "profile"))
