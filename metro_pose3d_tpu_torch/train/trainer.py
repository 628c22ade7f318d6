"""Single-process training loop (`metro_pose3d_tpu/train/trainer.py`):
moves host batches to the device, runs the step, and keeps the books:
`config.json`, `history.jsonl` (appended at every log step) and
`history.json` (the whole run, written at the end), checkpoints every
`checkpoint_every` steps with auto-resume, `data.cycle_batches` and a
`torch.profiler` trace of `profile_steps` steps into `<logdir>/profile`.

The host input pipeline is not ported (the JAX package's loader sits
behind jax-importing package `__init__`s), so `train` takes an iterator of
host batches in the `example_spec` layout. On resume it discards the first
`start_step` batches of that iterator, as the JAX loader's `skip_batches`
does, so a resumed run sees the batches an uninterrupted one would.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from metro_pose3d_tpu_torch.config import Config, apply_matmul_precision, config_to_json
from metro_pose3d_tpu_torch.device import resolve_device
from metro_pose3d_tpu_torch.pipeline.backgrounds import get_background_bank
from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
from metro_pose3d_tpu_torch.pipeline.occluders import get_occluder_bank
from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
from metro_pose3d_tpu_torch.train.loop import make_lr_schedule, make_train_step
from metro_pose3d_tpu_torch.train.state import create_train_state

log = logging.getLogger("metro_torch.train")


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


def _check_supported(cfg: Config, total: int) -> None:
    if cfg.train.fused_steps > 1:
        raise NotImplementedError("train.fused_steps > 1 is not ported (measured null)")
    if cfg.train.validate_every and cfg.train.validate_every <= total:
        raise NotImplementedError(
            "in-loop validation (train.validate_every > 0) needs predict_dataset, which "
            "is not ported yet; set train.validate_every=0")


def train(cfg: Config, batches: Iterator[dict], occluder_bank: Optional[np.ndarray] = None,
          max_steps: Optional[int] = None, root_index: int = 0, device=None,
          background_bank: Optional[np.ndarray] = None):
    """Train to `train.num_steps` (or `max_steps`) -> the final `TrainState`.

    batches: host batches (numpy, `pipeline/device.py::example_spec` layout
    of the JAX package). occluder_bank: float RGBA [N,T,T,4] in [0, 1]
    (default: `get_occluder_bank(data.occluder_root)`, procedural without
    VOC). background_bank: uint8 [N,T,T,3] scene images, T the batches'
    source side; with `aug.background_prob` > 0 and a first batch that
    carries "source_mask" (the data has masks) it defaults to
    `get_background_bank(data.background_root, data.source_side)`
    (procedural without a directory), and a batch that carries
    "source_mask" and "bg_params" is composited onto it; otherwise no bank
    is built or used. device: default the card; a RuntimeError where CUDA
    is absent.
    """
    t = cfg.train
    total = min(t.num_steps, max_steps or t.num_steps)
    _check_supported(cfg, total)
    batches = iter(batches)
    device = resolve_device(device)
    apply_matmul_precision(cfg)
    os.makedirs(t.logdir, exist_ok=True)
    with open(os.path.join(t.logdir, "config.json"), "w") as f:
        f.write(config_to_json(cfg))

    state = create_train_state(cfg, device)
    ckpt = Checkpointer(t.logdir, t.keep_checkpoints)
    state, start_step = ckpt.restore(state)
    if start_step:
        log.info("resumed from step %d", start_step)

    if occluder_bank is None:
        occluder_bank = get_occluder_bank(cfg.data.occluder_root or None,
                                          tile_side=cfg.aug.occluder_tile_side)
    # 3DHP green-screen replacement, where the data has masks: the
    # reference asks its dataset, the port the first batch
    first = next(batches, None)
    has_masks = first is not None and "source_mask" in first
    batches = itertools.chain([] if first is None else [first], batches)
    bg_bank = None
    if cfg.aug.background_prob > 0 and has_masks:
        if background_bank is None:
            background_bank = get_background_bank(cfg.data.background_root or None,
                                                  side=cfg.data.source_side)
        bg_bank = torch.from_numpy(np.ascontiguousarray(background_bank)).to(device)
        log.info("background replacement on: bank of %d tiles", len(background_bank))
    step_fn = make_train_step(cfg, root_index,
                              occluder_bank=pack_occluder_bank_for(occluder_bank, device),
                              background_bank=bg_bank)

    if cfg.data.cycle_batches > 0:
        # device-resident batches served round-robin; the phase follows the step
        buf = [batch_to_device(next(batches), device) for _ in range(cfg.data.cycle_batches)]
        it = (buf[i % len(buf)] for i in range(start_step, total))
    else:
        for _ in range(start_step):
            next(batches)
        it = (batch_to_device(b, device) for b in batches)

    lr_sched = make_lr_schedule(cfg)
    history = _prior_history(t.logdir, start_step) if start_step else []
    prof_at = start_step + 3 if t.profile_steps > 0 else None  # past the first steps
    prof = None
    t_last, n_since = time.perf_counter(), 0
    with open(os.path.join(t.logdir, "history.jsonl"), "a") as jsonl:
        done = start_step
        while done < total:
            if prof_at is not None and done == prof_at:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            batch = next(it)
            metrics = step_fn(state, batch)
            n_since += int(batch["is_3d"].shape[0])
            done += 1
            if prof is not None and done - prof_at >= t.profile_steps:
                _stop_profiler(prof, device, t.logdir)
                prof, prof_at = None, None

            if done % t.log_every == 0 or done == total:
                scalars = {k: float(v) for k, v in metrics.items()}  # syncs
                dt = time.perf_counter() - t_last
                scalars["crops_per_sec"] = n_since / dt
                scalars["learning_rate"] = float(lr_sched(done - 1))
                log.info("step %d loss=%.4f (3d=%.4f 2d=%.4f) |g|=%.2f %.1f crops/s", done,
                         scalars["loss"], scalars["loss3d"], scalars["loss2d"],
                         scalars["grad_norm"], scalars["crops_per_sec"])
                row = {"step": done, **scalars}
                jsonl.write(json.dumps(row) + "\n")
                jsonl.flush()
                history.append(row)
                t_last, n_since = time.perf_counter(), 0
            if done % t.checkpoint_every == 0 or done == total:
                ckpt.save(done, state)
    if prof is not None:  # the run ended inside the traced window
        _stop_profiler(prof, device, t.logdir)
    ckpt.wait()
    with open(os.path.join(t.logdir, "history.json"), "w") as f:
        json.dump(history, f)
    return state


def _stop_profiler(prof, device, logdir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = os.path.join(logdir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    log.info("wrote a torch.profiler trace to %s", out)
