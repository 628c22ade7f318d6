"""Host-side batching: deterministic, parallel example preparation
(`metro_pose3d_tpu/pipeline/loader.py`; the port keeps its own copy).

A worker pool runs the per-example host prep (`prepare_example`) and
batches stream to the device:

* Determinism is a contract: every example's RNG is
  `np.random.default_rng((seed, epoch, example_index))`, so any batch is
  reproducible independently of worker scheduling, pool type or host count.
* Each host iterates only indices `host_id::host_count` of the shuffled
  epoch order.
* Workers are threads by default: the C engine (`data.host_prep` native or
  auto) and the C tile copy run without the interpreter lock, while the
  numpy engine holds it for most of its ~700 small numpy calls an example.
  `pool_type="process"` runs decode and prep in spawned worker processes;
  each receives the dataset accessor once (pool initializer) and tasks ship
  only (index, rng key).

The JAX package also patches the environment of spawned workers so that they
start without its TPU runtime hook (`_patch_spawn_env`); the port has no such
hook and leaves the environment alone. This module imports neither torch
nor cv2, so spawned workers stay cheap. They touch CUDA only to decode
JPEGs where libjpeg is missing (`utils/improc.py::jpeg_backend` is then
nvJPEG): a worker process that decodes one opens its own CUDA context, and
holds 538 MiB of device memory from then on (`chip_smoke.py` phase
22, NVIDIA H100 80GB HBM3, 700.00 W). Spawn, the start method here, keeps
that safe; threads share the process's context, each decode with its own
nvJPEG state and stream.
"""
from __future__ import annotations

import concurrent.futures as _futures
import multiprocessing
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from metro_pose3d_tpu_torch.config import AugConfig
from metro_pose3d_tpu_torch.geom.joints import JointInfo
from metro_pose3d_tpu_torch.pipeline.crops import Example, prepare_example, sample_aug_params


def stack_examples(prepared: Sequence[dict]) -> dict:
    """List of prepared-example dicts -> dict of batched arrays."""
    keys = prepared[0].keys()
    return {k: np.stack([p[k] for p in prepared]) for k in keys}


def prefetch(iterator: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run `iterator` in a background thread, keeping `depth` batches ready.

    Overlaps host-side example preparation with the device step (one daemon
    thread and a bounded queue). Exceptions re-raise at the consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def prepare_one(
    example: Example,
    joint_info: JointInfo,
    proc_side: int,
    tile_side: int,
    aug_cfg: Optional[AugConfig],
    rng_key: tuple,
    n_occluders: int,
    box_expansion: float = 1.0,
    n_backgrounds: int = 0,
    engine: str = "python",
) -> dict:
    """Deterministic single-example prep (aug_cfg=None -> test-time path).

    `n_backgrounds` > 0 activates green-screen background replacement: the
    prepared dict gains "source_mask"/"bg_params" (all batches of a loader
    must agree, so this is a loader-level switch, not per-example).
    `engine` selects the crop-parameter math (config `data.host_prep`); the
    rng draws are the same for every engine."""
    if aug_cfg is None:
        return prepare_example(
            example, joint_info, proc_side, tile_side, aug=None,
            box_expansion=box_expansion, with_background=n_backgrounds > 0,
            engine=engine,
        )
    rng = np.random.default_rng(rng_key)
    aug, occ_center = sample_aug_params(rng, aug_cfg, n_occluders, n_backgrounds)
    return prepare_example(
        example, joint_info, proc_side, tile_side, aug=aug, occ_center=occ_center,
        box_expansion=box_expansion, with_background=n_backgrounds > 0,
        engine=engine,
    )


# --- process-pool plumbing --------------------------------------------------
# Worker state installed once per process by the pool initializer; tasks then
# ship only (example index, rng key). Spawn, not fork: the parent holds
# threads (prefetch, CUDA) that must not be duplicated.
_WORKER_STATE: dict = {}


def _init_worker(get_example, joint_info, proc_side, tile_side, aug_cfg,
                 n_occluders, box_expansion, n_backgrounds, engine):
    _WORKER_STATE["args"] = (get_example, joint_info, proc_side, tile_side,
                             aug_cfg, n_occluders, box_expansion, n_backgrounds,
                             engine)


def _prep_in_worker(task):
    i, rng_key = task
    (get_example, joint_info, proc_side, tile_side, aug_cfg,
     n_occluders, box_expansion, n_backgrounds, engine) = _WORKER_STATE["args"]
    ex = get_example(int(i))
    return prepare_one(ex, joint_info, proc_side, tile_side, aug_cfg,
                       rng_key, n_occluders, box_expansion, n_backgrounds,
                       engine=engine)


def batch_iterator(
    get_example: Callable[[int], Example],
    n_examples: int,
    joint_info: JointInfo,
    batch_size: int,
    proc_side: int,
    tile_side: int,
    aug_cfg: Optional[AugConfig] = None,
    seed: int = 0,
    shuffle: bool = True,
    n_workers: int = 4,
    host_id: int = 0,
    host_count: int = 1,
    drop_remainder: bool = True,
    max_epochs: Optional[int] = None,
    box_expansion: float = 1.0,
    n_backgrounds: int = 0,
    skip_batches: int = 0,
    n_occluders: int = 1,
    pool_type: str = "thread",
    host_prep: str = "python",
) -> Iterator[dict]:
    """Stream batched host-prepared examples, epoch after epoch.

    `get_example(i)` materializes example i (decoding images lazily keeps the
    dataset an index, not a RAM-resident array). Training (aug_cfg set) loops
    forever unless `max_epochs` is given; evaluation does one deterministic,
    unshuffled pass (pass shuffle=False, max_epochs=1) and pads the tail batch
    when drop_remainder=False (callers mask with the returned "_pad" field).
    `skip_batches` passes over the first full batches of the schedule without
    preparing any of their examples (resume).

    `pool_type="process"` runs decode + prep in spawn-based worker processes
    (config `data.pool_type`); `get_example` must then be picklable (dataset
    bound methods and functools.partial over them are; closures are not) and
    the caller's entry point needs the `if __name__ == "__main__"` guard
    (spawn re-imports __main__). Batches are identical across pool types by
    the (seed, epoch, idx) rng contract.
    """
    if pool_type == "process":
        pool = _futures.ProcessPoolExecutor(
            max_workers=max(n_workers, 1),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker,
            initargs=(get_example, joint_info, proc_side, tile_side, aug_cfg,
                      n_occluders, box_expansion, n_backgrounds, host_prep),
        )
    elif pool_type == "thread":
        pool = _futures.ThreadPoolExecutor(max_workers=max(n_workers, 1))
    else:
        raise ValueError(f"pool_type must be thread|process, got {pool_type!r}")
    epoch = 0
    try:
        while max_epochs is None or epoch < max_epochs:
            order = np.arange(n_examples)
            if shuffle:
                np.random.default_rng((seed, epoch)).shuffle(order)
            local = order[host_id::host_count]

            if pool_type == "process":
                _epoch = epoch

                def prep_map(chunk):
                    return pool.map(
                        _prep_in_worker,
                        [(int(i), (seed, _epoch, int(i))) for i in chunk],
                    )
            else:
                def prep(i):
                    ex = get_example(int(i))
                    return prepare_one(
                        ex, joint_info, proc_side, tile_side, aug_cfg,
                        (seed, epoch, int(i)), n_occluders, box_expansion,
                        n_backgrounds, engine=host_prep,
                    )

                def prep_map(chunk):
                    return pool.map(prep, chunk)

            for start in range(0, len(local), batch_size):
                chunk = local[start : start + batch_size]
                if skip_batches > 0 and len(chunk) == batch_size:
                    # resume: consume the schedule without preparing the
                    # examples; rngs are (seed, epoch, index)-keyed, so the
                    # skipped batches are exactly the ones already trained on
                    skip_batches -= 1
                    continue
                if len(chunk) < batch_size:
                    if drop_remainder:
                        break
                    pad = batch_size - len(chunk)
                    prepared = list(prep_map(chunk))
                    batch = stack_examples(prepared + [prepared[-1]] * pad)
                    batch["_pad"] = np.concatenate(
                        [np.ones(len(chunk), np.float32), np.zeros(pad, np.float32)]
                    )
                    yield batch
                    break
                batch = stack_examples(list(prep_map(chunk)))
                batch["_pad"] = np.ones(batch_size, np.float32)
                yield batch
            epoch += 1
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
