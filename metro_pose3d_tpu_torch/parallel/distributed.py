"""Joining a data-parallel job (`metro_pose3d_tpu/parallel/distributed.py`):
the process group of `torch.distributed`, and each process's share of a
global batch.

The JAX package's processes join through `jax.distributed.initialize` and
then run one pjit program over a global mesh. Here each process is one rank
of a `torch.distributed` process group and runs the same step on its own
rows; `parallel/mesh.py` holds the collectives that XLA inserts under the
mesh. A launcher such as `torchrun --nproc_per_node=N` sets the environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) that
`initialize_distributed` reads.

`make_global_batch` has no counterpart: no global array is ever assembled,
each rank keeps its own rows, and rank r's rows are rows r * per .. (r + 1)
* per - 1 of the global batch (`local_batch_slice`).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from metro_pose3d_tpu_torch.device import resolve_device


def in_group() -> bool:
    """Whether a process group is up (a group of one process counts)."""
    return dist.is_available() and dist.is_initialized()


def process_index_count() -> tuple:
    """(rank, world size) of `torch.distributed`, or (0, 1) where it is not
    initialized."""
    if in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(rank: int | None = None, world_size: int | None = None,
                           init_method: str | None = None, backend: str | None = None,
                           timeout: float | None = None, device=None) -> bool:
    """Join the process group (`initialize_multihost`) -> whether this call
    created it.

    A no-op (False) where a group is already up (a second call, or a
    launcher that made one) and where the world has one process: no
    `world_size` and `WORLD_SIZE` unset or 1. Unset arguments come from
    torchrun's environment: `RANK`, `WORLD_SIZE`, and `init_method`
    "env://", which reads `MASTER_ADDR` and `MASTER_PORT`. `backend`
    defaults to "nccl" where the rank's device (`resolve_device(device)`:
    the card of `LOCAL_RANK` unless `device` names one) is CUDA, "gloo" on
    the CPU; on CUDA that device becomes the current one. `timeout`
    (seconds, default torch's) bounds the rendezvous and every collective.

    Every failure raises: an unreachable rendezvous, a missing `RANK`, a
    world that never completes. Nothing falls back to a single-process
    world, where each process would train on its own rows with its own
    batch statistics and its own gradients, and nothing would crash.
    """
    if in_group():
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return False
    if rank is None:
        if "RANK" not in os.environ:
            raise RuntimeError(f"a world of {world_size} processes needs RANK")
        rank = int(os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank, **kwargs)
    return True


def local_batch_slice(global_batch_size: int, rank: int | None = None,
                      world_size: int | None = None) -> tuple:
    """(this rank's batch size, its offset in the global batch) for an evenly
    split batch; `rank` and `world_size` default to `process_index_count()`.
    A global batch that the ranks cannot split evenly raises ValueError."""
    if rank is None or world_size is None:
        rank, world_size = process_index_count()
    if global_batch_size % world_size:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{world_size} processes")
    per = global_batch_size // world_size
    return per, per * rank
