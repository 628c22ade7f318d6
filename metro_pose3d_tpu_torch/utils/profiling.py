"""Tracing and step timing (`metro_pose3d_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace (the host, and the card's kernels
where CUDA is present) into a directory; `StepTimer` keeps step latency
percentiles and throughput; `sync` waits for the card; and
`device_memory_stats` reads each card's allocator.

Usage:
    with trace(logdir):                      # a trace of a few steps
        step(...)

    timer = StepTimer()
    for batch in data:
        out = step(batch)
        sync(out)
        timer.tick(batch_size)               # call after each step
    print(timer.summary())                   # p50/p90 latency, items/sec

CUDA launches return before the kernel has run, so a step's wall time
means something only after `sync`.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def sync(tree=None) -> None:
    """Wait for the card: `torch.cuda.synchronize` on the device of the
    first tensor in `tree` (a tensor, or a dict, list or tuple of them), or,
    with no tensor, on the current device where CUDA is present. A no-op for
    tensors on the CPU, whose ops have finished when they return."""
    t = _first_tensor(tree)
    if t is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
    elif tree is None and torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """A `torch.profiler` trace of the block, written to
    `<logdir>/trace.json` (Chrome trace format; open it in Perfetto or
    chrome://tracing). It records the host's ops and, where CUDA is present,
    the card's kernels; the card (`device`, default the current one) is
    synchronized before the trace stops, so the block's kernels are in it."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Rolling step-latency and throughput tracker.

    `tick(n_items)` after each synchronized step; keeps the last `window`
    durations for robust percentiles (warmup steps excluded by `skip`).
    """

    def __init__(self, window: int = 200, skip: int = 2):
        self.window = window
        self.skip = skip
        self._seen = 0
        self._items = 0
        self._durations: list[float] = []
        self._last = time.perf_counter()

    def tick(self, n_items: int = 1):
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._seen += 1
        if self._seen <= self.skip:
            return dt
        self._items += n_items
        self._durations.append(dt)
        if len(self._durations) > self.window:
            self._durations.pop(0)
        return dt

    def reset_clock(self):
        self._last = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if not self._durations:
            return 0.0
        return 1.0 / float(np.mean(self._durations))

    def items_per_sec(self, items_per_step: int) -> float:
        return self.steps_per_sec * items_per_step

    def percentile_ms(self, q: float) -> float:
        if not self._durations:
            return 0.0
        return float(np.percentile(self._durations, q) * 1000)

    def summary(self, items_per_step: int | None = None) -> dict:
        out = {
            "steps": self._seen,
            "p50_ms": round(self.percentile_ms(50), 2),
            "p90_ms": round(self.percentile_ms(90), 2),
            "p99_ms": round(self.percentile_ms(99), 2),
            "steps_per_sec": round(self.steps_per_sec, 3),
        }
        if items_per_step:
            out["items_per_sec"] = round(self.items_per_sec(items_per_step), 1)
        return out


def device_memory_stats() -> dict:
    """Per CUDA device, in bytes: `bytes_in_use` and `peak_bytes_in_use`
    (PyTorch's caching allocator: tensors allocated now, and at most since
    the last `torch.cuda.reset_peak_memory_stats`) and `bytes_limit` (the
    card's total memory). `{}` where no CUDA device exists."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats
