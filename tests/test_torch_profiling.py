"""The port's tracing and step timing (`metro_pose3d_tpu_torch/utils/profiling.py`)
against the JAX package's `utils/profiling.py`, on the CPU.

`StepTimer` is the same arithmetic in both: fed the same `time.perf_counter`
readings (monkeypatched), their summaries are equal. The cases of
`tests/test_profiling.py` run on the port's timer. `sync` and
`device_memory_stats` have no device here: `sync` returns at once and the
memory statistics are `{}`, as the JAX package's are where the backend
exposes none. `trace` writes a Chrome trace that names the ops it saw.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from metro_pose3d_tpu.utils import profiling as jprof
from metro_pose3d_tpu_torch.utils import profiling

TIMER_CASES = {  # name: (window, skip, items per step, number of ticks)
    "defaults": (200, 2, 32, 40),
    "short_window": (10, 0, 7, 50),
    "long_skip": (5, 6, None, 9),
    "all_skipped": (200, 2, 16, 2),
}


def _readings(n: int) -> list:
    """Clock readings in seconds: steps of 5-40 ms with a slow first one."""
    steps = np.random.RandomState(n).uniform(0.005, 0.040, n + 1)
    steps[1] = 0.5
    return list(np.cumsum(steps) + 1000.0)


@pytest.mark.parametrize("case", sorted(TIMER_CASES))
def test_step_timer_summary_equals_jax(monkeypatch, case):
    window, skip, items, n = TIMER_CASES[case]
    out = {}
    for name, mod in (("jax", jprof), ("port", profiling)):
        clock = iter(_readings(n))
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(window=window, skip=skip)
        dts = [timer.tick(items or 1) for _ in range(n)]
        out[name] = (dts, timer.summary(items_per_step=items), timer.percentile_ms(75),
                     timer.items_per_sec(3))
    assert out["port"] == out["jax"]
    assert set(out["port"][1]) == ({"steps", "p50_ms", "p90_ms", "p99_ms", "steps_per_sec"}
                                   | ({"items_per_sec"} if items else set()))


def test_percentiles_and_throughput():
    t = profiling.StepTimer(skip=1)
    t.reset_clock()
    for _ in range(6):
        time.sleep(0.01)
        t.tick(32)
    s = t.summary(items_per_step=32)
    assert s["steps"] == 6
    assert 5 <= s["p50_ms"] <= 100
    assert s["items_per_sec"] > 0
    assert s["p99_ms"] >= s["p50_ms"]


def test_warmup_excluded():
    t = profiling.StepTimer(skip=2)
    t.reset_clock()
    time.sleep(0.05)  # a slow first call
    t.tick()
    time.sleep(0.05)
    t.tick()
    for _ in range(3):
        time.sleep(0.005)
        t.tick()
    assert t.percentile_ms(99) < 40  # the first calls' times are not kept


def test_window_bounds_memory():
    t = profiling.StepTimer(window=10, skip=0)
    for _ in range(50):
        t.tick()
    assert len(t._durations) == 10


def test_sync_none_and_tree_on_the_cpu():
    profiling.sync()
    profiling.sync(torch.ones(4))
    profiling.sync({"a": torch.ones(4), "b": [torch.zeros((2, 2))]})
    profiling.sync((np.zeros(3), "no tensor"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only contract")
def test_memory_stats_without_a_card_is_empty():
    stats = profiling.device_memory_stats()
    assert stats == {}
    for v in jprof.device_memory_stats().values():  # the JAX package's keys
        assert set(v) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


def test_trace_writes_a_chrome_trace_naming_the_ops(tmp_path):
    x = torch.randn(2, 3, 16, 16)
    w = torch.randn(4, 3, 3, 3)
    with profiling.trace(str(tmp_path / "t")):
        torch.nn.functional.conv2d(x, w)
    path = tmp_path / "t" / profiling.TRACE_FILE
    assert os.path.exists(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names, sorted(n for n in names if n)[:20]
