"""One run of one cell: set-up, the measured window (and, traced, a segment
under the profiler), the metrics, the check, and the result line."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from harness import check, spec as specs, trace
from harness.cell import Record, make

FORBIDDEN = ("jax", "jaxlib", "flax", "metro_pose3d_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: `metro_pose3d_tpu_torch` is not `metro_pose3d_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(device, n_chips: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": n_chips,
            "memory_peak_bytes": peak_bytes}


def metric_values(entries: list, rec: Record) -> dict:
    """Each metric's reader (`benchmark/metrics/<name>.py`) on the record;
    a reader that returns None is left out of the line."""
    out = {}
    for m in entries:
        value = specs.module("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
            n_chips: int = 1) -> dict:
    """The run, as a result dict (`checks` last). Usable on the CPU by tests."""
    device = torch.device(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    c = make(cell, device)
    marks.append(("model and kernels", time.perf_counter()))
    c.prepare(seed)
    c.warm()
    marks += c.marks[1:]
    peak_setup = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = Record(c, time.perf_counter() - t_start)
    print("set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(marks, marks[1:]))
          + f"; window at {rec.setup_s:.2f}", file=sys.stderr)
    c.window(seconds, rec)
    attempted = rec.items
    if traced:
        # the trace is a segment of its own after the window: the profiler's
        # start and its reading of the events would stall the window
        tr = c.traffic
        prof, holder = trace.tracer(tr["trace_wait"], tr["trace_iterations"])
        segment = Record(c, 0.0)
        with prof:
            c.window(0.0, segment, prof, tr["trace_wait"] + trace.WARMUP + tr["trace_iterations"])
        attempted += segment.items
        rec.timeline = trace.Timeline(holder["events"], tr["trace_iterations"])
        del holder["events"]
    peak = max(peak_setup, rec.peak_window_bytes)
    entries = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = metric_values(entries, rec)
    failed = c.failed_items()
    c.free_program()
    readings, bad = c.readings()
    correct, rows = check.verdict(readings, cell["limits"]["checks"], bad + failed)
    result = {"correct": correct, "attempted": attempted, "failed": failed + bad,
              "metrics": metrics, "device": device_info(device, n_chips, peak)}
    if traced:
        result["device"].update(busy_s=rec.timeline.busy_s, window_s=rec.timeline.window_s)
        result["breakdown"] = rec.timeline.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = specs.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     t_start, chips)
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
