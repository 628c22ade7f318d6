"""Spans and counters inside the port, traces and step timing
(`metro_pose3d_tpu/utils/profiling.py`).

`span` and `count` record where the host is and what it counted, but only
while a `torch.profiler` session records; `recorded` returns the last
session's record. `trace` records a `torch.profiler` trace (the host, and
the card's kernels where CUDA is present) into a directory; `StepTimer`
keeps step latency percentiles and throughput; `sync` waits for the card;
and `device_memory_stats` reads each card's allocator.

Usage:
    with span("serve.forward"):              # a span, nested in the open one
        out = fn(x)
    count("int8.weight_bytes", wq.numel())   # a counter, in the open root span
    launch("metro_warp_crop")                # a port kernel's launch, before it

    with trace(logdir):                      # a trace of a few steps, spans named
        step(...)
    rec = recorded()                         # that session's spans, counts,
                                             # launches and clock anchors

    timer = StepTimer()
    for batch in data:
        out = step(batch)
        sync(out)
        timer.tick(batch_size)               # call after each step
    print(timer.summary())                   # p50/p90 latency, items/sec

The gate is `torch.autograd.profiler._is_profiler_enabled`, which a
profiler sets when its RECORD phase starts and clears when it stops: the
benchmark's traced segment, the trainer's `profile_steps` window and `trace`.
Off, `span` returns one shared no-op object and `count` and `launch` return
at once: no allocation, no clock read. On, each span is also a profiler
label (so a trace with CPU activity shows it beside the kernels it
launched) and keeps its name, its parent, the sequence number of its root
span (the batch or step) and its start and end. A new session's first
record clears the last session's.

The clock is `time.time_ns()`, the Unix clock Kineto stamps its events on,
but not exactly: the offset varies from session to session, and the rate
may too. So where CUDA is initialised the session's first record, and the
profiler's stop, synchronise the card and launch one marker kernel
(`torch.cuda._sleep(0)`, `spin_kernel` in the trace) between two host
stamps; a reader of the trace maps host times through the two markers'
device starts.

CUDA launches return before the kernel has run, so a step's wall time
means something only after `sync`.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
MARKER_KERNEL = "spin_kernel"  # `torch.cuda._sleep`'s kernel, the clock anchor
# the profiler's label of a span: `record_function`'s C++ core without the
# dispatcher's round trip, 0.5 us a span on the card's host against 7-8 us;
# a trace with CPU activity shows it as an op
_Label = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span returned while no profiler records: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("recorder", "name", "index", "parent", "seq", "start_ns", "end_ns", "_label")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name

    # the stamps enclose the profiler's label, so that its cost falls in the
    # span and the host time between two sibling spans is a few lines here
    def __enter__(self):
        self.recorder.enter(self)
        self.start_ns = time.time_ns()
        self._label = _Label(self.name)
        self._label.__enter__()
        return self

    def __exit__(self, *exc):
        self._label.__exit__(*exc)
        self.end_ns = time.time_ns()
        self.recorder.exit(self)
        return False


class Recorder:
    """What the port recorded in one profiler session: spans, counts, kernel
    launches and the clock anchors. One per process (`RECORDER`), as the
    profiler is; a span belongs to the thread that drives the device."""

    def __init__(self):
        self.fresh = True
        self._clear()

    def begin(self) -> None:
        """A profiler session started: its first record replaces the last
        session's (a session that records nothing, such as the one a
        profiler opens and closes when it exits in WARMUP, replaces none)."""
        self.fresh = True

    def _clear(self) -> None:
        self.spans, self.counts, self.launches, self.anchors = [], [], [], []
        self.stack, self.roots = [], 0

    def _anchor(self) -> None:
        """Where CUDA is initialised (and no CUDA graph is being captured,
        which a sync would break): drain the card, and stamp the host on
        each side of the marker's launch."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return
        torch.cuda.synchronize()
        before = time.time_ns()
        torch.cuda._sleep(0)
        self.anchors.append({"before_ns": before, "after_ns": time.time_ns()})
        torch.cuda.synchronize()  # the marker has run, also before the profiler stops

    def _first(self) -> None:
        """A session's first record: clear, and anchor."""
        self.fresh = False
        self._clear()
        self._anchor()

    def end(self) -> None:
        """The profiler stops: a second anchor, so that a reader maps the
        host clock onto the trace's by offset and rate."""
        if not self.fresh and len(self.anchors) == 1:
            self._anchor()

    def seq(self) -> int:
        """The open root span's number in the session (-1 outside any)."""
        return self.stack[0].seq if self.stack else -1

    def enter(self, sp: _Span) -> None:
        if self.fresh:
            self._first()
        sp.index = len(self.spans)
        if self.stack:
            sp.parent, sp.seq = self.stack[-1].index, self.stack[0].seq
        else:
            sp.parent, sp.seq = None, self.roots
            self.roots += 1
        self.spans.append(sp)
        self.stack.append(sp)

    def exit(self, sp: _Span) -> None:
        if self.stack and self.stack[-1] is sp:  # one opened in an earlier session is not
            self.stack.pop()

    def count(self, name: str, n: int) -> None:
        if self.fresh:
            self._first()
        self.counts.append((name, n, self.seq()))

    def launch(self, kernel: str) -> None:
        if self.fresh:
            self._first()
        self.launches.append((kernel, time.time_ns(), self.seq()))

    def record(self) -> dict:
        """The session's record, as plain data (times in Unix ns): closed
        spans as dicts (name, parent index or None, seq, start_ns, end_ns),
        counts (name, n, seq), launches (kernel entry point, t_ns, seq), the
        marker kernel's name and the anchors: the host stamps around each
        marker launch, at the session's first record and at its end (none
        without CUDA)."""
        spans = [{"name": s.name, "parent": s.parent, "seq": s.seq, "start_ns": s.start_ns,
                  "end_ns": getattr(s, "end_ns", None)} for s in self.spans]
        return {"spans": spans,
                "counts": [dict(zip(("name", "n", "seq"), c)) for c in self.counts],
                "launches": [dict(zip(("kernel", "t_ns", "seq"), c)) for c in self.launches],
                "marker": MARKER_KERNEL, "anchors": [dict(a) for a in self.anchors]}


RECORDER = Recorder()


def span(name: str):
    """A context manager that records the block as a span named `name`
    while a profiler records; otherwise the shared no-op `OFF`."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(RECORDER, name)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name`, in the open root span, while a
    profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    RECORDER.count(name, n)


def launch(kernel: str) -> None:
    """Stamp the launch of a port kernel (its C entry point, e.g.
    "metro_warp_crop"), just before the call, while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    RECORDER.launch(kernel)


def recorded() -> dict:
    """The spans, counts, launches and anchors of the last (or current)
    profiler session (`Recorder.record`)."""
    return RECORDER.record()


def _install_session_hooks() -> None:
    """Begin a session where the gate is set, and anchor its end where the
    profiler stops: the profiler calls `_run_on_profiler_start` when a RECORD
    phase starts and `_disable_profiler` when it ends, both by their names
    in `torch.autograd.profiler`, which these wrap."""
    start = _autograd_profiler._run_on_profiler_start
    stop = _autograd_profiler._disable_profiler
    if getattr(start, "begins_recorder", False):
        return

    def on_start():
        start()
        RECORDER.begin()

    def on_stop():
        RECORDER.end()
        return stop()

    on_start.begins_recorder = True
    _autograd_profiler._run_on_profiler_start = on_start
    _autograd_profiler._disable_profiler = on_stop


_install_session_hooks()


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
