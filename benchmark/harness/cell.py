"""One cell: build the system once, prepare it from a seed (weights, traffic,
the system made ready on them), warm it up, run the measured window, check
what the window produced.

What differs between traffic kinds (the pool, the system's call, the loop,
the reference's answers) is a class of its own, `Kind` in
`benchmark/kinds/<kind>.py`, found by the traffic file's `kind`; the serving
and training kinds build on `harness/serving.py` and `harness/training.py`."""
from __future__ import annotations

import gc
import time

import torch

from harness import peaks, program, shapes, spec as specs, weights


class Record:
    """What one window measured; the metric readers read it."""

    def __init__(self, cell, setup_s):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.kind = cell.ROLE  # "serve" or "train": which readers apply
        self.setup_s = setup_s
        self.window_s = 0.0
        self.iterations = 0  # batches or steps completed in the window
        self.items = 0  # crops completed in the window
        self.latency_ms = []  # serving: submission to outputs on the host
        self.host_ms = []  # the system's call: predict_* or the step
        self.timeline = None  # the traced segment's, in a traced run
        self.peak_window_bytes = 0

    def per_iteration_ms(self, predicate) -> float:
        return self.timeline.time_s(predicate) * 1e3 / self.timeline.iterations

    def flops_per_iteration(self) -> int:
        return shapes.iteration_flops(self.cfg, self.traffic)

    def roofline_share(self, kernel: str) -> float:
        """The kernel's bound (`benchmark/rooflines/<kernel>.py`) over its
        device time in the trace, in %. The bound per launch is the mean
        over the launches an iteration makes, so launches the profiler
        misses do not count against it. A kernel the trace lacks fails."""
        roof = specs.module("rooflines", kernel)
        launches = roof.launches(self.cfg, self.traffic)
        seen = self.timeline.kernels(lambda n: any(k in n for k in roof.NAMES))
        if not launches or not seen:
            raise RuntimeError(f"{kernel}: {len(seen)} launches in the trace, "
                               f"{len(launches)} expected an iteration")
        bound = sum(peaks.bound_s(*launch) for launch in launches) / len(launches)
        time_s = sum(t - s for s, t, _ in seen) / 1e6
        return 100.0 * bound * len(seen) / time_s


def make(cell: dict, device):
    """The cell's `Kind` (by its traffic's `kind`), built on `device`."""
    return specs.kind(cell["traffic"]["kind"])(cell, device)


class Cell:
    """What every kind shares. A kind sets `ROLE` ("serve" or "train": which
    metric readers apply) and `FLOP_PASSES` (forwards a row costs), and gives

      rows(cfg, traffic), items(traffic)   static: crops the backbone sees an
                                           iteration, and crops a user gets
      crop_dtype(cfg)                      static: the type K1 writes crops in
      pool(traffic, cfg, seed, device)     static: the seed's inputs, sized
                                           by the traffic file alone
      reset_outputs(), prepare_system(), batches(), warm_up()
      loop(go, rec, prof) -> iterations    while go(k), each noted in rec
      readings() -> (readings, failed items), against the reference
      control_readings(precision) -> the same, of the reference at
                                     `precision` in the system's place
    """

    ROLE = ""
    FLOP_PASSES = 1
    SYSTEM_STATE = ()  # attributes that free_program drops

    def __init__(self, cell: dict, device):
        self.cfg = cell["config"]
        self.traffic = cell["traffic"]
        self.device = torch.device(device)
        self.ref = specs.reference(self.cfg)
        if self.device.type == "cuda":
            program.kernel_library_loaded()
        self.model = program.build_model(self.cfg, self.device, train=self.ROLE == "train")
        self.shapes = program.parameter_shapes(self.model)
        want = self.ref.parameter_shapes(self.cfg)
        if self.shapes != {k: tuple(v) for k, v in want.items()}:
            raise ValueError("the system's parameters are not the reference's: "
                             f"{sorted(set(self.shapes) ^ set(want))[:6]}")

    # ------------------------------------------------------------ set-up
    def mark(self, what: str) -> None:
        """Note the end of a set-up stage (printed by the run)."""
        self.marks.append((what, time.perf_counter()))

    def prepare_inputs(self, seed: int) -> None:
        """The seed's weights and traffic, made by the benchmark."""
        self.seed = seed
        self.marks = [("", time.perf_counter())]
        self.weights = weights.make(self.shapes, seed, self.device)
        self.mark("weights")
        self.inputs = self.pool(self.traffic, self.cfg, seed, self.device)
        self.mark("traffic")
        self.next = 0  # the pool index of the next iteration
        self.reset_outputs()

    def prepare(self, seed: int) -> None:
        """The inputs, and the system made ready on them."""
        self.prepare_inputs(seed)
        program.load_weights(self.model, self.weights)
        self.prepare_system()
        self.mark("system")

    def batch(self):
        """-> (pool index, batch) of the next iteration: the pool in turn."""
        batches = self.batches()
        i = self.next % len(batches)
        self.next += 1
        return i, batches[i]

    def warm(self) -> None:
        """Every shape the window uses, through the window's own calls."""
        self.warm_up()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark("warm-up")

    # ------------------------------------------------------------ window
    def window(self, seconds: float, rec: Record, prof=None, iterations: int = 0) -> None:
        """The loop for `seconds`, or for `iterations` under the profiler
        `prof`; it ends in a sync, and `rec` gets its time and its work."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        if iterations:
            go = lambda k: k < iterations  # noqa: E731
        else:
            go = lambda k: time.perf_counter() < t0 + seconds  # noqa: E731
        k = self.loop(go, rec, prof)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec.window_s = time.perf_counter() - t0
        rec.iterations = k
        rec.items = k * self.items(self.traffic)
        if self.device.type == "cuda":
            rec.peak_window_bytes = torch.cuda.max_memory_allocated(self.device)

    # ------------------------------------------------------------ check
    def failed_items(self) -> int:
        """Items the window failed outside the readings."""
        return 0

    def free_program(self) -> None:
        """The system's state goes before the reference runs, so that the
        reference fits and sets no peak of the system's."""
        for name in self.SYSTEM_STATE + ("model",):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
