"""Serving kinds: a closed loop of batches through the system's predict call,
`in_flight` batches enqueued before the oldest one's outputs are waited
for. Every answer of the window is checked against the reference's answer
for the same pool batch. A kind gives `make_batch` (one batch of the pool,
host numpy arrays), `call` (the system's entry on a batch) and
`reference_crops` (the reference's crops from a batch on the device)."""
from __future__ import annotations

import collections
import time

import torch

from harness import check, program, traffic as gen
from harness.cell import Cell


class Serving(Cell):
    ROLE = "serve"
    SYSTEM_STATE = ("server",)

    @staticmethod
    def rows(cfg: dict, traffic: dict) -> int:
        """A batch, doubled by flip test-time augmentation."""
        return traffic["batch"] * (2 if cfg["flip_tta"] else 1)

    @staticmethod
    def items(traffic: dict) -> int:
        return traffic["batch"]

    @staticmethod
    def crop_dtype(cfg: dict) -> str:
        return cfg["compute_dtype"]

    @classmethod
    def pool(cls, traffic: dict, cfg: dict, seed: int, device) -> list:
        return [cls.make_batch(gen.rng(seed, 1 + i), traffic, cfg["proc_side"])
                for i in range(traffic["pool"])]

    def reset_outputs(self) -> None:
        self.answers = []  # (pool index, outputs) of every timed batch

    def prepare_system(self) -> None:
        if self.cfg.get("quantize", "none") == "int8":
            program.calibrate(self.model, gen.calibration_crops(self.cfg, self.seed),
                              self.device)
            self.mark("calibration")
        self.server = program.Server(self.cfg, self.traffic, self.model,
                                     self.traffic["in_flight"] + 1)

    def batches(self) -> list:
        return self.inputs

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_batches"]):
            _, b = self.batch()
            self.server.collect(*self.server.fetch(self.call(self.server.est, b)))

    def loop(self, go, rec, prof) -> int:
        in_flight = self.traffic["in_flight"]
        pending = collections.deque()

        def complete():
            idx, ts, slot, ev = pending.popleft()
            self.answers.append((idx, self.server.collect(slot, ev)))
            rec.latency_ms.append((time.perf_counter() - ts) * 1e3)

        k = 0
        while go(k):
            idx, b = self.batch()
            ts = time.perf_counter()
            out = self.call(self.server.est, b)
            rec.host_ms.append((time.perf_counter() - ts) * 1e3)
            pending.append((idx, ts, *self.server.fetch(out)))
            del out
            while len(pending) >= in_flight:
                complete()
            k += 1
            if prof is not None:
                prof.step()
        while pending:
            complete()
        return k

    # ------------------------------------------------------------ check
    def reference_amax(self, precision: str):
        """The reference's own int8 calibration, where `precision` needs it."""
        if precision not in self.ref.LEVELS:
            return None
        crops = [self.ref.crops_from_u8(torch.from_numpy(c).to(self.device))
                 for c in gen.calibration_crops(self.cfg, self.seed)]
        with self.ref.no_tf32():
            return self.ref.calibrate(self.cfg, self.weights, crops)

    def reference_answers(self, precision: str) -> dict:
        indices = sorted({i for i, _ in self.answers}) or list(range(len(self.inputs)))
        return check.reference_serving(self.cfg, self.inputs, indices, self.ref, self.device,
                                       self.weights, precision,
                                       self.reference_amax(precision), self.reference_crops)

    def readings(self) -> tuple:
        expected = self.reference_answers(self.cfg["reference_precision"])
        r = check.serving_readings(self.answers, expected, self.traffic["batch"])
        return r["readings"], r["bad"]

    def control_readings(self, precision: str) -> tuple:
        want = self.reference_answers(self.cfg["reference_precision"])
        r = check.serving_readings(sorted(self.reference_answers(precision).items()), want,
                                   self.traffic["batch"])
        return r["readings"], r["bad"]
