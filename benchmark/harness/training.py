"""The training kind: steps of the system's train step over a pool of
device-resident batches in turn. Set-up runs the timed state's first
`checked_steps` steps through the window's call and feed; the reference
follows them from the same weights on the same batches."""
from __future__ import annotations

import time

import torch

from harness import check, program, traffic as gen
from harness.cell import Cell


class Training(Cell):
    ROLE = "train"
    FLOP_PASSES = 3  # a forward and a backward
    SYSTEM_STATE = ("trainer", "window_losses")

    @staticmethod
    def rows(cfg: dict, traffic: dict) -> int:
        return traffic["rows_3d"] + traffic["rows_2d"]

    @staticmethod
    def items(traffic: dict) -> int:
        return traffic["rows_3d"] + traffic["rows_2d"]

    @staticmethod
    def crop_dtype(cfg: dict) -> str:
        return "float32"  # in [0, 1], for the augmentation after the warp

    @staticmethod
    def pool(traffic: dict, cfg: dict, seed: int, device) -> dict:
        return gen.train_pool(traffic, cfg, seed, device)

    def reset_outputs(self) -> None:
        self.window_losses = []  # every timed step's loss

    def prepare_system(self) -> None:
        self.trainer = program.Trainer(self.cfg, self.traffic, self.model, self.inputs)

    def batches(self) -> list:
        return self.inputs["batches"]

    def warm_up(self) -> None:
        """The first steps of the timed state: the checked steps, whose
        readings the check compares, then the rest of the warm-up."""
        self.checked = self._checked_steps()
        self.mark("checked steps")
        for _ in range(self.traffic["warmup_steps"] - self.traffic["checked_steps"]):
            self.trainer.step(self.batch()[1])

    def _checked_steps(self) -> dict:
        params = dict(self.trainer.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, global_norms, grad_norms = [], [], None
        for t in range(self.traffic["checked_steps"]):
            metrics = self.trainer.step(self.batch()[1])
            losses.append(float(metrics["loss"]))
            global_norms.append(float(metrics["grad_norm"]))
            if t == 0:
                first = {k: self.trainer.first_moment(p).detach() / (1 - check.ADAM_BETA1)
                         for k, p in params.items()}
                grad_norms = check.norms(first)
        change = {k: float((p.detach().double() - start[k].double()).norm())
                  for k, p in params.items()}
        return {"losses": losses, "global_norms": global_norms, "grad_norms": grad_norms,
                "first_grads": first, "change_norms": change}

    def loop(self, go, rec, prof) -> int:
        k = 0
        while go(k):
            _, b = self.batch()
            ts = time.perf_counter()
            metrics = self.trainer.step(b)
            rec.host_ms.append((time.perf_counter() - ts) * 1e3)
            self.window_losses.append(metrics["loss"])
            k += 1
            if prof is not None:
                prof.step()
        return k

    # ------------------------------------------------------------ check
    def failed_items(self) -> int:
        """Train rows of steps whose loss is not finite."""
        bad = sum(not bool(torch.isfinite(v)) for v in self.window_losses)
        return bad * self.items(self.traffic)

    def reference_steps(self, precision: str) -> dict:
        return check.reference_training(self.cfg, self.traffic, self.weights, self.inputs,
                                        self.ref, precision)

    def readings(self) -> tuple:
        return check.training_readings(
            self.checked, self.reference_steps(self.cfg["reference_precision"])), 0

    def control_readings(self, precision: str) -> tuple:
        full = self.reference_steps(self.cfg["reference_precision"])
        return check.training_readings(self.reference_steps(precision), full), 0
