"""Metric writers (`metro_pose3d_tpu/utils/writers.py`): TensorBoard scalars
where `torch.utils.tensorboard` imports, and always a JSON-lines mirror,
`history.jsonl`, one `{"step": int, name: float, ...}` row per write, as the
JAX package writes it, so a run stays readable without TensorBoard.
"""
from __future__ import annotations

import json
import os


class NullWriter:
    """A writer that writes nothing: for every process but the first, which
    alone writes the shared logdir."""

    def write_scalars(self, step: int, scalars: dict):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def make_metric_writer(logdir: str, primary: bool = True):
    """A `MetricWriter` on the primary process, a `NullWriter` elsewhere."""
    return MetricWriter(logdir) if primary else NullWriter()


class MetricWriter:
    """write_scalars(step, dict) to `<logdir>/history.jsonl` (appended and
    flushed at every write) and, where it imports, TensorBoard."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "history.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:  # tensorboard absent or incompatible: JSON only
                self._tb = None

    def write_scalars(self, step: int, scalars: dict):
        clean = {k: float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": int(step), **clean}) + "\n")
        self._jsonl.flush()  # readable while the run goes on, and after a kill
        if self._tb is not None:
            for name, value in clean.items():
                self._tb.add_scalar(name, value, int(step))

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
