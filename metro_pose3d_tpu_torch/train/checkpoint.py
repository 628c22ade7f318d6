"""Checkpoints with auto-resume (`metro_pose3d_tpu/train/checkpoint.py`'s
API): `<logdir>/checkpoints/<step>/state.pt` holds `TrainState.state_dict()`
(model weights and BN statistics, Adam state, step) through `torch.save`.

Every write goes to a temporary directory first and is renamed into place,
so an interrupted save never leaves a partial checkpoint under a step's
name. The last `keep` checkpoints stay. The best one by a validation metric
lives in its own single slot, `<logdir>/best/<step>/`, with the metric in
`best_metric.txt`, so the rolling window cannot evict it. The JAX package's
orbax checkpoints are not read: that needs jax.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import torch

_FILE = "state.pt"


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, _FILE)))


def _write(directory: str, step: int, state) -> None:
    """Atomically write `state` as `<directory>/<step>/state.pt`."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=directory)
    try:
        torch.save(state.state_dict(), os.path.join(tmp, _FILE))
        final = os.path.join(directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _read(directory: str, step: int, state) -> None:
    d = torch.load(os.path.join(directory, str(step), _FILE), map_location="cpu",
                   weights_only=True)
    state.load_state_dict(d)


class Checkpointer:
    def __init__(self, logdir: str, keep: int = 3):
        self.dir = os.path.abspath(os.path.join(logdir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self._best_dir = os.path.abspath(os.path.join(logdir, "best"))
        self._marker = os.path.join(self._best_dir, "best_metric.txt")

    def save(self, step: int, state) -> None:
        """Write the checkpoint of `step` (synchronously) and drop all but
        the newest `keep`."""
        _write(self.dir, step, state)
        for old in _steps(self.dir)[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, str(old)), ignore_errors=True)

    def latest_step(self):
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, state) -> tuple:
        """Load the latest checkpoint into `state` in place -> (state, step);
        (state, 0) when there is none."""
        step = self.latest_step()
        if step is None:
            return state, 0
        _read(self.dir, step, state)
        return state, step

    def best_metric(self):
        if not os.path.exists(self._marker) or not _steps(self._best_dir):
            return None
        with open(self._marker) as f:
            return float(f.read().strip())

    def save_if_best(self, step: int, state, metric: float) -> bool:
        """Keep the checkpoint with the LOWEST `metric` (e.g. validation MPJPE)."""
        best = self.best_metric()
        if best is not None and metric >= best:
            return False
        old = _steps(self._best_dir)
        _write(self._best_dir, step, state)
        fd, tmp = tempfile.mkstemp(dir=self._best_dir)
        with os.fdopen(fd, "w") as f:
            f.write(f"{metric}\n")
        os.replace(tmp, self._marker)
        for s in old:
            if s != step:
                shutil.rmtree(os.path.join(self._best_dir, str(s)), ignore_errors=True)
        return True

    def restore_best(self, state) -> tuple:
        """Load the best checkpoint (or, without one, the latest) -> (state, step)."""
        steps = _steps(self._best_dir)
        if not steps:
            return self.restore(state)
        _read(self._best_dir, steps[-1], state)
        return state, steps[-1]

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (the JAX API's call)."""
