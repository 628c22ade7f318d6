"""A whole run (set-up, window, check) on the CPU at a small size, the look
for a card skipped, with the timed path broken underneath: `correct` has to
come out false, once for each fault a cell can have, and true without one.
The limits are the cells' own (`benchmark/limits/`)."""
import pytest
import torch

import metro_pose3d_tpu_torch.evaluation.engine as engine
import metro_pose3d_tpu_torch.train.loop as loop
from harness import main
from small import small_cell

SEED = 3_000_000_123


def _run(name):
    torch.set_num_threads(4)
    return main.execute(small_cell(name), SEED, 0.3, False, "cpu", 0.0)


def _altered(method):
    def call(self, *a, **k):
        out = method(self, *a, **k)
        out["pose3d_rootrel"] = out["pose3d_rootrel"].clone()
        out["pose3d_rootrel"][0, 1, 0] += 1000.0  # one joint of one crop, a metre off
        return out
    return call


def _half(method, tiles):
    def call(self, *a):
        if tiles:
            batch = a[0]
            keep = batch["source"].shape[0] // 2
            return method(self, {k: v[:keep] for k, v in batch.items()})
        keep = a[0].shape[0] // 2
        return method(self, a[0][:keep], a[1][:keep])
    return call


@pytest.mark.parametrize("name", ["bf16-crop-tta-b64", "int8-crop-tta-b128",
                                  "bf16-tile-tta-b64", "bf16-train-b96"])
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("name,tiles", [("bf16-crop-tta-b64", False),
                                        ("int8-crop-tta-b128", False),
                                        ("bf16-tile-tta-b64", True)])
def test_serving_faults_are_not_correct(monkeypatch, name, tiles, fault):
    attr = "predict_tiles" if tiles else "predict_crops"
    method = getattr(engine.PoseEstimator, attr)
    monkeypatch.setattr(engine.PoseEstimator, attr,
                        _altered(method) if fault == "answer_altered" else _half(method, tiles))
    assert not _run(name)["correct"]


def _frozen_step(real_step):
    """Adam runs (its moments are kept) and the parameters are put back."""
    def step(self, *a, **k):
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        out = real_step(self, *a, **k)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return out
    return step


def _half_rows(real_augment, real_losses):
    """The first half of the rows through the augmentation, the model and
    the losses; the other half left out."""
    def augment(batch, *a, **k):
        keep = batch["is_3d"].shape[0] // 2
        return real_augment({n: v[:keep] for n, v in batch.items()}, *a, **k)

    def losses(l3, l2, batch, cfg, root):
        keep = l3.shape[0]
        return real_losses(l3, l2, {n: v[:keep] for n, v in batch.items()}, cfg, root)
    return augment, losses


def _update_altered(real_step):
    """One leaf's update made ten times what Adam computed."""
    def step(self, *a, **k):
        p = self.param_groups[0]["params"][0]
        before = p.detach().clone()
        out = real_step(self, *a, **k)
        with torch.no_grad():
            p.copy_(before + 10 * (p - before))
        return out
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_training_faults_are_not_correct(monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", _frozen_step(torch.optim.Adam.step))
    elif fault == "half_batch":
        augment, losses = _half_rows(loop.device_augment, loop.compute_losses)
        monkeypatch.setattr(loop, "device_augment", augment)
        monkeypatch.setattr(loop, "compute_losses", losses)
    else:
        monkeypatch.setattr(torch.optim.Adam, "step", _update_altered(torch.optim.Adam.step))
    r = _run("bf16-train-b96")
    assert not r["correct"], r["checks"]
