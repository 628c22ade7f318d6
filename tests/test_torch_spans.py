"""The port's spans and counters (`metro_pose3d_tpu_torch/utils/profiling.py`)
on the CPU: off, they are one shared no-op and touch no clock and no memory;
on, they record only while a `torch.profiler` session records, in the
serving call, the int8 weight quantization and the train step, nested as
the code nests them; `trace()` names them in its Chrome trace."""
import itertools
import json
import os
import time
import tracemalloc

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, schedule

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset
from metro_pose3d_tpu_torch.evaluation.engine import PoseEstimator
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models.quantize import QuantConv
from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
from metro_pose3d_tpu_torch.pipeline.loader import prepare_one, stack_examples
from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
from metro_pose3d_tpu_torch.train.loop import make_train_step
from metro_pose3d_tpu_torch.train.state import create_train_state
from metro_pose3d_tpu_torch.utils import profiling

TINY = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
        "model.compute_dtype": "float32"}
CPU = [ProfilerActivity.CPU]


def _cfg(**over):
    return apply_overrides(Config(), {**TINY, **over})


def _crops(b=3):
    rng = np.random.RandomState(5)
    crops = rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)
    intr = np.tile(np.array([[900.0, 0, 31.5], [0, 905.0, 31.5], [0, 0, 1]], np.float32),
                   (b, 1, 1))
    return crops, intr


def _tiles(b=3):
    crops, intr = _crops(b)
    hom = np.tile(np.array([[1 / 128, 0, -0.25], [0, 1 / 128, -0.25], [0, 0, 1]], np.float32),
                  (b, 1, 1))
    return {"source": np.random.RandomState(6).randint(0, 256, (b, 128, 128, 3)).astype(np.uint8),
            "warp_h": hom, "warp_k": np.tile(np.float32([128, 128, 63.5, 63.5]), (b, 1)),
            "warp_dist": np.zeros((b, 5), np.float32), "intrinsics": intr}


def _estimator(**over):
    cfg = _cfg(**over)
    return PoseEstimator(cfg, init_metro_model(cfg.model, 0, "cpu"), H36M_17)


def _names(rec):
    return [s["name"] for s in rec["spans"]]


def _off_calls(times):
    for _ in times:
        profiling.span("serve.forward")
        profiling.count("int8.weight_bytes", 7)
        profiling.launch("metro_warp_crop")


def test_off_a_span_is_the_shared_no_op_and_nothing_is_recorded(monkeypatch):
    with profile(activities=CPU):
        with profiling.span("before"):
            profiling.count("kept", 1)
    kept = profiling.recorded()
    assert _names(kept) == ["before"]

    def no_clock():
        raise AssertionError("a clock was read while no profiler records")

    for name in ("time_ns", "time", "perf_counter", "perf_counter_ns", "monotonic"):
        monkeypatch.setattr(time, name, no_clock)
    assert profiling.span("a") is profiling.span("b") is profiling.OFF
    with profiling.span("a") as sp:
        assert sp is profiling.OFF
        profiling.count("kept", 5)
        profiling.launch("metro_maxpool3x3s2")
    _off_calls(range(10))
    monkeypatch.undo()
    assert profiling.recorded() == kept  # nothing recorded, no count changed

    tracemalloc.start()
    try:
        _off_calls(range(10))
        times = itertools.repeat(None, 1000)
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        _off_calls(times)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current == base and peak == base  # not a byte allocated, even for a moment


def test_spans_record_in_the_active_steps_only_and_a_new_session_clears():
    with profile(activities=CPU, schedule=schedule(wait=0, warmup=2, active=3)) as prof:
        for i in range(5):
            with profiling.span("step"):
                with profiling.span("inner"):
                    profiling.count("n", i)
                    profiling.launch("metro_warp_crop")
            prof.step()
    rec = profiling.recorded()
    assert _names(rec) == ["step", "inner"] * 3
    assert [s["seq"] for s in rec["spans"]] == [0, 0, 1, 1, 2, 2]
    assert [s["parent"] for s in rec["spans"]] == [None, 0, None, 2, None, 4]
    assert [(c["n"], c["seq"]) for c in rec["counts"]] == [(2, 0), (3, 1), (4, 2)]
    assert [(x["kernel"], x["seq"]) for x in rec["launches"]] == [("metro_warp_crop", k)
                                                                 for k in range(3)]
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    step, inner = rec["spans"][:2]
    assert step["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= step["end_ns"]
    assert rec["anchors"] == [] and rec["marker"] == "spin_kernel"  # no CUDA, no anchor

    with profile(activities=CPU):
        with profiling.span("second"):
            pass
    assert _names(profiling.recorded()) == ["second"]


def _serving_record(est, calls):
    with profile(activities=CPU):
        for call in calls:
            call(est)
    return profiling.recorded()


@pytest.mark.parametrize("path", ["crops", "tiles"])
def test_predict_nests_the_copy_and_the_forward_one_batch_id_a_call(path):
    est = _estimator()
    crops, intr = _crops()
    tiles = _tiles()
    call = ((lambda e: e.predict_crops(crops, intr)) if path == "crops"
            else (lambda e: e.predict_tiles(tiles)))
    rec = _serving_record(est, [call, call])
    assert _names(rec) == ["serve.predict", "serve.to_device", "serve.forward"] * 2
    assert [s["parent"] for s in rec["spans"]] == [None, 0, 0, None, 3, 3]
    assert [s["seq"] for s in rec["spans"]] == [0, 0, 0, 1, 1, 1]
    root, copy, fwd = rec["spans"][:3]
    assert root["start_ns"] <= copy["start_ns"] <= copy["end_ns"] <= fwd["start_ns"]
    assert fwd["end_ns"] <= root["end_ns"]


def test_int8_weight_bytes_are_every_quantized_convs_weights():
    est = _estimator(**{"model.quantize": "int8"})
    convs = [m for m in est.model.modules() if isinstance(m, QuantConv)]
    assert convs
    crops, intr = _crops()
    rec = _serving_record(est, [lambda e: e.predict_crops(crops, intr)])
    quant = [s for s in rec["spans"] if s["name"] == "int8.weights"]
    counts = [c for c in rec["counts"] if c["name"] == "int8.weight_bytes"]
    # every QuantConv's weights, once a forward (flip TTA is one doubled batch)
    assert sum(c["n"] for c in counts) == sum(m.weight.numel() for m in convs)
    assert len(quant) == len(counts) == len(convs)
    forward = _names(rec).index("serve.forward")
    assert all(s["parent"] == forward and s["seq"] == 0 for s in quant)


def test_a_train_step_nests_its_four_stages_in_order():
    cfg = _cfg(**{"train.batch_size": "8", "train.batch_size_2d": "0",
                  "train.warmup_steps": "0", "data.source_side": "128"})
    ds = SyntheticDataset(n_train=8, n_test=1, imshape=(256, 256))
    host = stack_examples([prepare_one(ds.train_example(i), ds.joint_info, 64, 128, cfg.aug,
                                       (0, 0, i), 8) for i in range(8)])
    state = create_train_state(cfg, "cpu", seed=1)
    step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(
        make_procedural_occluders(8, 32), "cpu"))
    batch = batch_to_device(host, "cpu")
    with profile(activities=CPU):
        step(state, batch)
    rec = profiling.recorded()
    assert _names(rec) == ["train.step", "train.augment", "train.forward", "train.backward",
                           "train.optimizer"]
    assert [s["parent"] for s in rec["spans"]] == [None, 0, 0, 0, 0]
    ends = [(s["start_ns"], s["end_ns"]) for s in rec["spans"][1:]]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))  # one after another
    assert state.step == 1


def test_trace_names_the_spans(tmp_path):
    est = _estimator()
    crops, intr = _crops()
    with profiling.trace(str(tmp_path / "t")):
        est.predict_crops(crops, intr)
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"serve.predict", "serve.to_device", "serve.forward"} <= names
    assert os.path.exists(tmp_path / "t" / profiling.TRACE_FILE)
