"""The EfficientNetV2-L cell `bf16-effv2l-crop-tta-b64` and what it reads: the
cell end to end at a small size on the CPU, the reference against the system
in float32; the seeded weights at the published widths; the FLOP count and
the `bn_act` roofline's bytes against hand counts; the new readers on a
record with and without the system's EfficientNetV2 spans; on the card, the
fp8 control against every serving limit."""
import copy
import sys
import types

import numpy as np
import pytest
import torch

import readings
from harness import main, peaks, program, spec, traffic, weights
from test_bench_spans import ns, record, timeline

CELL = "bf16-effv2l-crop-tta-b64"
CONFIG = "metro-effv2l-256-bf16"
TINY = {"backbone": "efficientnetv2-tiny", "proc_side": 64, "stem_width": 8, "top_width": 64,
        "blocks": ["r2_k3_s1_e1_i8_o8_c1", "r2_k3_s2_e4_i8_o16_c1", "r2_k3_s2_e4_i16_o24_se0.25",
                   "r1_k3_s1_e6_i24_o32_se0.25", "r2_k3_s2_e6_i32_o40_se0.25",
                   "r2_k3_s2_e6_i40_o48_se0.25"]}
# float32 on the CPU, as tests/test_bench_reference.py's serving cells: the
# two sides differ by summation order only
SERVE_TOL = {"rootrel_mm": 1e-2, "pose2d_px": 1e-3, "abs_mm": 5e-2}
NEW_READERS = ("mbconv_host_ms.serve", "idle_mbconv_ms.serve", "idle_se_ms.serve",
               "expanded_mb.serve")


def small_cell(dtype="float32"):
    c = copy.deepcopy(spec.cell(CELL))
    c["config"].update(TINY, compute_dtype=dtype)
    c["config"]["port"] = dict(c["config"]["port"], **{
        "model.backbone": TINY["backbone"], "model.proc_side": "64",
        "model.compute_dtype": dtype})
    c["traffic"].update(batch=3, tile_side=96, pool=3)
    return c


def published(dtype="float32"):
    cfg = spec.config(CONFIG)
    return dict(cfg, compute_dtype=dtype, port=dict(cfg["port"], **{
        "model.compute_dtype": dtype}))


def test_the_cell_end_to_end_at_a_small_size():
    result = main.execute(small_cell(), 2**31 + 99, 0.3, False, "cpu", 0.0)
    assert result["correct"] and result["failed"] == 0, result
    assert set(result["metrics"]) == {"crops_per_s", "batch_ms_p95", "setup_s"}
    for k, tol in SERVE_TOL.items():
        assert result["checks"][k]["value"] <= tol, (k, result["checks"])


def test_seeded_weights_at_published_widths_give_a_soft_heatmap():
    """One crop through the system and the reference in float32 on the
    benchmark's weights. The statistic: the largest probability of any voxel
    of any joint's 3D heatmap after the soft-argmax's softmax. It lies
    between 1.5 times the uniform 1 / (16 * 16 * 8) and 0.05 (one-hot is 1):
    the heads neither vanish nor saturate (seeds 1 and 2^31 + 77 read 0.0016
    and 0.0021). The logits agree within 1e-3 (round-off of 79 blocks, of
    logits of order 1), and the FLOPs counted from the reference's own convs
    are `forward_flops`."""
    cfg = published()
    ref = spec.reference(cfg)
    model = program.build_model(cfg, "cpu", train=False).eval()
    w = weights.make(program.parameter_shapes(model), 2**31 + 5, "cpu")
    program.load_weights(model, w)
    x = ref.crops_from_u8(torch.from_numpy(traffic.uint8_noise(traffic.rng(3, 1),
                                                               (1, 256, 256, 3))))
    counted = []
    real = torch.nn.functional.conv2d

    def counting(inp, wt, *a, **k):
        y = real(inp, wt, *a, **k)
        counted.append(y.shape[2] * y.shape[3] * wt.shape[0] * wt[0].numel())
        return y

    with torch.no_grad():
        got = model(x)
        torch.nn.functional.conv2d = counting
        try:
            want = ref.Forward(cfg, w)(x)
        finally:
            torch.nn.functional.conv2d = real
    assert 2 * sum(counted) == ref.forward_flops(cfg) == 61_368_399_872
    for g, r in zip(got, want):
        assert torch.isfinite(g).all() and float((g - r).abs().max()) <= 1e-3
    p = torch.softmax(got[0].reshape(1, -1, cfg["num_joints"]), dim=1)
    top = float(p.max())
    assert 1.5 / p.shape[1] < top < 0.05, top


def test_bn_act_bytes_are_a_hand_count_of_one_block():
    """Stage 4's first MBConv block at 128 rows (64 crops, TTA): bn1 after
    the 1x1 expansion to 384 channels at 32^2, bn2 after the stride-2
    depthwise conv at 16^2, bn3 after the projection to 192 at 16^2; bf16 in
    and out, and 12 bytes a channel of float32 mean, mul and bias."""
    cfg = spec.config(CONFIG)
    roof = spec.module("rooflines", "bn_act")
    tr = spec.traffic("crop-tta-b64")
    names = [b["name"] for b in spec.reference(cfg).bn_shapes(cfg)]
    launches = roof.launches(cfg, tr)
    assert len(launches) == len(names) == 217
    block = "backbone.stage4_block1"
    got = [launches[names.index(f"{block}.bn{i}")] for i in (1, 2, 3)]
    rows = 128
    want = [rows * 384 * 32 * 32 * 4 + 12 * 384, rows * 384 * 16 * 16 * 4 + 12 * 384,
            rows * 192 * 16 * 16 * 4 + 12 * 192]
    assert [b for b, _, _ in got] == want
    assert [ops for _, ops, _ in got] == [7 * rows * 384 * 1024, 7 * rows * 384 * 256,
                                          3 * rows * 192 * 256]
    # the whole forward: 79.08 M elements a crop, 40.49 GB, bound by bytes
    total = sum(peaks.bound_s(*launch) for launch in launches)
    assert round(total * 1e3, 4) == 12.0868


def test_the_mfu_reader_counts_the_references_flops():
    rec = types.SimpleNamespace(kind="serve", timeline=object(), cfg=spec.config(CONFIG),
                                traffic=spec.traffic("crop-tta-b64"), iterations=10,
                                window_s=1.0)
    got = spec.module("metrics", "effv2_mfu.serve").read(rec)
    assert got == pytest.approx(100 * 61_368_399_872 * 128 * 10 / 989e12)
    rec.cfg = spec.config("metro-r50v2-256-bf16")  # a reference without a FLOP count
    assert spec.module("metrics", "effv2_mfu.serve").read(rec) is None


def _effv2_record():
    """test_bench_spans's record with the EfficientNetV2 spans inside its
    forward and the counter."""
    r = record()

    def sp(name, parent, a, b):
        return {"name": name, "parent": parent, "seq": 0, "start_ns": ns(a), "end_ns": ns(b)}

    r["spans"] = r["spans"][:3] + [sp("effv2.fused", 2, 181, 185),
                                   sp("effv2.mbconv", 2, 185, 238), sp("effv2.se", 4, 190, 210)]
    r["counts"] = [{"name": "effv2.expanded_bytes", "n": 2_500_000, "seq": 0},
                   {"name": "effv2.expanded_bytes", "n": 500_000, "seq": 0}]
    return r


def _rec():
    return types.SimpleNamespace(kind="serve", timeline=timeline())


def test_the_new_readers_read_the_effv2_spans(monkeypatch):
    from harness import program_spans

    fake = types.ModuleType("recorder")
    fake.recorded = _effv2_record
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, fake)
    read = {n: spec.module("metrics", n).read(_rec()) for n in NEW_READERS}
    # the trace's idle [160, 200] falls in the MBConv span from 185 (5 us
    # outside the gate, 10 in it); [220, 260] in it from 220 to 238 (18 us)
    assert read == pytest.approx({"mbconv_host_ms.serve": 0.053, "idle_mbconv_ms.serve": 0.023,
                                  "idle_se_ms.serve": 0.010, "expanded_mb.serve": 3.0})


@pytest.mark.parametrize("name", NEW_READERS)
def test_the_new_readers_read_none_where_the_system_lacks_the_spans(monkeypatch, name):
    """A system without the EfficientNetV2 trunk (the R50 cells, or a parent
    that cannot build the trunk) records other spans and no such counter:
    None, not an error. (No recorder at all, and a recorder that recorded
    nothing, are `test_bench_spans.py`'s cases for every span reader.)"""
    from harness import program_spans

    fake = types.ModuleType("recorder")
    fake.recorded = record
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, fake)
    assert spec.module("metrics", name).read(_rec()) is None


@pytest.mark.cuda
def test_the_fp8_control_fails_every_serving_number(cuda_device):
    """At the cell's own size: the reference rounding to fp8 wherever the
    system keeps bf16 reads above every limit of the cell on each seed."""
    cell = spec.cell(CELL)
    limits = cell["limits"]["checks"]
    for seed, r, bad in readings.control_readings(cell, cuda_device, [424242, 434343, 444444]):
        assert bad or all(r[k] > lim for k, lim in limits.items()), (seed, r)
        assert np.isfinite([r[k] for k in limits]).all()
