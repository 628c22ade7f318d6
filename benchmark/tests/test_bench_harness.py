"""The harness on the CPU: what BENCHMARK.json names resolves to files, the
yardstick's counts, the traffic generator, the trace arithmetic, and what
the benchmark may import."""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import check, kernels, peaks, shapes, spec, trace, traffic

BENCH = spec.BENCH
BENCH_JSON = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
R50 = dict(backbone="resnet50", stride=16, num_joints=17, depth=8, proc_side=256,
           flip_tta=True, compute_dtype="bfloat16")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_JSON["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = spec.cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert spec.kind(c["traffic"]["kind"]).ROLE in ("serve", "train")
    spec.reference(c["config"])
    for m in c["end_to_end"] + c["per_layer"]:
        assert hasattr(spec.module("metrics", m["name"]), "read")
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    assert set(c["limits"]["control"]) == {"reference_precision"}


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "kinds").glob("*.py")))
def test_every_kind_gives_what_a_cell_calls(name):
    k = spec.kind(name)
    assert k.ROLE in ("serve", "train") and k.FLOP_PASSES in (1, 3)
    for method in ("rows", "items", "crop_dtype", "pool", "reset_outputs", "prepare_system",
                   "batches", "warm_up", "loop", "readings", "control_readings"):
        assert callable(getattr(k, method)), method


def test_benchmark_json_keeps_the_contract_shapes():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                 "moves", "workloads"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and not c["reduced"]
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


def test_flop_count_is_the_hand_count_of_r50_v2_at_256_stride_16():
    # stem 7x7/2 3->64 at 128^2; the stages at 64^2, 32^2, 16^2, 16^2 (the
    # last dilated), each unit 1x1 -> 3x3 -> 1x1, a stage's stride on its
    # last unit's 3x3 (whose 1x1 after it runs at the smaller side)
    stem = 128 * 128 * 64 * 7 * 7 * 3

    def stage(cin, w, n, side, out_side):
        proj = side * side * cin * 4 * w
        first = side * side * (cin * w + 9 * w * w + w * 4 * w)
        mid = side * side * (4 * w * w + 9 * w * w + w * 4 * w)
        last = side * side * 4 * w * w + out_side ** 2 * (9 * w * w + w * 4 * w)
        return proj + first + (n - 2) * mid + last

    macs = (stem + stage(64, 64, 3, 64, 32) + stage(256, 128, 4, 32, 16)
            + stage(512, 256, 6, 16, 16) + stage(1024, 512, 3, 16, 16))
    heads = 16 * 16 * 2048 * 17 * 9
    assert shapes.forward_flops(R50) == 2 * (macs + heads) == 15_316_549_632


def test_flop_count_matches_the_reference_forward_convolutions():
    from reference import metro

    counted = []
    real = torch.nn.functional.conv2d

    def counting(x, w, *a, **k):
        y = real(x, w, *a, **k)
        counted.append(y.shape[2] * y.shape[3] * w.shape[0] * w[0].numel())
        return y

    shapes_ = metro.parameter_shapes(R50)
    p = {k: torch.zeros(s) for k, s in shapes_.items()}
    torch.nn.functional.conv2d = counting
    try:
        with torch.no_grad():
            metro.Forward(dict(R50, bn_epsilon=1e-5, bn_momentum=0.99), p)(
                torch.zeros(1, 256, 256, 3))
    finally:
        torch.nn.functional.conv2d = real
    assert 2 * sum(counted) == shapes.forward_flops(R50)


@pytest.mark.parametrize("kernel,traffic_,ms", [
    # PERF.md's kernel table: K3 [128,64,128,128] bf16, K3 backward
    # [96,64,128,128], K1 B=64 512^2 -> 256^2 bf16 normalize and float32,
    # K2 B=96 with a bank of 64 96^2 tiles, QK1's 52 convs at B=128
    ("k3", {"kind": "serve_crops", "batch": 64}, 0.1002),
    ("k3bwd", {"kind": "train", "rows_3d": 64, "rows_2d": 32}, 0.1352),
    ("k1", {"kind": "serve_tiles", "batch": 64, "tile_side": 512}, 0.0225),
    ("k1", {"kind": "train", "rows_3d": 64, "rows_2d": 0, "tile_side": 512}, 0.0301),
    ("k2", {"kind": "train", "rows_3d": 64, "rows_2d": 32, "occluders": 64,
            "occluder_side": 96}, 0.0458),
    ("qk1", {"kind": "serve_crops", "batch": 64}, 1.3367),
])
def test_roofline_bytes_are_the_kernel_table_bounds(kernel, traffic_, ms):
    launches = spec.module("rooflines", kernel).launches(R50, traffic_)
    got = sum(b for b, _, _ in launches) / peaks.HBM_BYTES_PER_S * 1e3
    assert round(got, 4) == ms


def test_qk2_bytes_at_the_kernel_tables_stage_1_forms():
    # the table's QK2 bound sums one quantize (bf16 -> int8), one junction
    # (int32 -> int8) and one dequant (int32 -> bf16) at stage 1, B=128
    launches = spec.module("rooflines", "qk2").launches(R50, {"kind": "serve_crops",
                                                               "batch": 64})
    assert len(launches) == 20
    quantize = [b for b, _, _ in launches if b == 128 * 256 * 64 * 64 * 3]
    assert quantize, "the stage-1 quantize of a 256-channel input"
    junction, dequant = 128 * 64 * 64 * 64 * (4 + 1), 128 * 256 * 64 * 64 * (4 + 2)
    assert round((quantize[0] + junction + dequant) / peaks.HBM_BYTES_PER_S * 1e3, 4) == 0.4107


def test_a_seed_fixes_the_inputs_and_never_their_sizes():
    tr = {"kind": "serve_tiles", "batch": 3, "tile_side": 40, "pool": 2}
    cfg, big = {"proc_side": 32}, 2**31 + 12345
    pool = spec.kind("serve_tiles").pool
    a, b = pool(tr, cfg, big, "cpu"), pool(tr, cfg, big, "cpu")
    c = pool(tr, cfg, 7, "cpu")
    for x, y, z in zip(a, b, c):
        for k in x:
            assert np.array_equal(x[k], y[k]) and x[k].shape == z[k].shape
    assert not np.array_equal(a[0]["source"], c[0]["source"])
    pool(tr, cfg, -5, "cpu")  # any whole number


def test_train_pool_is_deterministic_on_the_device_it_is_made_on():
    tr = {"kind": "train", "rows_3d": 3, "rows_2d": 1, "tile_side": 32, "pool": 2,
          "occluders": 3, "occluder_side": 16, "backgrounds": 2}
    cfg = {"proc_side": 16, "num_joints": 17}
    a, b = traffic.train_pool(tr, cfg, 99, "cpu"), traffic.train_pool(tr, cfg, 99, "cpu")
    for x, y in zip(a["batches"], b["batches"]):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert torch.equal(a["occluders"], b["occluders"])
    assert a["batches"][0]["is_3d"].tolist() == [1, 1, 1, 0]


class _E:
    def __init__(self, name, s, t, cuda=False, thread=1):
        from torch.autograd import DeviceType

        self.name, self.thread = name, thread
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("R", (), {"start": s, "end": t})()


def test_timeline_busy_idle_breakdown_and_optimizer_phase():
    ev = [_E("client.iter", 0, 100, cuda=True), _E("warp_crop_kernel", 10, 30, True),
          _E("multi_tensor_apply_kernel", 40, 50, True), _E("elementwise_kernel", 50, 55, True),
          _E("multi_tensor_apply_kernel", 55, 60, True), _E("warp_crop_kernel", 110, 190, True),
          _E("aten::conv", 5, 20)]
    ev[0].is_user_annotation = True  # a host span mirrored onto the device: no work
    tl = trace.Timeline(ev, 2)
    assert tl.iterations == 2 and tl.window_s == pytest.approx(180e-6)  # [10, 190]
    assert tl.busy_s == pytest.approx(120e-6)  # [10, 30], [40, 60], [110, 190]
    assert kernels.optimizer_spans(tl.device) == [(40, 60)]
    bd = tl.breakdown()
    assert bd["device_ops"][0][0] == "warp_crop_kernel"
    assert dict(bd["idle_gaps"]) == {"before multi_tensor_apply_kernel": pytest.approx(10e-6),
                                     "before warp_crop_kernel": pytest.approx(50e-6)}


def test_kernel_kinds():
    assert kernels.is_conv("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc")
    assert not kernels.is_conv("void int8_conv_wgmma_kernel(CUtensorMap)")
    assert kernels.is_port("void maxpool3x3s2_bwd_kernel<__nv_bfloat16, 8>()")
    assert kernels.is_torch_other("void at::native::vectorized_elementwise_kernel<4>()")
    assert kernels.is_transfer("Memcpy HtoD (Pageable -> Device)")


def test_verdict_needs_every_number_within_its_limit():
    assert check.verdict({"a": 1.0}, {"a": 2.0}, 0)[0]
    assert not check.verdict({"a": 3.0}, {"a": 2.0}, 0)[0]
    assert not check.verdict({"a": 1.0}, {}, 0)[0]  # no limits: not correct
    assert not check.verdict({"b": 1.0}, {"a": 2.0}, 0)[0]  # a limit with no number
    assert check.verdict({"a": 1.0, "extra": {"x": 1}}, {"a": 2.0}, 0)[1] == [("a", 1.0, 2.0)]
    assert not check.verdict({"a": float("nan")}, {"a": 2.0}, 0)[0]
    assert not check.verdict({"a": 1.0}, {"a": 2.0}, 3)[0]  # a failed answer


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_jax_nor_the_jax_package_nor_the_smoke_scripts(path):
    names = _imports(BENCH / path)
    assert not names & {"jax", "jaxlib", "flax", "metro_pose3d_tpu", "chip_smoke", "bench"}
    if path.startswith("reference/"):
        assert "metro_pose3d_tpu_torch" not in names and "harness" not in names
    elif not path.startswith("tests/") and path != "harness/program.py":
        assert "metro_pose3d_tpu_torch" not in names  # the system enters through program.py


def test_forbidden_modules_compares_top_level_names_whole():
    import sys

    from harness import main

    sys.modules["metro_pose3d_tpu_torch_fake"] = sys  # a longer name is not the package
    try:
        assert "metro_pose3d_tpu" not in main.forbidden_modules()
    finally:
        del sys.modules["metro_pose3d_tpu_torch_fake"]
