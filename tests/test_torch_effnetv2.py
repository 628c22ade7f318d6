"""The EfficientNetV2 trunk of the port (`models/efficientnet.py`) on the CPU:
against the benchmark's plain reference (`benchmark/reference/metro_effv2.py`)
in float32 at `efficientnetv2-tiny`, its names, shapes and counts at the
published widths of EfficientNetV2-L, its spans and counter, the serving
entry points, what it refuses, and the ResNet trunks left as they were."""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.evaluation.engine import PoseEstimator, make_predict_fn
from metro_pose3d_tpu_torch.export import aot_compile, export_model, load_exported
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models import efficientnet, resnet
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.ops import bn
from metro_pose3d_tpu_torch.train.loop import make_train_step
from metro_pose3d_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
from harness import weights  # noqa: E402
from reference import metro_effv2 as ref  # noqa: E402

EPS, MOMENTUM = 0.001, 0.9
# the reference's description of the two trunks, in automl's block strings
TRUNK_CFG = {
    "efficientnetv2-l": dict(stem_width=32, top_width=1280, blocks=[
        "r4_k3_s1_e1_i32_o32_c1", "r7_k3_s2_e4_i32_o64_c1", "r7_k3_s2_e4_i64_o96_c1",
        "r10_k3_s2_e4_i96_o192_se0.25", "r19_k3_s1_e6_i192_o224_se0.25",
        "r25_k3_s2_e6_i224_o384_se0.25", "r7_k3_s1_e6_i384_o640_se0.25"]),
    "efficientnetv2-tiny": dict(stem_width=8, top_width=64, blocks=[
        "r2_k3_s1_e1_i8_o8_c1", "r2_k3_s2_e4_i8_o16_c1", "r2_k3_s2_e4_i16_o24_se0.25",
        "r1_k3_s1_e6_i24_o32_se0.25", "r2_k3_s2_e6_i32_o40_se0.25",
        "r2_k3_s2_e6_i40_o48_se0.25"]),
}
# float32 on the CPU: the port and the reference run the same float32
# operations but differ in summation order (padding inside the conv or by
# F.pad, the conv kernels chosen), about 2e-7 of logits of order 1, 1.7e-4
# mm of root-relative poses, 4e-6 px of 2D poses and 1.1e-2 mm of absolute
# ones, which the translation solve amplifies (as in the protocol path's
# 0.25 mm); each bound leaves 20 to 50 times that. A bf16 forward of the
# tiny trunk moves the logits by 4e-3 and the poses by 0.80 mm, 9.2e-3 px
# and 21 mm: 80 to 400 times each bound.
LOGIT_TOL = 1e-5
POSE_TOL = {"pose3d_rootrel": 5e-3, "pose2d_px": 1e-4, "pose3d_abs": 0.25}


def _cfg(backbone="efficientnetv2-tiny", dtype="float32", **over):
    side = "64" if backbone.endswith("tiny") else "256"
    return apply_overrides(Config(), {
        "model.backbone": backbone, "model.proc_side": side, "model.bn_epsilon": str(EPS),
        "model.bn_momentum": str(MOMENTUM), "model.compute_dtype": dtype,
        **{f"model.{k}": str(v) for k, v in over.items()}})


def _ref_cfg(cfg):
    m = cfg.model
    return dict(TRUNK_CFG[m.backbone], backbone=m.backbone, proc_side=m.proc_side,
                stride=m.stride, depth=m.depth, num_joints=m.num_joints,
                box_size_mm=m.box_size_mm, bn_epsilon=m.bn_epsilon)


def _seeded(model, cfg, seed=3):
    """The benchmark's seeded weights in `model`, and the same dict for the
    reference."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = weights.make(shapes, seed, "cpu")
    model.load_state_dict(w)
    return w


def _model(cfg, seed=3):
    model = MetroModel(cfg.model).eval()
    return model, _seeded(model, cfg, seed)


def _crops(b=3, side=64, seed=4):
    rng = np.random.RandomState(seed)
    crops = rng.randint(0, 256, (b, side, side, 3)).astype(np.uint8)
    intr = np.tile(np.array([[90.0, 0, 31.5], [0, 92.0, 30.5], [0, 0, 1]], np.float32),
                   (b, 1, 1))
    return crops, intr


def test_logits_equal_the_reference_in_float32_and_bf16_fails_them():
    cfg = _cfg()
    model, w = _model(cfg)
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32))
    with torch.no_grad():
        got = model(x)
        want = ref.Forward(_ref_cfg(cfg), w)(x)
        low = MetroModel(_cfg(dtype="bfloat16").model).eval()
        low.load_state_dict(w)
        coarse = low(x)
    for g, r, c in zip(got, want, coarse):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= LOGIT_TOL
        assert float((c - r).abs().max()) > LOGIT_TOL
    assert float(want[0].abs().max()) > 0.1  # logits of order 1, not vanished


def test_predict_crops_with_tta_equals_the_reference():
    crops, intr = _crops()
    outs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype=dtype)
        model, w = _model(cfg)
        est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
        outs[dtype] = {k: v.double() for k, v in est.predict_crops(crops, intr).items()}
    with torch.no_grad():
        want = ref.predict(_ref_cfg(cfg), w, ref.crops_from_u8(torch.from_numpy(crops)),
                           torch.from_numpy(intr), H36M_17.names)
    failed_by_bf16 = []
    for key, tol in POSE_TOL.items():
        assert float((outs["float32"][key] - want[key].double()).abs().max()) <= tol, key
        failed_by_bf16.append(float((outs["bfloat16"][key] - want[key].double()).abs().max())
                              > tol)
    assert all(failed_by_bf16)


def test_published_widths_names_shapes_counts_and_heatmap_sides():
    """EfficientNetV2-L: the reference's parameters by name and shape, 79
    blocks, 61 SE gates, 217 batch norms, every block's last conv `conv3`,
    and a 16 x 16 heatmap at 256 px with stride 16 (8 x 8 at stride 32)."""
    cfg = _cfg("efficientnetv2-l")
    model = MetroModel(cfg.model).eval()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(v) for k, v in ref.parameter_shapes(_ref_cfg(cfg)).items()}
    trunk = model.backbone
    blocks = [getattr(trunk, n) for n in trunk.fused_blocks + trunk.mbconv_blocks]
    assert (len(trunk.fused_blocks), len(trunk.mbconv_blocks)) == (18, 61)
    assert sum(hasattr(b, "se_reduce") for b in blocks) == 61
    assert sum(isinstance(m, resnet.BatchNorm) for m in model.modules()) == 217
    for b in blocks:
        assert [n for n, m in b.named_children() if isinstance(m, resnet.Conv)][-1] == "conv3"
    assert len(ref.blocks(_ref_cfg(cfg))) == 79 and len(ref.bn_shapes(_ref_cfg(cfg))) == 217
    for stride, side in ((16, 16), (32, 8)):
        trunk = MetroModel(_cfg("efficientnetv2-l", stride=stride).model).backbone.eval()
        with torch.no_grad():
            feats = trunk(torch.zeros(1, 3, 256, 256).contiguous(
                memory_format=torch.channels_last))
        assert tuple(feats.shape) == (1, 1280, side, side)
        assert ref.head_side(dict(_ref_cfg(cfg), stride=stride)) == side


def test_the_stage_plan_drops_strides_and_dilates_after_the_output_stride():
    stages = efficientnet.TRUNKS["efficientnetv2-l"].stages
    assert efficientnet.stage_plan(stages, 16) == [(1, 1), (2, 1), (2, 1), (2, 1), (1, 1),
                                                   (1, 2), (1, 2)]
    assert efficientnet.stage_plan(stages, 32) == [(1, 1), (2, 1), (2, 1), (2, 1), (1, 1),
                                                   (2, 1), (1, 1)]
    assert efficientnet.stage_plan(stages, 8) == [(1, 1), (2, 1), (2, 1), (1, 2), (1, 2),
                                                  (1, 4), (1, 4)]
    model = MetroModel(_cfg("efficientnetv2-l").model)
    assert model.backbone.stage6_block1.conv2.dilation == 2
    assert model.backbone.stage5_block19.conv2.dilation == 1
    assert model.backbone.stage7_block7.conv2.dilation == 2


def _expanded_bytes(cfg, rows):
    """The hand count of the counter: each expanding block's conv1 output, and
    each MBConv's depthwise output, in the compute dtype."""
    item = 2 if cfg.model.compute_dtype == "bfloat16" else 4
    total = 0
    for b in ref.blocks(_ref_cfg(cfg)):
        mid = b["cin"] * b["expand"]
        if b["fused"] and b["expand"] > 1:
            total += mid * b["out_side"] ** 2
        elif not b["fused"]:
            total += mid * (b["in_side"] ** 2 + b["out_side"] ** 2)
    return rows * total * item


def test_spans_and_the_expanded_bytes_counter_in_a_serving_call():
    cfg = _cfg()
    model, _ = _model(cfg)
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    crops, intr = _crops()
    est.predict_crops(crops, intr)  # off: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        est.predict_crops(crops, intr)
    rec = profiling.recorded()
    names = [s["name"] for s in rec["spans"]]
    assert names.count("effv2.fused") == names.count("effv2.mbconv") == 1
    se = [s for s in rec["spans"] if s["name"] == "effv2.se"]
    assert len(se) == sum(b["se"] > 0 for b in ref.blocks(_ref_cfg(cfg))) == 7
    assert all(rec["spans"][s["parent"]]["name"] == "effv2.mbconv" for s in se)
    forward = names.index("serve.forward")
    assert rec["spans"][names.index("effv2.fused")]["parent"] == forward
    got = sum(c["n"] for c in rec["counts"] if c["name"] == efficientnet.EXPANDED_BYTES)
    assert got == _expanded_bytes(cfg, 6)  # 3 crops and their mirrors


def test_every_serving_entry_point_takes_the_trunk(tmp_path):
    """`predict_crops`, `predict_tiles`, `predict_dataset`, an exported bundle
    and `aot_compile` (eager on the CPU), all on the same weights."""
    from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset
    from metro_pose3d_tpu_torch.evaluation.predict import predict_dataset

    cfg = _cfg(dtype="bfloat16", depth=4)
    model, _ = _model(cfg)
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    crops, intr = _crops()
    out = est.predict_crops(crops, intr)
    assert out["pose3d_abs"].shape == (3, 17, 3) and torch.isfinite(out["pose3d_abs"]).all()
    hom = np.tile(np.array([[1 / 128, 0, -0.25], [0, 1 / 128, -0.25], [0, 0, 1]], np.float32),
                  (3, 1, 1))
    tiles = {"source": np.random.RandomState(6).randint(0, 256, (3, 128, 128, 3)).astype(
        np.uint8), "warp_h": hom, "warp_k": np.tile(np.float32([128, 128, 63.5, 63.5]), (3, 1)),
        "warp_dist": np.zeros((3, 5), np.float32), "intrinsics": intr}
    assert torch.isfinite(est.predict_tiles(tiles)["pose3d_rootrel"]).all()
    export_model(cfg, model, str(tmp_path / "bundle"))
    cfg2, model2, fn = load_exported(str(tmp_path / "bundle"), device="cpu")
    assert cfg2.model == cfg.model
    c, k = torch.from_numpy(crops), torch.from_numpy(intr)
    again = fn(model2, c, k)
    compiled = aot_compile(fn, model2, 3, 64)
    for key in out:
        assert torch.equal(again[key], out[key]) and torch.equal(compiled(model2, c, k)[key],
                                                                 out[key]), key
    ds = SyntheticDataset(n_train=4, n_test=3, imshape=(128, 128))
    res = predict_dataset(apply_overrides(cfg, {"data.source_side": "128"}), model, ds)
    assert np.isfinite(np.asarray(res["pose3d_abs"] if "pose3d_abs" in res else
                                  res[next(iter(res))], dtype=np.float64)).all()


def test_int8_training_and_other_paddings_are_refused():
    with pytest.raises(ValueError, match="not ported for the EfficientNetV2 trunk"):
        MetroModel(_cfg(quantize="int8").model)
    with pytest.raises(ValueError, match="training is not ported"):
        MetroModel(_cfg().model, train=True)
    with pytest.raises(ValueError, match="training is not ported"):
        make_train_step(_cfg())
    with pytest.raises(ValueError, match="conv_padding 'same'"):
        MetroModel(_cfg(conv_padding="torch").model)
    with pytest.raises(ValueError, match="efficientnetv2-l"):
        MetroModel(apply_overrides(Config(), {"model.backbone": "resnet51"}).model)


def _parent_conv_forward(self, x):
    """`Conv.forward` before the `groups` argument."""
    weight = self.weight.to(self.dtype)
    bias = None if self.bias is None else self.bias.to(self.dtype)
    top, bottom, left, right = self.pads(*x.shape[2:])
    if (top, left) == (bottom, right):
        return F.conv2d(x, weight, bias, self.stride, (top, left), self.dilation)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, self.stride, 0, self.dilation)


def _parent_bn_forward(self, x, act="none"):
    """`BatchNorm`'s eval path before the activation choice: the float32
    chain, then F.relu where the call site asked for it."""
    assert not self.training and act in ("none", "relu")
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(self.var + self.eps) * self.scale
    y = ((x.float() - self.mean.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(
        self.dtype)
    return F.relu(y) if act == "relu" else y


RESNETS = {
    "tiny_bf16": {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4"},
    "tiny_f32_v15_torch": {"model.backbone": "tiny", "model.proc_side": "64",
                           "model.depth": "4", "model.compute_dtype": "float32",
                           "model.preactivation": "false", "model.conv_padding": "torch",
                           "model.stride_position": "first"},
    "resnet18_keras": {"model.backbone": "resnet18", "model.proc_side": "64",
                       "model.conv_padding": "keras"},
}


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_names_and_outputs_are_the_parent_modules(name, monkeypatch):
    """The ResNet trunks keep their module names and, bit for bit on the
    CPU, the outputs of `Conv` and `BatchNorm` as they were before the
    depthwise conv and the activation choice."""
    cfg = apply_overrides(Config(), RESNETS[name])
    model = init_metro_model(cfg.model, 6, "cpu").eval()
    assert isinstance(model.backbone, resnet.ResNet)
    assert all(not isinstance(m, efficientnet.MBConv) for m in model.modules())
    x = torch.from_numpy(np.random.RandomState(6).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32))
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        got = model(x)
        monkeypatch.setattr(resnet.Conv, "forward", _parent_conv_forward)
        monkeypatch.setattr(resnet.BatchNorm, "forward", _parent_bn_forward)
        want = model(x)
    assert list(model.state_dict()) == list(before)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bn.LAUNCHES == 0


def test_the_predict_fn_runs_without_tta_too():
    cfg = _cfg()
    model, w = _model(cfg)
    fn = make_predict_fn(cfg, H36M_17.mirror_mapping, root_index=0, flip_tta=False)
    crops, intr = _crops()
    out = fn(model, torch.from_numpy(crops), torch.from_numpy(intr))
    assert out["pose2d_px"].shape == (3, 17, 2) and torch.isfinite(out["pose2d_px"]).all()


def test_inference_mode_gives_the_no_grad_outputs_and_follows_a_parameter_change():
    """Serving runs under inference mode: its outputs are those of no_grad,
    and an in-place update of a conv's weight or a batch norm's variance
    shows in the next forward, since nothing derived from a parameter is
    kept between calls."""
    cfg = _cfg(dtype="bfloat16")
    model, w = _model(cfg)
    x = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32))
    conv, norm = model.backbone.stage3_block1.conv1, model.backbone.stage3_block1.bn1
    with torch.no_grad():
        plain = model(x)
    with torch.inference_mode():
        first = model(x)
    for a, b in zip(plain, first):
        assert torch.equal(a, b)
    with torch.no_grad():
        conv.weight.mul_(2.0)
        norm.var.add_(1.0)
        want = model(x)
    with torch.inference_mode():
        got = model(x)
    for a, b, p in zip(want, got, plain):
        assert torch.equal(a, b) and not torch.equal(a, p)


def test_a_forward_derives_every_cast_and_multiplier_in_one_pass_with_the_same_bits(
        monkeypatch):
    """`EfficientNetV2.derived` gives each dense conv's weight and bias in the
    compute dtype and each batch norm's eval multiplier with the bits of the
    modules' own derivation. A bf16 forward casts no dense conv's parameter
    on its own (only the depthwise weights, which the twin rounds as the
    kernel takes them) and runs one rsqrt for all the batch norms."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = _cfg(dtype="bfloat16")
    model, w = _model(cfg)
    trunk = model.backbone
    with torch.no_grad():
        for m in trunk.norms:
            m.var.uniform_(0.5, 2.0)
            m.scale.uniform_(-1.5, 1.5)
        d = trunk.derived()
    dense = [m for m in trunk.modules() if isinstance(m, resnet.Conv) and m.groups == 1]
    depthwise = [m for m in trunk.modules() if isinstance(m, resnet.Conv) and m.groups > 1]
    assert trunk.dense == dense and len(trunk.norms) == 29 and depthwise
    for m in dense:
        weight, bias = d[m]
        assert weight.dtype == torch.bfloat16 and torch.equal(weight, m.weight.to(torch.bfloat16))
        assert (bias is None) == (m.bias is None)
        assert bias is None or torch.equal(bias, m.bias.to(torch.bfloat16))
    for m in trunk.norms:
        assert torch.equal(d[m], torch.rsqrt(m.var + m.eps) * m.scale)

    casts = []
    to = torch.nn.Parameter.to

    def counted(self, *args, **kw):
        casts.append(self)
        return to(self, *args, **kw)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(torch.nn.Parameter, "to", counted, raising=False)
    x = torch.rand(2, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), Ops() as ops:
        trunk(x)
    assert [id(p) for p in casts] == [id(m.weight) for m in depthwise]
    assert ops.seen.count("rsqrt") == 1
