"""The port's int8 serving path (`metro_pose3d_tpu_torch/models/quantize.py`,
`ops/int8.py`) against the JAX package's (`metro_pose3d_tpu/models/quantize.py`).

Inputs come from numpy seeds; weights from flax init, converted with
`metro_pose3d_tpu_torch.convert`. Bit for bit: the weight quantization, the
int32 accumulators of every conv class given the same int8 inputs (against
`lax.conv_general_dilated` with `preferred_element_type=int32`), the
quantize and junction forms given the same inputs and scales (against the
flax `QuantConv` itself, through a 1x1 identity conv whose accumulator is
127 * its int8 input), and `percentile_like_jnp` against `jnp.percentile`.
Within stated bounds: junctions from BN parameters (`rsqrt` may differ by an
ulp), calibrated `amax` (float32 activations that differ in the last bits),
whole-model int8 logits and the poses of `make_predict_fn`.
"""
import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import chip_smoke

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.evaluation.engine import make_predict_fn as jax_make_predict_fn
from metro_pose3d_tpu.geom.joints import H36M_17
from metro_pose3d_tpu.models import quantize as jq
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, make_predict_fn
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models import quantize as tq
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.models.resnet import parse_quantize_extras
from metro_pose3d_tpu_torch.ops import int8

SIDE = 64


def _cfg(**over):
    base = {"model.backbone": "tiny", "model.proc_side": str(SIDE), "model.depth": "4",
            "model.compute_dtype": "float32", "model.quantize": "int8"}
    base.update({f"model.{k}": str(v) for k, v in over.items()})
    return apply_overrides(Config(), base)


def _crops(seed, n=2):
    return np.random.RandomState(seed).uniform(-1, 1, (n, SIDE, SIDE, 3)).astype(np.float32)


def _flax_variables(cfg, seed=0):
    """flax init of the model's parameter tree (params and batch_stats; the
    quantize fields change neither), with batch statistics moved off (0, 1)
    so that every BN affine does something. Cached by the fields that shape
    the tree: one init serves every int8 case of a backbone."""
    m = cfg.model
    return _flax_tree(m.backbone, m.preactivation, m.conv_padding, m.stride_position,
                      m.v2_biases, seed)


@functools.lru_cache(maxsize=None)
def _flax_tree(backbone, preact, padding, position, biases, seed):
    cfg = _cfg(quantize="none", backbone=backbone, preactivation=preact, conv_padding=padding,
               stride_position=position, v2_biases=biases)
    model = FlaxMetro(cfg.model)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIDE, SIDE, 3)))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + np.abs(rng.normal(size=v.shape)).astype(np.float32) * 0.1,
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _jax_calibrate(cfg, variables, batches):
    """The reference's `calibrate` on a calibration graph of `cfg`: it makes
    the "quant" collection of exactly the convs that `cfg` quantizes."""
    calib = FlaxMetro(dataclasses.replace(cfg.model, quantize=jq.calib_mode(cfg.model)))
    return jq.calibrate(calib, dict(variables), [jnp.asarray(b) for b in batches])


def _flax_apply(cfg, variables, x):
    model = FlaxMetro(cfg.model)
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    return [np.asarray(o) for o in out]


def _load_uncalibrated(cfg, variables):
    """The port's int8 model on a tree without "quant": every `amax` 0."""
    port = MetroModel(cfg.model)
    missing, unexpected = port.load_state_dict(state_dict_from_flax(variables), strict=False)
    assert not unexpected and missing and all(k.endswith(".amax") for k in missing)
    return port


def _amaxes(state: dict) -> dict:
    return {k: float(v) for k, v in state.items() if k.endswith(".amax")}


# ------------------------------------------------------------ weights


def test_weight_quantization_bit_exact():
    rng = np.random.RandomState(0)
    kernel = rng.normal(0, 0.1, (3, 3, 16, 24)).astype(np.float32)  # HWIO
    kernel[..., 5] = 0.0  # an all-zero output channel: swc = 1e-12, wq = 0
    sw = jnp.max(jnp.abs(kernel), axis=(0, 1, 2)) / 127.0  # the reference's lines
    swc = jnp.maximum(sw, 1e-12)
    wq = jnp.clip(jnp.round(kernel / swc), -127.0, 127.0).astype(jnp.int8)
    conv = tq.QuantConv(16, 24, 3)
    conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    got_wq, got_swc = conv.int8_weights()
    assert torch.equal(got_swc, torch.from_numpy(np.asarray(swc)))
    assert float(got_swc[5]) == np.float32(1e-12)
    want = torch.from_numpy(np.asarray(wq).transpose(3, 0, 1, 2).copy())  # HWIO -> OHWI
    assert torch.equal(got_wq, want)
    assert not got_wq[5].any()


# ------------------------------------------------------------ accumulators

# (kernel, stride, dilation, padding as XLA takes it, input side, cin):
# every conv class of the int8 graph
CONV_CLASSES = {
    "1x1_s1": (1, 1, 1, "SAME", 9, 16),
    "1x1_s2": (1, 2, 1, "SAME", 9, 16),
    "3x3_s1": (3, 1, 1, "SAME", 10, 16),
    "3x3_s2_same_even": (3, 2, 1, "SAME", 10, 32),
    "3x3_s2_same_odd": (3, 2, 1, "SAME", 11, 8),
    "3x3_dil2": (3, 1, 2, "SAME", 9, 16),
    "7x7_s2_cin3": (7, 2, 1, "SAME", 20, 3),
    "3x3_s2_torch_pads": (3, 2, 1, [(1, 1), (1, 1)], 10, 16),
    "7x7_s2_torch_pads": (7, 2, 1, [(3, 3), (3, 3)], 16, 3),
    "3x3_s1_odd_cin": (3, 1, 1, "SAME", 7, 5),
}


def _port_pads(padding, side, k, stride, dilation):
    from metro_pose3d_tpu_torch.models.resnet import _same_pads

    if padding == "SAME":
        return (*_same_pads(side, k, stride, dilation), *_same_pads(side, k, stride, dilation))
    (t, b), (l, r) = padding
    return t, b, l, r


@pytest.mark.parametrize("case", sorted(CONV_CLASSES))
def test_int32_accumulators_bit_exact(case):
    k, stride, dil, padding, side, cin = CONV_CLASSES[case]
    rng = np.random.RandomState(len(case))
    x = rng.randint(-127, 128, (2, side, side, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, cin, 12)).astype(np.int8)  # HWIO
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), padding,
        rhs_dilation=(dil, dil), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(w.transpose(3, 0, 1, 2).copy())  # OHWI
    got = int8.int8_conv(xt, wt, stride, dil, _port_pads(padding, side, k, stride, dil))
    assert got.dtype == torch.int32
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("epilogue", ["requant", "dequant"])
def test_conv_epilogues_equal_the_elementwise_forms(epilogue):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 16, 9, 9)).astype(np.int8))
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randint(-127, 128, (8, 3, 3, 16)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, 8).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 2, 8).astype(np.float32))
    pads = (1, 1, 1, 1)
    acc = int8.int8_conv(x, w, 1, 1, pads)
    form = "junction" if epilogue == "requant" else "dequant"
    dt = None if epilogue == "requant" else torch.bfloat16
    want = int8.int8_elementwise(form, acc, scale, bias, out_dtype=dt)
    got = int8.int8_conv(x, w, 1, 1, pads, epilogue, scale, bias, out_dtype=dt)
    assert torch.equal(got, want)


# the 1x1 route: k = 1 through QK1's epilogues is the integer product
# (`_int_mm`) of the strided input followed by the QK2 form, bit for bit
ONE_BY_ONE_EPILOGUES = {
    "acc": ("acc", {}),
    "requant": ("requant", {"relu": True}),
    "requant_norelu": ("requant", {"relu": False}),
    "dequant_f32": ("dequant", {"out_dtype": torch.float32}),
    "dequant_f32_bias": ("dequant", {"out_dtype": torch.float32, "bias": True}),
    "dequant_bf16": ("dequant", {"out_dtype": torch.bfloat16}),
    "dequant_bf16_bias": ("dequant", {"out_dtype": torch.bfloat16, "bias": True}),
}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", sorted(ONE_BY_ONE_EPILOGUES))
def test_1x1_conv_equals_int_products_then_the_qk2_form(case, stride):
    epilogue, kw = ONE_BY_ONE_EPILOGUES[case]
    rng = np.random.RandomState(11 + stride)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 32, 9, 7)).astype(np.int8))
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randint(-127, 128, (24, 1, 1, 32)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, 24).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 20, 24).astype(np.float32))
    xs = x[:, :, ::stride, ::stride]
    acc = int8.int_products(xs.permute(0, 2, 3, 1).reshape(-1, 32), w[:, 0, 0, :].t())
    acc = acc.reshape(2, xs.shape[2], xs.shape[3], 24).permute(0, 3, 1, 2)
    acc = acc.contiguous(memory_format=torch.channels_last)
    use_bias = bias if epilogue == "requant" or kw.get("bias") else None
    extra = {k: v for k, v in kw.items() if k != "bias"}
    got = int8.int8_conv(x, w, stride, 1, (0, 0, 0, 0), epilogue,
                         None if epilogue == "acc" else scale, use_bias, **extra)
    if epilogue == "acc":
        want = acc
    else:
        form = "junction" if epilogue == "requant" else "dequant"
        want = int8.int8_elementwise(form, acc, scale, use_bias, **extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


# ------------------------------------------------------------ QK1's plan

QK1_SOURCE = (Path(int8.__file__).resolve().parent.parent / "csrc" / "int8_conv.cu").read_text()


def _cu_constant(name):
    """A `constexpr int` of csrc/int8_conv.cu, evaluated from its source."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", QK1_SOURCE).group(1)
    names = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", QK1_SOURCE))
    while re.search(r"\bk[A-Z]\w*", expr):
        expr = re.sub(r"\bk[A-Z]\w*", lambda m: f"({names[m.group(0)]})", expr)
    return eval(expr.split("//")[0])


def test_qk1_plan_constants_are_the_kernels():
    assert _cu_constant("kTileM") == int8.QK1_TILE_M
    assert _cu_constant("kMaxStages") == int8.QK1_MAX_STAGES
    assert _cu_constant("kStagingBytes") == int8.QK1_STAGING_BYTES
    assert _cu_constant("kBarrierBytes") == int8.QK1_BARRIER_BYTES
    assert _cu_constant("kSmemMax") == int8.QK1_SMEM_BYTES


@pytest.mark.parametrize("name", sorted({**chip_smoke.QK1_PATH, **chip_smoke.QK1_PATH_1X1}))
def test_qk1_plan_takes_every_path_shape_into_the_wgmma_variant(name):
    """Each conv of the int8 path (chip_smoke's tables, B = 128) takes the
    wgmma variant: a 128-pixel rectangle of whole output rows, BN that
    divides N (64 for the 64-wide stage, 128, else 256), a stage of whole
    128- or 64-channel chunks, and a ring that fits shared memory."""
    b, c, h, w, n, k, stride, dil = {**chip_smoke.QK1_PATH, **chip_smoke.QK1_PATH_1X1}[name][:8]
    pads = (*_port_pads("SAME", h, k, stride, dil),)
    plan = int8.qk1_plan(b, c, h, w, n, k, k, stride, dil, pads)
    assert plan["variant"] == "wgmma"
    oh, ow = -(-h // stride), -(-w // stride)
    assert plan["bn"] == min(n, 256) and n % plan["bn"] == 0
    assert c % plan["bk"] == 0 and plan["bk"] == (128 if c % 128 == 0 else 64)
    assert plan["tile_w"] == min(ow, 128) and plan["tile_w"] * plan["tile_h"] == 128
    assert ow % plan["tile_w"] == 0 and oh % plan["tile_h"] == 0
    assert plan["tiles"] == b * oh * ow // 128 * (n // plan["bn"])
    smem = (plan["stages"] * (128 + plan["bn"]) * plan["bk"] + int8.QK1_STAGING_BYTES
            + int8.QK1_BARRIER_BYTES)
    assert 4 <= plan["stages"] <= int8.QK1_MAX_STAGES and smem <= int8.QK1_SMEM_BYTES


@pytest.mark.parametrize("shape,aligned,want", [
    ((128, 3, 256, 256, 64, 7, 2, 1, (2, 3, 2, 3)), True, "scalar"),  # the 7x7 stem
    ((2, 24, 9, 10, 40, 3, 1, 1, (1, 1, 1, 1)), True, "scalar"),  # C % 16 != 0
    ((2, 64, 9, 9, 64, 3, 1, 1, (1, 1, 1, 1)), False, "scalar"),  # unaligned tensors
    ((2, 64, 9, 9, 64, 3, 3, 1, (1, 1, 1, 1)), True, "scalar"),  # stride 3
    ((2, 16, 10, 10, 70, 3, 2, 1, (1, 1, 1, 1)), True, "wgmma"),  # ragged N, torch pads
    ((3, 32, 13, 11, 24, 3, 2, 1, (1, 1, 0, 1)), True, "wgmma"),  # odd sizes, uneven pads
], ids=["stem_c3", "c24", "unaligned", "stride3", "torch_pads_n70", "odd_13x11"])
def test_qk1_plan_variant_choice(shape, aligned, want):
    b, c, h, w, n, k, stride, dil, pads = shape
    assert int8.qk1_plan(b, c, h, w, n, k, k, stride, dil, pads, aligned)["variant"] == want


def test_qk1_plan_refuses_what_no_variant_takes():
    with pytest.raises(ValueError, match="no QK1 variant"):
        int8.qk1_plan(1, 16384, 4, 4, 8, 3, 3, 1, 1, (1, 1, 1, 1))  # K = 147456: int32 overflows
    x = torch.zeros((1, 16384, 4, 4), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 16384), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        int8.int8_conv_cuda(x, w, 1, 1, (1, 1, 1, 1))


def test_int8_forward_runs_the_path_tables_through_qk1(monkeypatch):
    """The default int8 model's backbone forward makes one QK1 launch per
    quantized conv, 52 in all: the 16 3x3 convs of `chip_smoke.QK1_PATH`
    and the 36 1x1 convs of `QK1_PATH_1X1`, with their epilogues and
    counts; and 20 QK2 launches, all `quantize`. The launches are recorded
    at B = 1 (the tables' B is the serving batch 128); the recorder returns
    zeros of the launch's shape."""
    calls, forms = [], []

    def record_conv(xq, wq, stride, dilation, pads, epilogue="acc", scale=None, bias=None,
                    relu=True, out_dtype=None):
        b, c, h, w, n, kh, kw, oh, ow = int8._conv_shapes(xq, wq, stride, dilation, pads)
        calls.append((c, h, w, n, kh, stride, dilation, epilogue, out_dtype))
        dtype = {"acc": torch.int32, "requant": torch.int8, "dequant": out_dtype}[epilogue]
        return torch.zeros((b, n, oh, ow), dtype=dtype).contiguous(
            memory_format=torch.channels_last)

    def record_elementwise(form, x, *args, **kwargs):
        forms.append(form)
        return torch.zeros_like(x, dtype=torch.int8)

    monkeypatch.setattr(tq, "int8_conv", record_conv)
    monkeypatch.setattr(tq, "int8_elementwise", record_elementwise)
    from metro_pose3d_tpu_torch.config import Config as PortConfig
    from metro_pose3d_tpu_torch.config import apply_overrides as port_overrides

    cfg = port_overrides(PortConfig(), {"model.quantize": "int8", "model.compute_dtype": "float32"})
    assert cfg.model.proc_side == 256
    model = MetroModel(cfg.model).eval()
    with torch.no_grad():
        model.backbone(torch.zeros((1, 3, 256, 256)).contiguous(memory_format=torch.channels_last))
    want = {}
    for b, c, h, w, n, k, stride, dil, count in chip_smoke.QK1_PATH.values():
        want[c, h, w, n, k, stride, dil, "requant", None] = count
    for b, c, h, w, n, k, stride, dil, count, epi in chip_smoke.QK1_PATH_1X1.values():
        key = (c, h, w, n, k, stride, dil, epi, torch.float32 if epi == "dequant" else None)
        want[key] = count
    got = {}
    for key in calls:
        got[key] = got.get(key, 0) + 1
    assert got == want
    assert len(calls) == 52 and forms == ["quantize"] * 20


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 8, 4, 4), dtype=torch.int8)
    w = torch.zeros((4, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="epilogue"):
        int8.int8_conv(x, w, 1, 1, (1, 1, 1, 1), "requant", torch.ones(4))
    with pytest.raises(ValueError, match="dequant"):
        int8.int8_conv(x, w, 1, 1, (1, 1, 1, 1), "dequant", torch.ones(4), out_dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        int8.int8_conv(x.float(), w, 1, 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="channels_last"):
        int8.int8_elementwise("quantize", torch.zeros(2, 3, 4, 5), torch.ones(()))
    with pytest.raises(ValueError, match="form"):
        int8.int8_elementwise("clip", torch.zeros(2, 3, dtype=torch.int32), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        int8.int8_conv_cuda(x, w, 1, 1, (1, 1, 1, 1))


# ------------------------------------------------------------ elementwise forms


def _flax_identity_acc(x, amax, pre_affine=None):
    """127 * (the int8 input the flax QuantConv makes of x): a 1x1 conv with
    identity weights, whose max|W| = 1 gives wq = 127 I."""
    c = (x[0] if pre_affine is not None else x).shape[-1]
    conv = jq.QuantConv(features=c, kernel_size=(1, 1), mode="int8", out_mode="acc",
                        dtype=jnp.float32)
    variables = {"params": {"kernel": jnp.eye(c, dtype=jnp.float32)[None, None]},
                 "quant": {"amax": jnp.float32(amax)}}
    acc, _ = conv.apply(variables, x, pre_affine=pre_affine)
    acc = np.asarray(acc)
    assert (acc % 127 == 0).all()
    return (acc // 127).astype(np.int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_form_bit_exact(dtype):
    rng = np.random.RandomState(4)
    x = rng.normal(0, 1.5, (2, 5, 7, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties, in units of sa below
    x = torch.from_numpy(x).to(dtype)
    for amax_case in (127.0, 3.7):  # sa = 1 puts the ties above on .5
        sa = torch.clamp_min(torch.tensor(amax_case, dtype=torch.float32), 1e-6) / 127.0
        got = int8.int8_elementwise(
            "quantize", x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), sa)
        want = _flax_identity_acc(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), amax_case)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _junction_inputs(seed, c=16):
    rng = np.random.RandomState(seed)
    acc = rng.randint(-60000, 60000, (2, 6, 5, c)).astype(np.int32)
    scale_in = rng.uniform(1e-5, 1e-4, c).astype(np.float32)
    a = rng.uniform(0.5, 2.0, c).astype(np.float32)
    cc = rng.normal(0, 1, c).astype(np.float32)
    return acc, scale_in, a, cc


@pytest.mark.parametrize("relu", [True, False])
def test_junction_bit_exact_given_acc_m_c(relu):
    """The same acc, m and c: QK2 `junction`'s twin equals the flax junction
    (ReLU on and off, ties included) bit for bit."""
    acc, scale_in, a, c = _junction_inputs(5)
    amax = 2.9
    want = _flax_identity_acc((jnp.asarray(acc), jnp.asarray(scale_in)), amax,
                              pre_affine=(jnp.asarray(a), jnp.asarray(c)))
    if not relu:
        sa = jnp.maximum(jnp.float32(amax), 1e-6) / 127.0
        y = jnp.asarray(acc).astype(jnp.float32) * ((a * scale_in) / sa) + c / sa
        want = np.asarray(jnp.clip(jnp.round(y), -127.0, 127.0).astype(jnp.int8))
    conv = tq.QuantConv(16, 16, 1)
    conv.amax.fill_(amax)
    acc_t = torch.from_numpy(acc).permute(0, 3, 1, 2)
    got = conv.quantize_input((acc_t, torch.from_numpy(scale_in)),
                              (torch.from_numpy(a), torch.from_numpy(c)), pre_relu=relu)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_junction_from_bn_parameters():
    """From BN parameters: the affine (a, c) goes through `rsqrt` in each
    framework, which may differ by an ulp, so at most 0.1% of the outputs
    may be one step off, and none by more."""
    rng = np.random.RandomState(6)
    c = 64
    stats = {"scale": rng.uniform(0.5, 2, c), "bias": rng.normal(0, 0.5, c),
             "mean": rng.normal(0, 1, c), "var": rng.uniform(0.1, 3, c)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    ja, jc = jq.BNAffine(epsilon=1e-3).apply(
        {"params": {"scale": stats["scale"], "bias": stats["bias"]},
         "batch_stats": {"mean": stats["mean"], "var": stats["var"]}}, c)
    bn = tq.BNAffine(c, eps=1e-3)
    for name, v in stats.items():
        getattr(bn, name).data = torch.from_numpy(v)
    ta, tc = bn.affine()
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=2e-7, atol=0)
    acc = np.random.RandomState(7).randint(-40000, 40000, (4, 16, 16, c)).astype(np.int32)
    scale_in = np.full(c, 3e-5, np.float32)
    want = _flax_identity_acc((jnp.asarray(acc), jnp.asarray(scale_in)), 4.0,
                              pre_affine=(ja, jc))
    conv = tq.QuantConv(c, c, 1)
    conv.amax.fill_(4.0)
    with torch.no_grad():
        got = conv.quantize_input((torch.from_numpy(acc).permute(0, 3, 1, 2),
                                   torch.from_numpy(scale_in)), (ta, tc))
    diff = np.abs(got.permute(0, 2, 3, 1).numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_dequant_form_bit_exact():
    """(acc * (sa * swc)).astype(dtype) + bias.astype(dtype), in bf16."""
    rng = np.random.RandomState(8)
    acc = rng.randint(-2 ** 24, 2 ** 24, (3, 4, 4, 16)).astype(np.int32)
    s = rng.uniform(1e-7, 1e-5, 16).astype(np.float32)
    bias = rng.normal(0, 3, 16).astype(np.float32)
    want = ((jnp.asarray(acc).astype(jnp.float32) * s).astype(jnp.bfloat16)
            + jnp.asarray(bias).astype(jnp.bfloat16))
    got = int8.int8_elementwise("dequant", torch.from_numpy(acc).permute(0, 3, 1, 2),
                                torch.from_numpy(s), torch.from_numpy(bias),
                                out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ percentile


@pytest.mark.parametrize("n,pct", [(1, 99.9), (1000, 99.9), (4097, 50.0), (12345, 0.1),
                                   (77777, 100.0), (2 ** 24 + 12345, 99.9)],
                         ids=["one", "small", "median", "low", "max", "above_2p24"])
def test_percentile_like_jnp_bit_exact(n, pct):
    x = np.abs(np.random.RandomState(n % 1000).standard_normal(n)).astype(np.float32)
    want = float(jnp.percentile(jnp.asarray(x), pct))
    got = tq.percentile_like_jnp(torch.from_numpy(x), pct)
    assert got.dtype == torch.float32
    assert float(got) == want


# ------------------------------------------------------------ calibration


@pytest.mark.parametrize("estimator", ["absmax", "p99.9"])
def test_calibrated_amax_matches_jax(estimator):
    cfg = _cfg(quantize_calib=estimator)
    variables = _flax_variables(cfg)
    batches = [_crops(10 + i) for i in range(3)]
    want = _amaxes(state_dict_from_flax(_jax_calibrate(cfg, variables, batches)))
    port = _load_uncalibrated(cfg, variables)
    assert set(_amaxes(port.state_dict()).values()) == {0.0}
    tq.calibrate(port, [torch.from_numpy(b) for b in batches])
    got = _amaxes(port.state_dict())
    assert set(got) == set(want) and len(got) == 16
    assert all(v > 0 for v in got.values())
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-5), name
    assert all(c.mode == "int8" for c in port.modules() if isinstance(c, tq.QuantConv))


def test_calibration_needs_a_batch_and_a_quantized_model():
    cfg = _cfg()
    model = init_metro_model(cfg.model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(model, [])
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(model, [torch.zeros(1, SIDE, SIDE, 3)], n_batches=0)
    with pytest.raises(ValueError, match="quantize"):
        tq.calibrate(init_metro_model(_cfg(quantize="none").model, 0, "cpu"), [_crops(0)])
    mcfg = _cfg().model
    assert tq.calib_mode(mcfg) == jq.calib_mode(mcfg) == "calib:99.9"
    for est in ("absmax", "p50", "p100"):
        m = dataclasses.replace(mcfg, quantize_calib=est)
        assert tq.calib_mode(m) == jq.calib_mode(m)
    for bad in ("median", "p120"):
        with pytest.raises(ValueError):
            tq.calib_mode(dataclasses.replace(mcfg, quantize_calib=bad))


# ------------------------------------------------------------ whole model

# (model overrides): fused and unfused pre-activation bottlenecks, a
# stage policy, the extras, v1.5 and the basic block
MODEL_CASES = {
    "fused": {},
    "unfused": {"quantize_fused": False},
    "stages_1_3": {"quantize_stages": "1,3"},
    "extras_stem_heads": {"quantize_extras": "stem,heads"},
    "v1_5": {"preactivation": False, "conv_padding": "torch", "stride_position": "first"},
    "basic_block": {"backbone": "resnet18", "quantize_extras": "heads"},
}


@pytest.fixture(scope="module")
def calibrated():
    """case -> (cfg, JAX-calibrated variables), built on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg = _cfg(**MODEL_CASES[case])
            variables = _flax_variables(cfg)
            cache[case] = cfg, _jax_calibrate(cfg, variables, [_crops(20 + i) for i in range(2)])
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_int8_logits_match_jax(calibrated, case):
    """The JAX-calibrated variables serve in the port (strict load, "quant"
    included); its int8 logits are within the JAX package's own bound for
    fused against unfused int8 (tests/test_quantize.py): a borderline value
    may round to the neighbouring int8 step in one framework only."""
    cfg, variables = calibrated(case)
    x = _crops(7, n=2)
    w3, w2 = _flax_apply(cfg, variables, x)
    port = load_flax_variables(MetroModel(cfg.model), variables).eval()
    with torch.no_grad():
        g3, g2 = port(torch.from_numpy(x))
    assert g3.shape == w3.shape and g2.shape == w2.shape
    bound = 0.05 * float(np.abs(w3).max()) + 0.02
    assert float(np.abs(g3.numpy() - w3).max()) < bound
    assert float(np.abs(g2.numpy() - w2).max()) < bound
    quant = [m for m in port.modules() if isinstance(m, tq.QuantConv)]
    assert quant and all(float(m.amax) > 0 for m in quant)


def test_quant_collection_converts_and_loads_strictly(calibrated):
    cfg, variables = calibrated("extras_stem_heads")
    converted = state_dict_from_flax(variables)
    port = MetroModel(cfg.model).state_dict()
    assert set(converted) == set(port)
    amax = {k for k in converted if k.endswith(".amax")}
    assert {"backbone.conv_stem.amax", "head3d.amax", "head2d.amax",
            "backbone.stage1_block1.conv2.amax"} <= amax
    assert all(converted[k].shape == () for k in amax)
    # a stage policy carries scales for its stages only, in both packages
    cfg13, v13 = calibrated("stages_1_3")
    names = set(_amaxes(state_dict_from_flax(v13)))
    assert names and all(n.split(".")[1][:6] in ("stage1", "stage3") for n in names)
    assert names == set(_amaxes(MetroModel(cfg13.model).state_dict()))
    # a bf16 tree lacks the scales: the strict load refuses it
    with pytest.raises(RuntimeError, match="amax"):
        load_flax_variables(MetroModel(cfg.model), {k: variables[k] for k in
                                                    ("params", "batch_stats")})


def test_train_refuses_int8():
    with pytest.raises(ValueError, match="inference-only"):
        MetroModel(_cfg().model, train=True)
    with pytest.raises(ValueError, match="inference-only"):
        init_metro_model(_cfg().model, 0, "cpu", train=True)


def _raises_like_jax(cfg_over, match):
    cfg = _cfg(**cfg_over)
    with pytest.raises(ValueError, match=match):
        FlaxMetro(cfg.model).init(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    with pytest.raises(ValueError, match=match):
        MetroModel(cfg.model)


@pytest.mark.parametrize("over,match", [
    ({"quantize_extras": "stem,head"}, "quantize_extras"),
    ({"quantize_extras": "stem,head", "quantize": "none"}, "quantize_extras"),
    ({"quantize_1x1_dot": "sometimes"}, "quantize_1x1_dot"),
    ({"quantize_1x1_dot": "cin>=lots"}, "threshold"),
    ({"quantize_layout": "chwn"}, "quantize_layout"),
    ({"quantize_layout": "chwn", "quantize": "none"}, "quantize_layout"),
    ({"quantize_layout": "nchw", "quantize_stages": "2,3"}, "quantize_stages"),
    ({"quantize_layout": "nchw", "backbone": "resnet18"}, "bottleneck"),
], ids=["extras", "extras_bf16", "policy", "threshold", "layout", "layout_bf16",
        "nchw_stages", "nchw_basic"])
def test_validation_errors_match_jax(over, match):
    _raises_like_jax(over, match)


def test_accepted_knobs_change_nothing():
    """quantize_1x1_dot and quantize_layout pick TPU emitters of the same
    integer sums: any valid value gives the same logits."""
    assert parse_quantize_extras("stem, heads") == {"stem", "heads"}
    cfg = _cfg()
    model = init_metro_model(cfg.model, 3, "cpu")
    tq.calibrate(model, [torch.from_numpy(_crops(30))])
    x = torch.from_numpy(_crops(31))
    with torch.no_grad():
        base = model(x)
        for over in ({"quantize_1x1_dot": "none"}, {"quantize_1x1_dot": "cin>=16"},
                     {"quantize_layout": "nchw"}):
            other = MetroModel(_cfg(**over).model).eval()
            other.load_state_dict(model.state_dict())
            got = other(x)
            assert all(torch.equal(a, b) for a, b in zip(got, base)), over


# ------------------------------------------------------------ serving


def _tile_batch(b=2, tile=96):
    """uint8 tiles with warp parameters of the serving batch layout: each
    crop a rotated, scaled window of its tile through a mildly distorted
    camera (the pattern of tests/test_torch_cuda.py), crop intrinsics too."""
    rng = np.random.RandomState(41)
    ang, sc = rng.uniform(-0.5, 0.5, b), rng.uniform(0.9, 1.3, b)
    h = np.zeros((b, 3, 3))
    h[:, 0, 0], h[:, 0, 1] = sc * np.cos(ang), -sc * np.sin(ang)
    h[:, 1, 0], h[:, 1, 1] = sc * np.sin(ang), sc * np.cos(ang)
    h[:, :2, 2] = tile / 2 - np.einsum("bij,j->bi", h[:, :2, :2], [SIDE / 2, SIDE / 2])
    h[:, 2, 2] = 1.0
    f = float(tile)
    pre = np.array([[1 / f, 0, -tile / 2 / f], [0, 1 / f, -tile / 2 / f], [0, 0, 1]])
    return {"source": rng.randint(0, 256, (b, tile, tile, 3)).astype(np.uint8),
            "warp_h": np.einsum("ij,bjk->bik", pre, h).astype(np.float32),
            "warp_k": np.tile([f, f, tile / 2, tile / 2], (b, 1)).astype(np.float32),
            "warp_dist": np.tile([-0.05, 0.01, 1e-4, -1e-4, 0.0], (b, 1)).astype(np.float32),
            "intrinsics": np.tile(np.array([[90.0, 0, 31.5], [0, 92.0, 31.5], [0, 0, 1]],
                                           np.float32), (b, 1, 1))}


@pytest.mark.parametrize("from_tiles", [False, True], ids=["crops", "tiles"])
@pytest.mark.parametrize("flip_tta", [True, False], ids=["tta", "no_tta"])
def test_int8_serving_matches_jax(calibrated, from_tiles, flip_tta):
    """`make_predict_fn` on the int8 model, crop-in and tile-in, on the
    JAX-calibrated scales. Bound: the float32 engine's own
    (tests/test_torch_engine.py: 5e-3 mm root-relative, 1e-4 px, 0.1 mm
    absolute). On these inputs both graphs take the same int8 steps (their
    logits agree to 3e-7), so the poses differ by float32 roundoff only:
    measured at most 5.3e-4 mm, 7.6e-6 px and 8.3e-3 mm."""
    cfg, variables = calibrated("fused")
    port = load_flax_variables(MetroModel(cfg.model), variables).eval()
    kw = dict(mirror_mapping=H36M_17.mirror_mapping, root_index=0, flip_tta=flip_tta,
              reconstruct=True, from_tiles=from_tiles)
    jfn = jax_make_predict_fn(cfg, **kw)
    tfn = make_predict_fn(cfg, **kw)
    rng = np.random.RandomState(40)
    b = 2
    intr = np.tile(np.array([[90.0, 0, 31.5], [0, 92.0, 31.5], [0, 0, 1]], np.float32), (b, 1, 1))
    if from_tiles:
        batch = _tile_batch()
        want = jfn(variables, {k: jnp.asarray(v) for k, v in batch.items()})
        got = tfn(port, {k: torch.from_numpy(np.asarray(batch[k])) for k in TILE_KEYS})
    else:
        crops = rng.randint(0, 256, (b, SIDE, SIDE, 3)).astype(np.uint8)
        want = jfn(variables, jnp.asarray(crops), jnp.asarray(intr))
        got = tfn(port, torch.from_numpy(crops), torch.from_numpy(intr))
    tol = {"pose3d_rootrel": 5e-3, "pose2d_px": 1e-4, "pose3d_abs": 1e-1}
    for key, atol in tol.items():
        g, w = got[key].numpy(), np.asarray(want[key])
        assert np.isfinite(g).all(), key
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)


def test_entry_serves_int8_on_cpu():
    """The flagship entry point builds, calibrates and serves the int8
    graph at full width (R50 v2 @ 256, bf16)."""
    from metro_pose3d_tpu_torch.entry import entry

    fn, args = entry(device="cpu", batch_size=1, quantize="int8")
    model = args[0]
    assert model.cfg.quantize == "int8" and model.dtype == torch.bfloat16
    amax = [float(m.amax) for m in model.modules() if isinstance(m, tq.QuantConv)]
    assert len(amax) == 52 and min(amax) > 0
    out = fn(*args)
    assert out["pose3d_abs"].shape == (1, 17, 3)
    assert all(torch.isfinite(v).all() for v in out.values())


def _measured_maxima():
    """The port-against-JAX maxima that PERF.md quotes: int8 logits per
    model case (beside the bound), and the serving poses per form."""
    for case, over in MODEL_CASES.items():
        cfg = _cfg(**over)
        variables = _jax_calibrate(cfg, _flax_variables(cfg), [_crops(20 + i) for i in range(2)])
        w3, w2 = _flax_apply(cfg, variables, _crops(7))
        port = load_flax_variables(MetroModel(cfg.model), variables).eval()
        with torch.no_grad():
            g3, g2 = port(torch.from_numpy(_crops(7)))
        print(f"logits {case}: 3D {np.abs(g3.numpy() - w3).max():.2e}, 2D "
              f"{np.abs(g2.numpy() - w2).max():.2e}, bound {0.05 * np.abs(w3).max() + 0.02:.2e}")
    cfg = _cfg()
    variables = _jax_calibrate(cfg, _flax_variables(cfg), [_crops(20 + i) for i in range(2)])
    port = load_flax_variables(MetroModel(cfg.model), variables).eval()
    intr = np.tile(np.array([[90.0, 0, 31.5], [0, 92.0, 31.5], [0, 0, 1]], np.float32), (2, 1, 1))
    crops = np.random.RandomState(40).randint(0, 256, (2, SIDE, SIDE, 3)).astype(np.uint8)
    batch = _tile_batch()
    for from_tiles in (False, True):
        for flip_tta in (True, False):
            kw = dict(mirror_mapping=H36M_17.mirror_mapping, root_index=0, flip_tta=flip_tta,
                      reconstruct=True, from_tiles=from_tiles)
            if from_tiles:
                want = jax_make_predict_fn(cfg, **kw)(
                    variables, {k: jnp.asarray(v) for k, v in batch.items()})
                got = make_predict_fn(cfg, **kw)(
                    port, {k: torch.from_numpy(batch[k]) for k in TILE_KEYS})
            else:
                want = jax_make_predict_fn(cfg, **kw)(variables, jnp.asarray(crops),
                                                      jnp.asarray(intr))
                got = make_predict_fn(cfg, **kw)(port, torch.from_numpy(crops),
                                                 torch.from_numpy(intr))
            print(f"serving {'tiles' if from_tiles else 'crops'} TTA {flip_tta}: " + ", ".join(
                f"{k} {np.abs(got[k].numpy() - np.asarray(want[k])).max():.2e}" for k in want))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quantize.py
    _measured_maxima()
