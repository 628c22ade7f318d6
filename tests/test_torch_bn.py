"""Eval-mode batch norm and its activation (`metro_pose3d_tpu_torch/ops/bn.py`)
on the CPU: the twin and the model's batch norm against the float32 chain
that `BatchNorm` ran before the kernel (F.relu or F.silu after it), the train
path with an activation, whole models, the call sites and the wrapper's
checks. The kernel itself is held to the twin on the card
(tests/test_torch_cuda.py)."""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models import resnet
from metro_pose3d_tpu_torch.models.quantize import QuantConv
from metro_pose3d_tpu_torch.ops import bn


ACT_FNS = {"none": lambda y: y, "relu": F.relu, "silu": F.silu}
ACT_IDS = {"none": "affine", "relu": "relu", "silu": "silu"}


def _old_eval(x, mean, var, scale, bias, eps, dtype, act):
    """`BatchNorm`'s eval path before the kernel, then the activation (F.relu
    or F.silu) at the call site."""
    shape = (1, -1, 1, 1)
    xf = x.float()
    mul = torch.rsqrt(var + eps) * scale
    y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return ACT_FNS[act](y.to(dtype))


def _old_train(mod, x):
    """`BatchNorm`'s train path before the kernel (no group, no ghost BN):
    -> (y in the module's dtype, new running mean, new running variance)."""
    shape = (1, -1, 1, 1)
    xf = x.float()
    mean, mean2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
    mul = torch.rsqrt(var + mod.eps) * mod.scale
    y = (xf - mean.view(shape)) * mul.view(shape) + mod.bias.view(shape)
    with torch.no_grad():
        m = mod.momentum
        ra_mean, ra_var = m * mod.mean + (1 - m) * mean, m * mod.var + (1 - m) * var
    return y.to(mod.dtype), ra_mean, ra_var


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(_bits(a), _bits(b))


def _case(c, dtype, layout, seed=0):
    """x [3, c, 5, 7] (N*H*W = 105, odd) with NaN, +-inf and -0.0 in it, and
    running statistics and an affine whose channel 0 maps -0.0 to -0.0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, c, 5, 7, generator=g) * 3
    flat = x.view(-1)
    for value in (float("nan"), float("inf"), float("-inf"), -0.0):
        flat[torch.randint(0, flat.numel(), (7,), generator=g)] = value
    x[0, 0, 0, :3] = torch.tensor([-0.0, float("nan"), float("-inf")])
    x = x.to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    mean, scale, bias = (torch.randn(c, generator=g) for _ in range(3))
    var = torch.rand(c, generator=g) + 0.05
    mean[0], scale[0], bias[0] = 0.0, 1.0, -0.0
    return x, mean, var, scale, bias


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("act", list(ACT_IDS), ids=list(ACT_IDS.values()))
@pytest.mark.parametrize("c", [8, 64, 2048])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_twin_and_eval_batch_norm_equal_the_old_chain(dtype, layout, c, act):
    x, mean, var, scale, bias = _case(c, DTYPES[dtype], layout)
    want = _old_eval(x, mean, var, scale, bias, 1e-3, DTYPES[dtype], act)
    mul = torch.rsqrt(var + 1e-3) * scale
    assert _same_bits(bn.bn_act_plain(x, mean, mul, bias, act), want)
    assert _same_bits(bn.batch_norm_act(x, mean, mul, bias, act), want)
    mod = resnet.BatchNorm(c, 1e-3, dtype=DTYPES[dtype]).eval()
    with torch.no_grad():
        for name, t in (("mean", mean), ("var", var), ("scale", scale), ("bias", bias)):
            getattr(mod, name).copy_(t)
        assert _same_bits(mod(x, act=act), want)
    assert bool(torch.isnan(want).any()) and bool((want == float("inf")).any())
    assert bn.LAUNCHES == 0  # nothing launches on the CPU


def test_silu_twin_keeps_the_special_values():
    """F.silu on the rounded affine: NaN stays NaN, +inf stays +inf, -inf
    gives NaN (-inf / inf), -0.0 stays -0.0, and a large negative value
    goes to -0.0."""
    x = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, -200.0, 3.0])
    x = x.view(1, 6, 1, 1)
    zero, one = torch.zeros(6), torch.ones(6)
    for dtype in DTYPES.values():
        y = bn.bn_act_plain(x.to(dtype), zero, one, zero * -1.0, "silu").float().view(-1)
        assert torch.isnan(y[0]) and y[1] == float("inf") and torch.isnan(y[2])
        assert y[3] == 0 and torch.signbit(y[3]) and y[4] == 0 and torch.signbit(y[4])
        assert y[5] == F.silu(torch.tensor(3.0).to(dtype)).float()


def test_an_unknown_activation_raises():
    x, c = torch.randn(2, 8, 3, 3), torch.zeros(8)
    with pytest.raises(ValueError, match="unknown batch norm activation"):
        bn.bn_act_plain(x, c, c, c, "gelu")
    with pytest.raises(ValueError, match="unknown batch norm activation"):
        resnet.BatchNorm(8, 1e-3).train()(x, act=True)


def _train_case(dtype, act):
    """Value, gradient of x and of the affine, and the running statistics of
    the train path with `act`, against the old train path with the
    activation after it."""
    torch.manual_seed(1)
    mod = resnet.BatchNorm(16, 1e-3, dtype=DTYPES[dtype]).train()
    with torch.no_grad():
        mod.scale.normal_()
        mod.bias.normal_()
    x = torch.randn(4, 16, 6, 5).to(DTYPES[dtype]).contiguous(memory_format=torch.channels_last)
    ref = copy.deepcopy(mod)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = mod(xa, act=act)
    y, ra_mean, ra_var = _old_train(ref, xb)
    want = ACT_FNS[act](y)
    assert _same_bits(got, want)
    g = torch.randn(want.shape).to(want.dtype)
    got.backward(g)
    want.backward(g)
    assert _same_bits(xa.grad, xb.grad)
    for name in ("scale", "bias"):
        assert torch.equal(getattr(mod, name).grad, getattr(ref, name).grad), name
    assert torch.equal(mod.mean, ra_mean) and torch.equal(mod.var, ra_var)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_batch_norm_with_relu_is_relu_of_the_old_train_path(dtype):
    _train_case(dtype, "relu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_batch_norm_with_silu_is_silu_of_the_old_train_path(dtype):
    _train_case(dtype, "silu")


@pytest.mark.parametrize("group_size", [0, 2])
def test_train_relu_flag_is_f_relu_of_the_flagless_call(group_size):
    """`act="relu"` in train mode, ghost BN included, is F.relu after it."""
    torch.manual_seed(2)
    mod = resnet.BatchNorm(8, 1e-3, group_size=group_size).train()
    ref = copy.deepcopy(mod)
    x = torch.randn(4, 8, 3, 3)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = mod(xa, act="relu"), F.relu(ref(xb))
    assert torch.equal(got, want)
    got.sum().backward()
    want.sum().backward()
    assert torch.equal(xa.grad, xb.grad) and torch.equal(mod.scale.grad, ref.scale.grad)
    assert torch.equal(mod.mean, ref.mean) and torch.equal(mod.var, ref.var)


def _old_forward(self, x, act="none", mul=None):
    """The chain before the kernel, its multiplier computed from the module's
    own vectors (a `mul` the trunk derived for it is not used)."""
    assert not self.training
    return _old_eval(x, self.mean, self.var, self.scale, self.bias, self.eps, self.dtype, act)


MODELS = {
    "tiny_bf16": {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4"},
    "tiny_f32_v15": {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
                     "model.compute_dtype": "float32", "model.preactivation": "false",
                     "model.conv_padding": "torch"},
    "resnet50_bf16": {"model.proc_side": "64"},
    "effv2_tiny_bf16": {"model.backbone": "efficientnetv2-tiny", "model.proc_side": "64",
                        "model.depth": "4"},
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_model_gives_the_outputs_of_the_old_chain(name, monkeypatch):
    """A whole eval forward, B = 1, against the same model with every batch
    norm run as the float32 chain before the kernel, F.relu after it."""
    cfg = apply_overrides(Config(), MODELS[name])
    model = init_metro_model(cfg.model, 4, "cpu").eval()
    with torch.no_grad():  # running statistics away from 0 and 1
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                m.mean.normal_(0, 0.1)
                m.var.uniform_(0.5, 2.0)
    side = cfg.model.proc_side
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (1, side, side, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got = model(x)
        monkeypatch.setattr(resnet.BatchNorm, "forward", _old_forward)
        want = model(x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same_bits(g, w)


CALL_COUNTS = {  # overrides -> (batch norms a forward, of them with the ReLU, with the SiLU)
    "resnet50_v2": ({}, (49, 49, 0)),
    "resnet50_v2_int8": ({"model.quantize": "int8"}, (17, 17, 0)),
    "resnet50_v15": ({"model.preactivation": "false", "model.conv_padding": "torch",
                      "model.stride_position": "first"}, (53, 33, 0)),
    "resnet18_v2": ({"model.backbone": "resnet18"}, (17, 17, 0)),
    "effv2_l": ({"model.backbone": "efficientnetv2-l"}, (217, 0, 142)),
}


@pytest.mark.parametrize("name", sorted(CALL_COUNTS))
def test_every_batch_norm_before_a_relu_takes_it_in_the_same_call(name, monkeypatch):
    """One eval forward calls `batch_norm_act` once a batch norm, with
    "relu" wherever F.relu followed it: all 49 of R50 v2 (16 bn_pre, bn1,
    bn2, bn_final), the 17 of int8 R50 v2 whose bn1 and bn2 are folded into
    QK1's junctions; in v1.5 the 33 of the stem and each unit's bn1 and
    bn2, and not bn3 or bn_proj, whose ReLU follows the residual add. In
    EfficientNetV2-L, "silu" in 142 of 217: all but the 75 after a block's
    projecting 1x1 conv (14 Fused-MBConv and 61 MBConv blocks)."""
    over, want = CALL_COUNTS[name]
    cfg = apply_overrides(Config(), {"model.proc_side": "64", **over})
    model = init_metro_model(cfg.model, 0, "cpu").eval()
    for m in model.modules():
        if isinstance(m, QuantConv):
            m.amax.fill_(4.0)
    calls = []
    plain = bn.batch_norm_act

    def spy(*args, **kw):
        calls.append(args[4])
        return plain(*args, **kw)

    monkeypatch.setattr(bn, "batch_norm_act", spy)
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert (len(calls), calls.count("relu"), calls.count("silu")) == want


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.randn(2, 8, 4, 6)
    c = torch.zeros(8)
    with pytest.raises(ValueError, match="channels_last- or NCHW-contiguous"):
        bn.bn_act_cuda(x.transpose(2, 3), c, c, c)
    with pytest.raises(ValueError, match="channels_last- or NCHW-contiguous"):
        bn.bn_act_cuda(x[:, :, :, ::2], c, c, c)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn.bn_act_cuda(x.half(), c, c, c)
    with pytest.raises(ValueError, match=r"\[N,C,H,W\]"):
        bn.bn_act_cuda(x[0], c, c, c)
    with pytest.raises(ValueError, match="float32 mul of shape"):
        bn.bn_act_cuda(x, c, torch.zeros(4), c)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        bn.bn_act_cuda(x, c, c, c)
    with pytest.raises(ValueError, match="unsupported device"):
        bn.batch_norm_act(x.to("meta"), c, c, c)


@pytest.mark.parametrize("x_dtype,bn_dtype", [(torch.float32, torch.bfloat16),
                                              (torch.bfloat16, torch.float32)])
def test_eval_batch_norm_refuses_an_input_off_its_compute_dtype(x_dtype, bn_dtype):
    """Eval batch norm writes x's dtype on every device, so an input in
    another dtype than the module's raises, on the CPU as on the card."""
    mod = resnet.BatchNorm(8, 1e-3, dtype=bn_dtype).eval()
    x = torch.randn(2, 8, 3, 3).to(x_dtype)
    with pytest.raises(TypeError, match="compute dtype"):
        mod(x)
    with pytest.raises(TypeError, match="compute dtype"):
        mod(x, act="relu")


@pytest.mark.parametrize("shape,dtype,memory_format,want", [
    ((2, 64, 3, 3), torch.bfloat16, torch.channels_last, ("channels_last", 8)),
    ((2, 64, 3, 3), torch.float32, torch.channels_last, ("channels_last", 4)),
    ((2, 12, 3, 3), torch.bfloat16, torch.channels_last, ("channels_last", 1)),
    ((2, 12, 4, 4), torch.bfloat16, torch.contiguous_format, ("nchw", 8)),
    ((2, 12, 3, 3), torch.float32, torch.contiguous_format, ("nchw", 1)),
    ((5, 7, 1, 1), torch.float32, torch.contiguous_format, ("channels_last", 1)),
])
def test_layout_and_vector_width(shape, dtype, memory_format, want):
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=memory_format)
    kind = bn.layout(x)
    assert (kind, bn.vector_width(x, kind, 0, 16)) == want
    assert bn.vector_width(x, kind, 0, 8) == 1  # a pointer off 16 bytes
