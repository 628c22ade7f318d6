"""The depthwise conv (`metro_pose3d_tpu_torch/ops/dwconv.py`) on the CPU: the
twin against F.conv2d in float64, `Conv` with `groups` through the twin, the
special values, and the wrapper's checks. The kernel itself is held to the
twin on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.models.resnet import Conv, _same_pads
from metro_pose3d_tpu_torch.ops import dwconv

# (C, H, W, k, stride, dilation): SAME pads, even and odd sides, stride 2 with
# its uneven pad, dilation 2, a C that holds no whole 16-byte vector
CASES = [(16, 9, 10, 3, 1, 1), (24, 10, 10, 3, 2, 1), (8, 7, 9, 3, 1, 2), (5, 6, 6, 3, 2, 2),
         (32, 11, 8, 3, 1, 2), (12, 15, 16, 3, 2, 2)]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def case(c, h, w, k, stride, dil, dtype, seed=0):
    """x [2, c, h, w] channels_last with NaN, +-inf and -0.0 in it, a weight
    [c, 1, k, k], and the SAME pads."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c, h, w, generator=g) * 2
    flat = x.view(-1)
    for value in (float("nan"), float("inf"), float("-inf"), -0.0):
        flat[torch.randint(0, flat.numel(), (2,), generator=g)] = value
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = torch.randn(c, 1, k, k, generator=g) * 0.5
    pads = (*_same_pads(h, k, stride, dil), *_same_pads(w, k, stride, dil))
    return x, weight, pads


def _f64(x, weight, stride, dil, pads):
    top, bottom, left, right = pads
    xp = F.pad(x.double(), (left, right, top, bottom))
    return F.conv2d(xp, weight.to(x.dtype).double(), None, stride, 0, dil, x.shape[1])


@pytest.mark.parametrize("c,h,w,k,stride,dil", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_twin_is_the_depthwise_conv(dtype, c, h, w, k, stride, dil):
    """Finite inputs: the twin is F.conv2d (groups = C, float64) within the
    float32 sum's round-off (a few ulp of the largest term) and then one
    rounding to the dtype; its layout is x's."""
    x, weight, pads = case(c, h, w, k, stride, dil, DTYPES[dtype])
    x = torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
    got = dwconv.depthwise_conv_plain(x, weight, stride, dil, pads)
    want = _f64(x, weight, stride, dil, pads)
    assert got.shape == want.shape and got.dtype == x.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    ulp = 2.0 ** -7 if dtype == "bf16" else 2.0 ** -20
    assert float((got.double() - want).abs().max()) <= ulp * float(want.abs().max()) + 1e-6


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv_with_groups_runs_the_twin(dtype):
    x, weight, _ = case(24, 10, 10, 3, 2, 2, DTYPES[dtype])
    conv = Conv(24, 24, 3, 2, 2, dtype=DTYPES[dtype], groups=24)
    with torch.no_grad():
        conv.weight.copy_(weight)
        got = conv(x)
    want = dwconv.depthwise_conv_plain(x, weight, 2, 2, conv.pads(10, 10))
    bits = torch.int16 if dtype == "bf16" else torch.int32
    assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits))
    assert dwconv.LAUNCHES == 0  # nothing launches on the CPU


def test_special_values_propagate_as_in_the_sum():
    """A NaN or an infinity in a tap's window spreads to the outputs that sum
    it; a zero padding multiplies too, so an infinite weight makes the
    border NaN."""
    x = torch.zeros(1, 1, 3, 3)
    x[0, 0, 1, 1] = float("inf")
    w = torch.ones(1, 1, 3, 3)
    y = dwconv.depthwise_conv_plain(x, w, 1, 1, (1, 1, 1, 1))
    assert (y == float("inf")).all()
    w[0, 0, 0, 0] = float("inf")
    y = dwconv.depthwise_conv_plain(torch.ones(1, 1, 3, 3), w, 1, 1, (1, 1, 1, 1))
    assert torch.isnan(y[0, 0, 0, 0]) and y[0, 0, 2, 2] == float("inf")


def test_the_wrapper_and_conv_refuse_what_they_do_not_take():
    x = torch.randn(2, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match=r"\[C,1,k,k\]"):
        dwconv.depthwise_conv_plain(x, torch.zeros(8, 2, 3, 3), 1, 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        dwconv.depthwise_conv_cuda(x, torch.zeros(8, 1, 3, 3), 1, 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        dwconv.depthwise_conv(x.to("meta"), torch.zeros(8, 1, 3, 3, device="meta"), 1, 1,
                              (1, 1, 1, 1))
    with pytest.raises(ValueError, match="depthwise here"):
        Conv(8, 16, 3, groups=8)
    with pytest.raises(ValueError, match="depthwise here"):
        Conv(8, 8, 3, bias=True, groups=8)


def test_out_size_is_the_same_padding_rule():
    for size in range(5, 20):
        for k, stride, dil in ((3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 2, 2)):
            low, high = _same_pads(size, k, stride, dil)
            assert dwconv.out_size(size, k, stride, dil, low, high) == -(-size // stride)
    assert np.isfinite(dwconv.out_size(4, 3, 1, 1, 0, 0))
