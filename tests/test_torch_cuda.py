"""The port's CUDA kernels on the card, against their plain versions, and the
nvJPEG decode of a machine without libjpeg against the fixtures' libjpeg
pixels.

Marked `cuda`: these skip where CUDA is absent. They import no jax (the
card's machine has none); run them there with the conftest left out:
    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.evaluation.engine import PoseEstimator, make_predict_fn
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models.resnet import BatchNorm
from metro_pose3d_tpu_torch.ops import bn, pool, warp
from test_torch_bn import DTYPES, _bits, _case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (3, 5, 15, 13), (1, 8, 9, 16)])
def test_pool_kernel_bit_exact(cuda, shape, dtype):
    x = torch.randn(shape, device=cuda).to(dtype).contiguous(memory_format=torch.channels_last)
    before = pool.LAUNCHES
    got = pool.stem_max_pool(x)
    assert pool.LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, pool.max_pool_plain(x))  # max is exact


def test_pool_kernel_rejects_nchw_contiguous(cuda):
    with pytest.raises(ValueError, match="channels_last"):
        pool.stem_max_pool(torch.randn(2, 8, 16, 16, device=cuda))


def _params(rng, b, tile, side):
    ang = rng.uniform(-1.7, 1.7, b)
    sc = rng.uniform(0.8, 1.8, b)
    h = np.zeros((b, 3, 3))
    h[:, 0, 0], h[:, 0, 1] = sc * np.cos(ang), -sc * np.sin(ang)
    h[:, 1, 0], h[:, 1, 1] = sc * np.sin(ang), sc * np.cos(ang)
    h[:, :2, 2] = tile / 2 - np.einsum("bij,j->bi", h[:, :2, :2], [side / 2, side / 2])
    f = float(tile)
    pre = np.array([[1 / f, 0, -tile / 2 / f], [0, 1 / f, -tile / 2 / f], [0, 0, 1]])
    h = np.einsum("ij,bjk->bik", pre, h)
    h[:, 2] = [rng.uniform(-3, 0) / side, 0.0, 1.0]  # some rays behind the camera
    k = np.tile([f, f, tile / 2, tile / 2], (b, 1))
    d = np.tile([-0.15, 0.03, 5e-4, -5e-4, 0.01], (b, 1))
    return [torch.tensor(a, dtype=torch.float32) for a in (h, k, d)]


def _warp_inputs(cuda, shared_frame):
    rng = np.random.RandomState(0)
    b, tile, side = 8, 256, 128
    n = 1 if shared_frame else b
    src = torch.from_numpy(rng.randint(0, 256, (n, tile, tile, 3)).astype(np.uint8)).to(cuda)
    h, k, d = (t.to(cuda) for t in _params(rng, b, tile, side))
    idx = torch.zeros(b, dtype=torch.int32, device=cuda) if shared_frame else None
    return src, h, k, d, side, idx


@pytest.mark.parametrize("shared_frame", [False, True])
def test_warp_kernel_matches_plain(cuda, shared_frame):
    args = _warp_inputs(cuda, shared_frame)
    before = warp.LAUNCHES
    got = warp.warp_images(*args)
    assert warp.LAUNCHES == before + 1
    want = warp.warp_images_plain(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(got)
    # [0,255] units: the kernels build with -fmad=false and keep the plain
    # version's order of operations; the margin is for a float32 coordinate
    # ulp through the bilinear weights, should one operation round otherwise
    assert float((got[ok] - want[ok]).abs().max()) <= 0.05


FORMS = {f"{e}-{str(d)[6:]}": (e, d) for e, d in warp.FORMS}
FORM_UNITS = {"none": 1.0, "unit": 1 / 255, "normalize": 2 / 255,  # [0,255] -> the form's
              "normalize_div": 2 / 255}


def _same_bits(a, b):
    nan = torch.isnan(b)
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[b.dtype]
    return (a.dtype == b.dtype and torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(view), b[~nan].view(view)))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shared_frame", [False, True])
def test_warp_epilogue_matches_plain_chain_and_unfused_kernel(cuda, shared_frame, form):
    epilogue, dtype = FORMS[form]
    args = _warp_inputs(cuda, shared_frame)
    before = dict(warp.KERNEL_LAUNCHES)
    got = warp.warp_images(*args, epilogue=epilogue, out_dtype=dtype)
    assert warp.KERNEL_LAUNCHES[epilogue, dtype] == before[epilogue, dtype] + 1
    assert got.dtype == dtype
    want = warp.warp_images_plain(*args, epilogue=epilogue, out_dtype=dtype)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(got)
    # test_warp_kernel_matches_plain's 0.05, in the form's units; bf16 adds
    # one bf16 ulp at 1.0 (2^-7): both sides round to bf16 once
    tol = 0.05 * FORM_UNITS[epilogue] + (2 ** -7 if dtype == torch.bfloat16 else 0.0)
    assert float((got[ok].float() - want[ok].float()).abs().max()) <= tol
    # the fused epilogue rounds as the unfused chain does: bit for bit
    unfused = warp.apply_epilogue(warp.warp_images(*args), epilogue, dtype)
    assert _same_bits(got, unfused)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_warp_out_of_range_source_gives_zeros_in_every_epilogue(cuda, form):
    epilogue, dtype = FORMS[form]
    src = torch.full((1, 16, 16, 3), 200, dtype=torch.uint8, device=cuda)
    h = torch.eye(3, device=cuda).expand(2, 3, 3).contiguous()
    k = torch.tensor([[1.0, 1.0, 0.0, 0.0]] * 2, device=cuda)
    out = warp.warp_images(src, h, k, torch.zeros(2, 5, device=cuda), 8,
                           torch.tensor([0, 5], device=cuda), epilogue, dtype)
    zero = {"none": 0.0, "unit": 0.0, "normalize": -1.0, "normalize_div": -1.0}[epilogue]
    inside = warp.apply_epilogue(torch.full((1,), 200.0), epilogue, dtype).item()
    assert bool((out[1] == zero).all()) and bool((out[0] == inside).all())


@pytest.mark.parametrize("reps", [1, 64])
@pytest.mark.parametrize("rows", [64, 128])
def test_rowsel_kernel_is_exact(cuda, rows, reps):
    from metro_pose3d_tpu_torch.probes import prims

    rng = np.random.RandomState(rows + reps)
    p = torch.from_numpy(np.eye(160, dtype=np.float32)[rng.randint(0, 160, (4, rows))])
    s = torch.from_numpy(rng.randint(0, 255, (4, 160, 128)).astype(np.float32))
    p, s = p.to(cuda).bfloat16(), s.to(cuda).bfloat16()
    want = prims.rowsel_plain(p, s, reps)
    for split in (1, 2, 3):
        assert torch.equal(prims.rowsel_cuda(p, s, reps, split), want)


def test_warp_kernel_out_of_range_source_gives_zeros(cuda):
    src = torch.full((1, 16, 16, 3), 200, dtype=torch.uint8, device=cuda)
    h = torch.eye(3, device=cuda).expand(2, 3, 3).contiguous()
    k = torch.tensor([[1.0, 1.0, 0.0, 0.0]] * 2, device=cuda)
    out = warp.warp_images(src, h, k, torch.zeros(2, 5, device=cuda), 8,
                           torch.tensor([0, 5], device=cuda))
    assert float(out[0].min()) == 200.0 and float(out[1].abs().max()) == 0.0


def test_tiny_serving_on_card_matches_cpu(cuda):
    cfg = apply_overrides(Config(), {"model.backbone": "tiny", "model.proc_side": "64",
                                     "model.depth": "4", "model.compute_dtype": "float32"})
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu_model = init_metro_model(cfg.model, seed=1, device="cpu")
        gpu_model = init_metro_model(cfg.model, seed=1, device=cuda)
        rng = np.random.RandomState(2)
        h, k, d = _params(rng, 4, 128, 64)
        batch = {"source": torch.from_numpy(rng.randint(0, 256, (4, 128, 128, 3)).astype(np.uint8)),
                 "warp_h": h, "warp_k": k, "warp_dist": torch.zeros(4, 5),
                 "intrinsics": torch.tensor([[[900.0, 0, 31.5], [0, 900.0, 31.5], [0, 0, 1]]] * 4)}
        fn = make_predict_fn(cfg, np.arange(17), flip_tta=True, reconstruct=True,
                             from_tiles=True)
        want = fn(cpu_model, batch)
        got = fn(gpu_model, {key: v.to(cuda) for key, v in batch.items()})
    finally:
        torch.backends.cudnn.allow_tf32 = True
    for key in want:
        # float32 with TF32 off: other summation orders only
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (3, 5, 15, 13), (1, 8, 9, 16)])
@pytest.mark.parametrize("ties", [False, True])
def test_pool_backward_kernel_matches_plain(cuda, shape, dtype, ties):
    x = torch.randn(shape, device=cuda)
    if ties:
        x = torch.round(x * 4) / 4  # neighbours often equal: the chain splits ties
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    oh, ow = (shape[2] + 1) // 2, (shape[3] + 1) // 2
    g = torch.randn(shape[0], shape[1], oh, ow, device=cuda).to(dtype)
    xr = x.clone().requires_grad_(True)
    before = pool.BWD_LAUNCHES
    pool.stem_max_pool(xr).backward(g)
    assert pool.BWD_LAUNCHES == before + 1
    assert xr.grad.is_contiguous(memory_format=torch.channels_last)
    # float32 sums of the same power-of-two weights, once rounded to dtype
    want = pool.max_pool_bwd_plain(x.float(), g.float())
    err = (xr.grad.float() - want).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-6
    else:  # within one bf16 ulp of the float32 sum
        assert bool((err <= want.abs() * 2 ** -7).all())


def test_occluder_kernel_matches_plain(cuda):
    from metro_pose3d_tpu_torch.ops import occlusion
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders

    rng = np.random.RandomState(3)
    b, side = 12, 64
    bank = occlusion.pack_occluder_bank(make_procedural_occluders(8, 32)).to(cuda)
    crops = torch.from_numpy(rng.uniform(0, 1, (b, side, side, 3)).astype(np.float32)).to(cuda)
    ang = rng.uniform(-np.pi, np.pi, b)
    ang[:4] = [np.pi / 2, -np.pi / 2, np.pi, -np.pi]
    sc = rng.uniform(1.4, 5, b)
    aff = np.zeros((b, 2, 3), np.float32)
    aff[:, 0, 0], aff[:, 0, 1] = sc * np.cos(ang), -sc * np.sin(ang)
    aff[:, 1, 0], aff[:, 1, 1] = sc * np.sin(ang), sc * np.cos(ang)
    aff[:, :, 2] = 16 - np.einsum("bij,bj->bi", aff[:, :, :2], rng.uniform(-10, 74, (b, 2)))
    idx = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, -1, 8, 3, 2], dtype=torch.int32, device=cuda)
    en = torch.tensor([1.0] * 10 + [0.0, 1.0], device=cuda)
    args = (crops, bank, idx, torch.from_numpy(aff).to(cuda), en)
    before = occlusion.LAUNCHES
    got = occlusion.occlude_with_bank(*args)
    assert occlusion.LAUNCHES == before + 1
    want = occlusion.occlude_plain(*args)
    # the plain version's order of operations, no FMA contraction
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got[8:11], crops[8:11])  # out-of-range index, disabled


def _tiny_train_step_card_vs_cpu(cuda, masked):
    """One float32 train step of a tiny model on the CPU and on the card,
    from one seed; with `masked`, the batch carries a foreground mask and is
    composited onto a background bank."""
    from metro_pose3d_tpu_torch.pipeline.backgrounds import make_procedural_backgrounds
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state

    cfg = apply_overrides(Config(), {"model.backbone": "tiny", "model.proc_side": "64",
                                     "model.depth": "4", "model.compute_dtype": "float32",
                                     "train.warmup_steps": "0"})
    rng = np.random.RandomState(4)
    b = 8
    h, k, _ = _params(rng, b, 128, 64)
    ang = rng.uniform(-np.pi, np.pi, b)
    aff = np.zeros((b, 2, 3), np.float32)
    aff[:, 0, 0], aff[:, 0, 1] = 3 * np.cos(ang), -3 * np.sin(ang)
    aff[:, 1, 0], aff[:, 1, 1] = 3 * np.sin(ang), 3 * np.cos(ang)
    aff[:, :, 2] = 48 - np.einsum("bij,bj->bi", aff[:, :, :2], rng.uniform(10, 54, (b, 2)))
    batch = {
        "source": rng.randint(0, 256, (b, 128, 128, 3)).astype(np.uint8),
        "warp_h": h.numpy(), "warp_k": k.numpy(), "warp_dist": np.zeros((b, 5), np.float32),
        "coords3d_true": rng.uniform(-500, 500, (b, 17, 3)).astype(np.float32)
        + np.array([0, 0, 4000], np.float32),
        "coords2d_true": rng.uniform(0, 64, (b, 17, 2)).astype(np.float32),
        "joint_validity": np.ones((b, 17), np.float32),
        "joint_validity_2d": np.ones((b, 17), np.float32),
        "is_3d": np.ones(b, np.float32),
        "intrinsics": np.tile(np.array([[900, 0, 31.5], [0, 900, 31.5], [0, 0, 1]],
                                       np.float32), (b, 1, 1)),
        "color_params": np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(0.8, 1.2, b),
                                  rng.uniform(0.8, 1.2, b), rng.uniform(-0.3, 0.3, b)],
                                 1).astype(np.float32),
        "occ_params": np.stack([np.ones(b), np.arange(b) % 8], 1).astype(np.float32),
        "occ_affine": aff,
    }
    backgrounds = None
    if masked:
        batch["source_mask"] = rng.randint(0, 256, (b, 128, 128)).astype(np.uint8)
        batch["bg_params"] = np.stack([np.arange(b) % 2, np.arange(b) % 3], 1).astype(np.float32)
        backgrounds = make_procedural_backgrounds(3, 128, 4)
    occ = make_procedural_occluders(8, 96)
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            state = create_train_state(cfg, dev, seed=1)
            step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(occ, dev),
                                   background_bank=None if backgrounds is None
                                   else torch.from_numpy(backgrounds).to(dev))
            metrics = step(state, batch_to_device(batch, dev))
            out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                             {k: v.cpu() for k, v in state.model.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32 = True
    (m_cpu, sd_cpu), (m_gpu, sd_gpu) = out["cpu"], out[str(cuda)]
    for key in m_cpu:
        # float32 with TF32 off: other summation orders only
        assert m_gpu[key] == pytest.approx(m_cpu[key], rel=1e-3), key
    lr = cfg.train.base_lr
    for name in sd_cpu:
        # BN statistics to roundoff; a weight whose gradient is ~0 may take
        # Adam's step of lr with the other sign
        atol = 1e-4 if name.endswith((".mean", ".var")) else 2 * lr + 1e-6
        torch.testing.assert_close(sd_gpu[name], sd_cpu[name], rtol=0, atol=atol)


def test_tiny_train_step_on_card_matches_cpu(cuda):
    _tiny_train_step_card_vs_cpu(cuda, masked=False)


def test_tiny_masked_train_step_with_backgrounds_on_card_matches_cpu(cuda):
    _tiny_train_step_card_vs_cpu(cuda, masked=True)


def test_decode_with_tf32_on_matches_cpu(cuda):
    """The soft-argmax decode uses no matmul, so TF32 (which rounds a
    float32 matmul's inputs by up to ~5e-4 relative) cannot move it."""
    from metro_pose3d_tpu_torch.ops.soft_argmax import soft_argmax_2d, soft_argmax_3d

    g = torch.Generator().manual_seed(5)
    l3 = 3 * torch.randn((8, 16, 16, 8, 17), generator=g)
    l2 = 3 * torch.randn((8, 16, 16, 17), generator=g)
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        got3, got2 = soft_argmax_3d(l3.to(cuda)).cpu(), soft_argmax_2d(l2.to(cuda)).cpu()
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        torch.backends.cudnn.allow_tf32 = before[2]
    # (0,1) units: float32 sums in another order on the card
    torch.testing.assert_close(got3, soft_argmax_3d(l3), rtol=0, atol=1e-5)
    torch.testing.assert_close(got2, soft_argmax_2d(l2), rtol=0, atol=1e-5)


def _smooth_relu(shape, device):
    """A smooth field through a ReLU: patches of exact zeros, as after bn_stem + ReLU."""
    b, c, h, w = shape
    coarse = torch.randn(b, c, -(-h // 4), -(-w // 4), device=device)
    smooth = coarse.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)[:, :, :h, :w]
    return torch.relu(smooth + 0.3 * torch.randn(shape, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (3, 5, 15, 13), (1, 8, 9, 16)])
@pytest.mark.parametrize("mode", ["torch", "keras"])
def test_pool_mode_kernels_match_plain(cuda, mode, shape, dtype):
    cl = dict(memory_format=torch.channels_last)
    for x in (torch.randn(shape, device=cuda), -torch.rand(shape, device=cuda) - 0.5,
              _smooth_relu(shape, cuda)):
        x = x.to(dtype).contiguous(**cl)
        xr = x.clone().requires_grad_(True)
        fwd, bwd = pool.MODE_LAUNCHES[mode], pool.MODE_BWD_LAUNCHES[mode]
        y = pool.stem_max_pool(xr, mode)
        assert torch.equal(y, pool.max_pool_plain(x, mode))  # max is exact
        g = torch.randn(y.shape, device=cuda).to(dtype)
        y.backward(g)
        assert (pool.MODE_LAUNCHES[mode], pool.MODE_BWD_LAUNCHES[mode]) == (fwd + 1, bwd + 1)
        want = pool.max_pool_bwd_plain(x.float(), g.float(), mode)
        err = (xr.grad.float() - want).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-6
        else:  # within one bf16 ulp of the float32 sum
            assert bool((err <= want.abs() * 2 ** -7).all())
    # all-negative input: only the keras pad's 0 wins, and only at the border
    zeros = pool.max_pool_cuda(
        (-torch.rand(shape, device=cuda) - 0.5).to(dtype).contiguous(**cl), mode) == 0
    assert bool(zeros.any()) == (mode == "keras")


def test_probe_kernels_match_plain(cuda):
    from metro_pose3d_tpu_torch.probes import gather, prims

    for h, w, axis, dtype, b in gather.SHAPES[3:] + [(16, 24, 0, torch.float32, 3)]:
        x, idx = gather.make_case(h, w, axis, dtype, b, device=cuda)
        before = gather.LAUNCHES.get((h, w, axis, dtype, b), 0)
        assert torch.equal(gather.gather_cuda(x, idx, axis), gather.gather_plain(x, idx, axis))
        assert gather.LAUNCHES[h, w, axis, dtype, b] == before + 1
    for name, (cuda_fn, plain_fn, args, _) in prims.make_cases(device=cuda, b=4).items():
        before = sum(prims.LAUNCHES.values())
        got = cuda_fn(*args)
        assert sum(prims.LAUNCHES.values()) == before + 1
        assert torch.equal(got, plain_fn(*args)), name
    # a row whose staged window outgrows a block's shared memory, and negative reps
    too_wide = torch.zeros(1, 2, prims.LOOP_SMEM_WORDS, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        prims.lane_loop_cuda(too_wide, too_wide)
    with pytest.raises(ValueError):
        prims.roll_cuda(too_wide, torch.zeros(1, dtype=torch.int32, device=cuda))
    small = torch.zeros(1, 2, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        prims.lane_loop_cuda(small, small, reps=-1)


def test_probe_edge_cases_match_plain(cuda):
    """The roll, lane loop and row slice kernels on negative and out-of-range
    shifts, indices and starts (the ends of int32 among them, where start + k
    wraps), widths that are not a multiple of 4 or below 32, reps 0, 1, 33
    and above the width, and the row slice's reps split at H - rows, at the
    int32 wrap and at both: equal to their plain versions."""
    from metro_pose3d_tpu_torch.probes import prims

    cases = prims.edge_cases(device=cuda)
    assert len(cases) == 24
    for name, (cuda_fn, plain_fn, args, kw) in cases.items():
        assert torch.equal(cuda_fn(*args, **kw), plain_fn(*args, **kw)), name


def test_gather_edge_cases_match_take_along_dim(cuda):
    """The gather kernels on both axes and both dtypes at W = 1, 13, 130,
    H = 1, B = 1, the largest strip and row a block holds, and an input or
    index at a storage offset that breaks 16-byte alignment: bit for bit
    `take_along_dim`. A shape the tile cannot hold raises, and the launch
    floor is not counted as a launch."""
    from metro_pose3d_tpu_torch.probes import gather

    cases = gather.edge_cases(device=cuda)
    assert len(cases) == 32
    for name, (x, idx, axis) in cases.items():
        before = gather.LAUNCHES.get(gather.case_key(x, axis), 0)
        got = gather.gather_cuda(x, idx, axis)
        assert gather.LAUNCHES[gather.case_key(x, axis)] == before + 1
        assert torch.equal(got, gather.gather_plain(x, idx, axis)), name
    for name, (x, idx, axis) in gather.untileable(device=cuda).items():
        with pytest.raises(ValueError, match="shared memory"):
            gather.gather_cuda(x, idx, axis)
    x, idx = gather.make_case(64, 128, 0, torch.int32, 2, device=cuda)
    counts = dict(gather.LAUNCHES)
    gather.gather_floor(x, idx, 0)
    gather.gather_floor(x, idx, 1)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == counts


def test_dynslice_floor_is_not_a_launch(cuda):
    from metro_pose3d_tpu_torch.probes import prims

    x = torch.zeros((4, 512, 128), dtype=torch.int32, device=cuda)
    start = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = prims.LAUNCHES["dynslice"]
    prims.dynslice_floor(x, start)
    torch.cuda.synchronize()
    assert prims.LAUNCHES["dynslice"] == before
    with pytest.raises(ValueError):
        prims.dynslice_cuda(torch.zeros((1, 513, 8), dtype=torch.int32, device=cuda),
                            torch.zeros(1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("family", ["torchvision", "keras_v2", "twofive"])
def test_tiny_family_serving_on_card_matches_cpu(cuda, family):
    over = {"torchvision": {"model.preactivation": "false", "model.conv_padding": "torch",
                            "model.stride_position": "first"},
            "keras_v2": {"model.conv_padding": "keras", "model.v2_biases": "true"},
            "twofive": {"model.model_class": "twofive"}}[family]
    cfg = apply_overrides(Config(), {"model.backbone": "tiny", "model.proc_side": "64",
                                     "model.depth": "4", "model.compute_dtype": "float32",
                                     **over})
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu_model = init_metro_model(cfg.model, seed=1, device="cpu")
        gpu_model = init_metro_model(cfg.model, seed=1, device=cuda)
        rng = np.random.RandomState(2)
        crops = torch.from_numpy(rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8))
        intr = torch.tensor([[[900.0, 0, 31.5], [0, 900.0, 31.5], [0, 0, 1]]] * 4)
        fn = make_predict_fn(cfg, np.arange(17), flip_tta=True, reconstruct=True)
        want = fn(cpu_model, crops, intr)
        got = fn(gpu_model, crops.to(cuda), intr.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert set(got) == set(want)
    for key in want:
        # float32 with TF32 off: other summation orders only
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-2)


# ------------------------------------------- the pool kernels' two variants
def _pool_case(kind, shape, dtype, device, seed=0):
    """A channels_last pool input: "random", "nan" (random with ~5% NaN),
    "relu" (whole windows tie at 0), "negative" (keras border windows
    return their 0 pad)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "relu":
        x = _smooth_relu(shape, device)
    else:
        x = torch.randn(shape, generator=gen, device=device)
        if kind == "nan":
            x[torch.rand(shape, generator=gen, device=device) < 0.05] = float("nan")
        elif kind == "negative":
            x = -x.abs() - 0.5
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _widths(c, dtype):
    vec = pool.vector_width(c, dtype, 0)
    return [vec, 1] if vec > 1 else [1]


def _launched(way, width, fn):
    before = dict(pool.VARIANT_LAUNCHES[way])
    out = fn()
    want = {k: before[k] + (k == pool.variant(width)) for k in before}
    assert pool.VARIANT_LAUNCHES[way] == want
    return out


SIZES = {"even": (16, 12), "odd": (15, 13)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", ["even", "odd"])
@pytest.mark.parametrize("c", [64, 24, 8, 5])
@pytest.mark.parametrize("mode", ["same", "torch", "keras"])
def test_pool_forward_variants_bit_exact(cuda, mode, c, size, dtype):
    shape = (2, c, *SIZES[size])
    for kind in ("random", "nan", "relu", "negative"):
        x = _pool_case(kind, shape, dtype, cuda)
        want = pool.max_pool_plain(x, mode)
        nan = torch.isnan(want)
        for width in _widths(c, dtype):
            got = _launched("fwd", width, lambda: pool.max_pool_cuda(x, mode, width=width))
            # max is exact: equal value for value, NaN where the plain version has NaN
            assert torch.equal(torch.isnan(got), nan), (kind, width)
            assert torch.equal(got[~nan], want[~nan]), (kind, width)
        assert kind != "nan" or bool(nan.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", ["even", "odd"])
@pytest.mark.parametrize("c", [64, 24, 8, 5])
@pytest.mark.parametrize("mode", ["same", "torch", "keras"])
def test_pool_backward_variants_match_plain(cuda, mode, c, size, dtype):
    shape = (2, c, *SIZES[size])
    for kind in ("random", "nan", "relu", "negative"):
        x = _pool_case(kind, shape, dtype, cuda, seed=1)
        oh, ow = pool.pool_geometry(*shape[2:], mode)[:2]
        g = torch.randn(shape[0], c, oh, ow, device=cuda).to(dtype)
        want = pool.max_pool_bwd_plain(x.float(), g.float(), mode)
        for width in _widths(c, dtype):
            got = _launched("bwd", width, lambda: pool.max_pool_bwd_cuda(x, g, mode, width=width))
            again = pool.max_pool_bwd_cuda(x, g, mode, width=width)
            bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
            assert torch.equal(got.view(bits), again.view(bits))  # no atomics
            err = (got.float() - want).abs()
            if dtype == torch.float32:  # the same power-of-two weights, float32 sums
                assert float(err.max()) <= 1e-6, (kind, width)
            else:  # within one bf16 ulp of the float32 sum
                assert bool((err <= want.abs() * 2 ** -7).all()), (kind, width)


@pytest.mark.parametrize("mode", ["torch", "keras"])
def test_pool_backward_reaches_the_last_row_of_an_even_size(cuda, mode):
    # torch/keras, even size: the last input row is reached by window row
    # OH - 1 only (its tap row 2); its home row OH has no window of its own
    shape = (2, 64, 16, 12)
    x = _pool_case("relu", shape, torch.bfloat16, cuda)
    g = torch.zeros(2, 64, 8, 6, device=cuda)
    g[:, :, -1] = torch.randn(2, 64, 6, device=cuda)
    g[:, :, :, -1] = torch.randn(2, 64, 8, device=cuda)
    g = g.to(torch.bfloat16)
    want = pool.max_pool_bwd_plain(x.float(), g.float(), mode)
    assert bool((want[:, :, -1] != 0).any()) and bool((want[:, :, :, -1] != 0).any())
    for width in (8, 1):
        got = pool.max_pool_bwd_cuda(x, g, mode, width=width).float()
        assert bool(((got - want).abs() <= want.abs() * 2 ** -7).all())


def test_pool_picks_the_scalar_variant_for_unaligned_tensors(cuda):
    # a view 2 elements into its storage: C=64 bf16 but not 16-byte aligned
    base = torch.randn(2 * 64 * 16 * 12 + 2, device=cuda).to(torch.bfloat16)
    x = base[2:].view(2, 16, 12, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 != 0
    assert pool.vector_width(64, torch.bfloat16, x.data_ptr()) == 1
    xr = x.clone().requires_grad_(True)  # the clone is aligned again
    y = _launched("fwd", 1, lambda: pool.stem_max_pool(x))
    assert torch.equal(y, pool.max_pool_plain(x))
    y = _launched("fwd", 8, lambda: pool.stem_max_pool(xr))
    _launched("bwd", 8, lambda: y.backward(torch.ones_like(y)))
    with pytest.raises(ValueError, match="width"):
        pool.max_pool_cuda(x, width=8)


# ------------------------------------------------------------ int8 serving

# QK1 shapes: (B, C, H, W, N, k, stride, dilation, padding): the 3x3 convs of
# R50 v2 @ 256 at batch 8 (the path runs batch 128), with XLA SAME pads, then
# odd sizes, the 7x7 stem with C = 3, a C that is no multiple of 16, torch
# pads and an N that ends inside a tile; then 1x1 convs: three of the path's
# at batch 8, a strided one and one with a ragged N
INT8_CONV_SHAPES = {
    "1x1_64_256": (8, 64, 64, 64, 256, 1, 1, 1, "same"),
    "1x1_1024_256": (8, 1024, 16, 16, 256, 1, 1, 1, "same"),
    "1x1_512_2048": (8, 512, 16, 16, 2048, 1, 1, 1, "same"),
    "1x1_s2": (4, 256, 15, 16, 512, 1, 2, 1, "same"),
    "1x1_n70": (3, 48, 9, 7, 70, 1, 1, 1, "same"),
    "s1_64": (8, 64, 64, 64, 64, 3, 1, 1, "same"),
    "s2_64": (8, 64, 64, 64, 64, 3, 2, 1, "same"),
    "s1_128": (8, 128, 32, 32, 128, 3, 1, 1, "same"),
    "s2_128": (8, 128, 32, 32, 128, 3, 2, 1, "same"),
    "s1_256": (8, 256, 16, 16, 256, 3, 1, 1, "same"),
    "dil2_512": (8, 512, 16, 16, 512, 3, 1, 2, "same"),
    "stem_7x7_c3": (4, 3, 64, 64, 64, 7, 2, 1, "same"),
    "odd_sizes": (3, 32, 13, 11, 24, 3, 2, 1, "same"),
    "c24_unaligned": (2, 24, 9, 10, 40, 3, 1, 1, "same"),
    "torch_pads_n70": (2, 16, 10, 10, 70, 3, 2, 1, "torch"),
}


def _int8_conv_case(cuda, name, seed=0):
    from metro_pose3d_tpu_torch.models.resnet import _same_pads

    b, c, h, w, n, k, s, d, padding = INT8_CONV_SHAPES[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda, dtype=torch.int8)
    x = x.permute(0, 3, 1, 2)  # channels_last
    wq = torch.randint(-127, 128, (n, k, k, c), generator=g, device=cuda, dtype=torch.int8)
    if padding == "same":
        pads = (*_same_pads(h, k, s, d), *_same_pads(w, k, s, d))
    else:
        pads = ((k - 1) // 2 * d,) * 4
    scale = torch.rand(n, generator=g, device=cuda) * 3e-4 + 1e-5
    bias = torch.randn(n, generator=g, device=cuda) * 20
    return x, wq, s, d, pads, scale, bias


@pytest.mark.parametrize("epilogue", ["acc", "requant", "requant_norelu", "dequant_f32",
                                      "dequant_bf16", "dequant_bf16_nobias"])
@pytest.mark.parametrize("shape", sorted(INT8_CONV_SHAPES))
def test_int8_conv_kernel_bit_exact(cuda, shape, epilogue):
    from metro_pose3d_tpu_torch.ops import int8

    x, wq, s, d, pads, scale, bias = _int8_conv_case(cuda, shape)
    epi, rest = (epilogue.split("_", 1) + [""])[:2]
    kw = {"acc": {}, "requant": dict(scale=scale, bias=bias, relu=rest != "norelu"),
          "dequant": dict(scale=scale, bias=None if rest.endswith("nobias") else bias,
                          out_dtype=torch.float32 if rest == "f32" else torch.bfloat16)}[epi]
    want = int8.int8_conv_plain(x, wq, s, d, pads, epi, **kw)
    b, c, h, w, n, k = x.shape + wq.shape[:2]
    plan = int8.qk1_plan(b, c, h, w, n, k, k, s, d, pads)
    assert plan["variant"] == ("scalar" if shape in ("stem_7x7_c3", "c24_unaligned") else "wgmma")
    for variant in sorted({plan["variant"], "scalar"}):
        before = int8.launches("int8_conv", epi, variant)
        got = int8.int8_conv_cuda(x, wq, s, d, pads, epi, variant=variant, **kw)
        torch.cuda.synchronize()
        assert int8.launches("int8_conv", epi, variant) == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want), (shape, epilogue, variant)


@pytest.mark.parametrize("form", ["quantize_f32", "quantize_bf16", "junction", "junction_norelu",
                                  "dequant_f32", "dequant_bf16", "dequant_bf16_nobias"])
@pytest.mark.parametrize("shape", [(128, 256, 64, 64), (2, 17, 5, 3), (3, 24, 7, 9)])
def test_int8_elementwise_kernel_bit_exact(cuda, shape, form):
    from metro_pose3d_tpu_torch.ops import int8

    g = torch.Generator(device=cuda).manual_seed(1)
    c = shape[1]
    kind, rest = (form.split("_", 1) + [""])[:2]
    if kind == "quantize":
        x = torch.randn(shape, generator=g, device=cuda) * 3
        x.view(-1)[:4] = torch.tensor([0.5, -0.5, 1.5, 2.5], device=cuda) * 0.02  # ties
        x = x.to(torch.bfloat16 if rest == "bf16" else torch.float32)
        args = (x.contiguous(memory_format=torch.channels_last),
                torch.tensor(0.02, device=cuda))
        kw = {}
    else:
        acc = torch.randint(-2 ** 24, 2 ** 24, shape, generator=g, device=cuda, dtype=torch.int32)
        s = torch.rand(c, generator=g, device=cuda) * 1e-5 + 1e-7
        b = torch.randn(c, generator=g, device=cuda) * 5
        args = (acc.contiguous(memory_format=torch.channels_last), s)
        kw = (dict(bias=b, relu=rest != "norelu") if kind == "junction" else
              dict(bias=None if rest.endswith("nobias") else b,
                   out_dtype=torch.float32 if rest == "f32" else torch.bfloat16))
    want = int8.elementwise_plain(kind, *args, **kw)
    for width in (16, 1):
        got = int8.int8_elementwise_cuda(kind, *args, width=width, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (shape, form, width)


def test_int8_elementwise_unaligned_picks_the_scalar_variant(cuda):
    from metro_pose3d_tpu_torch.ops import int8

    base = torch.randint(-1000, 1000, (2 * 7 * 5 * 16 + 1,), device=cuda, dtype=torch.int32)
    acc = base[1:].view(2, 7, 5, 16).permute(0, 3, 1, 2)
    assert acc.is_contiguous(memory_format=torch.channels_last) and acc.data_ptr() % 16 != 0
    s = torch.full((16,), 1e-3, device=cuda)
    before = int8.launches("int8_elementwise", "dequant", "scalar")
    got = int8.int8_elementwise("dequant", acc, s, out_dtype=torch.float32)
    assert int8.launches("int8_elementwise", "dequant", "scalar") == before + 1
    assert torch.equal(got, int8.elementwise_plain("dequant", acc, s, out_dtype=torch.float32))
    with pytest.raises(ValueError, match="width"):
        int8.int8_elementwise_cuda("dequant", acc, s, out_dtype=torch.float32, width=16)


@pytest.mark.parametrize("m,k,n", [(1, 64, 17), (16, 8, 8), (300, 3, 5), (4096, 2048, 136)])
def test_int_products_pad_to_what_int_mm_takes(cuda, m, k, n):
    from metro_pose3d_tpu_torch.ops import int8

    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    got = int8.int_products(a, w.t())
    assert got.shape == (m, n) and got.is_contiguous()
    assert torch.equal(got.cpu(), torch._int_mm(a.cpu(), w.t().cpu()))


def test_int8_serving_forward_takes_route_b(cuda):
    """The int8 R50 v2 serving forward (at 64^2, B = 2, TTA) launches QK1
    once per quantized conv, 52, all in the wgmma variant, 1x1 convs
    included; QK2 only to quantize the 20 inputs that come from float
    (conv1 and proj of each unit); and no `torch._int_mm`."""
    from metro_pose3d_tpu_torch.models.quantize import QuantConv
    from metro_pose3d_tpu_torch.ops import int8

    cfg = apply_overrides(Config(), {"model.quantize": "int8", "model.proc_side": "64"})
    model = init_metro_model(cfg.model, 3, cuda)
    for m in model.modules():
        if isinstance(m, QuantConv):
            m.amax.fill_(4.0)
    fn = make_predict_fn(cfg, np.arange(17), root_index=0, flip_tta=True, reconstruct=False)
    crops = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, device=cuda)
    intr = torch.tensor([[90.0, 0, 31.5], [0, 90.0, 31.5], [0, 0, 1]], device=cuda).expand(2, 3, 3)
    int_mm, calls = torch._int_mm, []

    def counting_int_mm(*args):
        calls.append(args[0].shape)
        return int_mm(*args)

    int8.reset_launches()
    torch._int_mm = counting_int_mm
    try:
        out = fn(model, crops, intr.contiguous())
        torch.cuda.synchronize()
    finally:
        torch._int_mm = int_mm
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert int8.launches("int8_conv") == int8.launches("int8_conv", var="wgmma") == 52
    assert int8.launches("int8_conv", "requant") == 32  # conv1 and conv2 of 16 units
    assert int8.launches("int8_conv", "dequant") == 20  # conv3 and proj
    assert int8.launches("int8_elementwise") == int8.launches("int8_elementwise", "quantize") == 20
    assert calls == []


@pytest.mark.parametrize("over", [{}, {"quantize_fused": "false"},
                                  {"quantize_extras": "stem,heads"},
                                  {"preactivation": "false", "conv_padding": "torch"}],
                         ids=["fused", "unfused", "extras", "v1_5"])
def test_tiny_int8_serving_on_card_matches_cpu(cuda, over):
    """A tiny int8 model calibrated on the CPU serves on the card (every
    kernel launched) and on the CPU: the int8 graphs take the same integer
    sums, so they differ only where a float32 activation before a quantize
    rounds otherwise on the card (cuDNN's convolutions, float32 batch norm)."""
    from metro_pose3d_tpu_torch.models.quantize import calibrate
    from metro_pose3d_tpu_torch.ops import int8

    over = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
            "model.compute_dtype": "float32", "model.quantize": "int8",
            **{f"model.{k}": v for k, v in over.items()}}
    cfg = apply_overrides(Config(), over)
    cpu = init_metro_model(cfg.model, 5, "cpu")
    rng = np.random.RandomState(5)
    calibrate(cpu, [torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32))
                    for _ in range(2)])
    card = init_metro_model(cfg.model, 5, cuda)
    card.load_state_dict(cpu.state_dict())
    crops = torch.from_numpy(rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8))
    intr = torch.tensor([[90.0, 0, 31.5], [0, 90.0, 31.5], [0, 0, 1]]).expand(3, 3, 3).contiguous()
    fn = make_predict_fn(cfg, np.arange(17), root_index=0, flip_tta=True, reconstruct=False)
    int8.reset_launches()
    got = fn(card, crops.to(cuda), intr.to(cuda))
    torch.cuda.synchronize()
    assert int8.launches("int8_conv") > 0 and int8.launches("int8_elementwise") > 0
    want = fn(cpu, crops, intr)
    for key in want:
        assert float((got[key].cpu() - want[key]).abs().max()) < {"pose3d_rootrel": 5.0,
                                                                  "pose2d_px": 0.5}[key], key


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_aot_compile_replays_the_eager_predict(cuda, quantize):
    """`export.aot_compile` on the card: a CUDA graph whose replay gives the
    eager call's bits on fresh inputs, leaves earlier answers alone, refuses
    another shape, and counts one replay's launches at each replay (the
    capture counts none)."""
    from metro_pose3d_tpu_torch.export import aot_compile
    from metro_pose3d_tpu_torch.models.quantize import calibrate
    from metro_pose3d_tpu_torch.ops import int8

    cfg = apply_overrides(Config(), {"model.backbone": "tiny", "model.proc_side": "64",
                                     "model.depth": "4", "model.quantize": quantize})
    model = init_metro_model(cfg.model, 3, cuda)
    rng = np.random.RandomState(3)
    if quantize == "int8":
        calibrate(model, [torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(
            np.float32)).to(cuda) for _ in range(2)])
    fn = make_predict_fn(cfg, np.arange(17), root_index=0, flip_tta=True)
    intr = torch.tensor([[90.0, 0, 31.5], [0, 90.0, 31.5], [0, 0, 1]]).expand(4, 3, 3)
    pool.reset_launches()
    int8.reset_launches()
    bn.reset_launches()
    compiled = aot_compile(fn, model, 4, 64)
    assert compiled.graph is not None and pool.LAUNCHES == 2  # the two warm-up calls
    counted = (pool.LAUNCHES, int8.launches(), bn.LAUNCHES)
    first = None
    for _ in range(2):
        crops = torch.from_numpy(rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)).to(cuda)
        got = compiled(model, crops, intr.contiguous())
        want = fn(model, crops, intr.contiguous().to(cuda))
        for key in want:
            assert torch.equal(got[key], want[key]), key
        if first is None:
            first, kept = got, {k: v.clone() for k, v in got.items()}
    for key in kept:
        assert torch.equal(first[key], kept[key]), key
    per = {k: n for d in compiled.launches for k, n in d.items()}
    per_bn = sum(n for k, n in per.items() if k in bn.KERNEL_LAUNCHES)
    assert per and (pool.LAUNCHES, int8.launches(), bn.LAUNCHES) == (
        counted[0] + 4 * sum(n for k, n in per.items() if k[0] == "fwd"),
        counted[1] + 4 * sum(n for k, n in per.items() if k[0].startswith("int8")),
        counted[2] + 4 * per_bn)
    assert (sum(n for k, n in per.items() if k[0] == "int8_conv") > 0) == (quantize == "int8")
    # tiny: 4 units of 3 batch norms and bn_final; int8 folds bn1 and bn2 into QK1
    assert per_bn == {"none": 13, "int8": 5}[quantize]
    with pytest.raises(TypeError, match="compiled for"):
        compiled(model, crops[:2], intr[:2])


def test_a_traced_session_anchors_its_spans_on_two_marker_kernels(cuda):
    """`utils/profiling.py`: a session's first record and the profiler's stop
    each drain the card and launch one marker kernel; through them, the pool
    kernel starts after its launch stamp, which its span encloses."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metro_pose3d_tpu_torch.utils import profiling

    x = torch.randn(4, 64, 128, 128, device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    pool.stem_max_pool(x)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("outer"):
            pool.stem_max_pool(x)
        time.sleep(0.2)  # the markers' launch latencies, over 0.2 s, fix the rate to 1e-3
    rec = profiling.recorded()
    device = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    marks = [s for s, n in device if rec["marker"] in n]
    runs = [s for s, n in device if "maxpool3x3s2_kernel" in n]
    assert len(marks) == 2 and len(runs) == 1, (marks, runs, rec["anchors"])
    first, last = rec["anchors"]
    assert first["before_ns"] <= first["after_ns"] <= last["before_ns"] <= last["after_ns"]
    rate = (marks[1] - marks[0]) / ((last["after_ns"] - first["after_ns"]) / 1e3)
    assert abs(rate - 1) < 1e-2, (rate, marks, rec["anchors"])
    (launch,) = rec["launches"]
    stamp_us = (launch["t_ns"] - first["after_ns"]) / 1e3 * rate + marks[0]
    assert launch["kernel"] == "metro_maxpool3x3s2" and runs[0] >= stamp_us, (runs, stamp_us)
    (outer,) = rec["spans"]
    assert outer["start_ns"] <= launch["t_ns"] <= outer["end_ns"]


# --- nvJPEG: the JPEG decode of a machine without libjpeg ---------------------------

REAL_JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "real_files",
                         "jpeg")
# levels of [0, 255] against libjpeg's pixels (chip_smoke.NVJPEG_CEILINGS): they
# catch swapped channels, a wrong chroma siting or a missed colour conversion,
# not the IDCT's and the upsampling's rounding
NVJPEG_MAX, NVJPEG_MEAN = 16, 1.0


@pytest.fixture
def nvjpeg(cuda):
    from metro_pose3d_tpu_torch.utils import improc

    if improc.jpeg_backend() != "nvjpeg":
        pytest.skip("libjpeg is present: this process decodes JPEGs with it")
    return improc


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("name", ["s444", "s422", "s420", "gray", "progressive", "restart",
                                  "odd_37x53", "frame_1000", "mask_1000"])
def test_nvjpeg_decode_is_near_libjpeg(nvjpeg, name, gray):
    path = os.path.join(REAL_JPEG, f"{name}.jpg")
    got = nvjpeg.imread_gray(path) if gray else nvjpeg.imread(path)
    want = nvjpeg.imread(os.path.join(REAL_JPEG, f"{name}.{'gray' if gray else 'rgb'}.png"))
    want = want[..., 0] if gray else want
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= NVJPEG_MAX and diff.mean() <= NVJPEG_MEAN, (diff.max(), diff.mean())


def test_nvjpeg_refuses_what_is_not_a_jpeg(nvjpeg):
    with pytest.raises(nvjpeg.CorruptImage):
        nvjpeg.decode_jpeg_bytes(b"definitely not a jpeg")
    with open(os.path.join(REAL_JPEG, "s420.jpg"), "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="item 1"):
        nvjpeg.decode_jpeg_batch([data, b"not a jpeg"], threads=2)


# ---------------------------------------- eval batch norm and its activation (ops/bn.py)


def _bn_shapes(cfg, cuda):
    """[(C, H, W, act)] of the batch norms of the config's eval forward of one
    crop."""
    model = init_metro_model(cfg.model, 0, cuda).eval()
    shapes = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda _, args, kw: shapes.append((*args[0].shape[1:], kw.get("act", "none"))),
                with_kwargs=True)
    side = cfg.model.proc_side
    with torch.no_grad():
        model(torch.zeros(1, side, side, 3, device=cuda))
    return shapes


def _r50_bn_shapes(cuda):
    """[(C, H, W, act)] of the batch norms of a Config() forward (R50 v2 @ 256)."""
    return _bn_shapes(Config(), cuda)


def _bn_path_inputs(gen, cuda, c, h, w):
    """A bf16 channels_last [128, c, h, w] input (64 crops with flip TTA) and
    a channel's mean, mul and bias."""
    x = (torch.randn((128, c, h, w), generator=gen, device=cuda) * 2).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    mean, scale, bias = (torch.randn(c, generator=gen, device=cuda) for _ in range(3))
    mul = torch.rsqrt(torch.rand(c, generator=gen, device=cuda) + 0.05) * scale
    return x, mean, mul, bias


def test_bn_kernel_bit_exact_at_the_r50_path_shapes(cuda):
    """The 49 batch norms of the bf16 serving forward at 128 rows (64 crops,
    flip TTA), each with and without the ReLU, in the vec16 variant."""
    shapes = _r50_bn_shapes(cuda)
    assert len(shapes) == 49 and all(act == "relu" for *_, act in shapes)
    gen = torch.Generator(device=cuda).manual_seed(0)
    bn.reset_launches()
    for c, h, w, _ in shapes:
        x, mean, mul, bias = _bn_path_inputs(gen, cuda, c, h, w)
        for act in ("none", "relu"):
            assert _same_bits(bn.bn_act_cuda(x, mean, mul, bias, act),
                              bn.bn_act_plain(x, mean, mul, bias, act)), (c, h, w, act)
    assert bn.launches("bfloat16", var="vec16") == bn.LAUNCHES == 98


def test_bn_kernel_bit_exact_at_the_effv2l_path_shapes(cuda):
    """The 217 batch norms of EfficientNetV2-L's bf16 serving forward at 128
    rows, each with its own activation (142 SiLU, 75 none), in the vec16
    variant: the kernel's bits are the twin's (torch's F.silu on the card)."""
    cfg = apply_overrides(Config(), {"model.backbone": "efficientnetv2-l"})
    shapes = _bn_shapes(cfg, cuda)
    acts = [act for *_, act in shapes]
    assert (len(shapes), acts.count("silu"), acts.count("none")) == (217, 142, 75)
    gen = torch.Generator(device=cuda).manual_seed(1)
    bn.reset_launches()
    differing = total = 0
    for c, h, w, act in shapes:
        x, mean, mul, bias = _bn_path_inputs(gen, cuda, c, h, w)
        got = bn.bn_act_cuda(x, mean, mul, bias, act)
        want = bn.bn_act_plain(x, mean, mul, bias, act)
        differing += int((_bits(got) != _bits(want)).sum())
        total += got.numel()
    print(f"bn_act at the EfficientNetV2-L path shapes: {differing} of {total} elements differ")
    assert differing == 0
    assert bn.launches("bfloat16", "silu", "vec16") == 142
    assert bn.launches("bfloat16", "none", "vec16") == 75 == bn.LAUNCHES - 142


@pytest.mark.parametrize("width", [None, 1], ids=["auto", "scalar"])
@pytest.mark.parametrize("act", ["none", "relu", "silu"], ids=["affine", "relu", "silu"])
@pytest.mark.parametrize("c", [8, 64, 2048])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bn_kernel_bit_exact_at_the_cpu_cases(cuda, dtype, layout, c, act, width):
    """tests/test_torch_bn.py's cases (odd N*H*W; NaN, +-inf and -0.0, a
    channel that takes -0.0 to -0.0) on the card: the kernel's bits, NaN and
    the sign of zero included, are the twin's."""
    x, mean, var, scale, bias = (t.to(cuda) for t in _case(c, DTYPES[dtype], layout))
    mul = torch.rsqrt(var + 1e-3) * scale
    got = bn.bn_act_cuda(x, mean, mul, bias, act, width)
    assert _same_bits(got, bn.bn_act_plain(x, mean, mul, bias, act))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bn_kernel_takes_unaligned_tensors_in_the_scalar_variant(cuda, dtype):
    base = torch.randn(1 + 2 * 64 * 5 * 5, device=cuda).to(DTYPES[dtype])
    x = base[1:].view(2, 5, 5, 64).permute(0, 3, 1, 2)  # channels_last, 2 or 4 bytes off
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16
    mean, mul, bias = (torch.randn(64, device=cuda) for _ in range(3))
    bn.reset_launches()
    got = bn.bn_act_cuda(x, mean, mul, bias, "relu")
    assert bn.launches(var="scalar") == 1
    assert _same_bits(got, bn.bn_act_plain(x, mean, mul, bias, "relu"))
    with pytest.raises(ValueError, match="does not fit"):
        bn.bn_act_cuda(x, mean, mul, bias, "relu", width=16 // x.element_size())


def test_bn_kernel_refuses_a_gradient(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda).contiguous(memory_format=torch.channels_last)
    c = torch.zeros(8, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        bn.bn_act_cuda(x.clone().requires_grad_(True), c, c, c)
    mod = BatchNorm(8, 1e-3).to(cuda).eval()
    with pytest.raises(RuntimeError, match="no backward"):
        mod(x)  # its scale and bias need a gradient
    with torch.no_grad():
        assert mod(x, act="relu").shape == x.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernel_counts_no_launch_for_an_empty_tensor(cuda, dtype):
    """An empty input launches nothing, so it counts nothing."""
    x = torch.empty((0, 64, 8, 8), dtype=dtype, device=cuda).contiguous(
        memory_format=torch.channels_last)
    c = torch.zeros(64, device=cuda)
    bn.reset_launches()
    for act in bn.ACTIVATIONS:
        y = bn.bn_act_cuda(x, c, c, c, act)
        assert y.shape == x.shape and y.dtype == dtype
        assert y.is_contiguous(memory_format=torch.channels_last)
    assert bn.LAUNCHES == 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_serving_with_the_bn_kernel_equals_the_twin_chain(cuda, quantize, monkeypatch):
    """`predict_crops` and `predict_tiles` at Config() (R50 v2 @ 256, TTA,
    B = 64; int8 calibrated on noise): 49 kernel launches a bf16 forward, 17
    an int8 one, and the outputs of the same calls with the twin's chain on
    the card, bit for bit."""
    from metro_pose3d_tpu_torch.models.quantize import calibrate

    cfg = apply_overrides(Config(), {"model.quantize": quantize})
    model = init_metro_model(cfg.model, 7, cuda)
    rng = np.random.RandomState(7)
    if quantize == "int8":
        calibrate(model, [torch.from_numpy(rng.uniform(-1, 1, (16, 256, 256, 3)).astype(
            np.float32)).to(cuda) for _ in range(2)])
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    b = 64
    crops = rng.randint(0, 256, (b, 256, 256, 3)).astype(np.uint8)
    intr = np.tile(np.array([[900.0, 0, 127.5], [0, 900.0, 127.5], [0, 0, 1]], np.float32),
                   (b, 1, 1))
    h, k, _ = _params(rng, b, 512, 256)
    tiles = {"source": rng.randint(0, 256, (b, 512, 512, 3)).astype(np.uint8),
             "warp_h": h, "warp_k": k, "warp_dist": torch.zeros(b, 5), "intrinsics": intr}
    per_forward = {"none": 49, "int8": 17}[quantize]
    bn.reset_launches()
    got = [est.predict_crops(crops, intr)]
    assert bn.LAUNCHES == bn.launches(act="relu", var="vec16") == per_forward
    got.append(est.predict_tiles(tiles))
    assert bn.LAUNCHES == 2 * per_forward
    monkeypatch.setattr(bn, "bn_act_cuda", lambda x, mean, mul, bias, act="none":
                        bn.bn_act_plain(x, mean, mul, bias, act))
    want = [est.predict_crops(crops, intr), est.predict_tiles(tiles)]
    assert bn.LAUNCHES == 2 * per_forward
    for g, w in zip(got, want):
        for key in w:
            assert torch.equal(g[key], w[key]), key


def test_effv2l_serving_with_the_bn_kernel_equals_the_twin_chain(cuda, monkeypatch):
    """EfficientNetV2-L's `predict_crops` and `predict_tiles` at 256 px (bf16,
    TTA, B = 64): 217 batch norm launches a forward, 142 of them with the
    SiLU, and 61 depthwise conv launches; the outputs of the same calls with
    both kernels' twins on the card, bit for bit."""
    from metro_pose3d_tpu_torch.ops import dwconv

    cfg = apply_overrides(Config(), {"model.backbone": "efficientnetv2-l",
                                     "model.bn_epsilon": "0.001", "model.bn_momentum": "0.9"})
    model = init_metro_model(cfg.model, 11, cuda)
    rng = np.random.RandomState(11)
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    b = 64
    crops = rng.randint(0, 256, (b, 256, 256, 3)).astype(np.uint8)
    intr = np.tile(np.array([[900.0, 0, 127.5], [0, 900.0, 127.5], [0, 0, 1]], np.float32),
                   (b, 1, 1))
    h, k, _ = _params(rng, b, 512, 256)
    tiles = {"source": rng.randint(0, 256, (b, 512, 512, 3)).astype(np.uint8),
             "warp_h": h, "warp_k": k, "warp_dist": torch.zeros(b, 5), "intrinsics": intr}
    bn.reset_launches()
    dwconv.reset_launches()
    got = [est.predict_crops(crops, intr)]
    assert bn.LAUNCHES == 217 and bn.launches(act="silu", var="vec16") == 142
    assert dwconv.LAUNCHES == dwconv.launches("bfloat16", "vec16") == 61
    got.append(est.predict_tiles(tiles))
    assert (bn.LAUNCHES, dwconv.LAUNCHES) == (2 * 217, 2 * 61)
    monkeypatch.setattr(bn, "bn_act_cuda", lambda x, mean, mul, bias, act="none":
                        bn.bn_act_plain(x, mean, mul, bias, act))
    monkeypatch.setattr(dwconv, "depthwise_conv_cuda", dwconv.depthwise_conv_plain)
    want = [est.predict_crops(crops, intr), est.predict_tiles(tiles)]
    assert (bn.LAUNCHES, dwconv.LAUNCHES) == (2 * 217, 2 * 61)
    for g, w in zip(got, want):
        for key in w:
            assert torch.isfinite(g[key]).all(), key
            assert torch.equal(g[key], w[key]), key


def test_effv2_aot_compile_replays_the_eager_bits(cuda):
    """`export.aot_compile` captures the EfficientNetV2 crop-in TTA predict
    (the tiny trunk, B = 4) as one CUDA graph; a replay gives the eager
    call's bits and counts one replay's bn_act launches."""
    from metro_pose3d_tpu_torch.export import aot_compile

    cfg = apply_overrides(Config(), {"model.backbone": "efficientnetv2-tiny",
                                     "model.proc_side": "64", "model.depth": "4"})
    model = init_metro_model(cfg.model, 5, cuda)
    fn = make_predict_fn(cfg, np.arange(17), root_index=0, flip_tta=True)
    intr = torch.tensor([[90.0, 0, 31.5], [0, 90.0, 31.5], [0, 0, 1]]).expand(4, 3, 3).contiguous()
    compiled = aot_compile(fn, model, 4, 64)
    crops = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (4, 64, 64, 3)).astype(
        np.uint8)).to(cuda)
    bn.reset_launches()
    got = compiled(model, crops, intr)
    per_replay = bn.LAUNCHES
    want = fn(model, crops, intr.to(cuda))
    assert per_replay == bn.LAUNCHES - per_replay == 29  # the tiny trunk's batch norms
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------- the depthwise conv (ops/dwconv.py)


def test_dwconv_kernel_bit_exact_at_the_effv2l_path_shapes(cuda):
    """The 61 depthwise convs of EfficientNetV2-L's bf16 serving forward at
    128 rows, in the vec16 variant: the kernel's bits are the twin's."""
    from metro_pose3d_tpu_torch.models.efficientnet import MBConv
    from metro_pose3d_tpu_torch.ops import dwconv

    cfg = apply_overrides(Config(), {"model.backbone": "efficientnetv2-l"})
    model = init_metro_model(cfg.model, 0, cuda).eval()
    shapes = []
    for m in model.modules():
        if isinstance(m, MBConv):
            m.conv2.register_forward_pre_hook(
                lambda mod, args: shapes.append((mod, tuple(args[0].shape[1:]))))
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3, device=cuda))
    assert len(shapes) == 61
    gen = torch.Generator(device=cuda).manual_seed(2)
    dwconv.reset_launches()
    for conv, (c, h, w) in shapes:
        x = (torch.randn((128, c, h, w), generator=gen, device=cuda) * 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        weight = torch.randn((c, 1, 3, 3), generator=gen, device=cuda) * 0.4
        pads = conv.pads(h, w)
        got = dwconv.depthwise_conv_cuda(x, weight, conv.stride, conv.dilation, pads)
        want = dwconv.depthwise_conv_plain(x, weight, conv.stride, conv.dilation, pads)
        assert _same_bits(got, want), (c, h, w, conv.stride, conv.dilation)
    assert dwconv.launches("bfloat16", "vec16") == dwconv.LAUNCHES == 61


@pytest.mark.parametrize("width", [None, 1], ids=["auto", "scalar"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dwconv_kernel_bit_exact_at_the_cpu_cases(cuda, dtype, width):
    """tests/test_torch_dwconv.py's cases (odd sides, stride 2's uneven pad,
    dilation 2, C = 5; NaN, +-inf and -0.0 in x) on the card."""
    from metro_pose3d_tpu_torch.ops import dwconv
    from test_torch_dwconv import CASES, case

    for c, h, w, k, stride, dil in CASES:
        x, weight, pads = case(c, h, w, k, stride, dil, DTYPES[dtype])
        x, weight = x.to(cuda), weight.to(cuda)
        vec = dwconv.vector_width(x, 0)
        got = dwconv.depthwise_conv_cuda(x, weight, stride, dil, pads,
                                         width if vec > 1 else None)
        want = dwconv.depthwise_conv_plain(x, weight, stride, dil, pads)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert _same_bits(got.contiguous(), want.contiguous()), (c, h, w, k, stride, dil)


def test_dwconv_kernel_takes_unaligned_tensors_and_refuses_the_rest(cuda):
    from metro_pose3d_tpu_torch.ops import dwconv

    base = torch.randn(1 + 2 * 9 * 9 * 16, device=cuda).to(torch.bfloat16)
    x = base[1:].view(2, 9, 9, 16).permute(0, 3, 1, 2)  # channels_last, 2 bytes off
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16
    weight = torch.randn(16, 1, 3, 3, device=cuda)
    dwconv.reset_launches()
    got = dwconv.depthwise_conv_cuda(x, weight, 1, 1, (1, 1, 1, 1))
    assert dwconv.launches(var="scalar") == 1
    assert _same_bits(got, dwconv.depthwise_conv_plain(x, weight, 1, 1, (1, 1, 1, 1)))
    with pytest.raises(ValueError, match="does not fit"):
        dwconv.depthwise_conv_cuda(x, weight, 1, 1, (1, 1, 1, 1), width=8)
    with pytest.raises(ValueError, match="channels_last"):
        dwconv.depthwise_conv_cuda(x.contiguous(), weight, 1, 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="k = 3"):
        dwconv.depthwise_conv_cuda(x, torch.randn(16, 1, 7, 7, device=cuda), 1, 1, (3, 3, 3, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        dwconv.depthwise_conv_cuda(x, weight.requires_grad_(True), 1, 1, (1, 1, 1, 1))
    empty = torch.empty((0, 16, 9, 9), dtype=torch.bfloat16, device=cuda).contiguous(
        memory_format=torch.channels_last)
    dwconv.reset_launches()
    assert dwconv.depthwise_conv_cuda(empty, weight.detach(), 1, 1, (1, 1, 1, 1)).shape == (
        0, 16, 9, 9)
    assert dwconv.LAUNCHES == 0
