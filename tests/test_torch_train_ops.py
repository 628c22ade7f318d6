"""The port's training-path operations against the JAX package on the CPU.

Colour jitter and background composite, the procedural occluder bank, the
occluder paste (plain version of the K2 kernel), the stem pool's gradient
(plain version of the K3 backward), train-mode batch norm, the learning-rate
schedule, and the clip + Adam update. Inputs are numpy arrays made from a
seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.experimental.pallas import tpu as pltpu

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.models.resnet import GhostBatchNorm
from metro_pose3d_tpu.ops import color as jcolor
from metro_pose3d_tpu.ops import occlusion as jocc
from metro_pose3d_tpu.ops.pool_pallas import stem_max_pool as jax_stem_pool
from metro_pose3d_tpu.pipeline import occluders as joccluders
from metro_pose3d_tpu.train import loop as jloop
from metro_pose3d_tpu_torch.models.resnet import BatchNorm
from metro_pose3d_tpu_torch.ops import color, occlusion, pool
from metro_pose3d_tpu_torch.pipeline import occluders
from metro_pose3d_tpu_torch.train import loop


def _color_params(rng, b):
    return [rng.uniform(-0.125, 0.125, b), rng.uniform(0.75, 1.25, b),
            rng.uniform(0.75, 1.25, b), rng.uniform(-0.3, 0.3, b)]


def test_color_jitter_matches_jax():
    rng = np.random.RandomState(0)
    imgs = rng.uniform(0, 1, (4, 24, 20, 3)).astype(np.float32)
    params = [p.astype(np.float32) for p in _color_params(rng, 4)]
    want = np.asarray(jcolor.color_jitter(jnp.asarray(imgs), *map(jnp.asarray, params)))
    got = color.color_jitter(torch.from_numpy(imgs), *map(torch.from_numpy, params)).numpy()
    # float32 roundoff of three 3-term colour transforms (the reference sums
    # its HIGHEST einsums in its own order)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.array_equal(color._YIQ2RGB, np.asarray(jcolor._YIQ2RGB))


def test_composite_background_matches_jax_exactly():
    rng = np.random.RandomState(1)
    b, t = 4, 32
    src = rng.randint(0, 256, (b, t, t, 3)).astype(np.uint8)
    mask = rng.randint(0, 256, (b, t, t)).astype(np.uint8)
    mask[0] = 255  # all foreground: a no-op
    bank = rng.randint(0, 256, (3, t, t, 3)).astype(np.uint8)
    bgp = np.array([[1, 2], [0, 1], [1, 0], [1, 1]], np.float32)
    want = np.asarray(jcolor.composite_background(*map(jnp.asarray, (src, mask, bank, bgp))))
    got = color.composite_background(*map(torch.from_numpy, (src, mask, bank, bgp))).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], src[0])
    np.testing.assert_array_equal(got[1], src[1])  # disabled


def test_procedural_bank_bit_for_bit():
    np.testing.assert_array_equal(occluders.make_procedural_occluders(),
                                  joccluders.make_procedural_occluders())
    np.testing.assert_array_equal(occluders.make_procedural_occluders(5, 32, seed=3),
                                  joccluders.make_procedural_occluders(5, 32, seed=3))
    np.testing.assert_array_equal(occluders.get_occluder_bank(None, 48),
                                  joccluders.get_occluder_bank(None, 48))


# the angle set of tests/test_warp_twopass.py::test_occluder_twopass_matches_bank_path:
# full-range rotations, with the near +-90 degree band
ANGLES = [-np.pi / 2 + 0.01, np.pi / 2 - 0.005, 0.3, -2.9, 1.3, 2.2]


def _occluder_case(side=128, t2=96, n=8, seed=5):
    rng = np.random.RandomState(seed)
    b = len(ANGLES)
    bank = np.zeros((n, t2, t2, 4), np.float32)
    yy, xx = np.meshgrid(np.arange(t2), np.arange(t2), indexing="ij")
    for i in range(n):
        bank[i, ..., :3] = np.sin((xx + (i + 1) * yy) / 7.0)[..., None] * 0.4 + 0.5
        bank[i, ..., 3] = ((xx - t2 / 2) ** 2 + (yy - t2 / 2) ** 2 < (t2 * 0.4) ** 2)
    bank[:, ::7, :, 3] = 0.5  # soft alpha rows
    crops = rng.uniform(0, 1, (b, side, side, 3)).astype(np.float32)
    idx = rng.randint(0, n, (b,)).astype(np.int32)
    affs = []
    for th in ANGLES:
        sc = 1.0 / rng.uniform(0.2, 0.7)
        c, s = np.cos(th), np.sin(th)
        m = sc * np.array([[c, -s], [s, c]])
        aff = np.zeros((2, 3))
        aff[:, :2] = m
        aff[:, 2] = np.array([t2 / 2, t2 / 2]) - m @ (rng.uniform(0.1, 0.9, 2) * side)
        affs.append(aff)
    affs = np.stack(affs).astype(np.float32)
    en = np.array([1, 1, 0, 1, 1, 1], np.float32)
    return crops, bank, idx, affs, en


def _assert_close_up_to_coordinate_ulps(got, want):
    err = np.abs(got - want)
    assert err.max() <= 6.2e-5
    assert (err > 1e-5).mean() < 1e-3


def _port_occlude(crops, bank, idx, affs, en):
    return occlusion.occlude_with_bank(
        torch.from_numpy(crops), occlusion.pack_occluder_bank(bank), torch.from_numpy(idx),
        torch.from_numpy(affs), torch.from_numpy(en)).numpy()


def test_occluder_plain_matches_jax_bank_and_tiles():
    crops, bank, idx, affs, en = _occluder_case()
    got = _port_occlude(crops, bank, idx, affs, en)
    jargs = tuple(map(jnp.asarray, (idx, affs, en)))
    want = np.asarray(jax.jit(jocc.occlude_with_bank, static_argnums=2)(
        jnp.asarray(crops), jocc.pack_occluder_bank(jnp.asarray(bank)), bank.shape[1], *jargs))
    # The reference sums its HIGHEST placement einsum in its own order, so a
    # tile coordinate (up to ~700 px at scale 5) may differ by one float32
    # ulp, 6.1e-5; a bilinear weight moves by as much, times a texel step of
    # at most 1. Most pixels agree to roundoff.
    _assert_close_up_to_coordinate_ulps(got, want)
    np.testing.assert_array_equal(got[2], crops[2])  # disabled: untouched
    assert np.abs(got - crops).max() > 0.1  # the occluders are there

    # the reference form, on the bank quantised as the port stores it
    q = occlusion.pack_occluder_bank(bank).numpy().astype(np.float32) / 255.0
    tiles = jnp.asarray(q[idx])
    want_tiles = np.asarray(jax.jit(jocc.occlude_with_tiles)(jnp.asarray(crops), tiles,
                                                             *jargs[1:]))
    _assert_close_up_to_coordinate_ulps(got, want_tiles)


def test_occluder_plain_against_pallas_twopass_kernel():
    crops, bank, idx, affs, en = _occluder_case()
    got = _port_occlude(crops, bank, idx, affs, en)
    with pltpu.force_tpu_interpret_mode():
        two = np.asarray(jocc.occlude_with_bank_twopass(
            jnp.asarray(crops), jocc.pack_occluder_bank_raw(jnp.asarray(bank)),
            *map(jnp.asarray, (idx, affs, en))))
    diff = np.abs(got - two)
    # that test's two-pass tolerances: sub-pixel two-pass phase + 8-bit
    # repacking; alpha edges may move by one tap
    assert diff.mean() < 2e-3
    assert (diff > 0.05).mean() < 1e-3


def test_occluder_index_outside_bank_is_transparent():
    crops, bank, idx, affs, en = _occluder_case()
    idx[:] = [-1, 8, 100, 0, 1, 2]
    got = _port_occlude(crops, bank, idx, affs, en)
    np.testing.assert_array_equal(got[:3], crops[:3])
    assert np.abs(got[3:] - crops[3:]).max() > 0.1


def test_occluder_wrapper_checks_inputs():
    crops, bank, idx, affs, en = _occluder_case()
    args = [torch.from_numpy(crops), occlusion.pack_occluder_bank(bank),
            torch.from_numpy(idx), torch.from_numpy(affs), torch.from_numpy(en)]
    with pytest.raises(ValueError, match="uint8"):
        occlusion.occlude_with_bank(args[0], args[1].float(), *args[2:])
    with pytest.raises(ValueError, match="float32"):
        occlusion.occlude_with_bank(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        occlusion.occlude_with_bank(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="CUDA"):  # no quiet fallback to the plain path
        occlusion.occlude_cuda(*args)
    assert occlusion.LAUNCHES == 0


POOL_SHAPES = [(2, 16, 16, 8), (2, 15, 13, 5), (1, 9, 16, 3), (1, 8, 7, 4)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_gradient_matches_jax(shape, ties):
    """Autograd through the plain pool == jax.grad of the JAX training pool,
    with the chain's 0.5/0.5 tie split (ties: x on a grid of 0.25)."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4
    oh, ow = (shape[1] + 1) // 2, (shape[2] + 1) // 2
    g = rng.randn(shape[0], oh, ow, shape[3]).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_stem_pool(t, train=True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    got = pool.max_pool_bwd_plain(xt, gt).permute(0, 2, 3, 1).numpy()
    # the same weights (exact powers of two); sums of up to four window terms
    # in another order
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    xr = xt.clone().requires_grad_(True)
    pool.stem_max_pool(xr).backward(gt)  # the CPU wrapper is differentiable
    torch.testing.assert_close(xr.grad, pool.max_pool_bwd_plain(xt, gt), rtol=0, atol=0)


def test_pool_gradient_splits_ties_as_the_chain():
    x = torch.zeros(1, 1, 4, 4)  # every window is one big tie
    g = torch.ones(1, 1, 2, 2)
    dx = pool.max_pool_bwd_plain(x.contiguous(memory_format=torch.channels_last), g)
    # window (0,0) lies inside the image and splits its 1 over taps 0..8 as
    # 1/256, 1/256, 1/128, ..., 1/4, 1/2; the padding taps of the others
    # lose every comparison, so each window hands on exactly 1
    assert float(dx[0, 0, 0, 0]) == 2 ** -8
    assert float(dx[0, 0, 0, 1]) == 2 ** -8
    assert float(dx.sum()) == 4.0
    assert torch.all(dx > 0)


@pytest.mark.parametrize("group_size", [0, 3])
def test_train_batch_norm_matches_flax(group_size):
    rng = np.random.RandomState(group_size)
    x = (rng.randn(6, 5, 7, 4) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.uniform(-1, 1, 4).astype(np.float32)
    mean0 = rng.randn(4).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 4).astype(np.float32)
    gy = rng.randn(6, 5, 7, 4).astype(np.float32)
    if group_size:
        fbn = GhostBatchNorm(group_size=group_size, use_running_average=False,
                             epsilon=1e-3, dtype=jnp.float32)
    else:
        fbn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                            dtype=jnp.float32)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(x, p):
        y, upd = fbn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd["batch_stats"])

    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (want_y, want_stats)), (gx, gp) = jax.value_and_grad(f, (0, 1), has_aux=True)(
        jnp.asarray(x), p)

    bn = BatchNorm(4, 1e-3, momentum=0.99, group_size=group_size).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum().backward()

    def nhwc(t):
        return t.detach().permute(0, 2, 3, 1).numpy()

    # float32 moments summed in another order
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), atol=2e-6, rtol=0)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(gp["scale"]), atol=2e-4, rtol=0)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(want_stats["mean"]), atol=1e-7, rtol=0)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(want_stats["var"]), atol=1e-6, rtol=0)


def _sched_cfg(schedule, warmup):
    return apply_overrides(Config(), {"train.lr_schedule": schedule,
                                      "train.warmup_steps": str(warmup),
                                      "train.num_steps": "150000"})


@pytest.mark.parametrize("schedule", ["exp_decay", "cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 1000])
def test_lr_schedule_matches_optax(schedule, warmup):
    cfg = _sched_cfg(schedule, warmup)
    want, got = jloop.make_lr_schedule(cfg), loop.make_lr_schedule(cfg)
    counts = sorted({0, max(warmup - 1, 0), warmup, warmup + 1, warmup + 7, warmup + 12345,
                     100_000})
    for c in counts:
        # optax evaluates in float32, the port in float64
        assert got(c) == pytest.approx(float(want(c)), rel=1e-6, abs=1e-12), c
    if warmup:
        assert got(0) == 0.0  # the first update is zero
    assert got(warmup) == pytest.approx(cfg.train.base_lr)


@pytest.mark.parametrize("clip", [0.0, 1.0, 100.0])
def test_clip_and_adam_match_optax(clip):
    """Three updates of `make_optimizer` + the port's clip against
    optax.chain(clip_by_global_norm, adam) with the same schedule; clip 1.0
    is active (gradient norm ~5), 100 is not, 0 is off."""
    cfg = apply_overrides(Config(), {"train.grad_clip_norm": str(clip),
                                     "train.warmup_steps": "2"})
    rng = np.random.RandomState(7)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 2 for s in shapes] for _ in range(3)]

    tx = jloop.make_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(p)) for p in params])
    opt = loop.make_optimizer(cfg, module)
    sched = loop.make_lr_schedule(cfg)
    for count, g in enumerate(grads):
        for p, x in zip(module, g):
            p.grad = torch.from_numpy(x.copy())
        gl = [p.grad for p in module]
        norm = torch.nn.utils.get_total_norm(gl)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        if clip > 0:
            loop.clip_by_global_norm_(gl, clip, norm)
        for group in opt.param_groups:
            group["lr"] = sched(count)
        opt.step()
    for p, want in zip(module, jp):
        # the updates are ~lr = 1e-4 per step; float32 roundoff of Adam's
        # bias correction and division taken in another order
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), atol=1e-9, rtol=1e-6)
    moved = max(float((p.detach() - torch.from_numpy(q)).abs().max())
                for p, q in zip(module, params))
    assert moved > 5e-5  # two updates of ~1e-4 after the zero one
