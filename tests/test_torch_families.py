"""The port's other model families against the JAX package on the CPU.

The stem pool's `torch` and `keras` alignments (forward and gradient), the
ResNet variants (v2 and v1.5, bottleneck and basic block, the three padding
conventions, both stride positions, v2 biases), the 2.5D head (`twofive`:
predict dicts and losses) and one train step of a v1.5 / torch-padding model.
Inputs and weights are made from a seed with numpy and go through the JAX
function and its counterpart in the port.
"""
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.evaluation.engine import make_predict_fn as jax_make_predict_fn
from metro_pose3d_tpu.geom.joints import H36M_17
from metro_pose3d_tpu.models.losses import compute_losses as jax_compute_losses
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu.ops import pool_pallas
from metro_pose3d_tpu.pipeline.device import device_augment as jax_device_augment
from metro_pose3d_tpu.train import loop as jloop
from metro_pose3d_tpu.train.state import create_train_state as jax_create_train_state
from metro_pose3d_tpu_torch.convert import (
    load_flax_variables, state_dict_from_flax, train_state_from_flax,
)
from metro_pose3d_tpu_torch.evaluation.engine import make_predict_fn
from metro_pose3d_tpu_torch.models import resnet as port_resnet
from metro_pose3d_tpu_torch.models.losses import compute_losses
from metro_pose3d_tpu_torch.models.metro import MetroModel, twofive_backproject
from metro_pose3d_tpu_torch.ops import pool
from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
from metro_pose3d_tpu_torch.train.loop import make_train_step
from metro_pose3d_tpu_torch.train.state import create_train_state

from test_torch_train import N_OCC, TINY, _flat, bank, host_batches  # noqa: F401 (fixtures)

MIRROR = H36M_17.mirror_mapping
# The suite runs in several worker processes on few cores, and every worker
# imports this module when it collects: keep torch's own thread pool small so
# the workers (and XLA's CPU collectives in the JAX tests) are not starved.
torch.set_num_threads(2)


# ------------------------------------------------------------------ the pool
def _pool_input(shape, kind, seed=0):
    """NHWC float32: "random"; "ties" (quarters: neighbours often equal);
    "relu" (a smooth field through a ReLU, as after bn_stem + ReLU: about
    half exact zeros, in patches, so whole windows tie at 0); "negative"
    (every border window all-negative, so the keras pad's 0 wins there)."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4) / 4
    elif kind == "relu":
        b, h, w, c = shape
        coarse = rng.normal(size=(b, -(-h // 4), -(-w // 4), c)).astype(np.float32)
        smooth = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
        x = np.maximum(smooth + 0.3 * x, 0)
    elif kind == "negative":
        x = -np.abs(x) - 0.5
    return x


def _to_port(x_nhwc, dtype=torch.float32):
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _from_port(y_nchw):
    return y_nchw.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind", ["random", "negative"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (2, 15, 13, 5)], ids=["even", "odd"])
@pytest.mark.parametrize("mode", ["torch", "keras"])
def test_pool_modes_forward_bit_exact(mode, shape, dtype, kind):
    x = _pool_input(shape, kind)
    xj = jnp.asarray(x).astype(dtype)
    window = np.asarray(pool_pallas.stem_max_pool(xj, mode=mode, train=False).astype(jnp.float32))
    chain = np.asarray(pool_pallas.stem_max_pool(xj, mode=mode, train=True).astype(jnp.float32))
    got = pool.stem_max_pool(_to_port(x, getattr(torch, dtype)), mode)
    assert got.dtype == getattr(torch, dtype)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_from_port(got), window)  # max is exact
    np.testing.assert_array_equal(_from_port(got), chain)
    if kind == "negative":
        # only the keras pad's 0 can win a window of negative values, and only at the border
        zeros = _from_port(got) == 0
        assert zeros.any() == (mode == "keras")
        assert not zeros[:, 1:-1, 1:-1].any()
        assert mode != "keras" or zeros[:, 0].all() and zeros[:, :, 0].all()


@pytest.mark.parametrize("kind", ["random", "ties", "relu"])
@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (2, 15, 13, 5)], ids=["even", "odd"])
@pytest.mark.parametrize("mode", ["same", "torch", "keras"])
def test_pool_modes_gradient_matches_jax_chain(mode, shape, kind):
    x = _pool_input(shape, kind, seed=1)
    y, vjp = jax.vjp(lambda t: pool_pallas.stem_max_pool(t, mode=mode, train=True),
                     jnp.asarray(x))
    g = np.random.RandomState(2).normal(size=y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    xt = _to_port(x).requires_grad_(True)
    pool.stem_max_pool(xt, mode).backward(_to_port(g))
    # the same chain of maxima, ties split 0.5/0.5 at every link: sums of at
    # most four products of g with a power of two
    np.testing.assert_allclose(_from_port(xt.grad), np.asarray(want), atol=1e-7, rtol=0)
    np.testing.assert_allclose(_from_port(pool.max_pool_bwd_plain(_to_port(x), _to_port(g), mode)),
                               np.asarray(want), atol=1e-7, rtol=0)
    if kind == "relu":
        # whole windows tie at 0 here; every link keeps the gradient's mass,
        # except that in keras mode a pad cell tied at the max takes its share away
        windows = np.asarray(y)
        assert (windows == 0).mean() > 0.1
        ones = torch.ones(_to_port(g).shape)
        mass = float(pool.max_pool_bwd_plain(_to_port(x), ones, mode).sum())
        if mode == "keras":
            assert mass < windows.size - 1
        else:
            assert mass == pytest.approx(windows.size, rel=1e-6)


def test_pool_mode_is_checked():
    with pytest.raises(ValueError, match="mode"):
        pool.stem_max_pool(torch.zeros(1, 2, 4, 4), "valid")


# ------------------------------------------------------------ the backbones
def _cfg(**over):
    base = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
            "model.compute_dtype": "float32"}
    base.update({f"model.{k}": str(v) for k, v in over.items()})
    return apply_overrides(Config(), base)


def _random_variables(cfg, seed=0):
    """Flax variables of the model's tree filled from a seed with numpy:
    lecun-normal kernels, and non-trivial biases and BN leaves (flax's own
    init would leave every bias 0 and every BN the identity). The heads'
    kernels are scaled so that the logits keep a magnitude of 1-2."""
    side = cfg.model.proc_side
    tree = jax.eval_shape(lambda: FlaxMetro(cfg.model).init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = fan_in ** -0.5 * (0.4 if path[-2].key.startswith("head") else 1.0)
            return rng.normal(0, std, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, tree)


def _logits_both(cfg, batch=2, seed=0):
    variables = _random_variables(cfg, seed)
    side = cfg.model.proc_side
    x = np.random.RandomState(seed + 1).uniform(-1, 1, (batch, side, side, 3)).astype(np.float32)
    fmodel = FlaxMetro(cfg.model)
    want = jax.jit(lambda v, x: fmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    port = load_flax_variables(MetroModel(cfg.model), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    return [g.numpy() for g in got], [np.asarray(w) for w in want], port


FAMILY_CASES = [
    pytest.param(backbone, preact, padding, position, biases,
                 id=f"{backbone}-{'v2' if preact else 'v15'}-{padding}-{position}"
                    f"{'-biases' if biases else ''}")
    for backbone in ("tiny", "resnet18")
    for preact in (True, False)
    for padding in ("same", "torch", "keras")
    for position in ("first", "last")
    for biases in (False, True)
]


@pytest.mark.parametrize("backbone,preact,padding,position,biases", FAMILY_CASES)
def test_family_logits_match_flax(backbone, preact, padding, position, biases):
    cfg = _cfg(backbone=backbone, preactivation=preact, conv_padding=padding,
               stride_position=position, v2_biases=biases)
    (g3, g2), (w3, w2), port = _logits_both(cfg)
    names = set(port.state_dict())
    assert ("backbone.bn_stem.scale" in names) == (not preact)
    assert ("backbone.bn_final.scale" in names) == preact
    assert ("backbone.conv_stem.bias" in names) == biases
    assert port.backbone.pool_mode == padding
    assert g3.shape == w3.shape and g2.shape == w2.shape
    # float32 roundoff of logits of magnitude ~1-2 through ~10-20 layers
    # (tests/test_torch_model.py)
    np.testing.assert_allclose(g3, w3, atol=2e-5, rtol=0)
    np.testing.assert_allclose(g2, w2, atol=2e-5, rtol=0)


@pytest.mark.parametrize("backbone,preact,padding,position,biases", [
    ("tiny", False, "torch", "first", False), ("tiny", True, "keras", "last", True),
    ("resnet18", False, "torch", "first", False)],
    ids=["tiny-torchvision", "tiny-keras-v2", "resnet18-torchvision"])
def test_family_logits_match_flax_bf16(backbone, preact, padding, position, biases):
    cfg = _cfg(backbone=backbone, preactivation=preact, conv_padding=padding,
               stride_position=position, v2_biases=biases, compute_dtype="bfloat16")
    (g3, g2), (w3, w2), _ = _logits_both(cfg)
    # the two frameworks round to bf16 at different places: a few bf16 ulps
    # (2^-7 at magnitude 1-2), as tests/test_torch_model.py
    np.testing.assert_allclose(g3, w3, atol=5e-2, rtol=0)
    np.testing.assert_allclose(g2, w2, atol=5e-2, rtol=0)


def test_block_shapes_and_refusals():
    model = MetroModel(_cfg(backbone="resnet34", preactivation=False).model)
    assert model.backbone.out_channels == 512  # `features`, not 4 * features
    assert len(model.backbone.blocks) == 16
    assert MetroModel(_cfg().model).backbone.out_channels == 8 * 8 * 4
    with pytest.raises(ValueError, match="quantize_extras"):
        MetroModel(_cfg(quantize="int8", quantize_extras="stem,head").model)
    with pytest.raises(ValueError, match="conv_padding"):
        MetroModel(_cfg(conv_padding="valid").model)
    with pytest.raises(ValueError, match="model_class"):
        MetroModel(_cfg(model_class="other").model)


# ------------------------------------------------------------- the 2.5D head
@pytest.fixture(scope="module")
def twofive():
    cfg = _cfg(model_class="twofive")
    variables = _random_variables(cfg, seed=5)
    return cfg, variables, load_flax_variables(MetroModel(cfg.model), variables).eval()


@pytest.mark.parametrize("from_tiles", [False, True], ids=["crops", "tiles"])
@pytest.mark.parametrize("flip_tta", [False, True], ids=["plain", "tta"])
def test_twofive_predict_matches_jax(twofive, flip_tta, from_tiles):
    cfg, variables, model = twofive
    rng = np.random.RandomState(11)
    b = 3
    intr = np.tile(np.array([[900.0, 0, 31.5], [0, 905.0, 31.5], [0, 0, 1]], np.float32),
                   (b, 1, 1))
    kw = dict(root_index=0, flip_tta=flip_tta, from_tiles=from_tiles)
    if from_tiles:
        hom = np.tile(np.array([[1 / 128, 0, -0.25], [0, 1 / 128, -0.25], [0, 0, 1]], np.float32),
                      (b, 1, 1))
        batch = {"source": rng.randint(0, 256, (b, 128, 128, 3)).astype(np.uint8),
                 "warp_h": hom, "warp_k": np.tile(np.float32([128, 128, 63.5, 63.5]), (b, 1)),
                 "warp_dist": np.zeros((b, 5), np.float32), "intrinsics": intr}
        want = jax_make_predict_fn(cfg, MIRROR, **kw)(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
        got = make_predict_fn(cfg, MIRROR, **kw)(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
    else:
        crops = rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)
        want = jax_make_predict_fn(cfg, MIRROR, **kw)(variables, jnp.asarray(crops),
                                                       jnp.asarray(intr))
        got = make_predict_fn(cfg, MIRROR, **kw)(model, torch.from_numpy(crops),
                                                 torch.from_numpy(intr))
    assert set(got) == set(want) == {"pose25d", "pose2d_px"}  # nothing is reconstructed
    p25, w25 = got["pose25d"].numpy(), np.asarray(want["pose25d"])
    # float32 end to end (tests/test_torch_engine.py): pixels to 1e-4, the metric z to 5e-3 mm
    np.testing.assert_allclose(p25[..., :2], w25[..., :2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p25[..., 2], w25[..., 2], atol=5e-3, rtol=0)
    np.testing.assert_allclose(got["pose2d_px"].numpy(), np.asarray(want["pose2d_px"]),
                               atol=1e-4, rtol=0)


def test_twofive_backproject_matches_jax():
    from metro_pose3d_tpu.models.metro import twofive_backproject as jax_backproject

    rng = np.random.RandomState(4)
    pose = rng.uniform(0, 64, (3, 17, 3)).astype(np.float32)
    intr = np.tile(np.array([[900.0, 0, 31.5], [0, 905.0, 31.5], [0, 0, 1]], np.float32),
                   (3, 1, 1))
    depth = rng.uniform(3000, 5000, 3).astype(np.float32)
    want = np.asarray(jax_backproject(jnp.asarray(pose), jnp.asarray(intr), jnp.asarray(depth)))
    got = twofive_backproject(torch.from_numpy(pose), torch.from_numpy(intr),
                              torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)  # mm, float32 roundoff


@pytest.mark.parametrize("mixed", [False, True], ids=["all3d", "mixed2d3d"])
def test_twofive_losses_match_jax(twofive, mixed):
    cfg, _, _ = twofive
    rng = np.random.RandomState(6)
    b, j, d, s = 4, 17, cfg.model.depth, cfg.model.heatmap_side
    l3d = rng.normal(size=(b, s, s, d, j)).astype(np.float32)
    l2d = rng.normal(size=(b, s, s, j)).astype(np.float32)
    batch = {
        "coords3d_true": (rng.uniform(-500, 500, (b, j, 3)) + [0, 0, 4000]).astype(np.float32),
        "coords2d_true": rng.uniform(0, 64, (b, j, 2)).astype(np.float32),
        "joint_validity": (rng.uniform(size=(b, j)) > 0.2).astype(np.float32),
        "joint_validity_2d": (rng.uniform(size=(b, j)) > 0.2).astype(np.float32),
        "is_3d": np.ones(b, np.float32),
        "intrinsics": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
    }
    if mixed:
        batch["is_3d"][2:] = 0.0
    acfg = apply_overrides(cfg, {"train.absloss_weight": "0.1"})  # ignored for twofive
    want_total, want = jax_compute_losses(jnp.asarray(l3d), jnp.asarray(l2d),
                                          {k: jnp.asarray(v) for k, v in batch.items()}, acfg, 0)
    got_total, got = compute_losses(torch.from_numpy(l3d), torch.from_numpy(l2d),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, acfg, 0)
    assert set(got) == set(want) == {"loss3d", "loss2d", "loss"}
    assert float(got_total) == pytest.approx(float(want_total), rel=2e-4)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-4), k


# ------------------------------------------- one train step, v1.5 / torch padding
V15 = {"model.preactivation": "false", "model.conv_padding": "torch",
       "model.stride_position": "first"}


def _relu_margin(model, crops):
    """The least |input| of any ReLU in one train-mode forward of a copy."""
    m = copy.deepcopy(model).train()
    margins = []
    relu = torch.nn.functional.relu

    def spy(x, *a, **k):
        margins.append(float(x.detach().abs().min()))
        return relu(x, *a, **k)

    with mock.patch.object(port_resnet.F, "relu", spy), torch.no_grad():
        m(crops)
    return min(margins)


def test_v15_torch_padding_train_step_matches_jax(host_batches, bank):  # noqa: F811
    cfg = apply_overrides(Config(), {**TINY, **V15})
    tx = jloop.make_optimizer(cfg)
    start = jax.device_get(jax.jit(lambda key: jax_create_train_state(cfg, tx, key))(
        jax.random.PRNGKey(3)))
    port = create_train_state(cfg, "cpu")
    port.load_state_dict(train_state_from_flax(start))
    assert "backbone.bn_stem.scale" in dict(port.model.named_parameters())
    assert "backbone.stage1_block1.bn3.scale" in port.state_dict()["adam"]

    # A ReLU input within the two forwards' roundoff of 0 may take the other
    # side in the other package and move its gradient entry, so the
    # comparison is made on a batch that has none (the rule of
    # tests/test_torch_train.py). This model's residual stream is not
    # renormalised before each unit, so roundoff moves its ReLU inputs
    # further than the pre-activation model's and that file's 2e-6 is not
    # enough: the margin asked for is 3e-5, and two rows at a time are
    # tried: fewer ReLU inputs, hence a wider least margin.
    jbank = jnp.asarray(bank)
    for batch in ({k: v[r:r + 2] for k, v in b.items()} for b in host_batches
                  for r in range(0, 8, 2)):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        crops = jax_device_augment(jb, cfg.model.proc_side, jbank, train=True)
        if _relu_margin(port.model, torch.from_numpy(np.array(crops))) >= 3e-5:
            break
    else:
        pytest.fail("every candidate batch has a ReLU input within 3e-5 of 0")

    fmodel = FlaxMetro(cfg.model.at_phase(train=True))

    def loss_fn(params):
        (l3d, l2d), _ = fmodel.apply({"params": params, "batch_stats": start.batch_stats},
                                     crops, train=True, mutable=["batch_stats"])
        return jax_compute_losses(l3d, l2d, jb, cfg, 0)[0]

    want = state_dict_from_flax({"params": jax.jit(jax.grad(loss_fn))(start.params)})
    m = copy.deepcopy(port.model).train()
    l3d, l2d = m(torch.from_numpy(np.array(crops)))
    compute_losses(l3d, l2d, batch_to_device(batch, "cpu"), cfg, 0)[0].backward()
    for name, p in m.named_parameters():
        # float32 roundoff through ~15 layers, per tensor against its norm; the
        # pool's input is post-ReLU here, so its ties split as the JAX chain splits them
        err = float((p.grad - want[name]).norm())
        assert err <= 1e-4 * float(want[name].norm()) + 1e-7, (name, err)

    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    jstate, jm = jloop.make_train_step(cfg, tx, occluder_bank=jbank)(
        jax.tree_util.tree_map(jnp.array, start), batch)
    pm = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(bank, "cpu"))(
        port, batch_to_device(batch, "cpu"))
    assert set(pm) == set(jm)
    for key in jm:
        rtol = 1e-2 if key == "grad_norm" else 2e-4  # tests/test_torch_train.py
        assert float(pm[key]) == pytest.approx(float(jm[key]), rel=rtol), key
    got = port.model.state_dict()
    want = state_dict_from_flax(jax.device_get({"params": jstate.params,
                                                "batch_stats": jstate.batch_stats}))
    assert set(got) == set(want)
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    params = [k for k in want if k not in stats]
    assert any(k.startswith("backbone.bn_stem.") for k in stats)
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=k)
    lr = cfg.train.base_lr
    diff = np.abs(_flat({k: got[k] for k in params}) - _flat({k: want[k] for k in params}))
    moved = np.abs(_flat({k: got[k] for k in params}) - _flat({k: before[k] for k in params}))
    assert diff.max() <= 2 * lr + 1e-6
    assert (diff <= 0.1 * lr).mean() > 0.99
    assert 0.5 * lr < np.median(moved) <= lr * 1.01
