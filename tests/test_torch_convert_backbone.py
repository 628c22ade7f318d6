"""The port's ImageNet backbone conversion (`utils/convert_backbone.py`) against
torch's own feature maps and against the JAX package's converter.

A seeded ResNet-18 with torchvision's names (the hand-built trunk of
tests/test_convert_backbone.py) goes through both packages' converters; the
backbone `.npz` written by either package loads in the other;
`train.backbone_init` carries the leaves into the train state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.utils import convert_backbone as jax_cb
from metro_pose3d_tpu_torch.convert import state_dict_from_flax
from metro_pose3d_tpu_torch.models.resnet import ResNet
from metro_pose3d_tpu_torch.train.state import create_train_state
from metro_pose3d_tpu_torch.utils import convert_backbone as cb

from test_convert_backbone import _torch_resnet18, _torch_trunk_features

R18 = {"model.backbone": "resnet18", "model.preactivation": "false",
       "model.conv_padding": "torch", "model.stride_position": "first",
       "model.compute_dtype": "float32", "model.proc_side": "64", "model.depth": "4"}


def _cfg(**over):
    return apply_overrides(Config(), {**R18, **over})


@pytest.fixture(scope="module")
def converted():
    tm = _torch_resnet18()
    return tm, cb.torchvision_resnet_to_state_dict(tm.state_dict(), depths=(2, 2, 2, 2))


def _trunk(cfg, state):
    net = ResNet(cfg.model, torch.float32).eval()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return net


def test_features_match_the_torch_trunk(converted):
    tm, state = converted
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    ref = _torch_trunk_features(tm, x)
    with torch.no_grad():
        out = _trunk(_cfg(**{"model.stride": "32"}), state)(x).numpy()
    # float32 through 17 convs in two summation orders
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    with torch.no_grad():
        shifted = _trunk(_cfg(**{"model.stride": "32", "model.conv_padding": "same"}), state)(x)
    assert np.abs(shifted.numpy() - ref).max() > 1e-3  # SAME sits one pixel off


def test_equals_the_jax_converter_leaf_for_leaf(converted):
    tm, state = converted
    params, stats = jax_cb.torchvision_resnet_to_flax(tm.state_dict(), depths=(2, 2, 2, 2))
    want = state_dict_from_flax({"params": params, "batch_stats": stats})
    assert set(want) == set(state)
    for name, leaf in want.items():
        np.testing.assert_array_equal(state[name], leaf.numpy(), err_msg=name)
    # and the names are the trunk's own
    assert set(state) == set(ResNet(_cfg().model).state_dict())


class _Layer:
    def __init__(self, weights):
        self._weights = weights

    def get_weights(self):
        return self._weights


class _KerasLike:
    """Stands in for a Keras ResNet-v2: `get_layer(name).get_weights()` with
    Keras's layer names and layouts (HWIO kernels; gamma, beta, mean, var),
    seeded; a missing layer raises ValueError as Keras does."""

    def __init__(self, depths=(1, 1, 1, 1), base=8, seed=0):
        rng = np.random.RandomState(seed)
        self.layers = {}

        def conv(name, k, cin, cout, bias):
            w = [rng.normal(0, (k * k * cin) ** -0.5, (k, k, cin, cout)).astype(np.float32)]
            self.layers[name] = w + ([rng.normal(0, 0.1, cout).astype(np.float32)] if bias else [])

        def bn(name, c):
            self.layers[name] = [rng.uniform(0.5, 1.5, c).astype(np.float32),
                                 rng.normal(0, 0.1, c).astype(np.float32),
                                 rng.normal(0, 0.1, c).astype(np.float32),
                                 rng.uniform(0.5, 1.5, c).astype(np.float32)]

        conv("conv1_conv", 7, 3, base, True)
        cin = base
        for stage, n in enumerate(depths):
            f = base * 2 ** stage
            for blk in range(1, n + 1):
                pre = f"conv{stage + 2}_block{blk}"
                bn(f"{pre}_preact_bn", cin)
                conv(f"{pre}_1_conv", 1, cin, f, False)
                bn(f"{pre}_1_bn", f)
                conv(f"{pre}_2_conv", 3, f, f, False)
                bn(f"{pre}_2_bn", f)
                conv(f"{pre}_3_conv", 1, f, 4 * f, True)
                if cin != 4 * f:
                    conv(f"{pre}_0_conv", 1, cin, 4 * f, True)
                cin = 4 * f
        bn("post_bn", cin)

    def get_layer(self, name):
        if name not in self.layers:
            raise ValueError(f"No such layer: {name}")
        return _Layer(self.layers[name])


def test_keras_v2_mapping_equals_the_jax_converter():
    model = _KerasLike()
    state = cb.keras_resnet_v2_to_state_dict(model, depths=(1, 1, 1, 1))
    params, stats = jax_cb.keras_resnet_v2_to_flax(model, depths=(1, 1, 1, 1))
    want = state_dict_from_flax({"params": params, "batch_stats": stats})
    assert set(want) == set(state)
    for name, leaf in want.items():
        np.testing.assert_array_equal(state[name], leaf.numpy(), err_msg=name)
    cfg = apply_overrides(Config(), {
        "model.backbone": "tiny", "model.preactivation": "true", "model.conv_padding": "keras",
        "model.stride_position": "last", "model.v2_biases": "true"})
    assert set(state) == set(ResNet(cfg.model).state_dict())  # biases where Keras has them
    assert "stage1_block1.conv3.bias" in state and "conv_stem.bias" in state


def test_npz_is_the_jax_packages_format_both_ways(converted, tmp_path):
    tm, state = converted
    params, stats = jax_cb.torchvision_resnet_to_flax(tm.state_dict(), depths=(2, 2, 2, 2))
    theirs, ours = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_cb.save_backbone_npz(params, stats, theirs)
    cb.save_backbone_npz(state, ours)
    a, b = np.load(theirs), np.load(ours)
    assert set(a.files) == set(b.files)  # slash-joined flax paths, HWIO kernels
    assert a["params:conv_stem/kernel"].shape == (7, 7, 3, 64)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    loaded = cb.load_backbone_npz(theirs)  # the JAX package's file in the port
    assert set(loaded) == set(state)
    for name in state:
        np.testing.assert_array_equal(loaded[name], state[name], err_msg=name)
    p2, s2 = jax_cb.load_backbone_npz(ours)  # the port's file in the JAX package
    back = state_dict_from_flax({"params": p2, "batch_stats": s2})
    for name in state:
        np.testing.assert_array_equal(back[name].numpy(), state[name], err_msg=name)


def test_backbone_init_carries_the_leaves_into_the_train_state(converted, tmp_path):
    _, state = converted
    path = str(tmp_path / "backbone.npz")
    cb.save_backbone_npz(state, path)
    cfg = _cfg(**{"train.backbone_init": path})
    warm = create_train_state(cfg, "cpu")
    cold = create_train_state(_cfg(), "cpu")
    got = warm.model.backbone.state_dict()
    for name, leaf in state.items():
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)
    # the heads keep their seeded init, and Adam starts fresh over every parameter
    assert torch.equal(warm.model.head3d.weight, cold.model.head3d.weight)
    assert not torch.equal(warm.model.backbone.conv_stem.weight,
                           cold.model.backbone.conv_stem.weight)
    assert warm.step == 0 and warm.model.training
    assert len(warm.optimizer.param_groups[0]["params"]) == len(list(warm.model.parameters()))


def test_shape_mismatch_reports_every_bad_leaf(converted):
    _, state = converted
    bad = dict(state)
    bad["conv_stem.weight"] = np.zeros((64, 3, 3, 3), np.float32)
    bad["stage2_block1.bn1.scale"] = np.zeros(7, np.float32)
    bad["stage9_block1.conv1.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    model = create_train_state(_cfg(), "cpu").model
    before = model.backbone.conv_stem.weight.clone()
    with pytest.raises(ValueError) as e:
        cb.apply_backbone_init(model, bad)
    msg = str(e.value)
    assert "shape mismatch at backbone.conv_stem.weight" in msg
    assert "shape mismatch at backbone.stage2_block1.bn1.scale" in msg
    assert "missing in model: backbone.stage9_block1.conv1.weight" in msg
    assert torch.equal(model.backbone.conv_stem.weight, before)  # nothing was copied
    # the JAX package reports the same leaves
    import jax

    from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro

    variables = jax.eval_shape(lambda: FlaxMetro(_cfg().model).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    bp = {"conv_stem": {"kernel": np.zeros((3, 3, 3, 64), np.float32)},
          "stage2_block1": {"bn1": {"scale": np.zeros(7, np.float32)}}}
    with pytest.raises(ValueError, match="conv_stem/kernel") as e2:
        jax_cb.apply_backbone_init(variables["params"], variables["batch_stats"], bp, {})
    assert "stage2_block1/bn1/scale" in str(e2.value)
