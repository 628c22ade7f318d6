"""The port's MetroModel against the flax MetroModel on converted weights.

Weights come from flax init with a fixed key and go through
`metro_pose3d_tpu_torch.convert`; crops are made from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from metro_pose3d_tpu_torch.init import init_metro_model
from metro_pose3d_tpu_torch.models.metro import MetroModel


def _cfg(**over):
    base = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
            "model.compute_dtype": "float32"}
    base.update({f"model.{k}": str(v) for k, v in over.items()})
    return apply_overrides(Config(), base)


def _flax(cfg, seed=0):
    side = cfg.model.proc_side
    model = FlaxMetro(cfg.model)
    init = jax.jit(lambda key, x: model.init(key, x, train=False))
    return model, init(jax.random.PRNGKey(seed), jnp.zeros((1, side, side, 3)))


def _logits_both(cfg, batch=2, seed=0):
    fmodel, variables = _flax(cfg, seed)
    side = cfg.model.proc_side
    x = np.random.RandomState(seed).uniform(-1, 1, (batch, side, side, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: fmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    port = load_flax_variables(MetroModel(cfg.model), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


# (overrides, atol): float32 runs agree to float32 roundoff of logits of
# magnitude ~1-2 through ~10 (tiny) or ~50 (resnet50) layers; in bfloat16 the
# two frameworks round at different places (conv bias add, batch-norm
# output), so the bound is a few bf16 ulps (2^-7 at magnitude 1-2).
MODEL_CASES = {
    "tiny_f32": ({}, 1e-5),
    "tiny_f32_stride_first": ({"stride_position": "first"}, 1e-5),
    "tiny_f32_odd_side": ({"proc_side": 72}, 1e-5),
    "tiny_bf16": ({"compute_dtype": "bfloat16"}, 5e-2),
    "resnet50_f32": ({"backbone": "resnet50"}, 2e-5),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_logits_match_flax(case):
    over, atol = MODEL_CASES[case]
    batch = 1 if over.get("backbone") == "resnet50" else 2
    (g3, g2), (w3, w2) = _logits_both(_cfg(**over), batch=batch)
    assert g3.shape == w3.shape and g2.shape == w2.shape
    assert g3.dtype == np.float32 and g2.dtype == np.float32
    np.testing.assert_allclose(g3, w3, atol=atol, rtol=0)
    np.testing.assert_allclose(g2, w2, atol=atol, rtol=0)


def test_converted_tree_matches_port_and_init():
    cfg = _cfg()
    _, variables = _flax(cfg)
    converted = state_dict_from_flax(variables)
    port = MetroModel(cfg.model).state_dict()
    assert set(converted) == set(port)
    for name, t in converted.items():
        assert tuple(t.shape) == tuple(port[name].shape), name
    assert "backbone.stage1_block1.proj.weight" in port  # tiny: projects and strides
    assert "backbone.stage1_block1.bn_pre.mean" in port

    init = init_metro_model(cfg.model, seed=3, device="cpu").state_dict()
    assert set(init) == set(port)
    w = init["backbone.stage2_block1.conv2.weight"]  # fan_in = 16 * 3 * 3
    assert abs(float(w.std()) - (1 / 144) ** 0.5) < 0.02
    assert float(w.abs().max()) <= 2 * (1 / 144) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(init["head3d.bias"], torch.zeros_like(init["head3d.bias"]))
    assert torch.equal(init["backbone.bn_final.var"], torch.ones_like(init["backbone.bn_final.var"]))
    again = init_metro_model(cfg.model, seed=3, device="cpu").state_dict()
    assert all(torch.equal(init[k], again[k]) for k in init)


@pytest.mark.parametrize("field,value", [
    ("conv_padding", "torch"), ("conv_padding", "keras"), ("preactivation", False),
    ("backbone", "resnet18"), ("v2_biases", True), ("quantize", "int8"),
    ("model_class", "twofive"),
])
def test_unported_options_raise(field, value):
    """No option is refused any more; every one builds, with the leaves the
    flax tree has for it (parity: tests/test_torch_families.py and, for the
    int8 path and its `amax` scales, tests/test_torch_quantize.py)."""
    cfg = _cfg(**{field: value}).model
    names = set(MetroModel(cfg).state_dict())
    expected = {
        "conv_padding": "backbone.bn_final.scale", "preactivation": "backbone.bn_stem.scale",
        "backbone": "backbone.stage4_block2.conv2.weight",
        "v2_biases": "backbone.conv_stem.bias", "model_class": "head3d.weight",
        "quantize": "backbone.stage1_block1.conv2.amax",
    }[field]
    assert expected in names
    assert ("backbone.bn_final.scale" in names) == (field != "preactivation")
