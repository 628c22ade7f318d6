"""`export.aot_compile` of the port against the JAX package's, on the CPU.

The JAX package lowers and compiles the crop-in predict for one batch shape
(`jax.jit(fn).lower(...).compile()`); the port's counterpart captures a CUDA
graph on the card (checked by `chip_smoke.py` phase 23) and, on a CPU model
as here, runs the function eagerly behind the same checks. Both run the
same flax weights (tiny backbone, float32; the port's from its exported
bundle of them, converted), and their outputs are held to
`tests/test_torch_engine.py`'s tolerances. Shapes, dtypes and a model
other than the compiled ones raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu import export as jexport
from metro_pose3d_tpu.evaluation.engine import make_predict_fn as jax_make_predict_fn
from metro_pose3d_tpu.geom.joints import H36M_17
from metro_pose3d_tpu_torch import export
from metro_pose3d_tpu_torch.convert import load_flax_variables
from metro_pose3d_tpu_torch.models.metro import MetroModel

from test_torch_engine import _assert_outputs_close, _cfg, _crop_inputs

B, SIDE = 3, 64


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(flax variables, the port's bundle of them converted)."""
    from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro

    cfg = _cfg()
    variables = jax.jit(lambda k, x: FlaxMetro(cfg.model).init(k, x, train=False))(
        jax.random.PRNGKey(11), jnp.zeros((1, SIDE, SIDE, 3)))
    model = load_flax_variables(MetroModel(_port_cfg().model), variables)
    return variables, export.export_model(_port_cfg(), model, str(tmp_path_factory.mktemp("b")))


def _port_cfg():
    from metro_pose3d_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), {"model.backbone": "tiny", "model.proc_side": str(SIDE),
                                      "model.depth": "4", "model.compute_dtype": "float32"})


@pytest.mark.parametrize("flip_tta", [True, False], ids=["tta", "no_tta"])
def test_aot_compiled_predict_matches_jax(bundle, flip_tta):
    variables, pdir = bundle
    root = H36M_17.names.index("pelv")  # as both packages' load_exported take it
    jfn = jax_make_predict_fn(_cfg(), H36M_17.mirror_mapping, root_index=root, flip_tta=flip_tta)
    crops, intr = _crop_inputs(B, SIDE)
    want = jexport.aot_compile(jfn, variables, B, SIDE)(variables, jnp.asarray(crops),
                                                        jnp.asarray(intr))
    _, model, fn = export.load_exported(pdir, flip_tta=flip_tta, device="cpu")
    compiled = export.aot_compile(fn, model, B, SIDE)
    assert compiled.graph is None and compiled.launches == []  # eager on the CPU
    got = compiled(model, torch.from_numpy(crops), torch.from_numpy(intr))
    _assert_outputs_close(got, want)
    # arrays are taken as tensors are, and the eager call is the function's
    again = compiled(model, crops, intr)
    eager = fn(model, torch.from_numpy(crops), torch.from_numpy(intr))
    for key in eager:
        assert torch.equal(again[key], eager[key]) and torch.equal(got[key], eager[key]), key


REFUSALS = {  # name: (crops shape, crops dtype, intrinsics shape, intrinsics dtype, error)
    "batch": ((B + 1, SIDE, SIDE, 3), np.uint8, (B + 1, 3, 3), np.float32, TypeError),
    "side": ((B, SIDE + 8, SIDE + 8, 3), np.uint8, (B, 3, 3), np.float32, TypeError),
    "crops_dtype": ((B, SIDE, SIDE, 3), np.float32, (B, 3, 3), np.float32, TypeError),
    "intrinsics_dtype": ((B, SIDE, SIDE, 3), np.uint8, (B, 3, 3), np.float64, TypeError),
    "intrinsics_shape": ((B, SIDE, SIDE, 3), np.uint8, (B, 9), np.float32, TypeError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_aot_compiled_predict_refuses_other_shapes(bundle, case):
    """As the JAX package's compiled executable refuses them."""
    _, model, fn = export.load_exported(bundle[1], device="cpu")
    compiled = export.aot_compile(fn, model, B, SIDE)
    cshape, cdtype, ishape, idtype, err = REFUSALS[case]
    with pytest.raises(err, match="compiled for"):
        compiled(model, np.zeros(cshape, cdtype), np.zeros(ishape, idtype))


def test_aot_compiled_predict_refuses_another_model(bundle):
    _, model, fn = export.load_exported(bundle[1], device="cpu")
    _, twin, _ = export.load_exported(bundle[1], device="cpu")
    compiled = export.aot_compile(fn, model, B, SIDE)
    crops, intr = _crop_inputs(B, SIDE)
    with pytest.raises(ValueError, match="another model object"):
        compiled(twin, crops, intr)
