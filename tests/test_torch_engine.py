"""The port's serving path end to end against the JAX engine and the golden.

`make_predict_fn` crop-in and tile-in, with flip TTA on and off, full and
weak reconstruction, with and without bone rescale, on converted flax
weights (tiny backbone, float32). Also: the stored golden of
tests/test_golden.py, the import rule (no jax in the port) and `entry()`.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.evaluation.engine import make_predict_fn as jax_make_predict_fn
from metro_pose3d_tpu.geom.joints import H36M_17
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu_torch.convert import load_flax_variables
from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, PoseEstimator, make_predict_fn
from metro_pose3d_tpu_torch.models.metro import MetroModel

from test_golden import GOLDEN_PATH
from test_golden import _build as golden_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIRROR = H36M_17.mirror_mapping
EDGES = np.asarray(H36M_17.edges)


def _cfg(**eval_over):
    over = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
            "model.compute_dtype": "float32"}
    over.update({f"eval.{k}": str(v) for k, v in eval_over.items()})
    return apply_overrides(Config(), over)


@pytest.fixture(scope="module")
def weights():
    cfg = _cfg()
    fmodel = FlaxMetro(cfg.model)
    variables = jax.jit(lambda k, x: fmodel.init(k, x, train=False))(
        jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3)))
    return variables, load_flax_variables(MetroModel(cfg.model), variables).eval()


def _crop_inputs(b=3, side=64):
    rng = np.random.RandomState(21)
    crops = rng.randint(0, 256, (b, side, side, 3)).astype(np.uint8)
    intr = np.tile(np.array([[900.0, 0, 31.5], [0, 905.0, 31.5], [0, 0, 1]], np.float32),
                   (b, 1, 1))
    intr[:, 0, 0] += rng.uniform(-50, 50, b).astype(np.float32)
    return crops, intr


def _assert_outputs_close(got, want):
    assert set(got) == set(want)
    for key in want:
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) else got[key]
        # float32 end to end. Logits agree to ~1e-6 (test_torch_model), which
        # the 2200 mm box turns into ~1e-3 mm and the 64 px crop into ~1e-5
        # px. The translation solve divides by the spread of the normalized
        # 2D rays (~20 px / 900 px focal here), so the absolute pose moves by
        # ~50x the root-relative difference: a few 1e-2 mm.
        atol = {"pose3d_rootrel": 5e-3, "pose2d_px": 1e-4, "pose3d_abs": 1e-1}[key]
        np.testing.assert_allclose(g, np.asarray(want[key]), atol=atol, rtol=0, err_msg=key)


CROP_CASES = {  # name: (flip_tta, eval overrides, bones)
    "tta_full": (True, {}, False),
    "tta_weak": (True, {"reconstruction": "weak"}, False),
    "plain_full": (False, {}, False),
    "plain_weak": (False, {"reconstruction": "weak"}, False),
    "tta_full_bones": (True, {"scale_recovery": "bone_lengths"}, True),
    "plain_no_reconstruction": (False, {"reconstruct_absolute": False}, False),
}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_in_matches_jax(weights, case):
    variables, model = weights
    flip_tta, over, bones = CROP_CASES[case]
    cfg = _cfg(**over)
    kw = dict(root_index=0, flip_tta=flip_tta)
    if bones:
        kw.update(bone_edges=EDGES, mean_bones=np.random.RandomState(3).uniform(
            80, 450, len(EDGES)).astype(np.float32))
    crops, intr = _crop_inputs()
    want = jax_make_predict_fn(cfg, MIRROR, **kw)(variables, jnp.asarray(crops),
                                                   jnp.asarray(intr))
    got = make_predict_fn(cfg, MIRROR, **kw)(model, torch.from_numpy(crops),
                                             torch.from_numpy(intr))
    _assert_outputs_close(got, want)


@pytest.fixture(scope="module")
def golden_inputs():
    cfg, variables, batch = golden_build()
    model = load_flax_variables(MetroModel(cfg.model), variables).eval()
    return cfg, variables, model, {k: np.array(v) for k, v in batch.items()}


@pytest.mark.parametrize("flip_tta", [False, True])
def test_tile_in_matches_jax(golden_inputs, flip_tta):
    cfg, variables, model, batch = golden_inputs
    kw = dict(root_index=0, flip_tta=flip_tta, reconstruct=True, from_tiles=True)
    want = jax_make_predict_fn(cfg, MIRROR, **kw)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(cfg, MIRROR, **kw)(
        model, {k: torch.from_numpy(batch[k]) for k in TILE_KEYS})
    _assert_outputs_close(got, want)


def test_tile_in_matches_golden(golden_inputs):
    cfg, _, model, batch = golden_inputs
    golden = dict(np.load(GOLDEN_PATH))
    tiles = {k: torch.from_numpy(batch[k]) for k in TILE_KEYS}
    got = {}
    for prefix, flip_tta in (("plain", False), ("tta", True)):
        fn = make_predict_fn(cfg, MIRROR, root_index=0, flip_tta=flip_tta,
                             reconstruct=True, from_tiles=True)
        got.update({f"{prefix}_{k}": v.numpy() for k, v in fn(model, tiles).items()})
    assert set(got) == set(golden)
    for key in sorted(golden):
        # the golden's own tolerance (tests/test_golden.py)
        np.testing.assert_allclose(got[key], golden[key], atol=5e-4, rtol=5e-4, err_msg=key)


def test_pose_estimator_matches_predict_fn(golden_inputs):
    cfg, _, model, batch = golden_inputs
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True)
    crops, intr = _crop_inputs(b=2)
    fn = make_predict_fn(cfg, MIRROR, root_index=0, flip_tta=True)
    want = fn(model, torch.from_numpy(crops), torch.from_numpy(intr))
    got = est.predict_crops(crops, intr)  # numpy in, tensors out
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    tiles = est.predict_tiles(batch)
    assert tiles["pose3d_abs"].shape == (4, 17, 3)
    assert all(torch.isfinite(v).all() for v in tiles.values())


def test_port_imports_no_jax():
    """Every module of the port (the demo, export and profiling among them),
    and chip_smoke, import without jax, flax, cv2 or matplotlib and without
    any module of the JAX package."""
    code = (
        "import pkgutil, importlib, sys, metro_pose3d_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import metro_pose3d_tpu_torch.entry\n"
        "import metro_pose3d_tpu_torch.train.trainer, metro_pose3d_tpu_torch.train.loop\n"
        "import metro_pose3d_tpu_torch.train.state, metro_pose3d_tpu_torch.train.checkpoint\n"
        "import metro_pose3d_tpu_torch.models.losses, metro_pose3d_tpu_torch.ops.occlusion\n"
        "import metro_pose3d_tpu_torch.pipeline.occluders\n"
        "import metro_pose3d_tpu_torch.config, metro_pose3d_tpu_torch.geom.camera\n"
        "import metro_pose3d_tpu_torch.geom.joints, metro_pose3d_tpu_torch.reference_constants\n"
        "import metro_pose3d_tpu_torch.utils.convert_backbone\n"
        "import metro_pose3d_tpu_torch.probes.gather, metro_pose3d_tpu_torch.probes.prims\n"
        "import metro_pose3d_tpu_torch.demo, metro_pose3d_tpu_torch.export\n"
        "import metro_pose3d_tpu_torch.utils.profiling\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in ('jax', 'flax', 'cv2', 'matplotlib') if m in sys.modules)\n"
        "bad += sorted(k for k in sys.modules if k == 'metro_pose3d_tpu'\n"
        "              or k.startswith('metro_pose3d_tpu.'))\n"
        "n = sum(k.startswith('metro_pose3d_tpu_torch') for k in sys.modules)\n"
        "print(bad, n)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 64  # every module was imported, the readers too


def test_entry_runs_flagship_on_cpu():
    from metro_pose3d_tpu_torch.entry import entry

    fn, args = entry(device="cpu", batch_size=2)
    model, crops, intr = args
    assert model.dtype == torch.bfloat16 and model.cfg.proc_side == 256
    out = fn(*args)
    assert out["pose3d_abs"].shape == (2, 17, 3) and out["pose2d_px"].shape == (2, 17, 2)
    assert all(torch.isfinite(v).all() for v in out.values())
