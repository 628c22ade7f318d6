"""The port's `--test` protocol path against the JAX package's, on the
synthetic shards that `metro_pose3d_tpu/data/synth_shard.py` writes.

Readers (`metro_pose3d_tpu_torch/data/{h36m,mpi_inf_3dhp,mpii,tdpw}.py`)
give the JAX readers' examples: pixels, boxes, cameras, coordinates,
validity and masks equal. `predict_dataset` on the tiny model of
`tests/test_h36m_shard.py` (flax weights from PRNGKey(42), converted) gives
the JAX dump row for row: the ground truth, labels and layout equal, the
predictions to the tolerances of `tests/test_torch_engine.py` (float32 end
to end; see `ATOL` for the absolute pose). The port's scorers give the
protocol goldens of `tests/golden/` at the JAX tests' tolerances, and equal
the JAX scorers on the same dumps. `calibrate_on_dataset` and int8
prediction give `int8_shard_golden.json`.
"""
import dataclasses
import json
import os
import shutil
import struct
import subprocess
import sys
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.config import Config as JaxConfig
from metro_pose3d_tpu.config import apply_overrides as jax_apply_overrides
from metro_pose3d_tpu.data import h36m as jax_h36m
from metro_pose3d_tpu.data import synth_shard
from metro_pose3d_tpu.data.datasets import get_dataset as jax_get_dataset
from metro_pose3d_tpu.evaluation import eval_3dhp as jax_eval_3dhp
from metro_pose3d_tpu.evaluation import eval_3dpw as jax_eval_3dpw
from metro_pose3d_tpu.evaluation import eval_h36m as jax_eval_h36m
from metro_pose3d_tpu.evaluation.predict import predict_dataset as jax_predict_dataset
from metro_pose3d_tpu.geom.procrustes import procrustes_align as jax_procrustes_align
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu.ops.decode import image_to_unit as jax_image_to_unit
from metro_pose3d_tpu.ops.pose3d import mean_bone_lengths as jax_mean_bone_lengths
from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from metro_pose3d_tpu_torch.data import h36m
from metro_pose3d_tpu_torch.data.datasets import get_dataset
from metro_pose3d_tpu_torch.evaluation import eval_3dhp, eval_3dpw, eval_h36m, predict
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.geom.procrustes import procrustes_align
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.models.quantize import calibrate_on_dataset
from metro_pose3d_tpu_torch.ops.decode import image_to_unit
from metro_pose3d_tpu_torch.ops.pose3d import mean_bone_lengths

from test_h36m_shard import OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
# float32 end to end, as tests/test_torch_engine.py: logits agree to ~1e-6,
# 2D to 1e-4 px. Root-relative poses get 5e-3 mm: the bone-length rescale
# multiplies the random model's small skeletons up. The translation solve
# then divides by the spread of the 2D rays and amplifies that difference
# ~55x on this shard's random model, whose depths reach 3 m: the absolute
# pose differs by 0.171 mm at most here, and is held to 0.25 mm.
ATOL = {"pose3d_rootrel": 5e-3, "pose2d_px": 1e-4, "pose3d_abs": 0.25}


def _load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cfgs():
    return jax_apply_overrides(JaxConfig(), OVERRIDES), apply_overrides(Config(), OVERRIDES)


@pytest.fixture(scope="module")
def weights(cfgs):
    jcfg, cfg = cfgs
    variables = FlaxMetro(jcfg.model).init(
        jax.random.PRNGKey(42), jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    return variables, load_flax_variables(MetroModel(cfg.model), variables)


@pytest.fixture(scope="module")
def h36m_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("h36m"))
    synth_shard.write_synthetic_h36m_shard(root)
    return root


@pytest.fixture(scope="module")
def h36m_dumps(cfgs, weights, h36m_root, tmp_path_factory):
    """(JAX dump, port dump, port dump path) of the H36M shard."""
    jcfg, cfg = cfgs
    variables, model = weights
    want = jax_predict_dataset(jcfg, variables, jax_get_dataset("h36m", h36m_root))
    got = predict.predict_dataset(cfg, model, get_dataset("h36m", h36m_root))
    path = predict.save_predictions(got, str(tmp_path_factory.mktemp("pred") / "fp.npz"))
    return want, got, path


# --- (a) H36M: the dump, row for row, and the scores ---------------------------

DUMP_KEYS = ("pose3d_rootrel", "pose3d_abs", "pose2d_px", "gt3d_rootrel", "gt3d_abs",
             "valid", "actions", "joint_names", "example_offset")


@pytest.mark.parametrize("key", DUMP_KEYS)
def test_h36m_dump_matches_jax(h36m_dumps, key):
    want, got, _ = h36m_dumps
    assert set(got) == set(want) == set(DUMP_KEYS)
    g, w = np.asarray(got[key]), np.asarray(want[key])
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    if key in ATOL:
        np.testing.assert_allclose(g, w, atol=ATOL[key], rtol=0, err_msg=key)
    else:
        np.testing.assert_array_equal(g, w)


def test_h36m_scores_match_golden(h36m_dumps):
    scores = eval_h36m.evaluate(h36m_dumps[2])
    golden = _load("h36m_shard_golden.json")
    for key in ("mpjpe", "pa_mpjpe", "abs_mpjpe"):
        np.testing.assert_allclose(scores[key], golden[key], rtol=1e-4, err_msg=key)
    assert set(scores["per_action_mpjpe"]) == set(golden["per_action_mpjpe"])
    for action, val in golden["per_action_mpjpe"].items():
        np.testing.assert_allclose(scores["per_action_mpjpe"][action], val, rtol=1e-4,
                                   err_msg=action)


def test_h36m_host_blocks_concatenate_to_the_dump(cfgs, weights, h36m_root, h36m_dumps,
                                                  monkeypatch):
    """Process 1 of 3 dumps rows 7-13 of the 20, with its offset, and rows
    2-3 of the first 4."""
    _, cfg = cfgs
    monkeypatch.setattr(predict, "process_index_count", lambda: (1, 3))
    part = predict.predict_dataset(cfg, weights[1], get_dataset("h36m", h36m_root))
    full = h36m_dumps[1]
    assert int(part["example_offset"]) == 7 and len(part["actions"]) == 7
    for key in ("gt3d_abs", "valid", "actions"):
        np.testing.assert_array_equal(part[key], full[key][7:14])
    np.testing.assert_allclose(part["pose3d_rootrel"], full["pose3d_rootrel"][7:14],
                               atol=1e-5, rtol=0)
    # n_examples cuts the split before it is blocked: 4 examples, rows 2-3.
    head = predict.predict_dataset(cfg, weights[1], get_dataset("h36m", h36m_root),
                                   n_examples=4)
    assert int(head["example_offset"]) == 2 and len(head["valid"]) == 2
    np.testing.assert_array_equal(head["actions"], full["actions"][2:4])


# --- (b) 3DHP ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tdhp_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("3dhp"))
    synth_shard.write_synthetic_3dhp_shard(root)
    return root


def test_3dhp_scores_match_golden(cfgs, weights, tdhp_root, tmp_path):
    _, cfg = cfgs
    ds = get_dataset("mpi_inf_3dhp", tdhp_root)
    result = predict.predict_dataset(cfg, weights[1], ds)
    assert result["univ_scale"].shape == (10,)
    scores = eval_3dhp.evaluate(predict.save_predictions(result, str(tmp_path / "p.npz")))
    golden = _load("3dhp_shard_golden.json")
    assert set(scores) == set(golden)
    for key in ("pck_150", "auc", "mpjpe", "pck_150_univ", "auc_univ", "mpjpe_univ"):
        np.testing.assert_allclose(scores[key], golden[key], rtol=1e-4, err_msg=key)
    for table in ("per_activity_pck", "per_activity_auc"):
        assert set(scores[table]) == set(golden[table])
        for act, val in golden[table].items():
            np.testing.assert_allclose(scores[table][act], val, rtol=1e-4,
                                       err_msg=f"{table} {act}")


def test_3dhp_shard_without_univ_scale_dumps_no_key(cfgs, weights, tdhp_root, tmp_path):
    _, cfg = cfgs
    root = str(tmp_path / "legacy")
    shutil.copytree(os.path.join(tdhp_root, "3dhp"), os.path.join(root, "3dhp"))
    path = os.path.join(root, "3dhp", "annotations_test.npz")
    ann = dict(np.load(path, allow_pickle=True))
    del ann["univ_scale"]
    np.savez(path, **ann)
    ds = get_dataset("mpi_inf_3dhp", root)
    assert ds.test_univ_scale(0) is None
    result = predict.predict_dataset(cfg, weights[1], ds, n_examples=3)
    assert "univ_scale" not in result and len(result["valid"]) == 3
    scores = eval_3dhp.evaluate(predict.save_predictions(result, str(tmp_path / "p.npz")))
    assert not any(k.endswith("_univ") for k in scores)


# --- (c) int8 ------------------------------------------------------------------

def test_int8_protocol_matches_golden(cfgs, weights, h36m_root, h36m_dumps, tmp_path):
    """`calibrate_on_dataset` over 2 batches of the test split, then the
    int8 dump, against the fp dump's MPJPE and the golden."""
    jcfg, cfg = cfgs
    variables = weights[0]
    cfg8 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantize="int8"))
    model8 = MetroModel(cfg8.model)
    missing, unexpected = model8.load_state_dict(state_dict_from_flax(variables), strict=False)
    assert not unexpected and missing and all(k.endswith(".amax") for k in missing)
    ds = get_dataset("h36m", h36m_root)
    assert calibrate_on_dataset(cfg8, model8, ds, n_batches=2) is model8
    assert all(float(v) > 0 for k, v in model8.state_dict().items() if k.endswith(".amax"))
    result = predict.predict_dataset(cfg8, model8, ds)
    mpjpe_int8 = eval_h36m.evaluate(predict.save_predictions(
        result, str(tmp_path / "int8.npz")))["mpjpe"]
    mpjpe_fp = eval_h36m.evaluate(h36m_dumps[2])["mpjpe"]
    golden = _load("int8_shard_golden.json")
    np.testing.assert_allclose(mpjpe_fp, golden["mpjpe_fp"], rtol=1e-4)
    np.testing.assert_allclose(mpjpe_int8, golden["mpjpe_int8"], rtol=1e-3)
    assert abs(mpjpe_int8 - mpjpe_fp) < 0.05 * mpjpe_fp


# --- (d) readers ----------------------------------------------------------------

@pytest.fixture(scope="module")
def mpii_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mpii"))
    synth_shard.write_synthetic_mpii_release(root)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "prepare_mpii.py"),
                          "--data-root", root], capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr
    return root


@pytest.fixture(scope="module")
def tdpw_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("3dpw"))
    synth_shard.write_synthetic_3dpw_release(root)
    return root


EXAMPLE_FIELDS = ("image", "bbox", "world_coords", "image_coords", "joint_validity", "mask")
CAMERA_FIELDS = ("K", "R", "t", "dist", "world_up")


def assert_examples_equal(got, want, what):
    for field in EXAMPLE_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), f"{what} {field}"
        if w is not None:
            assert np.asarray(g).dtype == np.asarray(w).dtype, f"{what} {field}"
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {field}")
    for field in CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(got.camera, field), getattr(want.camera, field),
                                      err_msg=f"{what} camera.{field}")


@pytest.mark.parametrize("name", ["h36m", "mpi_inf_3dhp", "mpii", "3dpw"])
def test_reader_examples_equal_jax(name, request):
    root = request.getfixturevalue(
        {"h36m": "h36m_root", "mpi_inf_3dhp": "tdhp_root", "mpii": "mpii_root",
         "3dpw": "tdpw_root"}[name])
    got, want = get_dataset(name, root), jax_get_dataset(name, root)
    assert type(got).__module__.startswith("metro_pose3d_tpu_torch.")
    assert (got.n_train, got.n_test) == (want.n_train, want.n_test)
    assert got.n_train + got.n_test > 0
    assert getattr(got, "has_masks", False) == getattr(want, "has_masks", False)
    for i in range(want.n_train):
        assert_examples_equal(got.train_example(i), want.train_example(i), f"train {i}")
    for i in range(want.n_test):
        assert_examples_equal(got.test_example(i), want.test_example(i), f"test {i}")
        if hasattr(want, "test_group_label"):
            assert got.test_group_label(i) == want.test_group_label(i)
        if hasattr(want, "test_univ_scale"):
            assert got.test_univ_scale(i) == want.test_univ_scale(i)
    if name == "mpi_inf_3dhp":
        assert any(got.train_example(i).mask is not None for i in range(got.n_train))
    if name == "mpii":
        with pytest.raises(IndexError):
            got.test_example(0)
    if name == "3dpw":
        assert got.n_test_frames == want.n_test_frames > 0
        for i in range(want.n_test_frames):
            (gi, gb, gc, gw, gs), (wi, wb, wc, ww, ws) = got.test_frame(i), want.test_frame(i)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gw, ww)
            assert gs == ws
            for field in CAMERA_FIELDS:
                np.testing.assert_array_equal(getattr(gc, field), getattr(wc, field))


def test_3dhp_mask_files_read_as_jax(tdhp_root, tmp_path):
    """Masks the shard does not write: colour and RGBA PNGs give the JAX
    reader's masks; a missing, truncated or corrupt one leaves the example
    without a mask as cv2's None does there; a colour PNG under a gamma
    chunk, which the port does not read, raises naming the file."""
    src = os.path.join(tdhp_root, "3dhp")
    root = tmp_path / "data"
    (root / "3dhp").mkdir(parents=True)
    shutil.copy(os.path.join(src, "annotations_test.npz"), root / "3dhp")
    ann = dict(np.load(os.path.join(src, "annotations_train.npz"), allow_pickle=True))
    rng = np.random.default_rng(3)
    h, w = cv2.imread(os.path.join(src, str(ann["image_paths"][0]))).shape[:2]
    colour = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    assert cv2.imwrite(str(root / "3dhp" / "rgb.png"), colour)
    assert cv2.imwrite(str(root / "3dhp" / "rgba.png"),
                       np.concatenate([colour[::-1], colour[..., :1]], -1))
    png = (root / "3dhp" / "rgb.png").read_bytes()
    (root / "3dhp" / "trunc.png").write_bytes(png[:len(png) // 2])
    (root / "3dhp" / "bad.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    (root / "3dhp" / "gamma.png").write_bytes(
        png[:33] + struct.pack(">I4sB", 1, b"sRGB", 0) + zlib.crc32(b"sRGB\x00").to_bytes(4, "big")
        + png[33:])
    masks = ["rgb.png", "rgba.png", "missing.png", "trunc.png", "bad.jpg", "gamma.png"]
    n = len(masks)
    assert len(ann["image_paths"]) >= n
    ann = {k: v[:n] if len(v) == len(ann["image_paths"]) else v for k, v in ann.items()}
    ann["image_paths"] = np.array([os.path.join(src, str(p)) for p in ann["image_paths"]])
    ann["mask_paths"] = np.array(masks)
    np.savez(root / "3dhp" / "annotations_train.npz", **ann)
    got, want = get_dataset("mpi_inf_3dhp", str(root)), jax_get_dataset("mpi_inf_3dhp", str(root))
    for i, mask in enumerate(masks[:-1]):
        assert_examples_equal(got.train_example(i), want.train_example(i), mask)
        assert (want.train_example(i).mask is None) == (i >= 2), mask
    assert want.train_example(n - 1).mask is not None
    with pytest.raises(ValueError, match="gamma.png"):
        got.train_example(n - 1)


def test_canonical_action_matches_jax():
    names = sorted(h36m.CANONICAL_ACTIONS | set(h36m._ACTION_ALIASES))
    assert h36m.CANONICAL_ACTIONS == jax_h36m.CANONICAL_ACTIONS
    assert h36m._ACTION_ALIASES == jax_h36m._ACTION_ALIASES
    for name in names + [n + " 1" for n in names]:
        assert h36m.canonical_action(name) == jax_h36m.canonical_action(name)
    for bad in ("Dancing", "walking", ""):
        with pytest.raises(ValueError, match="unknown H36M action"):
            h36m.canonical_action(bad)
        with pytest.raises(ValueError):
            jax_h36m.canonical_action(bad)


# --- (e) scorers and the small ops, port against JAX on the same inputs ----------

def _dump(rng, n=12, j=17, invalid=True, with_abs=True):
    gt = rng.normal(0, 300, (n, j, 3)).astype(np.float32)
    d = {"pose3d_rootrel": (gt + rng.normal(0, 60, gt.shape)).astype(np.float32),
         "gt3d_rootrel": gt, "joint_names": np.array([f"j{i}" for i in range(j)]),
         "actions": np.array(["Walking", "Photo", "Sitting"] * (n // 3))}
    if with_abs:
        d["pose3d_abs"] = d["pose3d_rootrel"] + 4000
        d["gt3d_abs"] = gt + 4000
    if invalid:
        valid = rng.random((n, j)) > 0.3
        valid[2] = False  # a row with no valid joint
        valid[:, 5] = False  # a joint invalid everywhere
        d["valid"] = valid
    return d


def _same_result(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert set(got[key]) == set(w), key
            for k, v in w.items():
                assert (got[key][k] is None and v is None) or got[key][k] == v, (key, k)
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("case", ["valid", "no_valid_key", "univ"])
def test_scorers_equal_jax(case, tmp_path):
    rng = np.random.default_rng(len(case))
    d = _dump(rng, invalid=case != "no_valid_key")
    if case == "univ":
        d["univ_scale"] = rng.uniform(0.9, 1.1, len(d["gt3d_rootrel"])).astype(np.float32)
    path = str(tmp_path / "d.npz")
    np.savez(path, **d)
    _same_result(eval_h36m.evaluate(path), jax_eval_h36m.evaluate(path))
    _same_result(eval_3dhp.evaluate(path), jax_eval_3dhp.evaluate(path))
    # the legacy "activities" spelling of the 3DHP group labels
    legacy = {("activities" if k == "actions" else k): v for k, v in d.items()}
    np.savez(path, **legacy)
    _same_result(eval_3dhp.evaluate(path), jax_eval_3dhp.evaluate(path))


@pytest.mark.parametrize("joints14", [False, True])
def test_eval_3dpw_equals_jax(joints14, tmp_path):
    rng = np.random.default_rng(3)
    gt = rng.normal(0, 300, (10, 24, 3)).astype(np.float32)
    d = {"pose3d": gt + rng.normal(0, 50, gt.shape).astype(np.float32), "gt3d": gt,
         "pose3d_abs": gt + 3000, "gt3d_abs": gt + 3050,
         "seq": np.array(["courtyard_a", "downtown_b"] * 5)}
    path = str(tmp_path / "mp.npz")
    np.savez(path, **d)
    _same_result(eval_3dpw.evaluate_3dpw(path, joints14),
                 jax_eval_3dpw.evaluate_3dpw(path, joints14))


def test_procrustes_bones_and_unit_equal_jax():
    rng = np.random.default_rng(11)
    pred, gt = rng.normal(0, 300, (2, 9, 17, 3))
    for scaling, reflection in ((True, False), (False, False), (True, True)):
        np.testing.assert_array_equal(
            procrustes_align(pred, gt, scaling, reflection),
            jax_procrustes_align(pred, gt, scaling, reflection))
    poses = rng.normal(0, 300, (32, 17, 3)).astype(np.float32)
    edges = np.asarray(H36M_17.bones)
    got = mean_bone_lengths(torch.from_numpy(poses), torch.from_numpy(edges)).numpy()
    want = np.asarray(jax_mean_bone_lengths(jnp.asarray(poses), jnp.asarray(edges)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    px = rng.uniform(-10, 300, (5, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(image_to_unit(torch.from_numpy(px), 256).numpy(),
                                  np.asarray(jax_image_to_unit(jnp.asarray(px), 256)))


# --- (f) the per-host blocks ----------------------------------------------------

def _jax_block(n_total, host_id, host_count):
    """The JAX package's block arithmetic
    (metro_pose3d_tpu/evaluation/predict.py:154-160)."""
    if host_count > 1:
        per = -(-n_total // host_count)
        offset = min(host_id * per, n_total)
        return offset, min(per, n_total - offset)
    return 0, n_total


def test_host_block_matches_jax():
    for n_total in range(21):
        for host_count in range(1, 5):
            blocks = [predict.host_block(n_total, h, host_count) for h in range(host_count)]
            assert blocks == [_jax_block(n_total, h, host_count) for h in range(host_count)]
            assert sum(n for _, n in blocks) == n_total


def test_joint_count_mismatch_raises(cfgs, weights, tdpw_root):
    _, cfg = cfgs
    with pytest.raises(ValueError, match="num_joints=17"):
        predict.predict_dataset(cfg, weights[1], get_dataset("3dpw", tdpw_root))
