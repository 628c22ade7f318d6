"""The port's multi-person path against the JAX package's, on the CPU.

Synthetic frames and sequences (`data/synthetic.py`), the shared-frame warp
(`ops/warp.py::warp_from_frame` and K1's `normalize_div` form),
`multiperson.make_multiperson_predict_fn` and `MultiPersonEstimator`,
`evaluation/predict.py::predict_multiperson_dataset` on the JAX package's
synthetic 3DPW release (scored against `tests/golden/tdpw_shard_golden.json`)
and `evaluation/truncation.py`, each against the JAX function on the same
flax weights (tiny backbone, float32), converted through `convert.py`.

Tolerances (`ATOL`) are `tests/test_torch_protocol.py`'s: float32 end to
end, 5e-3 mm root-relative, 0.25 mm absolute (the translation solve
amplifies the root-relative difference), 1e-4 crop pixels in 2D. The
estimator's `pose2d_px` is in frame pixels: its bound is 1e-4 times each
crop's zoom (frame pixels per crop pixel) plus one float32 ulp of the value,
which the dump rounds to once.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu import multiperson as jmp
from metro_pose3d_tpu.config import Config as JaxConfig
from metro_pose3d_tpu.config import apply_overrides as jax_apply_overrides
from metro_pose3d_tpu.data import synth_shard
from metro_pose3d_tpu.data import synthetic as jsynth
from metro_pose3d_tpu.data.datasets import get_dataset as jax_get_dataset
from metro_pose3d_tpu.evaluation import truncation as jtrunc
from metro_pose3d_tpu.evaluation.predict import (
    predict_multiperson_dataset as jax_predict_multiperson_dataset,
)
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu.ops import warp as jwarp
from metro_pose3d_tpu.ops.color import normalize as jax_normalize
from metro_pose3d_tpu.pipeline import crops as jcrops
from metro_pose3d_tpu_torch import multiperson
from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.convert import load_flax_variables
from metro_pose3d_tpu_torch.data import synthetic
from metro_pose3d_tpu_torch.data.datasets import get_dataset
from metro_pose3d_tpu_torch.evaluation import eval_3dpw, predict, truncation
from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import H36M_17, SMPL_24
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.ops import warp
from metro_pose3d_tpu_torch.pipeline.crops import prepare_inference_crop_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
        "model.compute_dtype": "float32", "data.source_side": "128"}
ATOL = {"pose3d_rootrel": 5e-3, "pose3d_abs": 0.25, "pose2d_crop_px": 1e-4}
BUCKETS = (1, 2, 4, 8)
WARP_ATOL = 1e-2  # [0,255]: tests/test_torch_warp_epilogue.py's warp tolerance


def _cfgs(**over):
    over = {**TINY, **over}
    return jax_apply_overrides(JaxConfig(), over), apply_overrides(Config(), over)


def _weights(jcfg, cfg, seed=0):
    variables = FlaxMetro(jcfg.model).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.model.proc_side, cfg.model.proc_side, 3), jnp.float32), train=False)
    return variables, load_flax_variables(MetroModel(cfg.model), variables).eval()


@pytest.fixture(scope="module")
def weights():
    return _weights(*_cfgs())


@pytest.fixture(scope="module")
def estimators(weights):
    """(JAX, port) estimators in frame mode on the same weights."""
    jcfg, cfg = _cfgs()
    variables, model = weights
    return (jmp.MultiPersonEstimator(jcfg, variables, H36M_17, buckets=BUCKETS),
            multiperson.MultiPersonEstimator(cfg, model, H36M_17, buckets=BUCKETS))


def _zoom(boxes, camera, cfg):
    """Frame pixels per crop pixel of each box's crop."""
    return np.array([camera.K[0, 0] / prepare_inference_crop_params(
        box, camera, cfg.model.proc_side, cfg.data.test_box_expansion)["intrinsics"][0, 0]
        for box in boxes])


def _assert_frame_close(got, want, zoom):
    assert set(got) == set(want) == {"pose3d_abs", "pose3d_rootrel", "pose2d_px"}
    for key in got:
        assert got[key].dtype == want[key].dtype == np.float32 and \
            got[key].shape == want[key].shape, key
    for key in ("pose3d_abs", "pose3d_rootrel"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL[key], rtol=0, err_msg=key)
    bound = ATOL["pose2d_crop_px"] * zoom[:, None, None] + np.spacing(np.abs(want["pose2d_px"]))
    assert np.all(np.abs(got["pose2d_px"] - want["pose2d_px"]) <= bound), \
        float(np.abs(got["pose2d_px"] - want["pose2d_px"]).max())


# --- synthetic frames -------------------------------------------------------------

@pytest.mark.parametrize("n, seed, imshape", [(3, 1, (512, 910)), (1, 10, (480, 641)),
                                              (6, 3, (720, 1280)), (8, 5, (300, 401))])
def test_multiperson_frame_equals_jax(n, seed, imshape):
    """Pixels, boxes, camera and world poses of the JAX frame (cv2's drawing),
    an odd width among them."""
    got = synthetic.make_multiperson_frame(n, seed=seed, imshape=imshape)
    want = jsynth.make_multiperson_frame(n, seed=seed, imshape=imshape)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].K, want[2].K)
    np.testing.assert_array_equal(got[2].R, want[2].R)
    np.testing.assert_array_equal(got[3], want[3])


def test_multiperson_sequence_equals_jax():
    got = list(synthetic.make_multiperson_sequence(4, 6, seed=2, imshape=(360, 641)))
    want = list(jsynth.make_multiperson_sequence(4, 6, seed=2, imshape=(360, 641)))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip((g[0], g[1], g[2].K, g[3]), (w[0], w[1], w[2].K, w[3])):
            np.testing.assert_array_equal(a, b)


# --- the shared-frame warp ----------------------------------------------------------

def _frame_params(n=3, seed=1, side=64):
    image, boxes, cam, _ = jsynth.make_multiperson_frame(n, seed=seed)
    prepared = [jcrops.prepare_inference_crop_params(b, cam, side, 1.0) for b in boxes]
    return image, {k: np.stack([p[k] for p in prepared]) for k in ("warp_h", "warp_k",
                                                                   "warp_dist")}


def test_warp_from_frame_matches_jax():
    """One launch over the shared frame (source index 0 for every crop)
    against the JAX frame warp (`_warp_images_packed` with source_indices)."""
    image, p = _frame_params()
    got = warp.warp_from_frame(torch.from_numpy(image), *(torch.from_numpy(p[k]) for k in p),
                               64)
    want = np.asarray(jwarp.warp_from_frame(jnp.asarray(image), *(jnp.asarray(p[k]) for k in p),
                                            64, sampler="packed"))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, rtol=0)
    assert float(got.std()) > 10  # the crops hold the frame's content, not its border


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_normalize_div_form_matches_the_jax_frame_chain(dtype):
    """`normalize_div` is normalize(x / 255) with an IEEE float32 division.
    JAX's frame chain, `normalize(warp / 255.0)` under jit, is held to it:
    XLA folds the division and the scale into one product and an offset (an
    FMA on the CPU), which differs from either written order by at most two
    float32 ulps of 1.0."""
    image, p = _frame_params()
    raw = warp.warp_from_frame(torch.from_numpy(image), *(torch.from_numpy(p[k]) for k in p),
                               64)
    got = warp.warp_from_frame(torch.from_numpy(image), *(torch.from_numpy(p[k]) for k in p),
                               64, epilogue="normalize_div", out_dtype=dtype)
    ieee = (raw.numpy() / np.float32(255.0)) * np.float32(255.0 / 127.5) + np.float32(-1.0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(ieee).to(dtype).float().numpy())
    want = np.asarray(jax.jit(lambda x: jax_normalize(x / 255.0))(jnp.asarray(raw.numpy())))
    if dtype == torch.float32:
        assert np.abs(got.numpy() - want).max() <= 2 * 2.0 ** -23
    else:  # one bf16 rounding of values that differ by two float32 ulps
        assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -8 + 2 * 2.0 ** -23


# --- the predict function --------------------------------------------------------

def _predict_batch(frame_mode, n=3, bucket=4, seed=3):
    """A JAX-prepared batch of n boxes padded to `bucket`, and the frame."""
    image, boxes, cam, worlds = jsynth.make_multiperson_frame(n, seed=seed)
    if frame_mode:
        prepared = [jcrops.prepare_inference_crop_params(b, cam, 64, 1.0) for b in boxes]
    else:
        prepared = [jcrops.prepare_inference_crop(image, b, cam, 64, 128, 1.0) for b in boxes]
    for pr in prepared:
        pr.pop("_crop_cam")
    prepared += [prepared[-1]] * (bucket - n)
    batch = {k: np.stack([pr[k] for pr in prepared]) for k in prepared[0]}
    if frame_mode:
        batch["frame"] = np.array(image[:, : image.shape[1] // 2 * 2])
    return batch, worlds


@pytest.mark.parametrize("bones", [False, True], ids=["metric", "bones"])
@pytest.mark.parametrize("flip_tta", [False, True], ids=["no_tta", "tta"])
@pytest.mark.parametrize("frame_mode", [True, False], ids=["frame", "tiles"])
def test_predict_fn_matches_jax(weights, frame_mode, flip_tta, bones):
    over = {"eval.scale_recovery": "bone_lengths"} if bones else {}
    jcfg, cfg = _cfgs(**over)
    variables, model = weights
    batch, worlds = _predict_batch(frame_mode)
    kw = dict(root_index=0, flip_tta=flip_tta, frame_mode=frame_mode)
    if bones:
        edges = H36M_17.bones
        kw.update(bone_edges=edges, mean_bones=np.linalg.norm(
            worlds[:, edges[:, 0]] - worlds[:, edges[:, 1]], axis=-1).mean(0).astype(np.float32))
    want = jmp.make_multiperson_predict_fn(jcfg, H36M_17.mirror_mapping, **kw)(variables, batch)
    got = multiperson.make_multiperson_predict_fn(cfg, H36M_17.mirror_mapping, **kw)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == set(ATOL)
    for key, atol in ATOL.items():
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape == (4, 17, 2 if "2d" in key else 3)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)


def test_rotate_is_the_highest_precision_einsum():
    rng = np.random.default_rng(0)
    rot = rng.normal(size=(5, 3, 3)).astype(np.float32)
    pts = (rng.normal(size=(5, 17, 3)) * 3000).astype(np.float32)
    want = np.einsum("bij,bkj->bki", rot.astype(np.float64), pts.astype(np.float64))
    got = multiperson.rotate(torch.from_numpy(rot), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)  # float32 sums of three products


# --- the estimator -----------------------------------------------------------------

def _both(estimators, *args, **kw):
    est_j, est_p = estimators
    return est_p.estimate_frame(*args, **kw), est_j.estimate_frame(*args, **kw)


def test_estimator_shapes_match_jax(estimators):
    image, boxes, cam, _ = synthetic.make_multiperson_frame(3, seed=3)
    got, want = _both(estimators, image, boxes, cam)
    assert got["pose3d_abs"].shape == got["pose3d_rootrel"].shape == (3, 17, 3)
    assert got["pose2d_px"].shape == (3, 17, 2)
    assert all(np.isfinite(v).all() for v in got.values())
    _assert_frame_close(got, want, _zoom(boxes, cam, estimators[1].cfg))


def test_bucket_padding_does_not_leak(estimators):
    """Person 0's result does not depend on the bucket it was padded to."""
    image, boxes, cam, _ = synthetic.make_multiperson_frame(3, seed=4)
    est = estimators[1]
    out3 = est.estimate_frame(image, boxes, cam)  # bucket 4
    out1 = est.estimate_frame(image, boxes[:1], cam)  # bucket 1
    # the translation solve amplifies the batch's float roundoff to ~1e-2 mm
    np.testing.assert_allclose(out3["pose3d_abs"][0], out1["pose3d_abs"][0], atol=0.05)
    _assert_frame_close(out1, estimators[0].estimate_frame(image, boxes[:1], cam),
                        _zoom(boxes[:1], cam, est.cfg))


def test_default_camera_and_empty_boxes(estimators):
    image, boxes, _, _ = synthetic.make_multiperson_frame(1, seed=5)
    got, want = _both(estimators, image, boxes)  # no camera given
    assert got["pose3d_abs"].shape == (1, 17, 3)
    _assert_frame_close(got, want, _zoom(boxes, Camera.from_fov(60.0, image.shape[:2]),
                                         estimators[1].cfg))
    empty, empty_j = _both(estimators, image, np.zeros((0, 4)))
    for key in empty:
        assert empty[key].shape == empty_j[key].shape == (0, 17, 2 if key == "pose2d_px" else 3)
        assert empty[key].dtype == np.float32


def test_chunking_beyond_largest_bucket(estimators):
    image, boxes, cam, _ = synthetic.make_multiperson_frame(3, seed=6)
    many = np.concatenate([boxes] * 4)  # 12 > the largest bucket, 8
    got, want = _both(estimators, image, many, cam)
    assert got["pose3d_abs"].shape == (12, 17, 3)
    # a box repeated gives the same prediction (the same bucket shape)
    np.testing.assert_allclose(got["pose3d_abs"][:3], got["pose3d_abs"][3:6], atol=0.05)
    _assert_frame_close(got, want, _zoom(many, cam, estimators[1].cfg))


def test_warmup_runs_every_bucket_up_to_max_people(estimators):
    image, boxes, cam, _ = synthetic.make_multiperson_frame(3, seed=21)
    est_j, est_p = estimators
    built = est_p.warmup(3, imshape=image.shape[:2], camera=cam)
    assert built == est_j.warmup(3, imshape=image.shape[:2], camera=cam) == 3  # 1, 2, 4
    assert est_p.warmup(100) == len(BUCKETS)
    got, want = _both(estimators, image, boxes, cam)
    _assert_frame_close(got, want, _zoom(boxes, cam, est_p.cfg))


def test_estimate_stream_equals_per_frame(estimators):
    """The stream yields exactly what per-frame calls give, in order, at
    every depth: with a frame without boxes, one beyond the largest bucket
    and one without a camera. The per-frame results hold to JAX's."""
    frames = []
    for seed in (11, 12, 13, 14):
        image, boxes, cam, _ = synthetic.make_multiperson_frame(3, seed=seed)
        frames.append((image, boxes, cam))
    frames.insert(2, (frames[0][0], np.zeros((0, 4)), frames[0][2]))
    frames.append((frames[1][0], np.concatenate([frames[1][1]] * 4), frames[1][2]))
    frames.append((frames[0][0], frames[0][1]))
    est_j, est = estimators
    ref = [est.estimate_frame(*f) for f in frames]
    for depth in (1, 2, 3):
        got = list(est.estimate_stream(iter(frames), depth=depth))
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            assert r.keys() == g.keys()
            for k in r:
                np.testing.assert_array_equal(r[k], g[k], err_msg=k)
    assert len(est.estimate_batch(frames)) == len(frames)
    for f, r in zip(frames, ref):
        if len(f[1]):
            cam = f[2] if len(f) > 2 else Camera.from_fov(60.0, f[0].shape[:2])
            _assert_frame_close(r, est_j.estimate_frame(*f), _zoom(f[1], cam, est.cfg))


def test_stream_survives_a_reused_frame_buffer(estimators):
    """A caller that decodes each frame into the same buffer gets what it
    gets with fresh buffers: the estimator copies the frame it dispatches."""
    est = estimators[1]
    frames = [synthetic.make_multiperson_frame(2, seed=s) for s in (31, 32, 33)]
    want = [est.estimate_frame(img, boxes, cam) for img, boxes, cam, _ in frames]
    buf = np.empty_like(frames[0][0])

    def reused():
        for img, boxes, cam, _ in frames:
            buf[...] = img
            yield buf, boxes, cam

    for g, w in zip(est.estimate_stream(reused(), depth=3), want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_absolute_poses_in_shared_frame(estimators):
    """People left and right of the optical axis decode to absolute
    positions on those sides: the crops' cameras look at the boxes and the
    poses rotate back into the frame's camera."""
    image, boxes, cam, worlds = synthetic.make_multiperson_frame(2, seed=7)
    got, want = _both(estimators, image, boxes, cam)
    gt_x = np.array([cam.world_to_camera(w)[0, 0] for w in worlds])
    assert np.all(np.sign(got["pose3d_abs"][:, :, 0].mean(-1)) == np.sign(gt_x))
    _assert_frame_close(got, want, _zoom(boxes, cam, estimators[1].cfg))


def test_odd_width_frame_matches_jax(estimators):
    """A box on the right edge of an odd-width frame: the frame is cut to an
    even width as in JAX, so the last column samples zeros in both."""
    image, boxes, cam, _ = synthetic.make_multiperson_frame(1, seed=10, imshape=(480, 641))
    edge = np.array([[560.0, 100.0, 120.0, 300.0]])
    for b in (boxes, edge):
        got, want = _both(estimators, image, b, cam)
        assert got["pose3d_abs"].shape == (1, 17, 3) and np.isfinite(got["pose3d_abs"]).all()
        _assert_frame_close(got, want, _zoom(b, cam, estimators[1].cfg))


def test_frame_mode_matches_tile_mode(weights):
    """With tiles that cover the whole ROI (factor 1, no decimation), frame
    mode and tile mode sample the same pixels."""
    jcfg, cfg = _cfgs(**{"data.source_side": "512"})
    variables, model = weights
    image, boxes, cam, _ = synthetic.make_multiperson_frame(2, seed=9)
    out = {}
    for frame_mode in (True, False):
        est = multiperson.MultiPersonEstimator(cfg, model, H36M_17, buckets=(4,),
                                               frame_mode=frame_mode)
        est_j = jmp.MultiPersonEstimator(jcfg, variables, H36M_17, buckets=(4,),
                                         frame_mode=frame_mode)
        out[frame_mode] = est.estimate_frame(image, boxes, cam)
        _assert_frame_close(out[frame_mode], est_j.estimate_frame(image, boxes, cam),
                            _zoom(boxes, cam, cfg))
    np.testing.assert_allclose(out[True]["pose3d_rootrel"], out[False]["pose3d_rootrel"],
                               atol=0.5)  # mm
    np.testing.assert_allclose(out[True]["pose2d_px"], out[False]["pose2d_px"], atol=0.1)


# --- predict_multiperson_dataset on the synthetic 3DPW release -------------------

TDPW = {**TINY, "model.num_joints": "24", "data.host_prep": "python"}  # tests/test_3dpw_shard.py
DUMP_ATOL = {"pose3d": ATOL["pose3d_rootrel"], "pose3d_abs": ATOL["pose3d_abs"]}


@pytest.fixture(scope="module")
def tdpw(tmp_path_factory):
    """(JAX dump, port dump, its path, port dataset) on the release, with
    tests/test_3dpw_shard.py's weights (PRNGKey(42))."""
    root = str(tmp_path_factory.mktemp("3dpw"))
    synth_shard.write_synthetic_3dpw_release(root)
    jcfg, cfg = (jax_apply_overrides(JaxConfig(), TDPW), apply_overrides(Config(), TDPW))
    variables, model = _weights(jcfg, cfg, seed=42)
    want = jax_predict_multiperson_dataset(jcfg, variables, jax_get_dataset("3dpw", root))
    ds = get_dataset("3dpw", root)
    got = predict.predict_multiperson_dataset(cfg, model, ds)
    path = predict.save_predictions(got, os.path.join(root, "predictions_mp.npz"))
    return want, got, path, ds


@pytest.mark.parametrize("key", ["pose3d", "pose3d_abs", "gt3d", "gt3d_abs", "seq"])
def test_tdpw_dump_matches_jax(tdpw, key):
    want, got, _, ds = tdpw
    assert set(got) == set(want)
    g, w = np.asarray(got[key]), np.asarray(want[key])
    assert g.dtype == w.dtype and g.shape == w.shape and len(g) == ds.n_test, (g.shape, w.shape)
    if key in DUMP_ATOL:
        np.testing.assert_allclose(g, w, atol=DUMP_ATOL[key], rtol=0, err_msg=key)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("joints14", [False, True], ids=["smpl24", "joints14"])
def test_tdpw_scores_match_golden(tdpw, joints14):
    with open(os.path.join(REPO, "tests", "golden", "tdpw_shard_golden.json")) as f:
        golden = json.load(f)
    scores = eval_3dpw.evaluate_3dpw(tdpw[2], joints14=joints14)
    if joints14:
        np.testing.assert_allclose(scores["mpjpe"], golden["mpjpe_14"], rtol=1e-4)
        return
    for key in ("mpjpe", "pa_mpjpe", "abs_mpjpe"):
        np.testing.assert_allclose(scores[key], golden[key], rtol=1e-4, err_msg=key)
    assert set(scores["per_sequence_mpjpe"]) == set(golden["per_sequence_mpjpe"])
    for seq, val in golden["per_sequence_mpjpe"].items():
        np.testing.assert_allclose(scores["per_sequence_mpjpe"][seq], val, rtol=1e-4,
                                   err_msg=seq)


def test_multiperson_dataset_refuses_a_skeleton_mismatch(weights):
    class Frames:
        joint_info = SMPL_24
        root_joint = "pelv"
        n_test_frames = 1

    with pytest.raises(ValueError, match="num_joints=24"):
        predict.predict_multiperson_dataset(_cfgs()[1], weights[1], Frames())


# --- the truncation table -----------------------------------------------------------

@pytest.mark.parametrize("model_class", ["metro", "twofive"])
def test_truncation_table_matches_jax(model_class):
    """evaluate_truncation's table (with the 2.5D lift for twofive) against
    JAX's on the same weights and synthetic examples."""
    from metro_pose3d_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset

    jcfg, cfg = _cfgs(**{"model.model_class": model_class})
    variables, model = _weights(jcfg, cfg, seed=3)
    fractions = (0.0, 0.3, 0.5)
    want = jtrunc.evaluate_truncation(jcfg, variables, JaxSynthetic(n_test=6), fractions,
                                      n_examples=6)
    got = truncation.evaluate_truncation(cfg, model, SyntheticDataset(n_test=6), fractions,
                                         n_examples=6)
    assert list(got) == list(want) == list(fractions)
    for frac in fractions:
        assert set(got[frac]) == set(want[frac]), frac
        assert got[frac]["n_visible"] == want[frac]["n_visible"]
        for key in got[frac]:
            np.testing.assert_allclose(got[frac][key], want[frac][key], atol=1e-3, rtol=0,
                                       err_msg=f"{frac} {key}")
    assert "mpjpe_hidden" in got[0.5]


def test_truncate_box_cuts_the_bottom():
    np.testing.assert_array_equal(truncation.truncate_box([10, 20, 30, 40], 0.25),
                                  jtrunc.truncate_box([10, 20, 30, 40], 0.25))
    np.testing.assert_array_equal(truncation.truncate_box([10, 20, 30, 40], 0.25),
                                  [10, 20, 30, 30])
