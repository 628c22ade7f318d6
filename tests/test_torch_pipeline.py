"""The port's host input pipeline against the JAX package's, on the CPU.

`metro_pose3d_tpu_torch.pipeline.crops` (both engines), `pipeline.loader`,
`train.joint_mapping`, `train.trainer.mixed_batch_iterator`, `data.datasets`
and `data.synthetic` on the same examples, draws and seeds as their
counterparts in `metro_pose3d_tpu`:

* the python engine equals the JAX package's python engine bit for bit, on
  every key of every case: test-time, augmented, distorted camera, large
  rotation with flip, 2D-only with NaN and invalid joints, NaN world
  coordinates, the green-screen mask, and both inference preps;
* the native engine (native/croprep.c) is within RTOL = 1e-6 of it on float
  fields (float32 outputs of float64 math), uint8 tiles and masks equal.
  It is not bit for bit the JAX package's native engine in float64: that one
  is built with -march=native, where GCC fuses products and sums into FMAs,
  and the port's with -ffp-contract=off; on an x86-64 host with GCC 12 they
  differ by at most 2.8e-13 relative (`test_native_engine_against_jax_native_in_float64`);
* the loaders yield the same batches bit for bit for the thread and process
  pools, with `skip_batches`, across a `host_id`/`host_count` partition, for
  a padded tail, with masks, and mixed with a 2D-only dataset;
* the port's synthetic dataset draws the JAX package's examples: camera,
  box and world coordinates bit for bit, at least 95% of the pixels equal
  (the lowest share measured over indices 0-31 at 512x512 is 0.9932).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from metro_pose3d_tpu.config import Config as JaxConfig
from metro_pose3d_tpu.config import apply_overrides as jax_apply_overrides
from metro_pose3d_tpu.data.synthetic import make_example as jax_make_example
from metro_pose3d_tpu.geom.camera import Camera as JaxCamera
from metro_pose3d_tpu.geom.joints import H36M_17 as JAX_H36M
from metro_pose3d_tpu.geom.joints import MPII_16 as JAX_MPII
from metro_pose3d_tpu.pipeline import crops as jcrops
from metro_pose3d_tpu.pipeline.loader import batch_iterator as jax_batch_iterator
from metro_pose3d_tpu.pipeline.loader import prepare_one as jax_prepare_one
from metro_pose3d_tpu.train import joint_mapping as jax_joint_mapping
from metro_pose3d_tpu.train.trainer import mixed_batch_iterator as jax_mixed_batch_iterator
from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.data import h36m, mpi_inf_3dhp, mpii, synthetic, tdpw
from metro_pose3d_tpu_torch.data.datasets import get_dataset
from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import H36M_17, MPII_16
from metro_pose3d_tpu_torch.native import build as native
from metro_pose3d_tpu_torch.pipeline import crops
from metro_pose3d_tpu_torch.pipeline.device import example_spec
from metro_pose3d_tpu_torch.pipeline.loader import batch_iterator, prefetch, prepare_one
from metro_pose3d_tpu_torch.train import joint_mapping
from metro_pose3d_tpu_torch.train.trainer import mixed_batch_iterator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6  # float32 outputs of float64 math; the engines agree to ~1e-12 in float64
ENGINES = ["python", "native"]


# --- examples of one package in the other's types ---------------------------

def to_port(ex):
    c = ex.camera
    cam = Camera(c.K.copy(), c.R.copy(), c.t.copy(), c.dist.copy(), c.world_up.copy())
    return crops.Example(image=ex.image, bbox=np.array(ex.bbox), camera=cam,
                         world_coords=None if ex.world_coords is None else ex.world_coords.copy(),
                         image_coords=None if ex.image_coords is None else ex.image_coords.copy(),
                         joint_validity=ex.joint_validity, mask=ex.mask)


def to_jax(ex):
    c = ex.camera
    cam = JaxCamera(c.K.copy(), c.R.copy(), c.t.copy(), c.dist.copy(), c.world_up.copy())
    return jcrops.Example(image=ex.image, bbox=np.array(ex.bbox), camera=cam,
                          world_coords=None if ex.world_coords is None else ex.world_coords.copy(),
                          image_coords=None if ex.image_coords is None else ex.image_coords.copy(),
                          joint_validity=ex.joint_validity, mask=ex.mask)


class JaxSynth:
    """The JAX package's synthetic examples, as JAX (`port=False`) or port
    Examples, optionally 2D-only in the MPII convention (the H36M joints
    MPII names, projected; the rest NaN and invalid) or with a mask."""

    root_joint = "pelv"

    def __init__(self, n, imshape=(256, 256), port=True, two_d=False, masks=False, seed=0):
        self.n_train = self.n_test = n
        self.imshape, self.port, self.two_d, self.seed = imshape, port, two_d, seed
        self.has_masks = masks
        self.joint_info = ((MPII_16 if port else JAX_MPII) if two_d
                           else (H36M_17 if port else JAX_H36M))

    def train_example(self, i):
        ex = jax_make_example(i, self.seed, self.imshape)
        if self.two_d:
            px = ex.camera.world_to_image(ex.world_coords)
            names = JAX_H36M.names
            pts = np.full((JAX_MPII.n_joints, 2), np.nan)
            valid = np.zeros(JAX_MPII.n_joints, bool)
            for j, name in enumerate(JAX_MPII.names):
                if name in names:
                    pts[j], valid[j] = px[names.index(name)], True
            ex = dataclasses.replace(ex, world_coords=None, image_coords=pts,
                                     joint_validity=valid)
        if self.has_masks:
            ex.mask = np.random.default_rng((7, i)).random(self.imshape) > 0.4
        return to_port(ex) if self.port else ex


# --- prepare_example ----------------------------------------------------------

def check_against_jax(got, want, engine, context=""):
    """Port result `got` against the JAX python engine's `want`."""
    assert got.keys() == want.keys(), context
    for k in want:
        if k == "_crop_cam":
            for attr in ("K", "R", "t", "dist"):
                a, b = getattr(got[k], attr), getattr(want[k], attr)
                if engine == "python":
                    np.testing.assert_array_equal(a, b, err_msg=f"{context}:{k}.{attr}")
                else:
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL)
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, f"{context}:{k}"
        if engine == "python" or a.dtype == np.uint8:
            np.testing.assert_array_equal(a, b, err_msg=f"{context}:{k}")
        else:
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=RTOL,
                                       atol=RTOL, err_msg=f"{context}:{k}")


def draws(seed, n):
    """n augmentation draws from both packages' `sample_aug_params` on the
    same seed -> [(jax AugParams, port AugParams, occ_center)]."""
    jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ja, jo = jcrops.sample_aug_params(jr, JaxConfig().aug, 50, 5)
        pa, po = crops.sample_aug_params(pr, Config().aug, 50, 5)
        for f in dataclasses.fields(ja):
            np.testing.assert_array_equal(getattr(pa, f.name), getattr(ja, f.name))
        np.testing.assert_array_equal(po, jo)
        out.append((ja, pa, jo))
    return out


def _case(name):
    """-> (JAX example, [(jax aug, port aug, occ)], prepare kwargs)."""
    ex = jax_make_example({"test_time": 0, "augmented": 1, "distorted": 2, "rotation_flip": 3,
                           "2d_only": 4, "nan_world": 5, "mask": 6}[name], imshape=(720, 960))
    kw = {}
    if name in ("test_time", "nan_world"):
        if name == "nan_world":
            ex.world_coords[2] = np.nan
        return ex, [(None, None, (0.5, 0.5))], kw
    if name == "augmented":
        return ex, draws(11, 25), kw
    if name == "distorted":
        ex.camera.dist[:] = [-0.2, 0.05, 1e-3, -5e-4, 0.01]
        return ex, draws(12, 15), kw
    if name == "rotation_flip":
        out = []
        for rot, (ja, pa, occ) in zip((-88.0, -45.0, 45.0, 88.0), draws(13, 4)):
            out.append((dataclasses.replace(ja, rot_rad=np.deg2rad(rot), flip=True),
                        dataclasses.replace(pa, rot_rad=np.deg2rad(rot), flip=True), occ))
        return ex, out, kw
    if name == "2d_only":
        pts = ex.camera.world_to_image(ex.world_coords)
        pts[3] = np.nan
        validity = np.ones(17, bool)
        validity[5] = False
        ex = dataclasses.replace(ex, world_coords=None, image_coords=pts,
                                 joint_validity=validity)
        return ex, draws(14, 10), kw
    ex.mask = np.random.default_rng(15).random((720, 960)) > 0.4
    return ex, draws(16, 10), {"with_background": True}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", ["test_time", "augmented", "distorted", "rotation_flip",
                                  "2d_only", "nan_world", "mask"])
def test_prepare_example_matches_jax(case, engine):
    ex, aug_draws, kw = _case(case)
    pex = to_port(ex)
    composited = 0
    for trial, (ja, pa, occ) in enumerate(aug_draws):
        want = jcrops.prepare_example(ex, JAX_H36M, 256, 512, aug=ja, occ_center=occ,
                                      engine="python", **kw)
        got = crops.prepare_example(pex, H36M_17, 256, 512, aug=pa, occ_center=occ,
                                    engine=engine, **kw)
        check_against_jax(got, want, engine, f"{case}:{trial}")
        composited += int(got.get("bg_params", [0])[0] == 1.0)
    if case == "2d_only":
        assert got["is_3d"] == 0.0
    if case == "nan_world":
        assert got["joint_validity"][2] == 0.0
    if case == "mask":
        assert "source_mask" in got and composited > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_inference_crop_matches_jax(engine):
    ex = jax_make_example(8, imshape=(720, 960))
    ex.camera.dist[:] = [-0.1, 0.02, 1e-3, -5e-4, 0.0]
    box = np.array([300.0, 150.0, 180.0, 420.0])
    want = jcrops.prepare_inference_crop(ex.image, box, ex.camera, 256, 512, 1.1,
                                         engine="python")
    got = crops.prepare_inference_crop(ex.image, box, to_port(ex).camera, 256, 512, 1.1,
                                       engine=engine)
    check_against_jax(got, want, engine)
    # the crop camera back-projects as the JAX package's does
    pts = np.random.default_rng(0).uniform(0, 255, (17, 2))
    from metro_pose3d_tpu.geom.camera import reproject_image_points as jax_reproject
    from metro_pose3d_tpu_torch.geom.camera import reproject_image_points

    np.testing.assert_allclose(reproject_image_points(pts, got["_crop_cam"], to_port(ex).camera),
                               jax_reproject(pts, want["_crop_cam"], ex.camera), atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_inference_crop_params_matches_jax(engine):
    ex = jax_make_example(9, imshape=(720, 960))
    box = np.array([500.0, 220.0, 150.0, 330.0])
    want = jcrops.prepare_inference_crop_params(box, ex.camera, 256, 1.1, engine="python")
    got = crops.prepare_inference_crop_params(box, to_port(ex).camera, 256, 1.1,
                                              engine=engine)
    check_against_jax(got, want, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_host_prep_properties(engine):
    """The JAX package's host-prep properties, on the port: 2D truth is the
    projection of 3D truth through the crop intrinsics, an untruncated
    person fits the crop, draws are deterministic, and a flip mirrors x and
    permutes the joints."""
    ds = synthetic.SyntheticDataset(imshape=(384, 384))
    aug_cfg = Config().aug
    prepared = [prepare_one(ds.train_example(i), H36M_17, 128, 256, None, (0, 0, i), 8,
                            engine=engine) for i in range(3)]
    for b in prepared:
        p3, k = b["coords3d_true"], b["intrinsics"]
        uv = np.stack([p3[:, 0] / p3[:, 2] * k[0, 0] + k[0, 2],
                       p3[:, 1] / p3[:, 2] * k[1, 1] + k[1, 2]], -1)
        np.testing.assert_allclose(uv, b["coords2d_true"], atol=1e-3)
        assert b["joint_validity_2d"].mean() > 0.95
    a, b = (prepare_one(ds.train_example(5), H36M_17, 128, 256, aug_cfg, (11, 0, 5), 8,
                        engine=engine) for _ in range(2))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    c = prepare_one(ds.train_example(5), H36M_17, 128, 256, aug_cfg, (12, 0, 5), 8,
                    engine=engine)
    assert not np.array_equal(a["warp_h"], c["warp_h"])
    ex = ds.train_example(0)
    flip = crops.AugParams(shift=np.zeros(2), scale=1.0, rot_rad=0.0, flip=True, brightness=0.0,
                           contrast=1.0, saturation=1.0, hue=0.0, occlude=False,
                           occluder_index=0, occluder_affine=np.eye(2, 3))
    base = crops.prepare_example(ex, H36M_17, 128, 256, engine=engine)
    flipped = crops.prepare_example(ex, H36M_17, 128, 256, aug=flip, engine=engine)
    m = H36M_17.mirror_mapping
    np.testing.assert_allclose(flipped["coords2d_true"][m][:, 0],
                               127 - base["coords2d_true"][:, 0], atol=1e-3)
    np.testing.assert_allclose(flipped["coords3d_true"][m][:, 0],
                               -base["coords3d_true"][:, 0], atol=1e-6)


def test_unknown_engine_rejected():
    ex = to_port(jax_make_example(7, imshape=(720, 960)))
    box = np.array([500.0, 220.0, 150.0, 330.0])
    with pytest.raises(ValueError):
        crops.prepare_example(ex, H36M_17, 256, 512, engine="cuda")
    with pytest.raises(ValueError):
        crops.prepare_inference_crop(ex.image, box, ex.camera, 256, 512, engine="nativ")
    with pytest.raises(ValueError):
        crops.prepare_inference_crop_params(box, ex.camera, 256, engine="nativ")


def test_engine_resolution(monkeypatch):
    """`auto` is native where the C engine builds and python where it does
    not; `native` then raises, naming the build's error."""
    assert crops.resolve_engine("auto") == "native"
    assert crops.resolve_engine("python") == "python"
    monkeypatch.setitem(native._loaded, "croprep", "cc: command not found")
    assert crops.resolve_engine("auto") == "python"
    with pytest.raises(RuntimeError, match="command not found"):
        crops.resolve_engine("native")
    ex = to_port(jax_make_example(0, imshape=(256, 256)))
    want = jcrops.prepare_example(to_jax(ex), JAX_H36M, 64, 128)
    check_against_jax(crops.prepare_example(ex, H36M_17, 64, 128, engine="auto"), want,
                      "python")  # and the tile copy falls back to numpy


def test_native_engine_against_jax_native_in_float64():
    """The port's C engine against the JAX package's on their float64
    outputs, over 64 draws with and without distortion: the same ROI and
    factor, and within 1e-11 relative (2.8e-13 with GCC 12 on x86-64; not bit for
    bit, since the JAX build fuses FMAs, see the module docstring)."""
    nat = jcrops._native_engine()
    if nat is None:
        pytest.skip("the JAX package's native extension did not build here")
    lib = native.crop_library()
    rng = np.random.default_rng(3)
    mirror = np.ascontiguousarray(JAX_H36M.mirror_mapping, np.int32)
    worst = 0.0
    for i in range(64):
        ex = jax_make_example(i, imshape=(720, 960))
        if i % 2:
            ex.camera.dist[:] = [-0.2, 0.05, 1e-3, -5e-4, 0.01]
        aug, _ = jcrops.sample_aug_params(rng, JaxConfig().aug, 50, 5)
        c = ex.camera
        cam = np.concatenate([c.K.ravel(), c.R.ravel(), c.t, c.dist, c.world_up])
        coords, valid = np.ascontiguousarray(ex.world_coords), np.ones(17, np.uint8)
        out, *roi = nat.crop_params(
            cam, np.asarray(ex.bbox, np.float64), 256, 512, 960, 720, 1.0,
            float(aug.shift[0]), float(aug.shift[1]), float(aug.scale), float(aug.rot_rad),
            int(aug.flip), 0, 17, coords, valid, mirror)
        want = np.frombuffer(out, np.float64)
        got, groi, factor = crops._native_crop_params(
            lib, to_port(ex).camera, ex.bbox, 256, 512, (720, 960), 1.0, aug.shift, aug.scale,
            aug.rot_rad, aug.flip, 0, coords, valid, mirror)
        assert (*groi, factor) == tuple(roi)
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3))))
    assert worst <= 1e-11


# --- the loader ---------------------------------------------------------------

def assert_batches_equal(got, want, engine="python"):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        check_against_jax(g, w, engine)


def _both(n, port_kw=None, jax_kw=None, ds_kw=None, **kw):
    """Batches of the port's and the JAX package's `batch_iterator` over the
    same examples."""
    p = JaxSynth(n, port=True, **(ds_kw or {}))
    j = JaxSynth(n, port=False, **(ds_kw or {}))
    got = list(batch_iterator(p.train_example, n, p.joint_info, **kw, **(port_kw or {})))
    want = list(jax_batch_iterator(j.train_example, n, j.joint_info, **kw, **(jax_kw or {})))
    return got, want


LOADER = dict(batch_size=4, proc_side=64, tile_side=128, seed=7, n_workers=2,
              n_occluders=8)


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_iterator_matches_jax(engine):
    from metro_pose3d_tpu.config import AugConfig as JaxAug

    got, want = _both(10, {"aug_cfg": Config().aug, "host_prep": engine},
                      {"aug_cfg": JaxAug()}, max_epochs=2, **LOADER)
    assert len(got) == 4  # 2 epochs x 2 full batches
    assert_batches_equal(got, want, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_process_pool_matches_jax(engine):
    """Spawned workers (2 workers, 2 batches) on the port's own synthetic
    dataset, which pickles and imports without torch, against the JAX
    loader on the same examples."""
    from metro_pose3d_tpu.config import AugConfig as JaxAug

    ds = synthetic.SyntheticDataset(n_train=8, imshape=(256, 256))
    got = list(batch_iterator(ds.train_example, 8, H36M_17, aug_cfg=Config().aug,
                              max_epochs=1, pool_type="process", host_prep=engine, **LOADER))
    want = list(jax_batch_iterator(lambda i: to_jax(ds.train_example(i)), 8, JAX_H36M,
                                   aug_cfg=JaxAug(), max_epochs=1, **LOADER))
    assert len(got) == 2
    assert_batches_equal(got, want, engine)


def test_skip_batches_matches_jax():
    full, _ = _both(16, max_epochs=2, shuffle=True, aug_cfg=None, **LOADER)
    got, want = _both(16, max_epochs=2, shuffle=True, aug_cfg=None, skip_batches=3, **LOADER)
    assert len(got) == len(full) - 3
    assert_batches_equal(got, want)
    assert_batches_equal(got, full[3:])


def test_host_partition_matches_jax():
    seen = []
    for host in range(2):
        got, want = _both(8, max_epochs=1, aug_cfg=None, host_id=host, host_count=2,
                          **{**LOADER, "batch_size": 2})
        assert_batches_equal(got, want)
        seen += [b["coords3d_true"] for b in got]
    rows = np.concatenate(seen).reshape(8, -1)
    assert len(np.unique(rows.round(3), axis=0)) == 8  # disjoint and complete


def test_padded_tail_matches_jax():
    got, want = _both(5, max_epochs=1, aug_cfg=None, shuffle=False, drop_remainder=False,
                      **LOADER)
    assert len(got) == 2
    np.testing.assert_array_equal(got[1]["_pad"], [1, 0, 0, 0])
    assert_batches_equal(got, want)


def test_masks_and_backgrounds_match_jax():
    from metro_pose3d_tpu.config import AugConfig as JaxAug

    got, want = _both(8, {"aug_cfg": Config().aug}, {"aug_cfg": JaxAug()},
                      ds_kw={"masks": True}, max_epochs=1, n_backgrounds=3, **LOADER)
    assert "source_mask" in got[0] and np.any(got[0]["bg_params"][:, 0] == 1)
    assert_batches_equal(got, want)


def test_mixed_batch_iterator_matches_jax():
    """3D rows and 2D-only rows in the MPII convention, remapped by joint
    name into the 3D dataset's, with a skip and masks on."""
    over = {"model.proc_side": "64", "data.source_side": "128", "train.batch_size": "4",
            "train.batch_size_2d": "2", "data.workers": "2"}
    cfg, jcfg = apply_overrides(Config(), over), jax_apply_overrides(JaxConfig(), over)
    got = mixed_batch_iterator(cfg, JaxSynth(8), JaxSynth(8, two_d=True, seed=3),
                               n_backgrounds=2, skip_batches=1, n_occluders=5)
    want = jax_mixed_batch_iterator(jcfg, JaxSynth(8, port=False),
                                    JaxSynth(8, port=False, two_d=True, seed=3),
                                    n_backgrounds=2, skip_batches=1, n_occluders=5)
    got = [next(got) for _ in range(3)]
    want = [next(want) for _ in range(3)]
    assert "_pad" not in got[0] and got[0]["is_3d"].tolist() == [1, 1, 1, 1, 0, 0]
    assert got[0]["coords2d_true"].shape == (6, 17, 2)
    assert np.all(got[0]["joint_validity_2d"][4:, H36M_17.index_of("spin")] == 0)
    assert_batches_equal(got, want)
    # a 3D-only stream keeps the loader's "_pad"
    only3d = next(mixed_batch_iterator(apply_overrides(cfg, {"train.batch_size_2d": "0"}),
                                       JaxSynth(8)))
    np.testing.assert_array_equal(only3d["_pad"], np.ones(4, np.float32))


def test_batches_follow_example_spec():
    spec = example_spec(17, 128, 64)
    got, _ = _both(4, ds_kw={"masks": True}, max_epochs=1, aug_cfg=None, n_backgrounds=2,
                   **LOADER)
    spec.update(source_mask=((128, 128), np.uint8), bg_params=((2,), np.float32),
                _pad=((), np.float32))
    assert set(got[0]) == set(spec)
    for k, (shape, dtype) in spec.items():
        assert got[0][k].shape == (4, *shape) and got[0][k].dtype == dtype, k


def test_occluder_indices_cover_the_real_bank():
    ds = synthetic.SyntheticDataset(n_train=32, imshape=(128, 128))
    for n_bank in (7, 200):
        it = batch_iterator(ds.train_example, 32, H36M_17, batch_size=16, proc_side=32,
                            tile_side=64, aug_cfg=Config().aug, seed=3, max_epochs=4,
                            n_workers=2, n_occluders=n_bank)
        idx = np.concatenate([b["occ_params"][:, 1] for b in it]).astype(int)
        assert idx.min() >= 0 and idx.max() < n_bank
        assert len(np.unique(idx)) == 7 if n_bank == 7 else len(np.unique(idx)) > 60


def test_prepare_one_matches_jax():
    ex = jax_make_example(2, imshape=(256, 256))
    want = jax_prepare_one(ex, JAX_H36M, 64, 128, JaxConfig().aug, (1, 2, 3), 8, 1.1, 2)
    got = prepare_one(to_port(ex), H36M_17, 64, 128, Config().aug, (1, 2, 3), 8, 1.1, 2)
    check_against_jax(got, want, "python")


def test_unknown_pool_type_raises():
    ds = synthetic.SyntheticDataset(n_train=4, imshape=(64, 64))
    with pytest.raises(ValueError, match="pool_type"):
        next(batch_iterator(ds.train_example, 4, H36M_17, batch_size=2, proc_side=32,
                            tile_side=64, pool_type="greenlet"))


def test_prefetch_order_and_exception():
    out = list(prefetch(iter([{"i": np.array(i)} for i in range(7)]), depth=2))
    assert [int(o["i"]) for o in out] == list(range(7))

    def gen():
        yield {"a": np.zeros(1)}
        raise RuntimeError("loader failed")

    it = prefetch(gen())
    next(it)
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)


# --- joint mapping and datasets ---------------------------------------------

def test_joint_mapping_matches_jax():
    m = joint_mapping.name_mapping(MPII_16, H36M_17)
    np.testing.assert_array_equal(m, jax_joint_mapping.name_mapping(JAX_MPII, JAX_H36M))
    assert m[H36M_17.index_of("spin")] == -1
    rng = np.random.default_rng(0)
    prepared = {"coords2d_true": rng.normal(size=(16, 2)).astype(np.float32),
                "coords3d_true": rng.normal(size=(16, 3)).astype(np.float32),
                "joint_validity": np.ones(16, np.float32),
                "joint_validity_2d": np.ones(16, np.float32), "is_3d": np.float32(0)}
    got = joint_mapping.remap_prepared(prepared, m)
    want = jax_joint_mapping.remap_prepared(prepared, m)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dataset_registry(tmp_path):
    ds = get_dataset("synthetic", n_train=3, n_test=2, imshape=(64, 64))
    assert isinstance(ds, synthetic.SyntheticDataset) and ds.n_train == 3
    assert not ds.has_masks and ds.root_joint in ds.joint_info.names
    readers = {"h36m": h36m.H36MDataset, "mpi_inf_3dhp": mpi_inf_3dhp.Mpi3dhpDataset,
               "mpii": mpii.MpiiDataset, "3dpw": tdpw.Tdpw3Dataset}
    for name, cls in readers.items():
        # the reader's class, which (as the JAX readers do) raises on a root
        # without its files
        with pytest.raises(FileNotFoundError) as err:
            get_dataset(name, str(tmp_path))
        assert err.traceback[-1].frame.f_globals["__name__"] == cls.__module__
        assert cls.__module__ == f"metro_pose3d_tpu_torch.data.{cls.__module__.split('.')[-1]}"
    with pytest.raises(KeyError):
        get_dataset("coco")


# --- the synthetic dataset ----------------------------------------------------

def test_synthetic_examples_match_jax():
    for i in range(32):
        want, got = jax_make_example(i), synthetic.make_example(i)
        for attr in ("K", "R", "t", "dist", "world_up"):
            np.testing.assert_array_equal(getattr(got.camera, attr), getattr(want.camera, attr))
        np.testing.assert_array_equal(got.bbox, want.bbox)
        np.testing.assert_array_equal(got.world_coords, want.world_coords)
        assert got.image.shape == want.image.shape == (512, 512, 3)
        np.testing.assert_array_equal(got.image, want.image, err_msg=f"example {i}")
    ds, jds = synthetic.SyntheticDataset(n_test=4), JaxSynth(4, port=False, imshape=(512, 512))
    np.testing.assert_array_equal(ds.test_example(1).world_coords,
                                  jax_make_example(1, 10_000).world_coords)
    np.testing.assert_array_equal(ds.train_example(3).bbox, jds.train_example(3).bbox)


def test_thin_lines_and_discs_are_cv2s():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for _ in range(300):
        p0, p1 = (tuple(int(v) for v in rng.integers(-5, 70, 2)) for _ in range(2))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = np.zeros((64, 64, 3), np.uint8)
        cv2.line(want, p0, p1, color, 1)
        got = np.zeros_like(want)
        synthetic.draw_line(got, p0, p1, color, 1)
        np.testing.assert_array_equal(got, want)  # clipped as cv2 clips, where a line leaves
    for radius in range(1, 12):
        center = tuple(int(v) for v in rng.integers(-3, 67, 2))
        want = np.zeros((64, 64, 3), np.uint8)
        cv2.circle(want, center, radius, (9, 99, 199), -1)
        got = np.zeros_like(want)
        synthetic.draw_disc(got, center, radius, (9, 99, 199))
        np.testing.assert_array_equal(got, want)


def test_thick_lines_near_cv2s():
    """Thick lines are cv2's pixel for pixel: 600 random lines with
    thicknesses 2-9 on gray and colour images from 8^2 to 512^2, end points
    off the image among them (cv2 clips the segment to the image grown by
    the thickness, then fills its quad in 16-bit fixed point)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(6)
    for i in range(600):
        side = int(rng.choice([8, 13, 32, 64, 128, 200, 512]))
        shape = (side, int(rng.choice([side, side // 2 + 3, 2 * side - 1])))
        p0, p1 = (tuple(int(v) for v in rng.integers(-side, 2 * side, 2)) for _ in range(2))
        if i % 7 == 0:
            p1 = p0
        elif i % 11 == 0:
            p1 = (p0[0], p1[1])
        elif i % 13 == 0:
            p1 = (p1[0], p0[1])
        t = int(rng.integers(2, 10))
        gray = i % 2 == 0
        color = 255 if gray else tuple(int(v) for v in rng.integers(0, 256, 3))
        want = np.zeros(shape if gray else (*shape, 3), np.uint8)
        cv2.line(want, p0, p1, color, t)
        got = np.zeros_like(want)
        synthetic.draw_line(got, p0, p1, color, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} {p0} {p1} t={t}")


# --- conventions --------------------------------------------------------------

def test_host_pipeline_imports_neither_torch_nor_cv2():
    """Spawned loader workers import these: they must stay cheap and never
    touch CUDA."""
    mods = ["metro_pose3d_tpu_torch.pipeline.loader", "metro_pose3d_tpu_torch.pipeline.crops",
            "metro_pose3d_tpu_torch.utils.improc", "metro_pose3d_tpu_torch.utils.cache",
            "metro_pose3d_tpu_torch.geom.camera", "metro_pose3d_tpu_torch.geom.joints",
            "metro_pose3d_tpu_torch.geom.boxes", "metro_pose3d_tpu_torch.data.datasets",
            "metro_pose3d_tpu_torch.data.synthetic", "metro_pose3d_tpu_torch.data.h36m",
            "metro_pose3d_tpu_torch.data.mpi_inf_3dhp", "metro_pose3d_tpu_torch.data.mpii",
            "metro_pose3d_tpu_torch.data.tdpw", "metro_pose3d_tpu_torch.native.build",
            "metro_pose3d_tpu_torch.train.joint_mapping", "metro_pose3d_tpu_torch.config"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in ('torch', 'cv2', 'jax') if m in sys.modules)\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
