"""The port's own copies of the JAX package's numpy-only modules cannot drift:
`config`, `reference_constants`, `geom/joints.py`, `geom/camera.py`. And the
port's entry points run on the card unless asked for the CPU."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from metro_pose3d_tpu import config as jax_config
from metro_pose3d_tpu import reference_constants as jax_constants
from metro_pose3d_tpu.geom import camera as jax_camera
from metro_pose3d_tpu.geom import joints as jax_joints
from metro_pose3d_tpu_torch import config as port_config
from metro_pose3d_tpu_torch import reference_constants as port_constants
from metro_pose3d_tpu_torch.geom import camera as port_camera
from metro_pose3d_tpu_torch.geom import joints as port_joints

SECTIONS = [f.name for f in dataclasses.fields(jax_config.Config)]


def test_config_sections_are_the_same():
    assert [f.name for f in dataclasses.fields(port_config.Config)] == SECTIONS


@pytest.mark.parametrize("section", SECTIONS)
def test_config_defaults_match_field_by_field(section):
    ours = getattr(port_config.Config(), section)
    theirs = getattr(jax_config.Config(), section)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in
                                                          dataclasses.fields(theirs)]
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert type(a) is type(b) and a == b, f"{section}.{f.name}: {a!r} != {b!r}"
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_every_reference_constant_matches():
    public = lambda m: {k: v for k, v in vars(m).items() if k.isupper()}  # noqa: E731
    ours, theirs = public(port_constants), public(jax_constants)
    assert set(ours) == set(theirs) and len(theirs) >= 20
    for name, value in theirs.items():
        assert type(ours[name]) is type(value) and ours[name] == value, name


def _load(module, text):
    """A config JSON as both packages read it back (export.py, demo.py of the
    JAX package): flattened to dotted overrides of Config()."""
    flat = {f"{sec}.{name}": str(val) for sec, fields in json.loads(text).items()
            for name, val in fields.items()}
    return module.apply_overrides(module.Config(), flat)


@pytest.mark.parametrize("writer,reader", [(jax_config, port_config), (port_config, jax_config)],
                         ids=["jax_to_port", "port_to_jax"])
def test_config_json_loads_in_the_other_package(writer, reader):
    over = {"model.backbone": "resnet34", "model.preactivation": "false",
            "model.conv_padding": "torch", "model.stride_test": "8", "train.base_lr": "3e-4",
            "train.backbone_init": "r34.npz", "eval.flip_tta": "false", "data.cycle_batches": "2"}
    cfg = writer.apply_overrides(writer.Config(), over)
    text = writer.config_to_json(cfg)
    back = _load(reader, text)
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert reader.config_to_json(back) == text
    assert back.model.at_phase(train=False).stride == 8 and back.model.at_phase(True).stride == 16


def test_overrides_behave_alike():
    over = {"model.depth": "4", "train.fused_adam": "true", "train.base_lr": "3e-4"}
    a = port_config.apply_overrides(port_config.Config(), over)
    b = jax_config.apply_overrides(jax_config.Config(), over)
    assert dataclasses.asdict(a) == dataclasses.asdict(b) and a.train.fused_adam is True
    for module in (port_config, jax_config):
        with pytest.raises(ValueError, match="unknown config field"):
            module.apply_overrides(module.Config(), {"model.nope": "1"})
        with pytest.raises(ValueError, match="section.field"):
            module.apply_overrides(module.Config(), {"model": "1"})
    assert port_config.Config().model.heatmap_side == jax_config.Config().model.heatmap_side


def test_matmul_precision_has_its_torch_meaning():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        port_config.apply_matmul_precision(port_config.Config())  # "": leaves them
        assert torch.backends.cudnn.allow_tf32
        port_config.apply_matmul_precision(port_config.apply_overrides(
            port_config.Config(), {"model.matmul_precision": "highest"}))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_predict_fn_honours_matmul_precision():
    from metro_pose3d_tpu_torch.evaluation.engine import make_predict_fn

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        mirror = port_joints.get_joint_info("h36m_17").mirror_mapping
        make_predict_fn(port_config.Config(), mirror)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        make_predict_fn(port_config.apply_overrides(
            port_config.Config(), {"model.matmul_precision": "highest"}), mirror)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_joint_tables_match():
    for name in ("h36m_17", "mpii_16", "mpi_inf_3dhp_17", "smpl_24"):
        ours, theirs = port_joints.get_joint_info(name), jax_joints.get_joint_info(name)
        assert ours.names == theirs.names and ours.edges == theirs.edges
        np.testing.assert_array_equal(ours.mirror_mapping, theirs.mirror_mapping)
    np.testing.assert_array_equal(port_joints.SMPL_EVAL_14_INDICES, jax_joints.SMPL_EVAL_14_INDICES)
    np.testing.assert_array_equal(port_joints.MPI3DHP_EVAL_14_INDICES,
                                  jax_joints.MPI3DHP_EVAL_14_INDICES)


def test_camera_copies_give_the_same_warp_parameters():
    rng = np.random.RandomState(0)
    params = []
    for module in (port_camera, jax_camera):
        r = np.random.RandomState(5)
        f = 512 * r.uniform(0.9, 1.3)
        src = module.Camera([[f, 0, 255.5], [0, f, 255.5], [0, 0, 1]],
                            distortion_coeffs=r.uniform(-1, 1, 5) * [0.15, 0.03, 5e-4, 5e-4, 0.01])
        crop = src.copy()
        crop.undistort()
        crop.turn_towards(1000 * np.array([0.1, -0.05, 1.0]))
        crop.rotate(0.3)
        crop.zoom(0.6)
        crop.center_principal_point((256, 256))
        crop.horizontal_flip()
        p = module.get_warp_params(src, crop)
        pts = rng.uniform(0, 255, (4, 2)) if not params else params[0][1]
        params.append((p, pts, module.reproject_image_points(pts, crop, src),
                       src.world_to_image(src.image_to_world(pts, 3000.0))))
    (pa, pts, ra, wa), (pb, _, rb, wb) = params
    for key in ("H", "K", "dist"):
        np.testing.assert_array_equal(pa[key], pb[key])
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_allclose(wa, pts, atol=1e-6)  # distort and undistort invert


@pytest.mark.parametrize("name", ["entry", "train", "create_train_state", "init_metro_model"])
def test_entry_points_need_the_card_unless_asked_for_the_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    from metro_pose3d_tpu_torch.entry import entry
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.train.state import create_train_state
    from metro_pose3d_tpu_torch.train.trainer import train

    cfg = port_config.apply_overrides(port_config.Config(), {
        "model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
        "train.validate_every": "0", "train.logdir": str(tmp_path)})
    calls = {"entry": lambda: entry(),
             "train": lambda: train(cfg, iter([]), max_steps=1),
             "create_train_state": lambda: create_train_state(cfg),
             "init_metro_model": lambda: init_metro_model(cfg.model, seed=0)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[name]()


def test_resolve_device():
    from metro_pose3d_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
