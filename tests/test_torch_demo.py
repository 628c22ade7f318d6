"""The port's demo (`metro_pose3d_tpu_torch/demo.py`) on the CPU, at a tiny
size (`Config` patched as `tests/test_demo.py` patches the JAX package's).

It writes a PNG that the port's own reader decodes and an npz of overlay
frames with `--video`; the poses it draws from an exported bundle of
converted JAX weights are JAX `MultiPersonEstimator.estimate_frame`'s on the
same synthetic frame, within `tests/test_torch_multiperson.py`'s tolerance;
a `--logdir` rebuilds its architecture from the logdir's `config.json`; and
it runs without cv2 or matplotlib. The JAX demo draws with cv2's
anti-aliased lines and matplotlib, so the pixels are not held to its
pixels; the drawing is checked where it must land.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu_torch import demo
from metro_pose3d_tpu_torch.geom.joints import H36M_17
from metro_pose3d_tpu_torch.utils import improc

from test_torch_multiperson import _assert_frame_close, _zoom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.backbone": "tiny", "model.proc_side": "64", "model.depth": "4",
        "model.compute_dtype": "float32", "data.source_side": "128"}
FRAME = (512, 910)  # make_multiperson_frame's default


def _tiny_port_cfg():
    from metro_pose3d_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), TINY)


@pytest.fixture
def tiny(monkeypatch):
    """`Config()` is the tiny model inside the demo."""
    import metro_pose3d_tpu_torch.config as config_mod

    cfg = _tiny_port_cfg()
    monkeypatch.setattr(config_mod, "Config", lambda: cfg)
    return cfg


@pytest.fixture
def drawn(monkeypatch):
    """The (image, results) of every `draw_demo` call."""
    calls, real = [], demo.draw_demo

    def spy(image, results, joint_info, out_path):
        calls.append((image, results))
        return real(image, results, joint_info, out_path)

    monkeypatch.setattr(demo, "draw_demo", spy)
    return calls


def test_demo_writes_a_png_the_port_decodes(tmp_path, tiny, drawn):
    out = tmp_path / "demo.png"
    assert demo.main(["--out", str(out)], device="cpu") == 0
    img = improc.imread(str(out))
    (frame, results), = drawn
    h, w = FRAME
    assert img.shape == (h, w + h, 3) and frame.shape == (h, w, 3)
    # the overlay is the frame with skeletons on it (random weights draw
    # small ones), the panel right of it
    changed = (img[:, :w] != frame).any(-1)
    assert changed.sum() > 3 * 29 and changed.mean() < 0.2  # a disc of radius 3: 29 pixels
    assert (img[:, w:] != demo.PANEL_BACKGROUND).any(-1).mean() > 0.001
    assert results["pose2d_px"].shape == (3, 17, 2)
    # each person's joints are drawn in its colour where they lie in the frame
    for p, pose2d in enumerate(results["pose2d_px"]):
        inside = [pt for pt in pose2d.astype(int) if 0 <= pt[0] < w and 0 <= pt[1] < h]
        for x, y in inside:
            assert tuple(img[y, x]) in demo.PALETTE, (p, x, y)


def test_demo_video_writes_overlay_frames(tmp_path, tiny):
    out = tmp_path / "clip"
    assert demo.main(["--video", "3", "--out", str(out)], device="cpu") == 0
    frames = np.load(str(out) + ".npz")["frames"]
    assert frames.shape == (3, *FRAME, 3) and frames.dtype == np.uint8
    from metro_pose3d_tpu_torch.data.synthetic import make_multiperson_sequence

    for got, (img, *_) in zip(frames, make_multiperson_sequence(3, 3, seed=0)):
        changed = (got != img).any(-1)
        assert changed.sum() > 3 * 29 and changed.mean() < 0.2


def test_demo_draws_the_jax_estimators_poses_from_a_bundle(tmp_path, drawn):
    """--bundle of converted JAX weights: the poses drawn are the JAX
    estimator's on the same frame."""
    from metro_pose3d_tpu import multiperson as jmp
    from metro_pose3d_tpu.config import Config as JaxConfig
    from metro_pose3d_tpu.config import apply_overrides as jax_apply_overrides
    from metro_pose3d_tpu.data.synthetic import make_multiperson_frame
    from metro_pose3d_tpu.geom.joints import H36M_17 as JAX_H36M_17
    from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
    from metro_pose3d_tpu_torch.convert import load_flax_variables
    from metro_pose3d_tpu_torch.export import export_model
    from metro_pose3d_tpu_torch.models.metro import MetroModel

    jcfg, cfg = jax_apply_overrides(JaxConfig(), TINY), _tiny_port_cfg()
    variables = FlaxMetro(jcfg.model).init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3)),
                                           train=False)
    bundle = export_model(cfg, load_flax_variables(MetroModel(cfg.model), variables),
                          str(tmp_path / "bundle"))
    assert demo.main(["--bundle", bundle, "--out", str(tmp_path / "b.png")], device="cpu") == 0
    (frame, got), = drawn
    image, boxes, cam, _ = make_multiperson_frame(3, seed=0)
    np.testing.assert_array_equal(frame, image)
    want = jmp.MultiPersonEstimator(jcfg, variables, JAX_H36M_17).estimate_frame(image, boxes, cam)
    _assert_frame_close(got, want, _zoom(boxes, cam, cfg))


def test_demo_logdir_rebuilds_its_architecture(tmp_path, drawn):
    """--logdir: `config.json` there makes the tiny model out of the default
    `Config()`, and the latest checkpoint gives its weights."""
    from metro_pose3d_tpu_torch.config import config_to_json
    from metro_pose3d_tpu_torch.data.synthetic import make_multiperson_frame
    from metro_pose3d_tpu_torch.models.metro import MetroModel
    from metro_pose3d_tpu_torch.multiperson import MultiPersonEstimator
    from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
    from metro_pose3d_tpu_torch.train.state import create_train_state

    cfg = _tiny_port_cfg()
    logdir = tmp_path / "run"
    logdir.mkdir()
    (logdir / "config.json").write_text(config_to_json(cfg))
    state = create_train_state(cfg, "cpu", seed=5)
    ckpt = Checkpointer(str(logdir))
    ckpt.save(7, state)
    ckpt.wait()
    assert demo.main(["--logdir", str(logdir), "--out", str(tmp_path / "l.png")],
                     device="cpu") == 0
    (_, got), = drawn
    model = MetroModel(cfg.model)
    model.load_state_dict(state.model.state_dict())
    image, boxes, cam, _ = make_multiperson_frame(3, seed=0)
    want = MultiPersonEstimator(cfg, model.eval(), H36M_17).estimate_frame(image, boxes, cam)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_demo_image_and_boxes(tmp_path, tiny, drawn):
    from metro_pose3d_tpu_torch.data.synthetic import make_multiperson_frame

    image, boxes, _, _ = make_multiperson_frame(2, seed=3, imshape=(300, 401))
    path = improc.imwrite_png(str(tmp_path / "frame.png"), image)
    spec = ";".join(",".join(f"{v:.3f}" for v in b) for b in boxes)
    assert demo.main(["--image", path, "--boxes", spec, "--out", str(tmp_path / "o.png")],
                     device="cpu") == 0
    (frame, results), = drawn
    np.testing.assert_array_equal(frame, image)
    assert results["pose3d_abs"].shape == (2, 17, 3)
    assert improc.imread(str(tmp_path / "o.png")).shape == (300, 401 + 300, 3)


def test_demo_requires_boxes_with_image(tmp_path):
    path = improc.imwrite_png(str(tmp_path / "x.png"), np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(SystemExit):
        demo.main(["--image", path, "--out", str(tmp_path / "o.png")], device="cpu")


def test_3d_view_axes():
    """As matplotlib's default 3D camera shows (x, depth, up): up straight
    up, x to the right and down (towards the viewer), depth to the right
    and up (away from it); the view is orthographic (linear)."""
    right, up = demo.view_3d(np.array([[1000.0, 0, 0], [0, -1000.0, 0], [0, 0, 1000.0]])).T
    assert up[1] > 0 and right[1] == 0  # -y is straight up
    assert right[0] > 0 and up[0] < 0 and right[2] > 0 and up[2] > 0
    p = np.random.RandomState(0).normal(0, 500, (5, 3))
    np.testing.assert_allclose(demo.view_3d(2 * p), 2 * demo.view_3d(p))


def test_demo_imports_neither_cv2_nor_matplotlib(tmp_path):
    out = tmp_path / "s.png"
    code = (
        "import sys\n"
        "import metro_pose3d_tpu_torch.config as c\n"
        f"cfg = c.apply_overrides(c.Config(), {TINY!r})\n"
        "c.Config = lambda: cfg\n"
        "from metro_pose3d_tpu_torch import demo\n"
        f"assert demo.main(['--out', {str(out)!r}], device='cpu') == 0\n"
        "bad = sorted(m for m in ('cv2', 'matplotlib', 'jax') if m in sys.modules)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert improc.imread(str(out)).shape == (*FRAME[:1], FRAME[1] + FRAME[0], 3)
    assert torch.get_num_threads() > 0
