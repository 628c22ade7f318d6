"""Demo: image (+ boxes) -> 3D skeletons, drawn into a PNG
(`metro_pose3d_tpu/demo.py`).

Loads a model (an exported bundle, a training logdir, or seeded random
weights), estimates every person in a frame with `MultiPersonEstimator` on
the card, and writes the frame with each person's 2D skeleton beside an
orthographic view of the absolute 3D poses. It draws with
`data/synthetic.py`'s rasterisers and writes the PNG with
`utils/improc.py::imwrite_png`: neither matplotlib nor cv2 is needed.

    python -m metro_pose3d_tpu_torch.demo --out=demo.png               # synthetic
    python -m metro_pose3d_tpu_torch.demo --image=frame.jpg \\
        --boxes="100,50,200,400;350,60,180,390" \\
        --bundle=/path/exported --out=demo.png
    python -m metro_pose3d_tpu_torch.demo --video=60 --out=demo        # demo.npz

`--video N` runs N frames of a synthetic moving-people sequence through the
pipelined `estimate_stream` and writes their overlays, uint8 [N, H, W, 3],
as `frames` in `<out>.npz` (the JAX demo's own output where no video codec
is installed).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

# person colours of the overlay and the 3D view, RGB
PALETTE = ((66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88), (171, 71, 188),
           (0, 172, 193))
LINE_WIDTH = 2
JOINT_RADIUS = 3
# the 3D view: matplotlib's default camera of the JAX demo's 3D axes
# (azimuth -60 degrees, elevation 30) over (x, depth, -y), orthographic
VIEW_AZIM, VIEW_ELEV = np.deg2rad(-60.0), np.deg2rad(30.0)
VIEW_MARGIN = 0.1  # of the panel, on each side
PANEL_BACKGROUND = 255
AXIS_COLORS = ((200, 0, 0), (0, 150, 0), (0, 0, 200))  # x, depth, up


def _finite(*points) -> bool:
    """Every coordinate finite and small enough for the rasterisers' int64
    pixel arithmetic (an untrained model can place a joint anywhere)."""
    return all(np.all(np.isfinite(p)) and np.all(np.abs(p) < 2**30) for p in points)


def draw_overlay(image: np.ndarray, results: dict, joint_info) -> np.ndarray:
    """A copy of `image` with each person's 2D skeleton (`pose2d_px`, full-
    image pixels): edges LINE_WIDTH wide and joints as discs, a colour a
    person. Non-finite joints are left out."""
    from metro_pose3d_tpu_torch.data.synthetic import draw_disc, draw_line

    img = np.ascontiguousarray(image.copy())
    for p, pose2d in enumerate(results["pose2d_px"]):
        c = PALETTE[p % len(PALETTE)]
        for a, b in joint_info.edges:
            if _finite(pose2d[a], pose2d[b]):
                draw_line(img, pose2d[a], pose2d[b], c, LINE_WIDTH)
        for pt in pose2d:
            if _finite(pt):
                draw_disc(img, pt, JOINT_RADIUS, c)
    return img


def view_3d(points_mm: np.ndarray) -> np.ndarray:
    """[..., 3] camera-frame points (x right, y down, z depth; mm) -> [..., 2]
    panel coordinates (right, up) of the orthographic view over (x, depth,
    -y) from azimuth VIEW_AZIM and elevation VIEW_ELEV."""
    x, depth, up = points_mm[..., 0], points_mm[..., 2], -points_mm[..., 1]
    ca, sa, ce, se = np.cos(VIEW_AZIM), np.sin(VIEW_AZIM), np.cos(VIEW_ELEV), np.sin(VIEW_ELEV)
    right = -sa * x + ca * depth
    vertical = -se * (ca * x + sa * depth) + ce * up
    return np.stack([right, vertical], axis=-1)


def draw_3d_panel(results: dict, joint_info, side: int) -> np.ndarray:
    """uint8 [side, side, 3]: the absolute 3D poses (`pose3d_abs`) of every
    person in one orthographic view (`view_3d`), scaled to fit the panel
    with equal axes, and the directions of x, depth and up from its corner."""
    from metro_pose3d_tpu_torch.data.synthetic import draw_line

    panel = np.full((side, side, 3), PANEL_BACKGROUND, np.uint8)
    poses = np.asarray(results["pose3d_abs"], np.float64).reshape(-1, joint_info.n_joints, 3)
    uv = view_3d(poses)
    ok = np.isfinite(uv).all(-1)
    if ok.any():
        lo, hi = uv[ok].min(0), uv[ok].max(0)
        scale = (1 - 2 * VIEW_MARGIN) * side / max(float((hi - lo).max()), 1e-6)
        mid = (lo + hi) / 2
        # right -> column, up -> row (rows grow downwards)
        px = np.stack([side / 2 + scale * (uv[..., 0] - mid[0]),
                       side / 2 - scale * (uv[..., 1] - mid[1])], axis=-1)
        for p, pose in enumerate(px):
            c = PALETTE[p % len(PALETTE)]
            for a, b in joint_info.edges:
                if _finite(pose[a], pose[b]):
                    draw_line(panel, pose[a], pose[b], c, LINE_WIDTH)
    origin = np.array([0.12 * side, 0.88 * side])
    for axis, color in zip(np.eye(3), AXIS_COLORS):
        # axis k of (x, depth, up) as a camera-frame direction
        d = view_3d(np.array([axis[0], -axis[2], axis[1]]))
        tip = origin + 0.08 * side * np.array([d[0], -d[1]])
        draw_line(panel, origin, tip, color, LINE_WIDTH)
    return panel


def draw_demo(image: np.ndarray, results: dict, joint_info, out_path: str) -> str:
    """The frame with its 2D overlay, and the 3D panel to its right, as one
    PNG at `out_path` -> out_path."""
    from metro_pose3d_tpu_torch.utils.improc import imwrite_png

    overlay = draw_overlay(image, results, joint_info)
    panel = draw_3d_panel(results, joint_info, overlay.shape[0])
    return imwrite_png(out_path, np.concatenate([overlay, panel], axis=1))


def run_video(est, joint_info, n_frames: int, out_path: str) -> str:
    """N frames of a synthetic moving-people sequence through the pipelined
    `estimate_stream` -> their overlays as `frames` in `out_path` (.npz)."""
    from metro_pose3d_tpu_torch.data.synthetic import make_multiperson_sequence

    # two passes over the generator keep memory at the pipeline's depth: the
    # estimator consumes one lazily, the overlay loop makes the same frames
    # in lockstep (the generator is deterministic)
    def frames():
        for img, boxes, cam, _ in make_multiperson_sequence(3, n_frames, seed=0):
            yield img, boxes, cam

    overlays = [draw_overlay(img, out, joint_info)
                for (img, _, _), out in zip(frames(), est.estimate_stream(frames()))]
    np.savez_compressed(out_path, frames=np.stack(overlays))
    return out_path


def load_model(args, device):
    """-> (cfg, model in eval mode on `device`, joint_info) from `--bundle`,
    `--logdir` (its `config.json` rebuilds the architecture it trained, and
    its latest checkpoint gives the weights), or neither (`Config()` with
    seeded random weights)."""
    import dataclasses
    import json

    from metro_pose3d_tpu_torch import config as config_mod
    from metro_pose3d_tpu_torch.geom.joints import H36M_17

    if args.bundle:
        from metro_pose3d_tpu_torch.export import load_exported

        cfg, model, _ = load_exported(args.bundle, device=device)
        return cfg, model, H36M_17
    cfg = config_mod.Config()
    cfg_json = os.path.join(args.logdir, "config.json") if args.logdir else ""
    if cfg_json and os.path.exists(cfg_json):
        with open(cfg_json) as f:
            stored = json.load(f)
        cfg = config_mod.apply_overrides(config_mod.Config(), {
            f"{sec}.{name}": str(val) for sec, fields in stored.items()
            for name, val in fields.items()})
    if args.logdir:
        from metro_pose3d_tpu_torch.main import _load_model

        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, logdir=args.logdir, load_path=""))
        return cfg, _load_model(cfg, device=device), H36M_17
    from metro_pose3d_tpu_torch.init import init_metro_model

    print("warning: random-init model (pass --bundle or --logdir)")
    return cfg, init_metro_model(cfg.model, 0, device).eval(), H36M_17


def main(argv=None, device=None) -> int:
    """The demo's command line (`argv`, default the process's). The model
    runs on the card unless `device` names another ("cpu" in the tests)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image", default="", help="input image (default: synthetic)")
    ap.add_argument("--boxes", default="",
                    help='person boxes "x,y,w,h;x,y,w,h"; default: synthetic GT')
    ap.add_argument("--bundle", default="", help="exported model dir")
    ap.add_argument("--logdir", default="", help="training logdir (checkpoint)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "metro_demo.png"))
    ap.add_argument("--video", type=int, default=0, metavar="N",
                    help="run an N-frame synthetic sequence through the pipelined "
                         "estimate_stream and write its overlays to <out>.npz")
    args = ap.parse_args(argv)
    if args.image and not args.boxes:
        sys.exit("--boxes required with --image (x,y,w,h;...)")

    from metro_pose3d_tpu_torch.device import resolve_device
    from metro_pose3d_tpu_torch.multiperson import MultiPersonEstimator

    cfg, model, joint_info = load_model(args, resolve_device(device))
    est = MultiPersonEstimator(cfg, model, joint_info)
    if args.video:
        out = args.out if args.out.endswith(".npz") else args.out + ".npz"
        path = run_video(est, joint_info, args.video, out)
        print(f"wrote {path} ({args.video} frames)")
        return 0

    if args.image:
        from metro_pose3d_tpu_torch.utils import improc

        image, camera = improc.imread(args.image), None
        boxes = np.array([[float(v) for v in b.split(",")] for b in args.boxes.split(";")])
    else:
        from metro_pose3d_tpu_torch.data.synthetic import make_multiperson_frame

        image, boxes, camera, _ = make_multiperson_frame(3, seed=0)
    results = est.estimate_frame(image, boxes, camera)
    path = draw_demo(image, results, joint_info, args.out)
    print(f"wrote {path} ({len(boxes)} people)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
