"""Synthetic 3D-pose dataset with exact, closed-form ground truth
(`metro_pose3d_tpu/data/synthetic.py`; the port keeps its own copy).

Renders stick-figure scenes with a known camera: joints are distinctly
colored discs, so end-to-end pipeline tests can verify that the on-device
warp places image content exactly where the host-side GT math says it lands.
Also serves as the data source of the training runs on the card (no licensed
dataset is needed).

The JAX package draws with cv2; the port draws in numpy, so a GPU host
needs no cv2. `make_example` takes the same random draws in the same
order, so the camera, `bbox`, `world_coords` and every later draw are bit for
bit the JAX package's; only the rasterisation may differ. Thin lines and the
filled discs are cv2's (Bresenham's 8-connected line and cv2's filled midpoint
circle, pixel for pixel); a thick line is the quad cv2 fills plus its round
caps, filled by exact scanline spans, which differs from cv2's fixed-point
edge stepping on a few edge pixels (tests/test_torch_pipeline.py states the
share). This module imports neither torch nor cv2.
"""
from __future__ import annotations

import functools

import numpy as np

from metro_pose3d_tpu_torch.geom.camera import Camera
from metro_pose3d_tpu_torch.geom.joints import H36M_17, JointInfo
from metro_pose3d_tpu_torch.pipeline.crops import Example

# Rough adult skeleton in a T-ish pose, pelvis-origin, millimeters,
# y DOWN (camera-like world), matching H36M_17 joint order.
_BASE_POSE = np.array(
    [
        [0, 0, 0],        # pelv
        [-120, 0, 0],     # rhip
        [-130, 430, 30],  # rkne
        [-140, 860, 0],   # rank
        [120, 0, 0],      # lhip
        [130, 430, 30],   # lkne
        [140, 860, 0],    # lank
        [0, -230, -20],   # spin
        [0, -470, 0],     # neck
        [0, -590, 20],    # head
        [0, -700, 0],     # htop
        [200, -440, 0],   # lsho
        [340, -200, 30],  # lelb
        [400, 40, 60],    # lwri
        [-200, -440, 0],  # rsho
        [-340, -200, 30], # relb
        [-400, 40, 60],   # rwri
    ],
    np.float64,
)


@functools.lru_cache(maxsize=None)
def _joint_colors(n: int) -> np.ndarray:
    """n distinct disc colours, uint8 [n, 3] (read-only)."""
    colors = np.random.default_rng(7).integers(60, 255, (n, 3)).astype(np.uint8)
    colors.flags.writeable = False
    return colors


def random_pose(rng: np.random.Generator) -> np.ndarray:
    """Perturbed base pose, rotated about the vertical axis, in world mm."""
    pose = _BASE_POSE + rng.normal(0, 40, _BASE_POSE.shape)
    yaw = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return pose @ rot.T


# --- rasterisation (cv2.line with LINE_8, cv2.circle filled) --------------


@functools.lru_cache(maxsize=None)
def _disc_offsets(radius: int) -> tuple:
    """(dy, dx) offsets of cv2's filled circle of `radius`: the spans its
    midpoint loop draws, as integer arrays (read-only)."""
    spans = {}

    def hline(y, x):
        spans[y] = max(spans.get(y, 0), x)

    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, x in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            hline(y, x)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    ys = np.concatenate([np.full(2 * x + 1, y) for y, x in spans.items()])
    xs = np.concatenate([np.arange(-x, x + 1) for x in spans.values()])
    ys.flags.writeable = xs.flags.writeable = False
    return ys, xs


def _paint(img: np.ndarray, ys: np.ndarray, xs: np.ndarray, color) -> None:
    ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[ok], xs[ok]] = color


def draw_disc(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1), pixel for pixel."""
    dy, dx = _disc_offsets(int(radius))
    _paint(img, dy + int(center[1]), dx + int(center[0]), color)


def _thin_line(img: np.ndarray, p0, p1, color) -> None:
    """cv2's 8-connected line from its left end: step k along the major axis
    moves the minor one by floor((2 b k + a - 1) / (2 a))."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    a, b = max(dx, dy), min(dx, dy)
    k = np.arange(a + 1)
    m = (2 * b * k + a - 1) // (2 * a) if a else k
    if dy > dx:
        _paint(img, y0 + sy * k, x0 + m, color)
    else:
        _paint(img, y0 + sy * m, x0 + k, color)


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """The quad cv2 fills around the segment (half width (t + t % 2) / 2,
    corners rounded to 1/65536 px as cv2 does) by scanline spans from
    round(left) to round(right), then its round caps of radius (t + 1) // 2."""
    h, w = img.shape[:2]
    ddx, ddy = float(p0[0] - p1[0]), float(p1[1] - p0[1])
    r2 = ddx * ddx + ddy * ddy
    if r2 > 0:
        r = (thickness + (thickness & 1)) * 32768.0 / np.sqrt(r2)
        dp = np.array([np.round(ddy * r), np.round(ddx * r)]) / 65536.0
        a, b = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
        quad = np.stack([a + dp, a - dp, b - dp, b + dp])
        y_lo = max(int(np.floor(quad[:, 1].min() + 0.5)), 0)
        y_hi = min(int(np.floor(quad[:, 1].max() + 0.5)), h - 1)
        if y_lo <= y_hi:
            ys = np.arange(y_lo, y_hi + 1, dtype=np.float64)
            lo = np.full(len(ys), np.inf)
            hi = np.full(len(ys), -np.inf)
            for e in range(4):
                (ax, ay), (bx, by) = quad[e], quad[(e + 1) % 4]
                near = (ys >= min(ay, by) - 0.5) & (ys <= max(ay, by) + 0.5)
                if ay == by:
                    xl, xh = min(ax, bx), max(ax, bx)
                else:
                    xl = xh = ax + (bx - ax) * np.clip((ys - ay) / (by - ay), 0.0, 1.0)
                lo = np.where(near, np.minimum(lo, xl), lo)
                hi = np.where(near, np.maximum(hi, xh), hi)
            left = np.maximum(np.floor(lo + 0.5), 0)
            right = np.minimum(np.floor(hi + 0.5), w - 1)
            rows = np.isfinite(lo) & (left <= right)
            left, right = left[rows].astype(np.int64), right[rows].astype(np.int64)
            # the spans' pixels as flat indices: O(painted), not O(box)
            n = right - left + 1
            xs = np.arange(n.sum()) + np.repeat(left - (np.cumsum(n) - n), n)
            img[np.repeat(ys[rows].astype(np.int64), n), xs] = color
    cap = (thickness + 1) // 2
    draw_disc(img, p0, cap, color)
    draw_disc(img, p1, cap, color)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """cv2.line(img, p0, p1, color, thickness) with LINE_8, in numpy."""
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        _thin_line(img, p0, p1, color)
    else:
        _thick_line(img, p0, p1, color, int(thickness))


def make_example(index: int, seed: int = 0, imshape=(512, 512)) -> Example:
    """Deterministic synthetic example #index."""
    rng = np.random.default_rng((seed, index))
    h, w = imshape
    cam = Camera.from_fov(55.0, imshape)
    cam.world_up = np.array([0.0, -1.0, 0.0])

    # place the person in front of the camera with some lateral offset
    depth = rng.uniform(2500, 5500)
    lateral = rng.uniform(-0.25, 0.25, 2) * depth
    root_world = np.array([lateral[0], lateral[1] * 0.3, depth])
    world = random_pose(rng) + root_world

    img = np.empty((h, w, 3), np.uint8)
    # background; a whole row broadcast over the rows, which numpy copies
    # far faster than the 3 values over every pixel
    img[...] = np.tile(rng.integers(10, 80, 3).astype(np.uint8), w).reshape(w, 3)
    # low-frequency clutter
    for _ in range(12):
        p1 = rng.integers(0, (w, h)).astype(int)
        p2 = rng.integers(0, (w, h)).astype(int)
        color = tuple(int(v) for v in rng.integers(0, 120, 3))
        draw_line(img, p1, p2, color, int(rng.integers(1, 8)))

    px = cam.world_to_image(world)
    colors = _joint_colors(len(world))
    radius = max(2, int(180 / depth * cam.K[0, 0] / 55))
    for p, c in zip(px, colors):
        if np.all(np.isfinite(p)):
            draw_disc(img, (int(round(p[0])), int(round(p[1]))), radius, c)

    lo = px.min(0) - 60
    hi = px.max(0) + 60
    bbox = np.array([lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]])
    return Example(image=img, bbox=bbox, camera=cam, world_coords=world)


class SyntheticDataset:
    joint_info: JointInfo = H36M_17
    root_joint = "pelv"
    has_masks = False

    def __init__(self, n_train=512, n_test=64, seed=0, imshape=(512, 512)):
        self.n_train = n_train
        self.n_test = n_test
        self.seed = seed
        self.imshape = imshape

    def train_example(self, i: int) -> Example:
        return make_example(i, seed=self.seed, imshape=self.imshape)

    def test_example(self, i: int) -> Example:
        return make_example(i, seed=self.seed + 10_000, imshape=self.imshape)
