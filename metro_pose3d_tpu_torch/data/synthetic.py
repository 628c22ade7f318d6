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
bit the JAX package's, and so is the image: lines (thin and thick, clipped
as cv2 clips them) and filled discs are cv2's pixel for pixel, with cv2's
fixed-point polygon fill for a thick line's quad
(tests/test_torch_pipeline.py fuzzes them against cv2). This module imports
neither torch nor cv2.
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
    moves the minor one by floor((2 b k + a - 1) / (2 a)). The end points
    must lie in the image (`_line8` clips them first)."""
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


# cv2's fixed-point drawing: XY_SHIFT fractional bits
_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's clipLine to [0, w) x [0, h) (Cohen-Sutherland, each step
    through a double, truncated): the clipped end points, or None where the
    segment misses the rectangle."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def _line8(img: np.ndarray, p0, p1, color) -> None:
    """cv2's integer LINE_8 line: clipped to the image where an end point
    leaves it, then `_thin_line` from the clipped ends."""
    h, w = img.shape[:2]
    if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h):
        clipped = _clip_line(w, h, *p0, *p1)
        if clipped is None:
            return
        p0, p1 = clipped[:2], clipped[2:]
    _thin_line(img, p0, p1, color)


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """cv2's Line2: an 8-connected line between end points with 16
    fractional bits, clipped in fixed point, the minor coordinate stepped in
    fixed point from the first end, rounded by adding half a pixel."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << _SHIFT, h << _SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    horizontal = abs(dx) > abs(dy)
    if (dx if horizontal else dy) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    _paint(img, np.array([(y2 + _HALF) >> _SHIFT]), np.array([(x2 + _HALF) >> _SHIFT]), color)
    if horizontal:
        step = _tdiv(dy * _ONE, dx | 1)
        k = np.arange(((x2 - x1) >> _SHIFT) + 1, dtype=np.int64)
        _paint(img, (y1 + _HALF + k * step) >> _SHIFT, ((x1 + _HALF) >> _SHIFT) + k, color)
    else:
        step = _tdiv(dx * _ONE, dy | 1)
        k = np.arange(((y2 - y1) >> _SHIFT) + 1, dtype=np.int64)
        _paint(img, ((y1 + _HALF) >> _SHIFT) + k, (x1 + _HALF + k * step) >> _SHIFT, color)


def _fill_convex(img: np.ndarray, v: list, color) -> None:
    """cv2's FillConvexPoly with LINE_8 and 16 fractional bits: the edges by
    `_line_fixed`, then from the top vertex down a left and a right edge
    whose x is stepped in fixed point (dx rounded, C's division), each row
    filled between the two x's rounded by adding half a pixel. The scan runs
    a row at a time in cv2; here it runs a stretch of rows between two
    vertices at a time, with the same integer arithmetic."""
    h, w = img.shape[:2]
    n = len(v)
    for i in range(n):
        _line_fixed(img, v[i - 1], v[i], color)
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + _HALF) >> _SHIFT, (max(xs) + _HALF) >> _SHIFT
    ymin, ymax = (min(ys) + _HALF) >> _SHIFT, (max(ys) + _HALF) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [vertex index, direction, x, dx, end row]
    edge = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
    budget = n  # cv2's `edges`: every vertex is walked past once
    y = ymin
    rows, lefts, rights = [], [], []
    while y <= ymax:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                budget -= 1
                if budget < 0:
                    break
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    xs_, xe = v[idx0][0], v[idx][0]
                    e[:] = [idx, di, xs_, _tdiv((xe - xs_) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + di) % n
        if budget < 0:
            break
        stop = min(edge[0][4], edge[1][4], ymax + 1)
        k = np.arange(stop - y, dtype=np.int64)
        xa, xb = edge[0][2] + k * edge[0][3], edge[1][2] + k * edge[1][3]
        rows.append(y + k)
        lefts.append((np.minimum(xa, xb) + _HALF) >> _SHIFT)
        rights.append((np.maximum(xa, xb) + _HALF) >> _SHIFT)
        edge[0][2] += (stop - y) * edge[0][3]
        edge[1][2] += (stop - y) * edge[1][3]
        y = stop
    if not rows:
        return
    rows, left, right = np.concatenate(rows), np.concatenate(lefts), np.concatenate(rights)
    keep = (rows >= 0) & (right >= 0) & (left < w)
    rows, left, right = rows[keep], np.maximum(left[keep], 0), np.minimum(right[keep], w - 1)
    # the spans' pixels as flat indices: O(painted), not O(box)
    cnt = right - left + 1
    cols = np.arange(cnt.sum()) + np.repeat(left - (np.cumsum(cnt) - cnt), cnt)
    img[np.repeat(rows, cnt), cols] = color


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """cv2's thick LINE_8 line: the segment clipped to the image grown by
    the thickness on every side, the quad around it (half width
    (t + t % 2) / 2, corners rounded to 1/65536 px) by `_fill_convex`, and
    round caps of radius (t + 1) // 2 at the clipped ends."""
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, p0[0] + t, p0[1] + t, p1[0] + t, p1[1] + t)
    if clipped is None:
        return
    p0, p1 = (clipped[0] - t, clipped[1] - t), (clipped[2] - t, clipped[3] - t)
    ddx, ddy = float(p0[0] - p1[0]), float(p1[1] - p0[1])
    r2 = ddx * ddx + ddy * ddy
    if r2 > np.finfo(np.float64).eps:
        r = (t + (t & 1)) * 32768.0 / np.sqrt(r2)
        # np.round: half to even, as cvRound
        dpx, dpy = int(np.round(ddy * r)), int(np.round(ddx * r))
        a = (p0[0] << _SHIFT, p0[1] << _SHIFT)
        b = (p1[0] << _SHIFT, p1[1] << _SHIFT)
        _fill_convex(img, [(a[0] + dpx, a[1] + dpy), (a[0] - dpx, a[1] - dpy),
                           (b[0] - dpx, b[1] - dpy), (b[0] + dpx, b[1] + dpy)], color)
    cap = (t + 1) // 2
    draw_disc(img, p0, cap, color)
    draw_disc(img, p1, cap, color)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """cv2.line(img, p0, p1, color, thickness) with LINE_8, in numpy."""
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        _line8(img, p0, p1, color)
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


def _make_frame_background(rng: np.random.Generator, imshape) -> np.ndarray:
    """Shared multi-person frame background: dark fill + random clutter."""
    h, w = imshape
    img = np.empty((h, w, 3), np.uint8)
    img[...] = np.tile(rng.integers(10, 70, 3).astype(np.uint8), w).reshape(w, 3)
    for _ in range(16):
        p1 = rng.integers(0, (w, h)).astype(int)
        p2 = rng.integers(0, (w, h)).astype(int)
        color = tuple(int(v) for v in rng.integers(0, 110, 3))
        draw_line(img, p1, p2, color, int(rng.integers(1, 6)))
    return img


def _render_person(img: np.ndarray, cam: Camera, world: np.ndarray, colors) -> list:
    """Draw one person's joints into `img`; returns their [x, y, w, h] box
    (the joints' extent plus a 50 px detector margin). The static frame and
    the sequence both draw through it."""
    px = cam.world_to_image(world)
    depth = float(world[:, 2].mean())
    radius = max(2, int(180 / depth * cam.K[0, 0] / 55))
    for pt, c in zip(px, colors):
        if np.all(np.isfinite(pt)):
            draw_disc(img, (int(round(pt[0])), int(round(pt[1]))), radius, c)
    lo, hi = px.min(0) - 50, px.max(0) + 50
    return [lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]]


def make_multiperson_frame(n_persons: int, seed: int = 0, imshape=(512, 910)):
    """One synthetic frame with several people under a single camera.

    -> (image uint8 RGB, boxes [P,4], Camera, world [P,17,3] mm): the
    input of the multi-person estimator (`multiperson.py`) without
    detector or dataset assets.
    """
    rng = np.random.default_rng((seed, 777))
    cam = Camera.from_fov(65.0, imshape)
    img = _make_frame_background(rng, imshape)

    worlds, boxes = [], []
    colors = _joint_colors(len(_BASE_POSE))
    for p in range(n_persons):
        depth = rng.uniform(3000, 6500)
        # spread people horizontally so boxes don't fully overlap
        x = (p - (n_persons - 1) / 2) * depth * 0.45 / max(n_persons / 3, 1)
        root = np.array([x, rng.uniform(-0.05, 0.1) * depth, depth])
        world = random_pose(rng) + root
        boxes.append(_render_person(img, cam, world, colors))
        worlds.append(world)
    return img, np.asarray(boxes, np.float64), cam, np.stack(worlds)


def make_multiperson_sequence(n_persons: int, n_frames: int, seed: int = 0,
                              imshape=(512, 910)):
    """Smoothly moving synthetic video: yields (image, boxes, Camera, world)
    per frame. People walk sinusoidal tracks in x and depth while their pose
    blends between two random poses; the background and the camera stay
    fixed, as for a static camera. Feeds `MultiPersonEstimator.estimate_stream`
    without video assets."""
    rng = np.random.default_rng((seed, 778))
    cam = Camera.from_fov(65.0, imshape)
    bg = _make_frame_background(rng, imshape)

    colors = _joint_colors(len(_BASE_POSE))
    tracks = []
    for p in range(n_persons):
        depth0 = rng.uniform(3500, 6000)
        x0 = (p - (n_persons - 1) / 2) * depth0 * 0.45 / max(n_persons / 3, 1)
        tracks.append({
            "x0": x0, "depth0": depth0,
            "amp_x": rng.uniform(200, 600), "amp_z": rng.uniform(150, 500),
            "phase": rng.uniform(0, 2 * np.pi),
            "period": rng.uniform(0.6, 1.4) * max(n_frames, 2),
            "pose_a": random_pose(rng), "pose_b": random_pose(rng),
            "y_frac": rng.uniform(-0.05, 0.1),
        })

    for f in range(n_frames):
        img = bg.copy()
        worlds, boxes = [], []
        for tr in tracks:
            t = 2 * np.pi * f / tr["period"] + tr["phase"]
            root = np.array([
                tr["x0"] + tr["amp_x"] * np.sin(t),
                tr["y_frac"] * tr["depth0"],
                tr["depth0"] + tr["amp_z"] * np.cos(t),
            ])
            # the pose blends a -> b -> a over the sequence
            alpha = 0.5 - 0.5 * np.cos(2 * np.pi * f / max(n_frames, 2))
            world = (1 - alpha) * tr["pose_a"] + alpha * tr["pose_b"] + root
            boxes.append(_render_person(img, cam, world, colors))
            worlds.append(world)
        yield img, np.asarray(boxes, np.float64), cam, np.stack(worlds)


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
