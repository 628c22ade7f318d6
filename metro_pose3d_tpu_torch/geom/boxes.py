"""Axis-aligned box utilities on `[x, y, w, h]` arrays (numpy, host-side).

Responsibility-parity with the reference's `src/boxlib.py` (SURVEY.md §3:
expand, expand_to_square, center, intersection, full_box, box_around).
All functions are pure and accept/return float64 numpy arrays. The port's
own copy of the JAX package's `geom/boxes.py`.
"""
from __future__ import annotations

import numpy as np


def center(box):
    """Center point (x, y) of an [x, y, w, h] box."""
    box = np.asarray(box, np.float64)
    return box[..., :2] + box[..., 2:4] / 2


def corners(box):
    """The four corners of the box, shape (..., 4, 2), order TL, TR, BR, BL."""
    box = np.asarray(box, np.float64)
    x, y, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return np.stack(
        [
            np.stack([x, y], -1),
            np.stack([x + w, y], -1),
            np.stack([x + w, y + h], -1),
            np.stack([x, y + h], -1),
        ],
        axis=-2,
    )


def box_around(center_point, size):
    """Box of `size` (scalar or (w,h)) centered on `center_point`."""
    center_point = np.asarray(center_point, np.float64)
    size = np.broadcast_to(np.asarray(size, np.float64), center_point.shape)
    return np.concatenate([center_point - size / 2, size], axis=-1)


def expand(box, factor):
    """Scale the box about its center by `factor` (scalar or per-axis)."""
    box = np.asarray(box, np.float64)
    return box_around(center(box), box[..., 2:4] * factor)


def expand_to_square(box, factor=1.0):
    """Smallest square containing the box (optionally expanded), same center."""
    box = np.asarray(box, np.float64)
    side = np.maximum(box[..., 2], box[..., 3]) * factor
    return box_around(center(box), np.stack([side, side], axis=-1))


def intersection(box_a, box_b):
    """Intersection box; w/h clipped at 0 when disjoint."""
    box_a = np.asarray(box_a, np.float64)
    box_b = np.asarray(box_b, np.float64)
    x1 = np.maximum(box_a[..., 0], box_b[..., 0])
    y1 = np.maximum(box_a[..., 1], box_b[..., 1])
    x2 = np.minimum(box_a[..., 0] + box_a[..., 2], box_b[..., 0] + box_b[..., 2])
    y2 = np.minimum(box_a[..., 1] + box_a[..., 3], box_b[..., 1] + box_b[..., 3])
    return np.stack([x1, y1, np.maximum(x2 - x1, 0), np.maximum(y2 - y1, 0)], -1)


def area(box):
    box = np.asarray(box, np.float64)
    return box[..., 2] * box[..., 3]


def iou(box_a, box_b):
    inter = area(intersection(box_a, box_b))
    union = area(box_a) + area(box_b) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def full_box(imshape):
    """Box covering a whole (height, width) image."""
    h, w = imshape[:2]
    return np.array([0.0, 0.0, float(w), float(h)])


def contains(box, points):
    """Whether each (..., 2) point lies inside the box."""
    box = np.asarray(box, np.float64)
    points = np.asarray(points, np.float64)
    lo = box[..., None, :2]
    hi = lo + box[..., None, 2:4]
    return np.all((points >= lo) & (points <= hi), axis=-1)


def bb_of_points(points):
    """Tight box around (..., N, 2) points."""
    points = np.asarray(points, np.float64)
    lo = points.min(axis=-2)
    hi = points.max(axis=-2)
    return np.concatenate([lo, hi - lo], axis=-1)


def clip_to_image(box, imshape):
    """Clip box to image bounds (height, width)."""
    return intersection(box, full_box(imshape))
