"""A frozen numpy pinhole camera, enough to synthesise crop warps: a source
camera with lens distortion (k1, k2, p1, p2, k3), and a virtual crop camera
at its optical centre, turned, rolled and zoomed. R is world -> camera, with
camera y down and z forward; pixel centres at integer coordinates."""
from __future__ import annotations

import numpy as np

WORLD_UP = np.array([0.0, -1.0, 0.0])


class Camera:
    def __init__(self, k, dist=None):
        self.K = np.array(k, np.float64)
        self.R = np.eye(3)
        self.dist = np.zeros(5) if dist is None else np.array(dist, np.float64)

    def copy(self) -> "Camera":
        c = Camera(self.K.copy(), self.dist.copy())
        c.R = self.R.copy()
        return c

    def turn_towards(self, target):
        """Optical axis through `target`, with no roll against WORLD_UP."""
        z = target / np.linalg.norm(target)
        down = -WORLD_UP
        y = down - np.dot(down, z) * z
        y = y / np.linalg.norm(y)
        self.R = np.stack([np.cross(y, z), y, z])

    def rotate(self, radians):
        """Roll the image content counter-clockwise by `radians`."""
        c, s = np.cos(radians), np.sin(radians)
        self.R = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]]) @ self.R

    def zoom(self, factor):
        self.K[0, 0] *= factor
        self.K[1, 1] *= factor

    def center_principal_point(self, side):
        self.K[0, 2] = self.K[1, 2] = (side - 1) / 2


def warp_params(src: Camera, dst: Camera):
    """The crop pixel -> source pixel map: H = R_src R_dst^T K_dst^-1 (the
    ray), the source intrinsics (fx, fy, cx, cy) and its distortion."""
    h = src.R @ dst.R.T @ np.linalg.inv(dst.K)
    k = np.array([src.K[0, 0], src.K[1, 1], src.K[0, 2], src.K[1, 2]])
    return h, k, src.dist.copy()


def crop_params(rng, b: int, tile: int, side: int):
    """Per-crop warp parameters (H [B,3,3], K [B,4], dist [B,5]) and crop
    intrinsics [B,3,3], float32: a source camera of focal length 0.9-1.3
    tiles with mild distortion, a crop camera turned up to 0.2 rad off its
    axis, rolled up to 0.4 rad and zoomed 0.8-1.3."""
    hs, ks, ds, intr = [], [], [], []
    for _ in range(b):
        f = tile * rng.uniform(0.9, 1.3)
        dist = rng.uniform(-1, 1, 5) * [0.15, 0.03, 5e-4, 5e-4, 0.01]
        src = Camera([[f, 0, (tile - 1) / 2], [0, f, (tile - 1) / 2], [0, 0, 1]], dist)
        crop = src.copy()
        crop.dist[:] = 0.0
        yaw, roll, zoom = rng.uniform(-0.2, 0.2), rng.uniform(-0.4, 0.4), rng.uniform(0.8, 1.3)
        pitch = rng.uniform(-0.2, 0.2)
        crop.turn_towards(1000 * np.array([np.sin(yaw), np.sin(pitch), np.cos(yaw)]))
        crop.rotate(roll)
        crop.zoom(zoom * side / tile)
        crop.center_principal_point(side)
        h, k, d = warp_params(src, crop)
        hs.append(h)
        ks.append(k)
        ds.append(d)
        intr.append(crop.K)
    return tuple(np.stack(a).astype(np.float32) for a in (hs, ks, ds, intr))
