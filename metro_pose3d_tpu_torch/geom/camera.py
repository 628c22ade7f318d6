"""Full pinhole camera model with distortion and virtual-crop-camera synthesis.

Responsibility-parity with the reference's `src/cameralib.py` (SURVEY.md §3):
world<->camera<->image transforms, radial/tangential distortion, and the
virtual-camera operations that synthesize person crops (`turn_towards`,
`zoom`, `undistort`, `square_pixels`, `horizontal_flip`, in-plane `rotate`,
`center_principal_point`). Unlike the reference, `reproject_image` does NOT
live here (no OpenCV): cameras *emit warp parameters* (`get_warp_params`)
that the on-device sampler in `metro_pose3d_tpu_torch.ops.warp` consumes. The
port's own copy of the JAX package's `geom/camera.py` (numpy only).

Conventions
-----------
* `R` (3x3): world->camera rotation; rows are the camera x/y/z axes expressed
  in world coordinates. `x_cam = R @ (x_world - t)`, with `t` the optical
  center in world coordinates. Camera z looks forward, y points *down* in the
  image, x points right.
* Pixel centers sit at integer coordinates (see reference_constants).
* `distortion` = (k1, k2, p1, p2, k3), OpenCV ordering.
* All math float64 numpy; methods mutate in place (reference style) and
  `copy()` gives an independent camera.
"""
from __future__ import annotations

import numpy as np


class Camera:
    def __init__(
        self,
        intrinsic_matrix=None,
        rot_world_to_cam=None,
        optical_center=None,
        distortion_coeffs=None,
        world_up=(0.0, -1.0, 0.0),
    ):
        self.K = np.array(
            intrinsic_matrix if intrinsic_matrix is not None else np.eye(3), np.float64
        )
        self.R = np.array(
            rot_world_to_cam if rot_world_to_cam is not None else np.eye(3), np.float64
        )
        self.t = np.array(
            optical_center if optical_center is not None else np.zeros(3), np.float64
        )
        self.dist = np.zeros(5, np.float64)
        if distortion_coeffs is not None:
            d = np.asarray(distortion_coeffs, np.float64).ravel()
            self.dist[: len(d)] = d
        self.world_up = np.asarray(world_up, np.float64)

    # ------------------------------------------------------------------ basics
    def copy(self) -> "Camera":
        c = Camera(self.K.copy(), self.R.copy(), self.t.copy(), self.dist.copy(), self.world_up.copy())
        return c

    @property
    def has_distortion(self) -> bool:
        return bool(np.any(self.dist != 0))

    def allclose(self, other, atol=1e-9) -> bool:
        return (
            np.allclose(self.K, other.K, atol=atol)
            and np.allclose(self.R, other.R, atol=atol)
            and np.allclose(self.t, other.t, atol=atol)
            and np.allclose(self.dist, other.dist, atol=atol)
        )

    # ------------------------------------------------------------- transforms
    def world_to_camera(self, points):
        points = np.asarray(points, np.float64)
        return (points - self.t) @ self.R.T

    def camera_to_world(self, points):
        points = np.asarray(points, np.float64)
        return points @ self.R + self.t

    def camera_to_image(self, points_cam):
        """Project camera-frame 3D points to pixels (with distortion)."""
        points_cam = np.asarray(points_cam, np.float64)
        z = points_cam[..., 2:3]
        normalized = points_cam[..., :2] / z
        distorted = distort_points(normalized, self.dist)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        skew = self.K[0, 1]
        x = fx * distorted[..., 0] + skew * distorted[..., 1] + cx
        y = fy * distorted[..., 1] + cy
        return np.stack([x, y], axis=-1)

    def world_to_image(self, points):
        return self.camera_to_image(self.world_to_camera(points))

    def image_to_camera(self, points_px, depth=1.0):
        """Back-project pixels to camera-frame points at the given z-depth."""
        points_px = np.asarray(points_px, np.float64)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        skew = self.K[0, 1]
        y = (points_px[..., 1] - cy) / fy
        x = (points_px[..., 0] - cx - skew * y) / fx
        normalized = undistort_points(np.stack([x, y], axis=-1), self.dist)
        depth = np.asarray(depth, np.float64)
        return np.stack(
            [normalized[..., 0] * depth, normalized[..., 1] * depth, np.broadcast_to(depth, normalized[..., 0].shape)],
            axis=-1,
        )

    def image_to_world(self, points_px, camera_depth=1.0):
        return self.camera_to_world(self.image_to_camera(points_px, camera_depth))

    def is_visible(self, world_points, imshape):
        """In-front-of-camera AND inside the (height, width) image bounds."""
        cam = self.world_to_camera(world_points)
        px = self.camera_to_image(cam)
        h, w = imshape[:2]
        return (
            (cam[..., 2] > 0)
            & (px[..., 0] >= -0.5)
            & (px[..., 0] <= w - 0.5)
            & (px[..., 1] >= -0.5)
            & (px[..., 1] <= h - 0.5)
        )

    # ----------------------------------------------- virtual-camera operations
    def undistort(self):
        self.dist[:] = 0.0

    def square_pixels(self):
        f = (self.K[0, 0] + self.K[1, 1]) / 2
        self.K[0, 0] = f
        self.K[1, 1] = f

    def zoom(self, factor):
        """Scale focal length(s); principal point unchanged."""
        self.K[0, 0] *= factor
        self.K[1, 1] *= factor

    def scale_output(self, factor):
        """Scale the whole image plane (focal AND principal point)."""
        self.K[:2] *= factor

    def shift_image(self, offset_xy):
        self.K[0, 2] += offset_xy[0]
        self.K[1, 2] += offset_xy[1]

    def center_principal_point(self, imshape):
        """Principal point to image center ((s-1)/2 pixel-center convention)."""
        h, w = imshape[:2]
        self.K[0, 2] = (w - 1) / 2
        self.K[1, 2] = (h - 1) / 2

    def horizontal_flip(self):
        """Mirror the camera about its vertical axis (negates the x axis)."""
        self.R[0] *= -1
        # keep the intrinsic skew consistent (normally zero)
        self.K[0, 1] *= -1

    def turn_towards(self, target_world):
        """Pure rotation so the optical axis passes through `target_world`.

        The new y axis is chosen to minimize roll against `world_up` (gravity
        stays vertical in the crop), matching the reference's construction of
        the virtual crop camera.
        """
        z = unit(np.asarray(target_world, np.float64) - self.t)
        down = -self.world_up  # camera y points down in the image
        y = down - np.dot(down, z) * z
        norm = np.linalg.norm(y)
        if norm < 1e-8:  # looking straight up/down: keep previous y as tiebreak
            y = self.R[1] - np.dot(self.R[1], z) * z
            norm = np.linalg.norm(y)
        y = y / norm
        x = np.cross(y, z)
        self.R = np.stack([x, y, z])

    def rotate(self, radians):
        """In-plane (roll) rotation of the image by `radians` (CCW positive).

        Implemented as a rotation about the optical axis: image content
        rotates by `radians` counterclockwise in pixel coordinates.
        """
        c, s = np.cos(radians), np.sin(radians)
        # Rotating the camera frame about +z rotates the *content* the
        # opposite way; with pixel y growing downward, visually-CCW content
        # rotation needs this camera-frame rotation:
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        self.R = rot @ self.R

    # ------------------------------------------------------------------ misc
    def get_projection_matrix(self):
        extr = np.concatenate([self.R, (-self.R @ self.t)[:, None]], axis=1)
        return self.K @ extr

    @staticmethod
    def from_fov(fov_degrees, imshape):
        """Canonical camera at origin, identity rotation, centered pp."""
        h, w = imshape[:2]
        f = (max(h, w) / 2) / np.tan(np.deg2rad(fov_degrees) / 2)
        K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float64)
        return Camera(K)


# --------------------------------------------------------------- distortion
def distort_points(normalized, dist):
    """OpenCV-model distortion of (..., 2) normalized image coordinates."""
    normalized = np.asarray(normalized, np.float64)
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    x, y = normalized[..., 0], normalized[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(distorted, dist, n_iter=10):
    """Invert `distort_points` by fixed-point iteration (exact enough <1e-9)."""
    if not np.any(np.asarray(dist) != 0):
        return np.asarray(distorted, np.float64)
    distorted = np.asarray(distorted, np.float64)
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    x = distorted[..., 0].copy()
    y = distorted[..., 1].copy()
    xd, yd = distorted[..., 0], distorted[..., 1]
    for _ in range(n_iter):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], axis=-1)


# ----------------------------------------------------------- reprojection
def reproject_image_points(points_px, src_cam: Camera, dst_cam: Camera):
    """Map pixels of `src_cam`'s image to `dst_cam`'s image.

    Exact when the two cameras share an optical center (our crop-synthesis
    case: the map is a homography possibly composed with distortion).
    """
    rays_src = src_cam.image_to_camera(points_px)  # depth-1 points
    rays_world = rays_src @ src_cam.R  # R.T applied from the right
    rays_dst = rays_world @ dst_cam.R.T
    return dst_cam.camera_to_image(rays_dst)


def get_warp_params(src_cam: Camera, dst_cam: Camera, dtype=np.float32):
    """Pack the dst-pixel -> src-pixel map for the on-device samplers.

    For output pixel p (homogeneous), the source pixel is
        ray = M @ Kdst_inv @ p         (3-vector, src camera frame)
        src_px = project_K_dist(ray)   (perspective divide + distortion + K)
    where M = R_src @ R_dst^T. When src has no distortion this is the exact
    3x3 homography H = K_src @ M @ Kdst_inv.

    Returns a dict of small float arrays (per crop):
        H     (3, 3) : M @ Kdst_inv  — rotation+intrinsics part, NO K_src
        K     (4,)   : fx, fy, cx, cy of the source camera
        dist  (5,)   : source distortion coefficients
    """
    m = src_cam.R @ dst_cam.R.T
    h = m @ np.linalg.inv(dst_cam.K)
    k = np.array(
        [src_cam.K[0, 0], src_cam.K[1, 1], src_cam.K[0, 2], src_cam.K[1, 2]], np.float64
    )
    return {
        "H": h.astype(dtype),
        "K": k.astype(dtype),
        "dist": src_cam.dist.astype(dtype),
    }


def unit(v):
    return v / np.linalg.norm(v)
