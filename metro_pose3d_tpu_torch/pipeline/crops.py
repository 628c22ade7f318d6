"""Host-side crop synthesis: virtual camera, source tile, ground truth
(`metro_pose3d_tpu/pipeline/crops.py`; the port keeps its own copy).

Responsibility-parity with the reference's `data_loading.load_and_transform3d`
(SURVEY.md §3.1 — the part that must be numerically nailed), re-split for TPU:
the expensive pixel work (warp/augment) moves on-device; this module does the
cheap 3x3 algebra and GT bookkeeping per example:

  box -> square (+train-time shift/scale/rotation/flip)
  -> virtual camera: undistort, turn_towards(box center ray), square_pixels,
     rotate, zoom-to-fit, center principal point            [exact homography]
  -> fixed-size uint8 source tile (slice + optional integer-area decimation)
  -> warp params rebased to tile coords
  -> GT: 3D joints re-expressed in the crop camera frame (mm), 2D projections
     in crop pixels, validity masks, mirror permutation when flipped.

Two engines compute the same thing: "python" (numpy) and "native" (the C
engine of `native/croprep.c`, loaded with ctypes; ~1e-12 relative in
float64, so within 1e-6 on the float32 outputs); "auto" takes the native
one where it builds. The random draws are the same for every engine. This
module imports neither torch nor cv2, so spawned loader workers stay cheap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from metro_pose3d_tpu_torch.config import AugConfig
from metro_pose3d_tpu_torch.geom import boxes as boxlib
from metro_pose3d_tpu_torch.geom.camera import Camera, get_warp_params, reproject_image_points
from metro_pose3d_tpu_torch.geom.joints import JointInfo
from metro_pose3d_tpu_torch.native import build as native
from metro_pose3d_tpu_torch.utils import improc

ENGINES = ("python", "native", "auto")


@dataclasses.dataclass
class Example:
    """One person instance. `world_coords` is None for 2D-only datasets."""

    image: np.ndarray  # uint8 HxWx3 (dataset loaders decode before this)
    bbox: np.ndarray  # [x, y, w, h]
    camera: Camera
    world_coords: Optional[np.ndarray] = None  # [J, 3] mm
    image_coords: Optional[np.ndarray] = None  # [J, 2] px (2D-only datasets)
    joint_validity: Optional[np.ndarray] = None  # [J] bool
    mask: Optional[np.ndarray] = None  # HxW fg mask (3DHP green-screen)


@dataclasses.dataclass
class AugParams:
    """Geometric+appearance augmentation draws for one example."""

    shift: np.ndarray  # (2,) fraction of box side
    scale: float
    rot_rad: float
    flip: bool
    brightness: float
    contrast: float
    saturation: float
    hue: float
    occlude: bool
    occluder_index: int
    occluder_affine: np.ndarray  # (2, 3) crop px -> tile px
    bg_enabled: bool = False  # 3DHP green-screen background replacement
    bg_index: int = 0


def sample_aug_params(
    rng: np.random.Generator, aug: AugConfig, n_occluders: int,
    n_backgrounds: int = 0,
) -> AugParams:
    do_color = rng.random() < aug.color_prob
    # occluder placement: cover a random sub-square of the crop
    occ_scale = rng.uniform(0.2, 0.7)
    occ_center = rng.uniform(0.1, 0.9, 2)
    occ_rot = rng.uniform(-np.pi, np.pi)
    c, s = np.cos(occ_rot), np.sin(occ_rot)
    # crop px -> tile px: translate crop center to tile center, rotate, scale
    scale_px = 1.0 / max(occ_scale, 1e-3)
    rotm = scale_px * np.array([[c, -s], [s, c]])
    affine = np.zeros((2, 3))
    affine[:, :2] = rotm
    return AugParams(
        shift=rng.uniform(-aug.shift_frac, aug.shift_frac, 2),
        scale=rng.uniform(aug.scale_down, aug.scale_up),
        rot_rad=np.deg2rad(rng.uniform(-aug.rot_max_deg, aug.rot_max_deg)),
        flip=bool(rng.random() < aug.flip_prob),
        brightness=rng.uniform(-0.125, 0.125) if do_color else 0.0,
        contrast=rng.uniform(0.75, 1.25) if do_color else 1.0,
        saturation=rng.uniform(0.75, 1.25) if do_color else 1.0,
        hue=rng.uniform(-0.3, 0.3) if do_color else 0.0,
        occlude=bool(rng.random() < aug.occlude_prob),
        occluder_index=int(rng.integers(max(n_occluders, 1))),
        occluder_affine=affine,
        bg_enabled=bool(n_backgrounds > 0 and rng.random() < aug.background_prob),
        bg_index=int(rng.integers(max(n_backgrounds, 1))),
        # note: occ_center folded into the affine translation below
    ), occ_center


def make_crop_camera(
    camera: Camera,
    bbox,
    proc_side: int,
    box_expansion: float = 1.0,
    shift=(0.0, 0.0),
    scale: float = 1.0,
    rot_rad: float = 0.0,
    flip: bool = False,
) -> Camera:
    """Build the virtual crop camera (SURVEY.md §3.1 steps 1-3).

    `scale` > 1 zooms IN (person larger); shift is a fraction of the square
    box side. The returned camera shares the source optical center, so the
    pixel map is an exact homography (+ source distortion).
    """
    box = boxlib.expand_to_square(np.asarray(bbox, np.float64), box_expansion)
    side = box[2]
    box = boxlib.box_around(boxlib.center(box) + np.asarray(shift) * side, side)

    cam = camera.copy()
    cam.undistort()
    center_world = camera.image_to_world(boxlib.center(box), camera_depth=1000.0)
    cam.turn_towards(center_world)
    cam.square_pixels()
    if flip:
        cam.horizontal_flip()
    if rot_rad != 0.0:
        cam.rotate(rot_rad)

    # zoom so the (rotated/flipped) box fits the output exactly: project the
    # box boundary into the current crop camera and fit its extent.
    t = np.linspace(0.0, 1.0, 4, endpoint=False)
    corners = boxlib.corners(box)  # (4, 2)
    boundary = np.concatenate(
        [corners[i] + (corners[(i + 1) % 4] - corners[i]) * t[:, None] for i in range(4)]
    )
    proj = reproject_image_points(boundary, camera, cam)
    pp = np.array([cam.K[0, 2], cam.K[1, 2]])
    half_extent = np.max(np.abs(proj - pp))
    cam.zoom(scale * (proc_side / 2.0) / max(half_extent, 1e-6))
    cam.center_principal_point((proc_side, proc_side))
    return cam


def extract_source_tile(image: np.ndarray, crop_cam: Camera, src_cam: Camera,
                        proc_side: int, tile_side: int, roi_out: list | None = None):
    """Slice (and if needed, area-decimate) the source region feeding a crop.

    Returns (tile uint8 [T,T,3], offset (2,), factor float): full-image pixel
    p maps to tile pixel (p - offset) / factor. Decimation uses integer-
    factor box averaging only when the needed region exceeds the tile
    (anti-aliased downsampling, matching the reference's area-resize
    behavior); the common case is a pure memcpy slice. When `roi_out` is
    given, the chosen ROI (x0, y0, x1, y1) is appended (e.g. to extract the
    matching foreground-mask tile).
    """
    h, w = image.shape[:2]
    grid = np.array(
        [[x, y] for x in np.linspace(0, proc_side - 1, 5) for y in np.linspace(0, proc_side - 1, 5)],
        np.float64,
    )
    src_pts = reproject_image_points(grid, crop_cam, src_cam)
    lo = np.floor(src_pts.min(0)) - 2
    hi = np.ceil(src_pts.max(0)) + 3
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, [w, h])
    roi_w, roi_h = np.maximum(hi - lo, 1)

    factor = max(1, int(np.ceil(max(roi_w, roi_h) / tile_side)))
    x0, y0 = int(lo[0]), int(lo[1])
    x1, y1 = int(hi[0]), int(hi[1])
    # ROI slice + integer-factor area decimation + zero pad, in the native C
    # runtime when built (utils/improc; box-mean == cv2 INTER_AREA for
    # integer factors), numpy otherwise.
    if roi_out is not None:
        roi_out.append((x0, y0, x1, y1))
    tile = improc.extract_tile_native(image, x0, y0, x1, y1, factor, tile_side)
    return tile, np.array([x0, y0], np.float64), float(factor)


def rebase_warp_params(params: dict, offset: np.ndarray, factor: float) -> dict:
    """Adjust src-camera intrinsics so the sampler reads tile coordinates."""
    fx, fy, cx, cy = (float(v) for v in params["K"])
    k = np.array(
        [fx / factor, fy / factor, (cx - offset[0]) / factor, (cy - offset[1]) / factor],
        params["K"].dtype,
    )
    return {"H": params["H"], "K": k, "dist": params["dist"]}


_NBASE = 40  # doubles before the per-joint GT blocks (native/croprep.c layout)
_EMPTY_F64 = np.zeros(0, np.float64)
_EMPTY_U8 = np.zeros(0, np.uint8)
_EMPTY_I32 = np.zeros(0, np.int32)


def _native_crop_params(lib, camera: Camera, bbox, proc_side: int, tile_side: int, imshape,
                        box_expansion: float, shift=(0.0, 0.0), scale: float = 1.0,
                        rot_rad: float = 0.0, flip: bool = False, mode: int = 2,
                        coords=_EMPTY_F64, valid=_EMPTY_U8, mirror=_EMPTY_I32) -> tuple:
    """One call of `metro_crop_params` -> (float64 parameters in the layout
    of native/croprep.c, (x0, y0, x1, y1) source ROI, decimation factor).
    mode 0: `coords` [J,3] world points; 1: [J,2] image points; 2: no GT."""
    j = len(mirror)
    if mode != 2 and not (coords.dtype == np.float64 and coords.flags.c_contiguous
                          and coords.shape == (j, 3 if mode == 0 else 2)
                          and valid.dtype == np.uint8 and valid.shape == (j,)
                          and mirror.dtype == np.int32 and mirror.flags.c_contiguous):
        raise ValueError("crop_params: coords, validity and mirror do not match")
    cam = np.concatenate([camera.K.ravel(), camera.R.ravel(), camera.t, camera.dist,
                          camera.world_up]).astype(np.float64)
    if cam.shape != (29,):
        raise ValueError("crop_params: the camera needs K 3x3, R 3x3, t 3, dist 5, world_up 3")
    box = np.ascontiguousarray(np.asarray(bbox, np.float64).reshape(4))
    valid = np.ascontiguousarray(valid)
    out = np.empty(_NBASE + 7 * j, np.float64)
    roi = np.empty(5, np.int32)
    h, w = imshape[:2]
    rc = lib.metro_crop_params(
        cam.ctypes.data, box.ctypes.data, int(proc_side), int(tile_side), int(w), int(h),
        float(box_expansion), float(shift[0]), float(shift[1]), float(scale), float(rot_rad),
        int(bool(flip)), int(mode), j, coords.ctypes.data, valid.ctypes.data,
        mirror.ctypes.data, out.ctypes.data, roi.ctypes.data)
    if rc:
        raise ValueError({2: "crop_params: singular crop intrinsics",
                          3: "crop_params: out of memory"}.get(rc, "crop_params: bad arguments"))
    x0, y0, x1, y1, factor = (int(v) for v in roi)
    return out, (x0, y0, x1, y1), factor


def _native_inference_params(lib, bbox, camera: Camera, proc_side: int,
                             tile_side: int, box_expansion: float,
                             imshape) -> tuple:
    """C-engine core shared by both inference prep paths: warp params +
    crop intrinsics + rot_to_orig (mode=2: no ground truth), plus the
    source ROI for tile extraction. Returns (dict, roi, factor)."""
    p, roi, factor = _native_crop_params(lib, camera, bbox, proc_side, tile_side, imshape,
                                         box_expansion)
    # reconstruct the crop camera (R_crop = M^T @ R_src since
    # M = R_src @ R_crop^T; shared optical center, no distortion)
    crop_cam = Camera(
        p[18:27].reshape(3, 3),
        p[27:36].reshape(3, 3).T @ camera.R,
        camera.t,
        None,
        camera.world_up,
    )
    d = {
        "warp_h": p[0:9].reshape(3, 3).astype(np.float32),
        "warp_dist": p[13:18].astype(np.float32),
        "intrinsics": p[18:27].reshape(3, 3).astype(np.float32),
        "rot_to_orig": p[27:36].reshape(3, 3).astype(np.float32),
        "_warp_k_rebased": p[9:13].astype(np.float32),
        "_warp_k_frame": p[36:40].astype(np.float32),
        "_crop_cam": crop_cam,
    }
    return d, roi, factor


def resolve_engine(engine: str) -> str:
    """The engine `engine` runs on this machine: "native" or "python".
    "auto" takes the C engine where it builds; "native" raises where it
    does not; an unknown name raises ValueError."""
    if engine not in ENGINES:
        raise ValueError(f"unknown prepare engine {engine!r}")
    if engine == "python":
        return "python"
    if native.crop_library() is not None:
        return "native"
    if engine == "native":
        raise RuntimeError("data.host_prep='native' but the C crop engine did not build: "
                           f"{native.build_error('croprep')}")
    return "python"


def prepare_inference_crop_params(
    bbox,
    camera: Camera,
    proc_side: int,
    box_expansion: float = 1.0,
    engine: str = "python",
) -> dict:
    """Host prep for one detector box in FRAME MODE: warp parameters in
    full-frame pixel coordinates (no source-tile extraction — the device
    samples the shared frame directly via `ops.warp.warp_from_frame`)."""
    if resolve_engine(engine) == "native":
        # imshape only bounds the ROI, which frame mode ignores
        d, _, _ = _native_inference_params(
            native.crop_library(), bbox, camera, proc_side, proc_side, box_expansion,
            (1 << 24, 1 << 24))
        return {
            "warp_h": d["warp_h"],
            "warp_k": d["_warp_k_frame"],
            "warp_dist": d["warp_dist"],
            "intrinsics": d["intrinsics"],
            "rot_to_orig": d["rot_to_orig"],
            "_crop_cam": d["_crop_cam"],
        }
    crop_cam = make_crop_camera(camera, bbox, proc_side, box_expansion)
    params = get_warp_params(camera, crop_cam)
    return {
        "warp_h": params["H"].astype(np.float32),
        "warp_k": params["K"].astype(np.float32),
        "warp_dist": params["dist"].astype(np.float32),
        "intrinsics": crop_cam.K.astype(np.float32),
        "rot_to_orig": (camera.R @ crop_cam.R.T).astype(np.float32),
        "_crop_cam": crop_cam,
    }


def prepare_inference_crop(
    image: np.ndarray,
    bbox,
    camera: Camera,
    proc_side: int,
    tile_side: int,
    box_expansion: float = 1.0,
    engine: str = "python",
) -> dict:
    """Host prep for one GT-free detector box (multi-person inference path).

    Like `prepare_example(aug=None)` minus ground truth: emits the source
    tile, warp parameters, crop intrinsics, and `rot_to_orig` — the rotation
    `R_src @ R_crop^T` that maps camera-frame points of the virtual crop
    camera back to the ORIGINAL camera frame (both share the optical center,
    so absolute poses transform by pure rotation).
    """
    if resolve_engine(engine) == "native":
        d, roi, factor = _native_inference_params(
            native.crop_library(), bbox, camera, proc_side, tile_side, box_expansion,
            image.shape)
        tile = improc.extract_tile_native(
            image, roi[0], roi[1], roi[2], roi[3], factor, tile_side)
        return {
            "source": tile,
            "warp_h": d["warp_h"],
            "warp_k": d["_warp_k_rebased"],
            "warp_dist": d["warp_dist"],
            "intrinsics": d["intrinsics"],
            "rot_to_orig": d["rot_to_orig"],
            "_crop_cam": d["_crop_cam"],
        }
    crop_cam = make_crop_camera(camera, bbox, proc_side, box_expansion)
    tile, offset, factor = extract_source_tile(
        image, crop_cam, camera, proc_side, tile_side
    )
    params = rebase_warp_params(get_warp_params(camera, crop_cam), offset, factor)
    rot_to_orig = camera.R @ crop_cam.R.T
    return {
        "source": tile,
        "warp_h": params["H"].astype(np.float32),
        "warp_k": params["K"].astype(np.float32),
        "warp_dist": params["dist"].astype(np.float32),
        "intrinsics": crop_cam.K.astype(np.float32),
        "rot_to_orig": rot_to_orig.astype(np.float32),
        "_crop_cam": crop_cam,  # host-only (popped before device transfer)
    }


def _aug_device_params(aug: AugParams | None, occ_center, proc_side, tile_side):
    """Occluder/color parameter arrays shipped to the device augment stage."""
    if aug is not None:
        occ_aff = aug.occluder_affine.copy()
        # place the occluder so crop point occ_center maps to the tile center
        tcenter = np.array([tile_side / 2.0, tile_side / 2.0])
        ccenter = np.asarray(occ_center) * proc_side
        occ_aff[:, 2] = tcenter - occ_aff[:, :2] @ ccenter
        color = np.array(
            [aug.brightness, aug.contrast, aug.saturation, aug.hue], np.float32
        )
        occ = np.array(
            [1.0 if aug.occlude else 0.0, float(aug.occluder_index)], np.float32
        )
    else:
        occ_aff = np.array([[1.0, 0, 1e6], [0, 1.0, 1e6]])  # off-tile = no-op
        color = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
        occ = np.array([0.0, 0.0], np.float32)
    return occ_aff, color, occ


def _mask_outputs(example: Example, aug: AugParams | None, roi, factor, tile_side):
    """Foreground-mask tile + bg params for green-screen replacement.

    All-foreground when the example carries no mask, which makes the device
    composite an exact no-op."""
    if example.mask is not None and aug is not None and aug.bg_enabled:
        m = example.mask.astype(np.uint8) * 255
        x0, y0, x1, y1 = roi
        mask_tile = improc.extract_tile_native(
            m, x0, y0, x1, y1, int(factor), tile_side
        )
        bg = np.array([1.0, float(aug.bg_index)], np.float32)
    else:
        mask_tile = np.full((tile_side, tile_side), 255, np.uint8)
        bg = np.array([0.0, 0.0], np.float32)
    return mask_tile, bg


def _prepare_example_native(
    lib,
    example: Example,
    joint_info: JointInfo,
    proc_side: int,
    tile_side: int,
    aug: AugParams | None,
    occ_center,
    box_expansion: float,
    with_background: bool,
) -> dict:
    """`prepare_example` through the C engine (native/croprep.c).

    One call replaces the whole numpy camera/GT chain; the engines agree to
    ~1e-12 relative in float64 (tests/test_torch_pipeline.py). The tile and
    mask copies are the same `improc.extract_tile_native` as the numpy path's."""
    j = joint_info.n_joints
    if example.world_coords is not None:
        mode = 0
        coords = np.ascontiguousarray(example.world_coords, np.float64)
        is_3d = 1.0
    else:
        mode = 1
        coords = np.ascontiguousarray(example.image_coords, np.float64)
        is_3d = 0.0
    valid_in = (
        np.ascontiguousarray(example.joint_validity, np.uint8)
        if example.joint_validity is not None
        else np.ones(j, np.uint8)
    )
    mirror = np.ascontiguousarray(joint_info.mirror_mapping, np.int32)
    if aug is not None:
        shift, scale, rot_rad, flip = aug.shift, aug.scale, aug.rot_rad, aug.flip
    else:
        shift, scale, rot_rad, flip = (0.0, 0.0), 1.0, 0.0, False
    p, (x0, y0, x1, y1), factor = _native_crop_params(
        lib, example.camera, example.bbox, proc_side, tile_side, example.image.shape,
        box_expansion, shift, scale, rot_rad, flip, mode, coords, valid_in, mirror)
    tile = improc.extract_tile_native(
        example.image, x0, y0, x1, y1, factor, tile_side
    )
    occ_aff, color, occ = _aug_device_params(aug, occ_center, proc_side, tile_side)
    g = _NBASE
    result = {
        "source": tile,
        "warp_h": p[0:9].reshape(3, 3).astype(np.float32),
        "warp_k": p[9:13].astype(np.float32),
        "warp_dist": p[13:18].astype(np.float32),
        "coords3d_true": p[g : g + 3 * j].reshape(j, 3).astype(np.float32),
        "coords2d_true": p[g + 3 * j : g + 5 * j].reshape(j, 2).astype(np.float32),
        "joint_validity": p[g + 5 * j : g + 6 * j].astype(np.float32),
        "joint_validity_2d": p[g + 6 * j : g + 7 * j].astype(np.float32),
        "is_3d": np.float32(is_3d),
        "intrinsics": p[18:27].reshape(3, 3).astype(np.float32),
        "color_params": color,
        "occ_params": occ,
        "occ_affine": occ_aff.astype(np.float32),
    }
    if with_background:
        mask_tile, bg = _mask_outputs(
            example, aug, (x0, y0, x1, y1), factor, tile_side
        )
        result["source_mask"] = mask_tile
        result["bg_params"] = bg
    return result


def prepare_example(
    example: Example,
    joint_info: JointInfo,
    proc_side: int,
    tile_side: int,
    aug: AugParams | None = None,
    occ_center=(0.5, 0.5),
    box_expansion: float = 1.0,
    with_background: bool = False,
    engine: str = "python",
) -> dict:
    """Full host-side preparation of one example -> dict of small arrays.

    With `aug=None` this is the deterministic test-time path (SURVEY.md §4.2).
    `engine` selects the parameter math: "python" (numpy), "native" (the C
    engine, ~1e-12-equivalent, fails loud where it does not build), or
    "auto" (native where it builds, else python).
    """
    if resolve_engine(engine) == "native":
        return _prepare_example_native(
            native.crop_library(), example, joint_info, proc_side, tile_side,
            aug, occ_center, box_expansion, with_background,
        )
    if aug is not None:
        crop_cam = make_crop_camera(
            example.camera, example.bbox, proc_side, box_expansion,
            shift=aug.shift, scale=aug.scale, rot_rad=aug.rot_rad, flip=aug.flip,
        )
        flip = aug.flip
    else:
        crop_cam = make_crop_camera(example.camera, example.bbox, proc_side, box_expansion)
        flip = False

    roi_out: list = []
    tile, offset, factor = extract_source_tile(
        example.image, crop_cam, example.camera, proc_side, tile_side,
        roi_out=roi_out,
    )
    params = rebase_warp_params(
        get_warp_params(example.camera, crop_cam), offset, factor
    )

    j = joint_info.n_joints
    valid_in = (
        np.asarray(example.joint_validity, bool)
        if example.joint_validity is not None
        else np.ones(j, bool)
    )
    if example.world_coords is not None:
        coords3d = crop_cam.world_to_camera(example.world_coords)
        coords2d = crop_cam.world_to_image(example.world_coords)
        valid3d = valid_in & np.all(np.isfinite(example.world_coords), -1)
        is_3d = 1.0
    else:
        coords3d = np.zeros((j, 3))
        # 2D-only datasets: map annotated image points through the homography
        coords2d = reproject_image_points(example.image_coords, example.camera, crop_cam)
        valid3d = np.zeros(j, bool)
        is_3d = 0.0
    valid2d = (
        valid_in
        & np.all(np.isfinite(coords2d), -1)
        & (coords2d[:, 0] >= -0.5) & (coords2d[:, 0] <= proc_side - 0.5)
        & (coords2d[:, 1] >= -0.5) & (coords2d[:, 1] <= proc_side - 0.5)
    )
    coords2d = np.nan_to_num(coords2d)
    coords3d = np.nan_to_num(coords3d)

    if flip:
        m = joint_info.mirror_mapping
        coords3d = coords3d[m]
        coords2d = coords2d[m]
        valid3d = valid3d[m]
        valid2d = valid2d[m]

    occ_aff, color, occ = _aug_device_params(aug, occ_center, proc_side, tile_side)

    out = {
        "source": tile,
        "warp_h": params["H"].astype(np.float32),
        "warp_k": params["K"].astype(np.float32),
        "warp_dist": params["dist"].astype(np.float32),
        "coords3d_true": coords3d.astype(np.float32),
        "coords2d_true": coords2d.astype(np.float32),
        "joint_validity": valid3d.astype(np.float32),
        "joint_validity_2d": valid2d.astype(np.float32),
        "is_3d": np.float32(is_3d),
        "intrinsics": crop_cam.K.astype(np.float32),
        "color_params": color,
        "occ_params": occ,
        "occ_affine": occ_aff.astype(np.float32),
    }
    if with_background:
        # foreground mask in TILE space for green-screen bg replacement
        # (3DHP FGmasks)
        mask_tile, bg = _mask_outputs(example, aug, roi_out[0], factor, tile_side)
        out["source_mask"] = mask_tile
        out["bg_params"] = bg
    return out
