"""Occluder bank: VOC object cutouts, or procedural fallbacks, in numpy
(`metro_pose3d_tpu/pipeline/occluders.py`, which cannot be imported without
jax: its package `__init__` imports the jax device pipeline).

The bank is one [N, T, T, 4] float32 RGBA array in [0, 1]; the train step
uploads it once, as uint8 (`pipeline/device.py::pack_occluder_bank_for`).
The procedural bank equals the JAX package's bit for bit at the same seed;
the VOC bank is read without cv2 (`utils/improc.py`: JPEGs through libjpeg
or nvJPEG, palette PNG masks, cv2's area resize) and equals the JAX
package's on the same files where libjpeg decodes them.
"""
from __future__ import annotations

import os

import numpy as np

from metro_pose3d_tpu_torch.utils import improc


class NoUsableOccluders(RuntimeError):
    """A VOC tree in which no object passes the filters."""


def make_procedural_occluders(n: int = 64, tile_side: int = 96, seed: int = 0) -> np.ndarray:
    """Random textured elliptical blobs with soft alpha edges."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:tile_side, 0:tile_side].astype(np.float32)
    cx = cy = (tile_side - 1) / 2.0
    bank = np.zeros((n, tile_side, tile_side, 4), np.float32)
    for i in range(n):
        a = rng.uniform(0.25, 0.48) * tile_side
        b = rng.uniform(0.25, 0.48) * tile_side
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xs - cx) * ct + (ys - cy) * st
        v = -(xs - cx) * st + (ys - cy) * ct
        r = (u / a) ** 2 + (v / b) ** 2
        alpha = np.clip((1.0 - r) * 4.0, 0.0, 1.0)
        # low-frequency colour texture
        freq = rng.uniform(0.02, 0.12, 2)
        phase = rng.uniform(0, 2 * np.pi, (2, 3))
        base = rng.uniform(0.1, 0.9, 3)
        tex = (
            base
            + 0.25 * np.sin(freq[0] * u[..., None] * 2 * np.pi + phase[0])
            + 0.25 * np.sin(freq[1] * v[..., None] * 2 * np.pi + phase[1])
        )
        bank[i, ..., :3] = np.clip(tex, 0, 1)
        bank[i, ..., 3] = alpha
    return bank


def load_voc_occluders(voc_root: str, tile_side: int = 96, max_count: int = 2000) -> np.ndarray:
    """Cut segmented Pascal VOC 2012 objects out into RGBA tiles.

    Needs `VOCdevkit/VOC2012` with `SegmentationObject` annotations under
    `voc_root`. As the reference does: a mask without its JPEG, or a file
    that is damaged, is skipped (cv2.imread's None); the mask is read as
    cv2's IMREAD_GRAYSCALE reads VOC's palette PNGs, so each object is a
    gray level, the luma of its palette colour, and ids 0 and 255 are
    skipped as gray levels (VOC's void outline, index 255, reads as 220 and
    is kept as one more object where it passes the filters: a defect of the
    reference that the port reproduces); objects smaller than 500 pixels or
    touching the image border are skipped; each tile is cv2's INTER_AREA
    resize of the float32 RGBA box. NoUsableOccluders where none is left;
    a missing JPEG decoder raises `improc.NoJpegDecoder`.
    """
    seg_dir = os.path.join(voc_root, "VOCdevkit", "VOC2012", "SegmentationObject")
    img_dir = os.path.join(voc_root, "VOCdevkit", "VOC2012", "JPEGImages")
    if not os.path.isdir(seg_dir):
        raise FileNotFoundError(f"VOC segmentation dir not found: {seg_dir}")
    tiles = []
    for fname in sorted(os.listdir(seg_dir)):
        if not fname.endswith(".png") or len(tiles) >= max_count:
            continue
        try:
            seg = improc.imread_gray(os.path.join(seg_dir, fname))
            img = improc.imread(os.path.join(img_dir, fname.replace(".png", ".jpg")))
        except (FileNotFoundError, improc.CorruptImage):
            continue
        for obj_id in np.unique(seg):
            if obj_id in (0, 255):
                continue
            mask = seg == obj_id
            ys, xs = np.nonzero(mask)
            if len(ys) < 500:
                continue
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            if y0 == 0 or x0 == 0 or y1 == seg.shape[0] or x1 == seg.shape[1]:
                continue  # touches the border: likely a truncated object
            rgba = np.zeros((y1 - y0, x1 - x0, 4), np.float32)
            rgba[..., :3] = img[y0:y1, x0:x1] / 255.0
            rgba[..., 3] = mask[y0:y1, x0:x1]
            tiles.append(improc.resize(rgba, (tile_side, tile_side), "area"))
            if len(tiles) >= max_count:
                break
    if not tiles:
        raise NoUsableOccluders("no usable VOC occluders found")
    return np.stack(tiles)


def get_occluder_bank(voc_root: str | None, tile_side: int = 96) -> np.ndarray:
    """The VOC bank when `voc_root` holds one, else the procedural bank.
    Only a missing VOC tree or one without a usable object falls back; a
    missing JPEG decoder or a file the port cannot read raises."""
    if voc_root and os.path.isdir(voc_root):
        try:
            return load_voc_occluders(voc_root, tile_side)
        except (FileNotFoundError, NoUsableOccluders):
            pass
    return make_procedural_occluders(tile_side=tile_side)
