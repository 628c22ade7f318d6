"""Background bank for the 3DHP green-screen replacement, in numpy
(`metro_pose3d_tpu/pipeline/backgrounds.py`; the port keeps its own copy so
that it imports nothing of the JAX package).

The bank is one [N, T, T, 3] uint8 array of scene images. The train step
holds it on the device and composites it behind the subject in source-tile
space, before the crop warp (`ops/color.py::composite_background`), for
every batch that carries "source_mask". Where no background directory
exists, a procedural bank of low-frequency colour fields stands in; it
equals the JAX package's bit for bit at the same arguments. A directory's
bank is read without cv2 (`utils/improc.py`) and equals the JAX package's
on the same files where libjpeg decodes them.
"""
from __future__ import annotations

import os

import numpy as np

from metro_pose3d_tpu_torch.utils import improc


def make_procedural_backgrounds(n: int = 32, side: int = 512, seed: int = 1) -> np.ndarray:
    """Low-frequency plausible 'scene' colour fields, uint8 [N, side, side, 3]."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:side, 0:side].astype(np.float32) / side
    bank = np.zeros((n, side, side, 3), np.uint8)
    for i in range(n):
        img = np.zeros((side, side, 3), np.float32)
        for _ in range(4):
            freq = rng.uniform(0.5, 4.0, 2)
            phase = rng.uniform(0, 2 * np.pi, (2, 3))
            amp = rng.uniform(0.05, 0.25, 3)
            img += amp * np.sin(
                freq[0] * xs[..., None] * 2 * np.pi + phase[0]
            ) + amp * np.sin(freq[1] * ys[..., None] * 2 * np.pi + phase[1])
        base = rng.uniform(0.15, 0.75, 3)
        bank[i] = np.clip((base + img) * 255, 0, 255).astype(np.uint8)
    return bank


def load_backgrounds_from_dir(path: str, side: int = 512, max_count: int = 500) -> np.ndarray:
    """Centre-crop and resize every image under `path` into the bank.

    Reads each file with `improc.imread` (RGB; JPEGs through libjpeg or
    nvJPEG), takes its centre square and resizes it to `side` as cv2's
    INTER_AREA does (a square under `side` grows through cv2's linear
    branch). A missing JPEG decoder raises.
    """
    files = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )[:max_count]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    bank = np.zeros((len(files), side, side, 3), np.uint8)
    for i, fname in enumerate(files):
        img = improc.imread(os.path.join(path, fname))
        h, w = img.shape[:2]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        bank[i] = improc.resize(img[y0 : y0 + s, x0 : x0 + s], (side, side), "area")
    return bank


def get_background_bank(bg_dir: str | None, side: int = 512) -> np.ndarray:
    """The bank from `bg_dir` when it holds images, else the procedural
    bank. Only a missing directory or file falls back (FileNotFoundError,
    OSError, as the reference); a missing JPEG decoder
    (`improc.NoJpegDecoder`, a RuntimeError) or a damaged file raises."""
    if bg_dir and os.path.isdir(bg_dir):
        try:
            return load_backgrounds_from_dir(bg_dir, side)
        except (FileNotFoundError, OSError):
            pass
    return make_procedural_backgrounds(side=side)
