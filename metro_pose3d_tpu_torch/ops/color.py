"""Colour augmentation and input normalization (`metro_pose3d_tpu/ops/color.py`).

The 3x3 colour transforms are written out as float32 products and sums,
never as a matmul: on the card a matmul may round its inputs to TF32, and
the reference asks for `Precision.HIGHEST`.
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch import reference_constants as C

# Rec.601 luma
_LUMA = (0.299, 0.587, 0.114)
# RGB -> YIQ and back (hue = rotation of the IQ plane); the inverse is taken
# in float32 by numpy, exactly as the reference builds it
_RGB2YIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                     [0.211, -0.523, 0.312]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def _mat3(m: np.ndarray, a, b, c):
    """m [3,3] applied to the channel triple (a, b, c), term by term."""
    m = m.tolist()  # float32 values as Python floats: exact as float32 scalars
    return [m[i][0] * a + m[i][1] * b + m[i][2] * c for i in range(3)]


def color_jitter(images, brightness, contrast, saturation, hue):
    """Per-image colour jitter of float images [B,H,W,3] in [0, 1].

    brightness [B] additive shift; contrast [B] factor about 0.5;
    saturation [B] factor about each pixel's luma; hue [B] rotation of the
    chroma (IQ) plane in radians. Returns [B,H,W,3] clipped to [0, 1].
    """
    b = brightness.float()[:, None, None, None]
    c = contrast.float()[:, None, None, None]
    s = saturation.float()[:, None, None, None]
    x = images + b
    x = (x - 0.5) * c + 0.5
    r, g, bl = x.unbind(-1)
    luma = (r * _LUMA[0] + g * _LUMA[1] + bl * _LUMA[2])[..., None]
    x = luma + (x - luma) * s

    cos_h = torch.cos(hue.float())[:, None, None]
    sin_h = torch.sin(hue.float())[:, None, None]
    y, i, q = _mat3(_RGB2YIQ, *x.unbind(-1))
    i, q = i * cos_h - q * sin_h, i * sin_h + q * cos_h
    return torch.clamp(torch.stack(_mat3(_YIQ2RGB, y, i, q), dim=-1), 0.0, 1.0)


def composite_background(sources_u8, masks_u8, bg_bank_u8, bg_params):
    """Green-screen background replacement in source-tile space.

    sources_u8 [B,T,T,3] uint8; masks_u8 [B,T,T] uint8 (255 = foreground);
    bg_bank_u8 [N,T,T,3] uint8; bg_params [B,2] (enabled flag, bank index;
    an index outside the bank is clamped into it). Returns uint8 tiles,
    rounded half to even as `jnp.round` rounds.
    """
    enabled = bg_params[:, 0].float()[:, None, None, None]
    idx = bg_params[:, 1].to(torch.int32).clamp(0, bg_bank_u8.shape[0] - 1).long()
    bg = bg_bank_u8[idx].float()
    src = sources_u8.float()
    alpha = (masks_u8.float() / 255.0)[..., None]
    out = src * alpha + bg * (1.0 - alpha)
    out = src + enabled * (out - src)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def normalize(images01):
    """[0,1] float images -> model input range [-1, 1]."""
    return images01 * (255.0 * C.IMAGE_SCALE) + C.IMAGE_OFFSET


def denormalize(images):
    """Model input range [-1, 1] -> [0, 1]: the inverse of `normalize`."""
    return (images - C.IMAGE_OFFSET) / (255.0 * C.IMAGE_SCALE)
