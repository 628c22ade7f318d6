"""Similarity (Procrustes) alignment for PA-MPJPE, in numpy on the host
(`metro_pose3d_tpu/geom/procrustes.py`; the port keeps its own copy, which
gives the same floats). Only the offline scorers use it."""
from __future__ import annotations

import numpy as np


def procrustes_align(pred, gt, allow_scaling=True, allow_reflection=False):
    """Optimal similarity transform of `pred` onto `gt` (per-example).

    pred, gt: (..., J, 3). Returns the transformed pred with the same shape.
    """
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_p = pred.mean(axis=-2, keepdims=True)
    mu_g = gt.mean(axis=-2, keepdims=True)
    p = pred - mu_p
    g = gt - mu_g

    cov = np.einsum("...ji,...jk->...ik", g, p)  # 3x3 = g^T p
    u, s, vt = np.linalg.svd(cov)
    rot = u @ vt
    if not allow_reflection:
        det = np.linalg.det(rot)
        fix = np.ones_like(s)
        fix[..., -1] = np.sign(det)
        rot = u @ (fix[..., :, None] * vt)
        s = s * fix

    if allow_scaling:
        var_p = np.einsum("...ji,...ji->...", p, p)
        scale = s.sum(axis=-1) / np.maximum(var_p, 1e-12)
        scale = scale[..., None, None]
    else:
        scale = 1.0

    return scale * np.einsum("...ij,...kj->...ki", rot, p) + mu_g
