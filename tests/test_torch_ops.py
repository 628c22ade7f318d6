"""Parity of the port's decode, TTA, reconstruction and color ops with JAX.

The same numpy inputs, made from a seed, go through the JAX function and its
PyTorch counterpart on the CPU. All of these ops run in float32 in both
packages; tolerances are float32 roundoff of the stated magnitudes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.geom.joints import H36M_17
from metro_pose3d_tpu.ops import color as jcolor
from metro_pose3d_tpu.ops import decode as jdecode
from metro_pose3d_tpu.ops import pose3d as jpose3d
from metro_pose3d_tpu.ops import soft_argmax as jsa
from metro_pose3d_tpu.ops import tta as jtta
from metro_pose3d_tpu_torch.ops import color, decode, pose3d, soft_argmax, tta

MIRROR = np.asarray(H36M_17.mirror_mapping)
EDGES = np.asarray(H36M_17.edges)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _pose_inputs(seed, b=4, j=17):
    rng = np.random.RandomState(seed)
    pose3d_rel = rng.normal(0, 300, (b, j, 3)).astype(np.float32)
    pose2d = rng.uniform(20, 230, (b, j, 2)).astype(np.float32)
    f = rng.uniform(800, 1500, b)
    intr = np.zeros((b, 3, 3), np.float32)
    intr[:, 0, 0], intr[:, 1, 1] = f, f * rng.uniform(0.98, 1.02, b)
    intr[:, 0, 1] = rng.uniform(-2, 2, b)
    intr[:, 0, 2], intr[:, 1, 2], intr[:, 2, 2] = 127.5, 127.5, 1.0
    return pose3d_rel, pose2d, intr


@pytest.mark.parametrize("shape", [(3, 16, 16, 17), (2, 8, 12, 5)])
def test_soft_argmax_2d(shape):
    logits = np.random.RandomState(0).normal(0, 3, shape).astype(np.float32)
    # outputs in (0, 1): float32 softmax + weighted sum over <= 256 cells
    _close(soft_argmax.soft_argmax_2d(_t(logits)),
           jsa.soft_argmax_2d(jnp.asarray(logits)), atol=2e-6)


@pytest.mark.parametrize("shape", [(3, 16, 16, 8, 17), (2, 4, 6, 5, 3)])
def test_soft_argmax_3d(shape):
    logits = np.random.RandomState(1).normal(0, 3, shape).astype(np.float32)
    # outputs in (0, 1): float32 softmax + weighted sum over <= 2048 cells
    _close(soft_argmax.soft_argmax_3d(_t(logits)),
           jsa.soft_argmax_3d(jnp.asarray(logits)), atol=2e-6)


def test_decode_maps():
    c = np.random.RandomState(2).uniform(0, 1, (3, 17, 3)).astype(np.float32)
    # one float32 multiply-add each: exact up to an ulp of the output
    _close(decode.heatmap_to_metric(_t(c), 2200.0),
           jdecode.heatmap_to_metric(jnp.asarray(c), 2200.0), atol=1e-4)
    _close(decode.heatmap_to_image(_t(c[..., :2]), 256),
           jdecode.heatmap_to_image(jnp.asarray(c[..., :2]), 256), atol=1e-5)
    _close(decode.root_relative(_t(c), 0), jdecode.root_relative(jnp.asarray(c), 0), atol=0)


def test_normalize():
    x = np.random.RandomState(3).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    _close(color.normalize(_t(x)), jcolor.normalize(jnp.asarray(x)), atol=0)


def test_denormalize():
    x = np.random.RandomState(5).uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    _close(color.denormalize(_t(x)), jcolor.denormalize(jnp.asarray(x)), atol=0)


def test_denormalize_inverts_normalize():
    """Within a float32 ulp of 1: normalize's product and offset round once
    each, and the division and the offset of the way back once each."""
    x = np.random.RandomState(6).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    _close(color.denormalize(color.normalize(_t(x))), x, atol=2 * np.spacing(np.float32(1)))
    u8 = np.arange(256, dtype=np.float32) / 255.0
    _close(color.denormalize(color.normalize(_t(u8))) * 255.0, np.arange(256), atol=1e-4)


def test_tta_flip_and_unflip():
    rng = np.random.RandomState(4)
    crops = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    _close(tta.flip_crop(_t(crops)), jtta.flip_crop(jnp.asarray(crops)), atol=0)
    p3 = rng.normal(0, 300, (2, 17, 3)).astype(np.float32)
    p2 = rng.uniform(0, 255, (2, 17, 2)).astype(np.float32)
    mirror = torch.as_tensor(MIRROR)
    _close(tta.unflip_pose3d(_t(p3), mirror),
           jtta.unflip_pose3d(jnp.asarray(p3), jnp.asarray(MIRROR)), atol=0)
    _close(tta.unflip_pose2d(_t(p2), mirror, 256),
           jtta.unflip_pose2d(jnp.asarray(p2), jnp.asarray(MIRROR), 256), atol=0)


@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_reconstruct_absolute(weak, weighted):
    p3, p2, intr = _pose_inputs(5)
    w = np.random.RandomState(6).uniform(0, 1, p3.shape[:2]).astype(np.float32) \
        if weighted else None
    got = pose3d.reconstruct_absolute(_t(p3), _t(p2), _t(intr),
                                      None if w is None else _t(w), weak_perspective=weak)
    want = jpose3d.reconstruct_absolute(jnp.asarray(p3), jnp.asarray(p2), jnp.asarray(intr),
                                        None if w is None else jnp.asarray(w),
                                        weak_perspective=weak)
    # camera-frame mm at depths of metres: the refined float32 solves agree
    # to ~1e-6 relative; 1e-5 leaves room for another LU pivot order
    _close(got, want, atol=1e-2, rtol=1e-5)


def test_bone_lengths_and_rescale():
    p3, _, _ = _pose_inputs(7)
    edges = torch.as_tensor(EDGES)
    ref = np.random.RandomState(8).uniform(100, 500, len(EDGES)).astype(np.float32)
    _close(pose3d.bone_lengths(_t(p3), edges),
           jpose3d.bone_lengths(jnp.asarray(p3), jnp.asarray(EDGES)), atol=1e-3, rtol=1e-6)
    _close(pose3d.rescale_to_bone_lengths(_t(p3), edges, _t(ref)),
           jpose3d.rescale_to_bone_lengths(jnp.asarray(p3), jnp.asarray(EDGES),
                                           jnp.asarray(ref)), atol=1e-3, rtol=1e-6)
