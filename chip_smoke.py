#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`metro_pose3d_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
nvcc. It builds the four CUDA kernels from `metro_pose3d_tpu_torch/csrc/`
into `build/kernels/`, then runs in phases:

  1 env      torch and CUDA versions, the card's name and power limit
  2 build    nvcc build of the kernel library, in seconds
  3 k3       stem max pool kernel == its plain version, bit for bit
  4 k1       crop warp kernel against its plain version (atol 0.05 in [0,255])
  5 serve    the serving path at the default Config() (ResNet-50 @ 256,
             bf16, flip TTA, full reconstruction) with seeded random
             weights: 3 crop-in and 3 tile-in requests of 64; both kernels
             must have launched
  6 parity   the same path in float32 (TF32 off) on the card and on the CPU
  7 time     kernels against their plain versions, and crops/s of the
             serving forms, with CUDA events (informative only)
  8 k2       occluder paste kernel against its plain version (atol 1e-5)
  9 k3-bwd   stem pool backward kernel against the plain backward, ties
             included: float32 within 1e-6, bf16 within one bf16 ulp of the
             float32 sum
 10 train    the training path at the default Config() (R50@256 bf16, 64 3D
             + 32 2D rows, 512^2 tiles) through `train()`: 10 steps with a
             checkpoint at 5, a resume from 5 to 10, then 20 steps on one
             batch whose loss must fall; all four kernels must have launched
 11 t-parity one float32 train step (TF32 off) on the card and on the CPU
 12 t-time   K2, K3-bwd and the bf16 train step at B=96 (informative), with
             a profiler breakdown of the step

A failed phase raises, so the script exits non-zero. The last two lines are
the kernels' JSON record and `{"ok": true, "device": {...}}`. Without CUDA
it exits non-zero at once and prints no result. It imports no jax.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 64
TILE = 512
WARP_TOL = 0.05  # [0,255] units: float32 coordinate ulps through the bilinear weights
# Card against CPU in float32: ~25x the port-vs-JAX float32 differences of
# the same path on the CPU (2e-3 mm root-relative, 7e-5 px, 0.1 mm absolute
# at R50@256), for cuDNN's other summation orders.
PARITY_TOL = {"pose3d_rootrel": 0.05, "pose2d_px": 0.01, "pose3d_abs": 1.0}
OCC_TOL = 1e-5  # [0,1] units; the kernel keeps the plain version's order of operations
N3D, N2D = 64, 32  # rows of a train batch (Config().train.batch_size, batch_size_2d)
# One float32 train step, card against CPU (R50@128, B=4, TF32 off): the
# losses are sums over the same forward in another order; the gradient norm
# also moves where a ReLU input within that roundoff of 0 changes side.
TRAIN_PARITY_RTOL = {"loss": 1e-4, "loss3d": 1e-4, "loss2d": 1e-4, "grad_norm": 1e-3}
STATS_ATOL = 1e-4


def fail(msg: str):
    raise RuntimeError(msg)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def crop_params(rng, b, tile, side, kind):
    """Per-crop warp params (H [B,3,3], K [B,4], dist [B,5]) and crop
    intrinsics [B,3,3] from the numpy camera model of the JAX package.

    kind: "normal" (boxes near the axis, mild roll), "rot90" (roll near
    +-90 degrees), "behind" (a wide crop turned ~80 degrees off the source
    axis, so part of its rays pass behind the source camera)."""
    from metro_pose3d_tpu.geom.camera import Camera, get_warp_params

    hs, ks, ds, intr = [], [], [], []
    for _ in range(b):
        f = tile * rng.uniform(0.9, 1.3)
        dist = rng.uniform(-1, 1, 5) * [0.15, 0.03, 5e-4, 5e-4, 0.01]
        src = Camera([[f, 0, (tile - 1) / 2], [0, f, (tile - 1) / 2], [0, 0, 1]],
                     distortion_coeffs=dist)
        crop = src.copy()
        crop.undistort()
        if kind == "behind":
            yaw, roll, zoom = np.deg2rad(rng.uniform(75, 85)) * rng.choice([-1, 1]), 0.0, 0.3
        elif kind == "rot90":
            yaw = rng.uniform(-0.2, 0.2)
            roll = rng.choice([-1, 1]) * np.pi / 2 + rng.uniform(-0.02, 0.02)
            zoom = rng.uniform(0.8, 1.2)
        else:
            yaw, roll, zoom = rng.uniform(-0.2, 0.2), rng.uniform(-0.4, 0.4), rng.uniform(0.8, 1.3)
        pitch = rng.uniform(-0.2, 0.2)
        crop.turn_towards(1000 * np.array([np.sin(yaw), np.sin(pitch), np.cos(yaw)]))
        crop.rotate(roll)
        crop.zoom(zoom * side / tile)
        crop.center_principal_point((side, side))
        p = get_warp_params(src, crop)
        hs.append(p["H"])
        ks.append(p["K"])
        ds.append(p["dist"])
        intr.append(crop.K.astype(np.float32))
    return tuple(np.stack(a).astype(np.float32) for a in (hs, ks, ds, intr))


def tile_batch(rng, b, tile, side, kind="normal"):
    h, k, d, intr = crop_params(rng, b, tile, side, kind)
    return {"source": rng.randint(0, 256, (b, tile, tile, 3)).astype(np.uint8),
            "warp_h": h, "warp_k": k, "warp_dist": d, "intrinsics": intr}


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def warp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference; NaN (rays at the horizon with distortion) must coincide."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        fail("warp kernel and plain version disagree on NaN positions")
    ok = ~torch.isnan(a)
    return float((a[ok] - b[ok]).abs().max())


def tie_count(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """For each window of the SAME 3x3/2 pool, how many taps equal its max y."""
    from metro_pose3d_tpu_torch.ops.pool import _same_geometry

    oh, ow, (top, bottom), (left, right) = _same_geometry(x.shape[2], x.shape[3])
    xp = torch.nn.functional.pad(x.float(), (left, right, top, bottom), value=float("-inf"))
    return sum((xp[:, :, dy: dy + 2 * oh: 2, dx: dx + 2 * ow: 2] == y.float()).int()
               for dy in range(3) for dx in range(3))


def profile_breakdown(fn, steps: int) -> str:
    """torch.profiler over `steps` calls of fn: device time per call, the
    device's busy share of the wall time, the eight aten ops with the most
    self device time and the port's own kernels, as shares of device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ops = [], []
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        if t > 0:
            (kernels if evt.device_type == DeviceType.CUDA else ops).append((t, evt.key))
    total = sum(t for t, _ in kernels)
    if total == 0:
        return "[12 t-time] profiler: no device time recorded"
    names = ("maxpool3x3s2_same_bwd", "maxpool3x3s2_same_kernel", "occluder_paste", "warp_crop")
    ours = {n: sum(t for t, k in kernels if n in k) for n in names}
    ops.sort(reverse=True)
    top = "; ".join(f"{k} {t / total:.1%}" for t, k in ops[:8])
    mine = "; ".join(f"{n} {t / total:.2%}" for n, t in ours.items())
    return (f"[12 t-time] profiler, train step: device {total / 1e3 / steps:.2f} ms/step, "
            f"busy {total / 1e6 / wall:.1%} of wall; top ops by self device time: {top}; "
            f"port kernels: {mine}")


def train_batch(rng, n3, n2, tile, side, n_occ, occ_side=96):
    """A host train batch in the `example_spec` layout, made with numpy:
    warps from `crop_params`, a random skeleton about 4 m in front of the
    crop camera projected into the crop, and occluder and colour parameters
    drawn as `pipeline/crops.py::sample_aug_params` draws them. The last n2
    rows are 2D-only (is_3d 0, no 3D validity)."""
    b, j = n3 + n2, 17
    h, k, d, intr = crop_params(rng, b, tile, side, "normal")
    root = np.stack([rng.uniform(-300, 300, b), rng.uniform(-300, 300, b),
                     rng.uniform(3500, 5000, b)], 1)
    xyz = (root[:, None] + rng.uniform(-600, 600, (b, j, 3))).astype(np.float32)
    uv = np.einsum("bij,bkj->bki", intr, xyz)
    uv = (uv[..., :2] / uv[..., 2:]).astype(np.float32)
    valid2d = ((uv >= 0) & (uv < side)).all(-1).astype(np.float32)
    is3d = np.r_[np.ones(n3), np.zeros(n2)].astype(np.float32)
    do_color = rng.random_sample(b) < 0.8
    color = np.where(do_color[:, None], np.stack(
        [rng.uniform(-0.125, 0.125, b), rng.uniform(0.75, 1.25, b),
         rng.uniform(0.75, 1.25, b), rng.uniform(-0.3, 0.3, b)], 1), [0.0, 1.0, 1.0, 0.0])
    occ_aff = np.zeros((b, 2, 3))
    for i in range(b):
        scale, centre, rot = rng.uniform(0.2, 0.7), rng.uniform(0.1, 0.9, 2), rng.uniform(-np.pi, np.pi)
        m = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]]) / scale
        occ_aff[i, :, :2] = m
        occ_aff[i, :, 2] = occ_side / 2.0 - m @ (centre * side)
    occ = np.stack([rng.random_sample(b) < 0.7, rng.randint(0, n_occ, b)], 1)
    return {"source": rng.randint(0, 256, (b, tile, tile, 3), dtype=np.uint8),
            "warp_h": h, "warp_k": k, "warp_dist": d,
            "coords3d_true": xyz * is3d[:, None, None], "coords2d_true": uv,
            "joint_validity": np.repeat(is3d[:, None], j, 1), "joint_validity_2d": valid2d,
            "is_3d": is3d, "intrinsics": intr, "color_params": color.astype(np.float32),
            "occ_params": occ.astype(np.float32), "occ_affine": occ_aff.astype(np.float32)}


def occluder_case(rng, b, side, n_occ, occ_side=96):
    """Placements for the K2 check: full-range rotations with +-90 and +-180
    degrees, scales 1.4-5, centres that put part of the occluder outside
    the crop, and a 0/1 mix of `enabled`."""
    rot = rng.uniform(-np.pi, np.pi, b)
    rot[:4] = [np.pi / 2, -np.pi / 2, np.pi, -np.pi]
    scale = rng.uniform(1.4, 5.0, b)
    centre = rng.uniform(-0.2, 1.2, (b, 2)) * side
    aff = np.zeros((b, 2, 3), np.float32)
    for i in range(b):
        m = scale[i] * np.array([[np.cos(rot[i]), -np.sin(rot[i])],
                                 [np.sin(rot[i]), np.cos(rot[i])]])
        aff[i, :, :2] = m
        aff[i, :, 2] = occ_side / 2.0 - m @ centre[i]
    idx = rng.randint(0, n_occ, b).astype(np.int32)
    enabled = (rng.random_sample(b) < 0.7).astype(np.float32)
    crops = rng.uniform(0, 1, (b, side, side, 3)).astype(np.float32)
    return crops, idx, aff, enabled


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from metro_pose3d_tpu.config import Config, apply_overrides
    from metro_pose3d_tpu.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, PoseEstimator
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.kernels import build
    from metro_pose3d_tpu_torch.ops import occlusion, pool, warp

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # 1 env
    card = card_info()
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(card)

    # 2 build
    t0 = time.perf_counter()
    build.load()
    how = (f"built in {build.build_seconds:.1f} s" if build.build_seconds
           else "reused from an earlier build of the same sources")
    print(f"[2 build] kernels {how} (load {time.perf_counter() - t0:.1f} s) "
          f"-> {build.build().parent}")

    # 3 K3: pool kernel == plain version, bit for bit
    pool_err = 0.0
    for shape, dtype in (((64, 64, 128, 128), torch.bfloat16),
                         ((16, 64, 128, 128), torch.float32),
                         ((8, 64, 127, 129), torch.bfloat16),
                         ((8, 24, 33, 18), torch.float32)):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        got, want = pool.max_pool_cuda(x), pool.max_pool_plain(x)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"K3 pool kernel differs from its plain version at {shape} {dtype}")
        pool_err = max(pool_err, float((got.float() - want.float()).abs().max()))
        print(f"[3 k3] pool {tuple(shape)} {dtype}: bit-exact")

    # 4 K1: warp kernel against its plain version
    warp_max = 0.0
    cases = {kind: tile_batch(rng, BATCH, TILE, 256, kind) for kind in ("normal", "rot90", "behind")}
    for kind, batch in cases.items():
        t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        args = (t["source"], t["warp_h"], t["warp_k"], t["warp_dist"], 256)
        got, want = warp.warp_images_cuda(*args), warp.warp_images_plain(*args)
        torch.cuda.synchronize()
        err = warp_err(got, want)
        _, in_front = warp.warp_coords(t["warp_h"], t["warp_k"], t["warp_dist"], 256)
        behind = float((~in_front).float().mean())
        if err > WARP_TOL:
            fail(f"K1 warp kernel off its plain version by {err} > {WARP_TOL} ({kind})")
        if kind == "behind" and behind == 0.0:
            fail("the behind-camera case has no ray behind the camera")
        warp_max = max(warp_max, err)
        print(f"[4 k1] warp {kind} B={BATCH} {TILE}^2->256^2: max abs err {err:.2e} "
              f"(tol {WARP_TOL}), behind-camera share {behind:.3f}")
    frame = torch.from_numpy(rng.randint(0, 256, (1, 720, 1280, 3)).astype(np.uint8)).to(dev)
    h, k, d, _ = (torch.from_numpy(a).to(dev) for a in crop_params(rng, 16, 720, 256, "normal"))
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    got = warp.warp_images_cuda(frame, h, k, d, 256, idx)
    want = warp.warp_images_plain(frame, h, k, d, 256, idx)
    err = warp_err(got, want)
    if err > WARP_TOL:
        fail(f"K1 warp kernel off its plain version by {err} in frame mode")
    warp_max = max(warp_max, err)
    print(f"[4 k1] warp shared 1280x720 frame, 16 crops: max abs err {err:.2e}")

    # 5 serve: the main path, counting kernel launches
    cfg = Config()
    model = init_metro_model(cfg.model, SEED, dev)
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    side = cfg.model.proc_side
    crop_reqs = [(rng.randint(0, 256, (BATCH, side, side, 3)).astype(np.uint8),
                  crop_params(rng, BATCH, TILE, side, "normal")[3]) for _ in range(3)]
    tile_reqs = [tile_batch(rng, BATCH, TILE, side) for _ in range(3)]
    pool.LAUNCHES = warp.LAUNCHES = 0
    outs = [est.predict_crops(c, i) for c, i in crop_reqs]
    outs += [est.predict_tiles(b) for b in tile_reqs]
    torch.cuda.synchronize()
    launches = {"pool": pool.LAUNCHES, "warp": warp.LAUNCHES}
    for out in outs:
        for key, shape in (("pose3d_rootrel", (BATCH, 17, 3)), ("pose2d_px", (BATCH, 17, 2)),
                           ("pose3d_abs", (BATCH, 17, 3))):
            if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                fail(f"serving output {key}: shape {tuple(out[key].shape)} or not finite")
    if launches["pool"] == 0 or launches["warp"] == 0:
        fail(f"the serving path did not launch every kernel: {launches}")
    print(f"[5 serve] 3 crop-in + 3 tile-in requests of {BATCH} (R50@256 bf16, TTA, "
          f"full reconstruction): outputs finite, launches {launches}")

    # 6 parity: float32 on the card against float32 on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = apply_overrides(Config(), {"model.compute_dtype": "float32"})
    cpu_model = init_metro_model(cfg32.model, SEED + 1, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = tile_batch(rng, 2, TILE, side)
    crops = rng.randint(0, 256, (2, side, side, 3)).astype(np.uint8)
    worst = {}
    for form in ("crops", "tiles"):
        res = []
        for m in (gpu_model, cpu_model):
            e = PoseEstimator(cfg32, m, H36M_17, flip_tta=True, reconstruct=True)
            out = (e.predict_crops(crops, batch["intrinsics"]) if form == "crops"
                   else e.predict_tiles({k: batch[k] for k in TILE_KEYS}))
            res.append({k: v.float().cpu() for k, v in out.items()})
        for key, tol in PARITY_TOL.items():
            err = float((res[0][key] - res[1][key]).abs().max())
            worst[f"{form}:{key}"] = err
            if not err <= tol:
                fail(f"card vs CPU float32 {form} {key}: {err} > {tol}")
    print(f"[6 parity] float32 card vs CPU, B=2, TF32 off: max abs diff "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol {PARITY_TOL})")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    # 7 timings (informative; the card's name and power limit beside each)
    xp = torch.randn((2 * BATCH, 64, 128, 128), generator=gen, device=dev)
    xp = xp.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    pool_ms, pool_plain_ms = time_ms(lambda: pool.max_pool_cuda(xp)), time_ms(
        lambda: pool.max_pool_plain(xp))
    print(f"[7 time] K3 pool [{2 * BATCH},64,128,128] bf16: kernel {pool_ms:.4f} ms, "
          f"plain {pool_plain_ms:.4f} ms  [{card}]")
    t = {k: torch.from_numpy(v).to(dev) for k, v in tile_reqs[0].items()}
    wargs = (t["source"], t["warp_h"], t["warp_k"], t["warp_dist"], side)
    warp_ms, warp_plain_ms = time_ms(lambda: warp.warp_images_cuda(*wargs)), time_ms(
        lambda: warp.warp_images_plain(*wargs))
    print(f"[7 time] K1 warp B={BATCH} {TILE}^2->256^2: kernel {warp_ms:.4f} ms, "
          f"plain {warp_plain_ms:.4f} ms  [{card}]")
    from metro_pose3d_tpu_torch.evaluation.engine import make_predict_fn

    for form in ("crops", "tiles"):
        for flip_tta, b in ((True, BATCH), (False, 2 * BATCH)):
            fn = make_predict_fn(cfg, H36M_17.mirror_mapping, root_index=0, flip_tta=flip_tta,
                                 reconstruct=True, from_tiles=form == "tiles")
            if form == "crops":
                c = torch.from_numpy(rng.randint(0, 256, (b, side, side, 3)).astype(np.uint8))
                i = torch.from_numpy(crop_params(rng, b, TILE, side, "normal")[3])
                args = (model, c.to(dev), i.to(dev))
            else:
                tb = tile_batch(rng, b, TILE, side)
                args = (model, {k: torch.from_numpy(tb[k]).to(dev) for k in TILE_KEYS})
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: fn(*args), iters=10)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[7 time] serve {form}-in bf16 {'TTA' if flip_tta else 'no TTA'} B={b}: "
                  f"{ms:.3f} ms/batch, {b / ms * 1e3:.1f} crops/s, peak {peak:.2f} GiB  [{card}]")

    del model, est, fn, args
    torch.cuda.empty_cache()
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state
    from metro_pose3d_tpu_torch.train.trainer import train

    # 8 K2: occluder paste kernel against its plain version
    bank_np = make_procedural_occluders(64, 96)
    bank = pack_occluder_bank_for(bank_np, dev)
    crops_np, idx_np, aff_np, en_np = occluder_case(rng, 96, side, len(bank_np))
    k2_args = (torch.from_numpy(crops_np).to(dev), bank,
               *(torch.from_numpy(a).to(dev) for a in (idx_np, aff_np, en_np)))
    got, want = occlusion.occlude_cuda(*k2_args), occlusion.occlude_plain(*k2_args)
    torch.cuda.synchronize()
    occ_err = float((got - want).abs().max())
    if not occ_err <= OCC_TOL:
        fail(f"K2 occluder kernel off its plain version by {occ_err} > {OCC_TOL}")
    changed = float((got != k2_args[0]).any(-1).float().mean())
    print(f"[8 k2] occluder paste B=96 {side}^2, bank 64x96^2, rotations to +-180 deg, "
          f"scales 1.4-5, {int(en_np.sum())}/96 enabled: max abs err {occ_err:.2e} "
          f"(tol {OCC_TOL}), pixels changed {changed:.3f}")

    # 9 K3 backward: kernel against the plain backward, ties included
    bwd_err = 0.0
    for shape, dtype, ties in (((96, 64, 128, 128), torch.bfloat16, False),
                               ((96, 64, 128, 128), torch.float32, False),
                               ((8, 64, 127, 129), torch.bfloat16, True),
                               ((8, 24, 33, 18), torch.float32, True)):
        x = torch.randn(shape, generator=gen, device=dev)
        if ties:
            x = torch.round(x * 4) / 4  # neighbours often equal
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        g = torch.randn((shape[0], shape[1], (shape[2] + 1) // 2, (shape[3] + 1) // 2),
                        generator=gen, device=dev).to(dtype)
        got = pool.max_pool_bwd_cuda(x, g)
        want = pool.max_pool_bwd_plain(x.float(), g.float())  # float32 sums of dtype values
        err = (got.float() - want).abs()
        bwd_err = max(bwd_err, float(err.max()))
        if dtype == torch.float32:
            ok, note = float(err.max()) <= 1e-6, f"max abs err {float(err.max()):.2e} (tol 1e-6)"
        else:
            ulps = float((err / (want.abs() * 2 ** -7).clamp_min(1e-30)).max())
            same = float((got.float() - pool.max_pool_bwd_plain(x, g).float()).abs().max())
            ok = bool((err <= want.abs() * 2 ** -7).all())
            note = (f"max err {ulps:.2f} bf16 ulp of the float32 sum (tol 1), "
                    f"max abs diff to the bf16 autograd {same:.2e}")
        if not ok:
            fail(f"K3 backward kernel off its plain version at {shape} {dtype}: {note}")
        tied = ""
        if ties:
            y = pool.max_pool_plain(x)
            share = float((tie_count(x, y) > 1).float().mean())
            tied = f", windows with a tied max {share:.3f}"
        print(f"[9 k3-bwd] {tuple(shape)} {dtype}: {note}{tied}")
    del x, g, got, want, err

    # 10 train: the main path of this slice, counting kernel launches
    t0 = time.perf_counter()
    host = [train_batch(rng, N3D, N2D, TILE, side, len(bank_np)) for _ in range(10)]
    print(f"[10 train] 10 host batches of {N3D} 3D + {N2D} 2D rows, {TILE}^2 tiles, made "
          f"in {time.perf_counter() - t0:.1f} s")
    over = {"train.checkpoint_every": "5", "train.log_every": "1", "train.validate_every": "0"}

    def run(logdir, extra, batches, steps):
        tcfg = apply_overrides(Config(), {**over, **extra, "train.logdir": logdir})
        state = train(tcfg, batches, occluder_bank=bank_np, max_steps=steps)
        torch.cuda.synchronize()
        with open(os.path.join(logdir, "history.json")) as f:
            return state, json.load(f)

    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "run")
        pool.LAUNCHES = pool.BWD_LAUNCHES = warp.LAUNCHES = occlusion.LAUNCHES = 0
        t0 = time.perf_counter()
        state, hist = run(logdir, {}, iter(host), 10)
        first_leg = time.perf_counter() - t0
        # as if the run had been cut after its checkpoint at step 5
        for name in os.listdir(os.path.join(logdir, "checkpoints")):
            if name != "5":
                shutil.rmtree(os.path.join(logdir, "checkpoints", name))
        if Checkpointer(logdir).latest_step() != 5:
            fail("the checkpoint of step 5 is missing")
        warp_before = warp.LAUNCHES
        resumed, hist2 = run(logdir, {}, iter(host), 10)
        train_launches = {"pool": pool.LAUNCHES, "pool_bwd": pool.BWD_LAUNCHES,
                          "warp": warp.LAUNCHES, "occluder": occlusion.LAUNCHES}
        if any(v == 0 for v in train_launches.values()):
            fail(f"the training path did not launch every kernel: {train_launches}")
        if state.step != 10 or resumed.step != 10 or warp.LAUNCHES - warp_before != 5:
            fail(f"resume: steps {state.step}, {resumed.step}, "
                 f"{warp.LAUNCHES - warp_before} steps after the restore (want 5)")
        for h in (hist, hist2):
            if [r["step"] for r in h] != list(range(1, 11)) or not all(
                    np.isfinite([r["loss"], r["loss3d"], r["loss2d"], r["grad_norm"]]).all()
                    for r in h):
                fail(f"train history not finite or not steps 1..10: {h}")
        d10 = abs(hist2[-1]["loss"] - hist[-1]["loss"]) / hist[-1]["loss"]
        if d10 > 1e-2:
            fail(f"the resumed run's loss at step 10 differs by {d10:.2e} (rel)")
        print(f"[10 train] Config() R50@256 bf16, B={N3D}+{N2D}: 10 steps in {first_leg:.1f} s "
              f"(loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, finite), checkpoint at 5, "
              f"resumed 5 -> 10 (step-10 loss rel diff {d10:.1e}); launches {train_launches}")
        del state, resumed
        fixed, hist3 = run(os.path.join(tmp, "fixed"), {
            "train.warmup_steps": "0", "data.cycle_batches": "1", "train.checkpoint_every": "20"},
            iter(host[:1]), 20)
        losses = [r["loss"] for r in hist3]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"the loss did not fall on one fixed batch: {losses}")
        rate = float(np.median([r["crops_per_sec"] for r in hist3[2:]]))
        print(f"[10 train] 20 steps on one batch, no warmup: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; host-clock rate {rate:.1f} crops/s  [{card}]")
        del fixed
    torch.cuda.empty_cache()

    # 11 train parity: one float32 step on the card and on the CPU, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = apply_overrides(Config(), {"model.compute_dtype": "float32", "model.proc_side": "128",
                                      "train.warmup_steps": "0"})
    pbatch = train_batch(rng, 3, 1, TILE, 128, len(bank_np))
    res = []
    for d in (dev, torch.device("cpu")):
        st = create_train_state(pcfg, d, seed=SEED + 2)
        step = make_train_step(pcfg, 0, occluder_bank=pack_occluder_bank_for(bank_np, d))
        m = step(st, batch_to_device(pbatch, d))
        res.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in st.model.state_dict().items()}))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    (mg, sg), (mc, sc) = res
    for k, tol in TRAIN_PARITY_RTOL.items():
        if not abs(mg[k] - mc[k]) <= tol * abs(mc[k]):
            fail(f"train parity {k}: card {mg[k]} CPU {mc[k]} (rtol {tol})")
    stats = [k for k in sc if k.endswith((".mean", ".var"))]
    stat_err = max(float((sg[k] - sc[k]).abs().max()) for k in stats)
    diff = torch.cat([(sg[k] - sc[k]).abs().flatten() for k in sc if k not in stats])
    lr = pcfg.train.base_lr
    near = float((diff <= 0.1 * lr).float().mean())
    if not (stat_err <= STATS_ATOL and float(diff.max()) <= 2 * lr + 1e-6 and near > 0.99):
        fail(f"train parity: BN stats {stat_err:.2e} (tol {STATS_ATOL}), params max "
             f"{float(diff.max()):.2e} (tol 2 lr), share within lr/10 {near:.4f} (want > 0.99)")
    print(f"[11 t-parity] one float32 step R50@128 B=4, card vs CPU, TF32 off: rel diff "
          + ", ".join(f"{k} {abs(mg[k] - mc[k]) / abs(mc[k]):.1e}" for k in TRAIN_PARITY_RTOL)
          + f" (rtol {TRAIN_PARITY_RTOL}); BN stats {stat_err:.1e} (atol {STATS_ATOL}); "
          f"params: median {float(diff.median()):.1e}, max {float(diff.max()):.1e} "
          f"(<= 2 lr), share within lr/10 {near:.5f}")
    del res, sg, sc

    # 12 timings (informative; the card's name and power limit beside each)
    occ_ms, occ_plain_ms = time_ms(lambda: occlusion.occlude_cuda(*k2_args)), time_ms(
        lambda: occlusion.occlude_plain(*k2_args))
    print(f"[12 t-time] K2 occluder paste B=96 {side}^2: kernel {occ_ms:.4f} ms, "
          f"plain {occ_plain_ms:.4f} ms  [{card}]")
    xb = torch.randn((96, 64, 128, 128), generator=gen, device=dev).to(torch.bfloat16)
    xb = xb.contiguous(memory_format=torch.channels_last)
    gb = torch.randn((96, 64, 64, 64), generator=gen, device=dev).to(torch.bfloat16)
    bwd_ms, bwd_plain_ms = time_ms(lambda: pool.max_pool_bwd_cuda(xb, gb)), time_ms(
        lambda: pool.max_pool_bwd_plain(xb, gb))
    print(f"[12 t-time] K3-bwd [96,64,128,128] bf16: kernel {bwd_ms:.4f} ms, "
          f"plain {bwd_plain_ms:.4f} ms  [{card}]")
    del xb, gb
    tcfg = Config()
    st = create_train_state(tcfg, dev, seed=SEED)
    step = make_train_step(tcfg, 0, occluder_bank=bank)
    tb = batch_to_device(host[0], dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(st, tb), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[12 t-time] train step Config() R50@256 bf16 B={N3D + N2D}: {step_ms:.2f} ms, "
          f"{(N3D + N2D) / step_ms * 1e3:.1f} crops/s, peak {peak:.2f} GiB  [{card}]")
    print(profile_breakdown(lambda: step(st, tb), steps=2))

    record = {"kernels": [
        {"name": "maxpool3x3s2_same", "route": "cuda",
         "source": "metro_pose3d_tpu_torch/csrc/maxpool_same.cu",
         "replaces": "metro_pose3d_tpu/ops/pool_pallas.py:90",
         "launches": launches["pool"] + train_launches["pool"],
         "max_abs_err": pool_err, "ms": pool_ms, "plain_ms": pool_plain_ms},
        {"name": "maxpool3x3s2_same_bwd", "route": "cuda",
         "source": "metro_pose3d_tpu_torch/csrc/maxpool_same_bwd.cu",
         "replaces": "metro_pose3d_tpu/ops/pool_pallas.py:90",
         "launches": train_launches["pool_bwd"],
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms},
        {"name": "warp_crop", "route": "cuda",
         "source": "metro_pose3d_tpu_torch/csrc/warp_crop.cu",
         "replaces": "metro_pose3d_tpu/ops/warp_pallas.py:415",
         "launches": launches["warp"] + train_launches["warp"],
         "max_abs_err": warp_max, "ms": warp_ms, "plain_ms": warp_plain_ms},
        {"name": "occluder_paste", "route": "cuda",
         "source": "metro_pose3d_tpu_torch/csrc/occluder_paste.cu",
         "replaces": "metro_pose3d_tpu/ops/warp_pallas.py:507",
         "launches": train_launches["occluder"],
         "max_abs_err": occ_err, "ms": occ_ms, "plain_ms": occ_plain_ms},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
