#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`metro_pose3d_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
nvcc. It builds the CUDA kernels from `metro_pose3d_tpu_torch/csrc/` into
`build/kernels/`, then runs in phases:

  1 env      torch and CUDA versions, the card's name and power limit
  2 build    nvcc build of the kernel library, in seconds; registers and
             spills of the crop warp, row-select, roll, lane-loop, gather,
             row-slice and QK1 wgmma kernels, and the warpgroup tensor-core
             instructions (HGMMA, IGMMA) in the row select's and QK1's SASS
  3 k3       stem max pool kernel == its plain version, bit for bit (NaN
             where it has NaN), in both variants: 16-byte vectors and scalar
  4 k1       crop warp kernel in each form (epilogue none, unit, normalize
             and normalize_div in float32 and bf16), crop and frame mode,
             against the plain
             chain (0.05 in [0,255], scaled to the form's units; bf16 plus
             one bf16 ulp), and the fused form bit for bit equal to the
             unfused kernel output through the plain epilogue
  5 serve    the serving path at the default Config() (ResNet-50 @ 256,
             bf16, flip TTA, full reconstruction) with seeded random
             weights: 3 crop-in and 3 tile-in requests of 64; both kernels
             must have launched, the pool in its 16-byte variant and the
             warp with its bf16 normalize epilogue only
  6 parity   the same path in float32 (TF32 off) on the card and on the
             CPU; then the soft-argmax decode with TF32 matmuls on, card
             against CPU (1e-5 in (0,1) units)
  7 time     kernels against their plain versions (device time by the
             profiler, and CUDA events per call), every K1 form beside the
             unfused chain, crops/s of the serving forms, and a profiler
             breakdown of tile-in serving (informative only)
  8 k2       occluder paste kernel against its plain version (atol 1e-5)
  9 k3-bwd   stem pool backward kernel against the plain backward on random,
             tied, post-ReLU and all-negative inputs, in both variants:
             float32 within 1e-6, bf16 within one bf16 ulp of the float32
             sum; two launches on one input bitwise equal
 10 train    the training path at the default Config() (R50@256 bf16, 64 3D
             + 32 2D rows, 512^2 tiles, background_prob 0.7) through the
             batch-fed loop (`trainer._train_on_batches`, the loop of
             `train()`), on batches that carry a foreground mask: 10 steps
             with a checkpoint at 5, a resume from 5 to 10, then 20 steps on
             one batch whose loss must fall; the loop builds the procedural
             background bank and every step composites on the card; all
             four kernels must have launched, the pool's forward and
             backward in their 16-byte variants, the warp with its unit
             epilogue only
 11 t-parity one float32 train step (TF32 off) of a masked batch with the
             background bank on the card and on the CPU
 12 t-time   K2, K3-bwd (random and post-ReLU input) and the bf16 train step
             at B=96 without and with the background bank (informative),
             with a profiler breakdown of the step
 13 modes    the pool's `torch` and `keras` alignments: forward bit for bit
             (float32 and bf16, even and odd sizes, all-negative border
             windows, the main-path shape), backward at phase 9's tolerances
             on random, tied and post-ReLU inputs, with the share of tied
             windows, in both variants; then their times beside
             `F.max_pool2d`
 14 families serving at full width (bf16, 256^2, B=64, flip TTA, full depth)
             of (a) the torchvision layout: resnet50 v1.5, torch padding,
             stride on the first unit; (b) the Keras-v2 layout: resnet50 v2,
             keras padding, stride on the last unit, v2 biases; (c) resnet34
             with (a)'s flags; (d) the 2.5D head on the default backbone:
             3 crop-in + 3 tile-in requests each, the pool kernel of the
             family's alignment (16-byte variant) and the warp must have
             launched; float32
             card against CPU for (a) and (b); crops/s of (a), (b), (c)
 15 f-train  training (a) from a backbone `.npz` written from a seeded
             torchvision-named state dict (`train.backbone_init`): 6 steps
             of 64 + 32 rows on one batch through the batch-fed loop, the loss must
             fall, the `torch` forward and backward kernels must have
             launched; 3 steps of (b) for the `keras` pair; one float32 step
             of (a) on the card and on the CPU
 16 probes   each probe kernel == its plain version; the gathers also on
             `probes.gather.edge_cases` (W = 1, 13, 130, H = 1, B = 1, the
             largest tile, unaligned inputs), and the shapes their tile
             cannot hold must raise; the roll, lane loop and row slice also
             on `probes.prims.edge_cases` (negative and out-of-range shifts
             and starts, the ends of int32, widths not a multiple of 4, reps
             0, 1, 33 and above the width, the row slice's run splits); the
             gathers (each sweep shape apart, then summed) and the row slice
             timed by device time beside an empty kernel on their grid (the
             launch floor), the plain version and `take_along_dim`; then
             the probes' own entry points (`probes.gather.main`,
             `probes.prims.main`) with their times and rates; the row
             select's time by split, and one `torch.bmm` over the stacked
             rolls as its yardstick
 17 int8     the int8 serving path (`model.quantize="int8"`): QK1 (the int8
             implicit-GEMM conv) bit for bit its twin under every epilogue
             and output type at the path's shapes (the 16 3x3 and the 36
             1x1 convs of R50 v2 @ 256 at B=128, `QK1_PATH`,
             `QK1_PATH_1X1`) in the wgmma variant, and at the edge shapes
             (the 7x7/2 stem with C = 3, odd sizes, C = 24, torch pads with
             N = 70) in both variants; QK2 (the elementwise int8 forms) in
             both variants at stage 1's shapes; `calibrate` on the card
             over 3 seeded batches of 64; 3 crop-in + 3 tile-in requests of
             64 at full width (bf16, TTA), which must take route B: 52 QK1
             launches a forward, all wgmma (32 requant, 20 dequant), 20 QK2
             quantize and no `torch._int_mm`, with K3 (16-byte variant) and
             K1 (bf16 normalize only); the calibrated model in float32 on
             the card and on the CPU, logits within 0.05 max|logits3d| +
             0.02; then (informative) each QK1 path shape's device time
             beside its bound (int8 operations at the card's rate, or
             bytes), `torch._int_mm` on the same sums and, for a 1x1 conv,
             `_int_mm` + the QK2 form it replaced; QK2 beside its bytes
             bound, int8 crops/s beside bf16 in turns (crop-in TTA B=64, no
             TTA B=128, tile-in TTA B=64), and a profiler breakdown of int8
             tile-in serving

 18 feed     the host input pipeline: builds the host runtime
             (`metro_pose3d_tpu_torch/native/`, the C crop engine and, where
             libjpeg is found, the JPEG decoder, into `build/native/`) and
             prints the seconds; decodes the JPEG fixture in `tests/fixtures/`
             against its stored pixels where libjpeg was found; holds
             `prepare_example`'s native engine to its python one over 64 draws
             (flips, large rotations, a distorted camera, 2D-only rows with
             NaN, masks; float fields within 1e-6, uint8 equal); measures
             (informative) the examples/s of `batch_iterator` by engine, pool
             type and worker count, with the synthetic render and on frames
             held in memory, and the copy of one 96-row batch to the card,
             pageable and pinned; then `train(Config(), SyntheticDataset, a
             2D-only view)` with `data.host_prep` auto (which must resolve to
             the C engine) through the loader and `prefetch`: 10 steps with a
             checkpoint at 5 and a resume from 5 to 10 that must prepare 5 x
             96 examples and no skipped one, finite losses, K1 unit, K2 and K3
             forward and backward (16-byte variants) launched, the wall time a
             step and the share of it spent waiting for the loader beside phase
             12's device-resident step; and 3 steps on a dataset whose
             `has_masks` is true, where `train()` must build the background
             bank and composite at every step
 19 dataset  the --test protocol path from annotation files to scores: an
             H36M-layout shard (subjects 1/5 train, 9/11 test, the JAX
             package's synthetic shard's cameras and world transform) of
             1000x1000 frames drawn by the port's renderer and stored as PNG
             (rows filtered None, Sub, Up, Average, Paeth in turn, so that the
             port's PNG unfilter runs every case); `get_dataset("h36m")` ->
             `predict_dataset(Config())` (R50@256 bf16, flip TTA, bone-length
             rescale, absolute reconstruction, the loader's thread pool) over
             300 test examples in 3 batches of 128, the last padded ->
             `save_predictions` -> `eval_h36m`: n_test rows, finite scores,
             the five canonical actions, K1 (bf16 normalize) and K3 launched
             once a batch; examples/s and the loader-wait share (informative);
             the first 8 test examples in float32 (TF32 off) on the card and
             on the CPU within PARITY_TOL; the int8 leg on the same weights:
             `calibrate_on_dataset` over 2 batches, `predict_dataset` (52 QK1
             and 20 QK2 launches a batch), `eval_h36m`, its MPJPE within 5% of
             the float one, and the first 4 test examples through it in
             float32 on the card and on the CPU (QK1/QK2's plain twins)
             within INT8_PARITY_TOL
 20 multi    the multi-person frame path and the command line:
             `MultiPersonEstimator` (Config(): R50@256 bf16, TTA, frame mode,
             the default buckets) on a synthetic 720p sequence of 48 frames of
             6 people: `warmup(8)`, then `estimate_stream(depth=2)` and an
             `estimate_frame` loop, frames/s and persons/s of each, their
             outputs equal (1e-3 mm/px), 48 K1 `normalize_div` bf16 and 48 K3
             launches a pass; one frame of 3 in float32 (TF32 off) on the card
             and on the CPU within PARITY_TOL (pose2d_px times the crops'
             zoom), and frame mode against tile mode with tiles that cover the
             ROI (0.5 mm, 0.1 px); int8 (calibrated as in phase 17) over 8
             frames, 52 QK1 and 20 QK2 launches a frame, its distance from
             bf16; `predict_multiperson_dataset` over 16 frames held in memory
             -> `eval_3dpw`; `main --train` (20 steps of the synthetic dataset,
             validation every 10: two val_mpjpe rows and the best checkpoint at
             their minimum, read back), `main --test` on the trained checkpoint
             and `--eval-h36m` (its printed scores equal `eval_h36m`'s),
             `--export` and `load_exported` (the checkpoint's weights bit for
             bit, one batch predicted)
 21 dp       data-parallel training (`parallel/`): 2 ranks, each a process of
             this script (`--dp-rank`), in a Gloo group on the one card
             through a `file://` rendezvous, train the default Config()
             (R50@256 bf16) on their rows of global batches of 64 3D + 32
             2D rows of 512^2 tiles (32 + 16 a rank), device-resident, through
             the batch-fed loop: 3 steps with a checkpoint, then a resume from
             3 to 5; the ranks' states equal (sha256), rank 0's history steps
             1..5 with finite losses, and on each rank K1 `unit`, K2, K3 and
             K3's backward launched once a step, in their 16-byte variants;
             each rank's ms a step and the share of a step spent in its
             collectives (informative); one float32 step (TF32 off, R50@128,
             global 6 + 2 rows) of the 2 ranks against one process on the
             same global batch within TRAIN_PARITY_RTOL, and its BN statistics
             and parameters as phase 11 holds them, and the same step with
             ghost BN in one group of the 8 global rows (4 on each rank: the
             group spans both) against one process; each rank's bf16 step
             with ghost BN in groups of 32 global rows (rows 32-63 straddle
             the ranks; informative); then NCCL as a group of
             one in this process: the float32 step within TRAIN_PARITY_RTOL of
             the step without a group, and the bf16 step's times; NCCL with 2
             ranks where the machine has two cards. A rank that fails, or a
             spawn that outlasts DP_TIMEOUT, fails the phase after every rank
             is killed
 22 real     real files on a machine without libjpeg or cv2, from the
             fixtures of `tests/fixtures/real_files/`: `improc.jpeg_backend()`
             must be nvJPEG (`native/nvjpegdec.cu`, built with nvcc; its path
             and version printed); every fixture JPEG (4:4:4, 4:2:2, 4:2:0,
             gray, progressive, restart interval, 37x53, 1000x1000 frame and
             mask) decoded by nvJPEG, colour and gray, within NVJPEG_CEILINGS
             (max 16, mean 1.0 levels) of its stored libjpeg pixels, with the
             share of pixels more than a level apart; the 1000x1000 frame's
             decode ms, one at a time and through `decode_jpeg_batch` on 4
             threads, and the device memory of a process that has decoded
             one (informative); the VOC occluder bank and the background bank
             from the fixture trees through nvJPEG, against the banks built
             from the stored libjpeg pixels (their tile counts and sha256
             fixed on the CPU, REAL_BANKS); `predict_dataset` (Config(),
             R50@256 bf16, TTA) on an H36M-layout shard of 128 copies of the
             1000x1000 JPEG, first pass and cached, against the same shard
             framed as PNGs of libjpeg's pixels (the predictions' largest
             difference in mm and px, informative), K1 normalize bf16 and K3
             once a pass; then `train()` at Config() for 3 steps on a
             3DHP-layout shard of JPEG frames and a JPEG mask with
             `data.occluder_root` and `data.background_root` the fixture
             trees: the VOC bank of 6 tiles and the background bank of 4, a
             composite at every step, finite losses, K1 unit, K2, K3 and K3's
             backward launched once a step
 23 finish   `export.aot_compile` (Config(): R50@256, crop-in with flip TTA,
             B=64) from `load_exported` bundles of seeded weights, bf16 and
             int8 (calibrated as in phase 17): each captured as a CUDA graph;
             load to first answer, eager and compiled, and steady ms a batch,
             eager and replayed (informative); the replay against the eager
             call on the same inputs and on fresh ones (equal bits expected;
             otherwise within PARITY_TOL / INT8_PARITY_TOL), an earlier
             answer unchanged by a later replay, a batch of 32 refused, and
             the wrappers' counts ticking once a replay by one replay's
             launches (K3 1; int8 also QK1 52 and QK2 20); a capture of a
             function that reads the card on the host raises. Then
             `demo.main` on the card writes a PNG that the port reads back
             and, with `--video 8`, an npz of 8 overlay frames, one K1
             normalize_div bf16 and one K3 launch a frame, without cv2 or
             matplotlib; then `utils/profiling.py`: `StepTimer` and `sync`
             around 20 eager predicts, `device_memory_stats()` (a peak above
             0, the card's total memory as the limit) and a `trace()` of 3
             predicts whose file names the stem pool's kernel (a trace that
             misses it is taken again, eight at most)

 24 bn       eval batch norm and its ReLU in one kernel (`ops/bn.py`): bit for
             bit its twin at the 49 batch norms of a Config() forward of 128
             rows (bf16, channels_last, with and without the ReLU, in both
             variants) and on NaN, +-inf and -0.0 in float32 and bf16,
             channels_last and NCHW; 49 launches a bf16 crop-in and tile-in
             forward and 17 an int8 one (TTA, B=64), all vec16 with the ReLU,
             whose outputs equal the same forward's with the twin's chain;
             then (informative) its device time over a crop-in forward's 49
             launches beside the bytes bound, the kernel and the twin alone at
             the same shapes, and the crop-in forward with each. Phases 10,
             17, 19, 20 and 23 count its launches on their paths too: none in
             a train step, 49 a bf16 forward and 17 an int8 one elsewhere.
 25 effv2    EfficientNetV2-L (`model.backbone="efficientnetv2-l"`): the
             depthwise kernel (`ops/dwconv.py`) bit for bit its twin at the 61
             depthwise convs of a forward of 128 rows (bf16, channels_last,
             both variants), the batch norm kernel bit for bit its twin at the
             217 batch norms (142 with the SiLU); a crop-in TTA batch of 64
             through `PoseEstimator` launches 61 depthwise and 217 batch norm
             kernels (142 SiLU) and equals the same batch with both twins;
             then (informative) the depthwise kernel alone at the 61 shapes
             beside its twin, cuDNN's grouped conv and the bytes bound, both
             kernels' device time over the forward, and the forward's time
             with the kernels and with the twins.

A failed phase raises, so the script exits non-zero. The last two lines are
the kernels' JSON record and `{"ok": true, "device": {...}}`. Each kernel's
record holds its launches on the path that runs it, its time, its plain
version's, its bound (the larger of bytes moved over the card's 3.35 TB/s
and operations over the card's peak for their type) and, where one PyTorch
call computes the same function, that call's time; a pool record also holds
its share of the bound. The roll, the lane loop and the row slice count
int32 adds at the INT32 pipe's rate (64 three-input adds, so 128 adds, a
clock an SM, at the card's SM count and maximum SM clock), the lane loop
also its shared-memory words (128 B a clock an SM), the row slice only the
rows its starts touch; their records name the term that bounds them
(`bound_term`: bytes, int32 adds or shared words; `bound_by` says bytes or
operations), and add the bytes-only bound (`bound_bytes_ms`), both shares,
and the kernel's time at reps 0 (`ms_reps0`: its loads and stores alone).
QK1's record sums the 52 convs of one backbone forward (`per_shape`
lists each, with its count; `parts` sums the 3x3 and the 1x1 ones apart),
its `library_ms` is `torch._int_mm` on the same integer sums (the unfolded
input of a 3x3); QK2's sums one launch of each form at stage 1
(`per_form`); both are marked as not TPU kernels in `replaces`. K3's,
QK1's and QK2's records add `graph_replay_launches`: their launches in one
replay of phase 23's CUDA graph of each bundle, bf16 and int8.
The gathers' and the row slice's records add `floor_ms`, the device time
of an empty kernel on their grid, block and shared memory; the gathers'
`library_ms` is `take_along_dim` on int64 indices cast beforehand (ATen's
gather kernel alone), their `plain_ms` the plain version with its cast,
both by device time; the sweep's record sums its shapes and lists each
(`per_shape`). The crop warp's and every probe's `ms` is device time from
the profiler (their wrappers' host work outlasts the kernel, so CUDA events
around back-to-back calls time the host; that reading is `call_ms`); the
other kernels' `ms` is by CUDA events. Without CUDA it exits non-zero at
once and prints no result. It imports no jax.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH = 64
TILE = 512
WARP_TOL = 0.05  # [0,255] units: float32 coordinate ulps through the bilinear weights
# Card against CPU in float32: ~25x the port-vs-JAX float32 differences of
# the same path on the CPU (2e-3 mm root-relative, 7e-5 px, 0.1 mm absolute
# at R50@256), for cuDNN's other summation orders.
PARITY_TOL = {"pose3d_rootrel": 0.05, "pose2d_px": 0.01, "pose3d_abs": 1.0}
OCC_TOL = 1e-5  # [0,1] units; the kernel keeps the plain version's order of operations
ENGINE_RTOL = 1e-6  # the C crop engine against numpy: float32 outputs of float64 math
N3D, N2D = 64, 32  # rows of a train batch (Config().train.batch_size, batch_size_2d)
# One float32 train step, card against CPU (R50@128, B=4, TF32 off): the
# losses are sums over the same forward in another order; the gradient norm
# also moves where a ReLU input within that roundoff of 0 changes side.
TRAIN_PARITY_RTOL = {"loss": 1e-4, "loss3d": 1e-4, "loss2d": 1e-4, "grad_norm": 1e-3}
STATS_ATOL = 1e-4
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# dense bf16 tensor-core rate, float32 rate outside the tensor cores.
# `card_rates` gives the int32 adds of the INT32 pipe and the shared-memory
# rate from the card's own SM count and maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "float32": 67e12}
TF32_DECODE_TOL = 1e-5  # (0,1) units; TF32 would round each input by ~5e-4 relative
FAMILIES = {  # name: (overrides of Config(), the pool alignment it runs)
    "a_torchvision_r50": ({"model.backbone": "resnet50", "model.preactivation": "false",
                           "model.conv_padding": "torch", "model.stride_position": "first"},
                          "torch"),
    "b_keras_v2_r50": ({"model.backbone": "resnet50", "model.preactivation": "true",
                        "model.conv_padding": "keras", "model.stride_position": "last",
                        "model.v2_biases": "true"}, "keras"),
    "c_torchvision_r34": ({"model.backbone": "resnet34", "model.preactivation": "false",
                           "model.conv_padding": "torch", "model.stride_position": "first"},
                          "torch"),
    "d_twofive": ({"model.model_class": "twofive"}, "same"),
}


def fail(msg: str):
    raise RuntimeError(msg)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card_rates() -> dict:
    """-> {"int32": int32 adds a second, "shared": shared-memory bytes a
    second, "int8": dense int8 tensor-core operations a second, "sms",
    "mhz"}, from the card's SM count and the maximum SM clock nvidia-smi
    reports. The INT32 pipe issues 64 three-input adds (IADD3, two adds
    each: ptxas pairs a chain of adds into them) a clock an SM; shared
    memory serves 128 bytes a clock an SM; the tensor cores do 8192 dense
    int8 operations (4096 multiply-adds) a clock an SM."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    mhz = float(out.strip().splitlines()[0].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"int32": sms * 64 * 2 * mhz * 1e6, "shared": sms * 128 * mhz * 1e6,
            "int8": sms * 8192 * mhz * 1e6, "sms": sms, "mhz": mhz}


def crop_params(rng, b, tile, side, kind):
    """Per-crop warp params (H [B,3,3], K [B,4], dist [B,5]) and crop
    intrinsics [B,3,3] from the numpy camera model of the JAX package.

    kind: "normal" (boxes near the axis, mild roll), "rot90" (roll near
    +-90 degrees), "behind" (a wide crop turned ~80 degrees off the source
    axis, so part of its rays pass behind the source camera)."""
    from metro_pose3d_tpu_torch.geom.camera import Camera, get_warp_params

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


def warp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference; NaN (rays at the horizon with distortion) must coincide."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        fail("warp kernel and plain version disagree on NaN positions")
    ok = ~torch.isnan(a)
    return float((a[ok] - b[ok]).abs().max())


WARP_FORM_NONE = ("none", torch.float32)
# [0,255] -> the form's units; a bf16 form also rounds once more to bf16
WARP_FORM_SCALE = {"none": 1.0, "unit": 1 / 255, "normalize": 2 / 255, "normalize_div": 2 / 255}


def fmt_forms(values: dict, spec: str = ".2e") -> str:
    return ", ".join(f"{e} {str(d)[6:]} {v:{spec}}" for (e, d), v in values.items())


def check_warp_forms(warp, args, what: str) -> dict:
    """Every K1 form on `args` against the plain chain: within WARP_TOL
    scaled to the form's units (a bf16 form: plus one bf16 ulp at 1.0,
    2^-7), NaN where it has NaN; and bit for bit equal to the unfused kernel
    output through the plain epilogue. -> {form: max abs err}."""
    unfused = warp.warp_images_cuda(*args)
    errs = {}
    for epi, dt in warp.FORMS:
        got = warp.warp_images_cuda(*args, epilogue=epi, out_dtype=dt)
        want = warp.warp_images_plain(*args, epilogue=epi, out_dtype=dt)
        torch.cuda.synchronize()
        tol = WARP_TOL * WARP_FORM_SCALE[epi] + (2 ** -7 if dt == torch.bfloat16 else 0.0)
        errs[epi, dt] = warp_err(got.float(), want.float())
        if errs[epi, dt] > tol:
            fail(f"K1 ({epi}, {dt}) off its plain chain by {errs[epi, dt]} > {tol} ({what})")
        if not same_bits(got, warp.apply_epilogue(unfused, epi, dt)):
            fail(f"K1 ({epi}, {dt}): the fused epilogue differs from the unfused kernel "
                 f"output through the plain epilogue ({what})")
    return errs


def bound(n_bytes: float, n_ops: float, op_type: str = "float32"):
    """-> (bound_ms, bound_by): the least time the card could take to move
    `n_bytes` (every input read once, every output written once) or to do
    `n_ops` operations of `op_type`, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def loop_bound(n_bytes: float, n_adds: float, n_shared: float, rates: dict):
    """-> (bound_ms, bound_by, term): the looped probes' bound, the largest
    of `n_bytes` over the memory rate, `n_adds` int32 adds and `n_shared`
    bytes read from shared memory at the card's `rates`; term names it
    ("bytes", "int32 adds" or "shared words"), bound_by is "bytes" or
    "operations"."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "int32 adds": n_adds / rates["int32"] * 1e3,
             "shared words": n_shared / rates["shared"] * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tie_count(x: torch.Tensor, y: torch.Tensor, mode: str = "same", pad_only: bool = False):
    """For each window of the 3x3/2 pool in the alignment `mode`, how many
    taps equal its max y; with `pad_only`, how many pad taps do."""
    from metro_pose3d_tpu_torch.ops.pool import pool_geometry

    oh, ow, (top, bottom), (left, right), fill = pool_geometry(x.shape[2], x.shape[3], mode)
    pads = (left, right, top, bottom)
    xp = F.pad(x.float(), pads, value=fill)
    is_pad = F.pad(torch.zeros_like(x, dtype=torch.bool), pads, value=True)
    total = 0
    for dy in range(3):
        for dx in range(3):
            view = (slice(None), slice(None), slice(dy, dy + 2 * oh, 2), slice(dx, dx + 2 * ow, 2))
            eq = xp[view] == y.float()
            total = total + ((eq & is_pad[view]) if pad_only else eq).int()
    return total


def device_ms(fn, kernel, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of a call of fn, by the profiler over `iters` calls:
    the time of the kernels whose name holds `kernel` (one launch a call),
    or, for a tuple of names, of the kernels named there (as many launches
    a call as the tuple has entries, as `launched_kernels` lists them). The
    profiler may miss launches of its window, so the mean is over the
    launches it recorded, at least half of them; a window that recorded
    fewer is profiled again, eight windows at most (two in a row once
    recorded none of the plain gather's launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    unique = set(names)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and any(n in evt.key for n in unique):
                total += evt.self_device_time_total
                count += evt.count
        if iters / 2 <= count / len(names) <= iters:
            return total / 1e3 / (count / len(names))
    fail(f"the profiler saw {count} launches of {names} in {iters} calls, eight times")


def launched_kernels(fn, calls: int = 10) -> tuple:
    """The names of the device kernels one call of fn launches, once for
    each launch, by the profiler over `calls` calls after a warm-up call:
    how a PyTorch call's own ATen kernels are found, to time them by
    `device_ms`. The profiler may miss launches of a window (three windows
    in a row saw none of `take_along_dim`'s once), so a window that saw
    none is profiled again, seven times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {evt.key: evt.count for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA}
        if counts:
            return tuple(sorted(name for name, n in counts.items()
                                for _ in range(max(1, round(n / calls)))))
    fail("the profiler saw no device kernel of a call, eight times")


def kernel_resources(cuobjdump: str, lib_path, names):
    """-> ({name: ["REG:n STACK:n LOCAL:n", ...]}, {name: warpgroup MMA
    count}) for the kernels of the built library whose mangled names hold
    one of `names` (one entry a template instance), from cuobjdump; the
    count is of HGMMA (floating point) and IGMMA (integer) instructions."""
    usage = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib_path)],
                           capture_output=True, text=True, timeout=120, check=True).stdout
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    found = {}
    lines = usage.splitlines()
    for i, line in enumerate(lines):
        for name in names:
            if "Function " in line and name in line and i + 1 < len(lines):
                regs = " ".join(f for f in lines[i + 1].split() if f.split(":")[0] in
                                ("REG", "STACK", "LOCAL"))
                found.setdefault(name, []).append(regs)
    hgmma = {}
    for block in sass.split("Function : ")[1:]:
        for name in names:
            if name in block.split("\n", 1)[0]:
                hgmma[name] = hgmma.get(name, 0) + block.count("HGMMA") + block.count("IGMMA")
    return found, hgmma


def profile_breakdown(fn, steps: int, label: str = "[12 t-time] profiler, train step") -> str:
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
        return f"{label}: no device time recorded"
    names = ("maxpool3x3s2_bwd_kernel", "maxpool3x3s2_kernel", "occluder_paste", "warp_crop",
             "int8_conv_", "int8_elementwise_kernel")
    ours = {n: sum(t for t, k in kernels if n in k) for n in names}
    ops.sort(reverse=True)
    top = "; ".join(f"{k} {t / total:.1%}" for t, k in ops[:8])
    mine = "; ".join(f"{n} {t / total:.2%}" for n, t in ours.items())
    return (f"{label}: device {total / 1e3 / steps:.2f} ms a call, "
            f"busy {total / 1e6 / wall:.1%} of wall; top ops by self device time: {top}; "
            f"port kernels: {mine}")


def train_batch(rng, n3, n2, tile, side, n_occ, occ_side=96, n_bg=0):
    """A host train batch in the `example_spec` layout, made with numpy:
    warps from `crop_params`, a random skeleton about 4 m in front of the
    crop camera projected into the crop, and occluder and colour parameters
    drawn as `pipeline/crops.py::sample_aug_params` draws them. The last n2
    rows are 2D-only (is_3d 0, no 3D validity). With `n_bg` > 0 the batch
    also carries a foreground mask ("source_mask": an ellipse with a soft
    edge, 255 inside) and background parameters ("bg_params": enabled with
    probability 0.7, a bank index below n_bg), as a masked 3DHP batch does."""
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
    extra = {}
    if n_bg:
        ys, xs = np.mgrid[0:tile, 0:tile].astype(np.float32) / tile
        masks = np.empty((b, tile, tile), np.uint8)
        for i in range(b):
            (cx, cy), (rx, ry) = rng.uniform(0.3, 0.7, 2), rng.uniform(0.1, 0.3, 2)
            r2 = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2
            masks[i] = np.clip((1 - r2) * 4, 0, 1) * 255
        bg = np.stack([rng.random_sample(b) < 0.7, rng.randint(0, n_bg, b)], 1)
        bg[0, 0] = 1
        extra = {"source_mask": masks, "bg_params": bg.astype(np.float32)}
    return {**extra, "source": rng.randint(0, 256, (b, tile, tile, 3), dtype=np.uint8),
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


def pool_inputs(gen, dev, shape, dtype, kind):
    """A channels_last pool input: "random"; "ties" (quantised to quarters,
    neighbours often equal); "relu" (a smooth field through a ReLU, as
    after bn_stem + ReLU: about half exact zeros, in patches, so whole
    windows tie at 0); "negative" (all values below 0, so a Keras border
    window returns its 0 pad); "nan" (random, with about 1% NaN)."""
    x = torch.randn(shape, generator=gen, device=dev)
    if kind == "nan":
        x[torch.rand(shape, generator=gen, device=dev) < 0.01] = float("nan")
    elif kind == "ties":
        x = torch.round(x * 4) / 4
    elif kind == "relu":
        b, c, h, w = shape
        coarse = torch.randn((b, c, -(-h // 4), -(-w // 4)), generator=gen, device=dev)
        smooth = coarse.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)[:, :, :h, :w]
        x = torch.relu(smooth + 0.3 * x)
    elif kind == "negative":
        x = -x.abs() - 0.5
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def pool_widths(x):
    """The pool kernels' variants that x allows: the 16-byte vector (where
    `vector_width` picks it) and the scalar one, as `width` arguments."""
    from metro_pose3d_tpu_torch.ops.pool import vector_width

    vec = vector_width(x.shape[1], x.dtype, x.data_ptr())
    return [vec, 1] if vec > 1 else [1]


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, as integers of its element size."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def same_values(got, want) -> bool:
    """Equal value for value, NaN where the other has NaN."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def same_bits(got, want) -> bool:
    """Equal bit for bit, NaN where the other has NaN."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(bits(got[~nan]), bits(want[~nan])))


def check_pool_fwd(pool, x, mode="same"):
    """Forward kernel, in every variant x allows, against the plain version,
    value for value (NaN where it has NaN). -> (max abs err, variants)."""
    want, err = pool.max_pool_plain(x, mode), 0.0
    for width in pool_widths(x):
        got = pool.max_pool_cuda(x, mode, width=width)
        torch.cuda.synchronize()
        if not same_values(got, want):
            fail(f"pool kernel ({mode}, {pool.variant(width)}) differs from its plain version at "
                 f"{tuple(x.shape)} {x.dtype}")
        ok = ~torch.isnan(want)
        err = max(err, float((got[ok].float() - want[ok].float()).abs().max()))
    return err, "+".join(pool.variant(w) for w in pool_widths(x))


def check_pool_bwd(pool, x, g, mode):
    """Backward kernel, in every variant x allows, against the plain backward
    on float32 copies: float32 within 1e-6, bf16 within one bf16 ulp of the
    float32 sum; a second launch bitwise equal to the first. -> (max abs
    err, note)."""
    want = pool.max_pool_bwd_plain(x.float(), g.float(), mode)
    worst, notes = 0.0, []
    for width in pool_widths(x):
        got = pool.max_pool_bwd_cuda(x, g, mode, width=width)
        again = pool.max_pool_bwd_cuda(x, g, mode, width=width)
        if not torch.equal(bits(got), bits(again)):
            fail(f"pool backward kernel ({mode}, {pool.variant(width)}) gave two results on one "
                 f"input at {tuple(x.shape)} {x.dtype}")
        err = (got.float() - want).abs()
        if x.dtype == torch.float32:
            ok, note = float(err.max()) <= 1e-6, f"max abs err {float(err.max()):.2e} (tol 1e-6)"
        else:
            ulps = float((err / (want.abs() * 2 ** -7).clamp_min(1e-30)).max())
            ok = bool((err <= want.abs() * 2 ** -7).all())
            note = f"max err {ulps:.2f} bf16 ulp of the float32 sum (tol 1)"
        if not ok:
            fail(f"pool backward kernel ({mode}, {pool.variant(width)}) off its plain version at "
                 f"{tuple(x.shape)} {x.dtype}: {note}")
        worst = max(worst, float(err.max()))
        notes.append(f"{pool.variant(width)} {note}")
    return worst, "; ".join(notes) + ", repeat launches bitwise equal"


def check_warp_forms_launched(where: str, form) -> None:
    """Fail unless every warp launch counted since the last reset was of
    `form` (and some were)."""
    from metro_pose3d_tpu_torch.ops import warp

    counts = warp.KERNEL_LAUNCHES
    if counts[form] == 0 or sum(counts.values()) != counts[form]:
        fail(f"{where}: the warp did not launch its {form} form only: {counts}")


def check_pool_variants(where: str, ways=("fwd",)) -> None:
    """Fail unless every pool launch counted since the last reset went
    through the 16-byte variant (and some did)."""
    from metro_pose3d_tpu_torch.ops import pool

    for way in ways:
        counts = pool.VARIANT_LAUNCHES[way]
        if counts["vec16"] == 0 or counts["scalar"]:
            fail(f"{where}: the pool {way} did not run in its 16-byte variant only: {counts}")


def phase_pool_modes(gen, dev, card):
    """13: the `torch` and `keras` alignments, forward and backward, and
    their times. -> {(mode, "fwd"|"bwd"): {"max_abs_err", "ms", "plain_ms", ...}}."""
    from metro_pose3d_tpu_torch.ops import pool
    from metro_pose3d_tpu_torch.probes import time_ms

    rec = {}
    for mode in ("torch", "keras"):
        fwd_err = 0.0
        for shape, dtype, kind in (((128, 64, 128, 128), torch.bfloat16, "random"),
                                   ((16, 64, 128, 128), torch.float32, "relu"),
                                   ((8, 64, 127, 129), torch.bfloat16, "negative"),
                                   ((8, 24, 33, 18), torch.float32, "negative"),
                                   ((4, 64, 128, 128), torch.bfloat16, "negative"),
                                   ((4, 64, 128, 128), torch.bfloat16, "nan"),
                                   ((3, 8, 15, 13), torch.float32, "nan"),
                                   ((3, 5, 16, 14), torch.bfloat16, "ties")):
            x = pool_inputs(gen, dev, shape, dtype, kind)
            err, variants = check_pool_fwd(pool, x, mode)
            fwd_err = max(fwd_err, err)
            note = ""
            if kind == "negative":
                got = pool.max_pool_cuda(x, mode)
                zeros = float((got == 0).float().mean())
                border = 1 - (got.shape[2] - 2) * (got.shape[3] - 2) / (got.shape[2] * got.shape[3])
                if (mode == "keras") != (zeros > 0) or zeros > border:
                    fail(f"pool ({mode}) on an all-negative input: share of zero outputs "
                         f"{zeros}, border windows {border}")
                note = f", all-negative input: outputs equal to the 0 pad {zeros:.4f}"
            print(f"[13 modes] {mode} fwd {tuple(shape)} {dtype} {kind}: bit-exact ({variants})"
                  f"{note}")
        rec[mode, "fwd"] = {"max_abs_err": fwd_err}

        bwd_err = 0.0
        for shape, dtype, kind in (((96, 64, 128, 128), torch.bfloat16, "relu"),
                                   ((16, 64, 128, 128), torch.float32, "relu"),
                                   ((8, 64, 127, 129), torch.bfloat16, "ties"),
                                   ((8, 24, 33, 18), torch.float32, "ties"),
                                   ((8, 64, 127, 129), torch.bfloat16, "random"),
                                   ((8, 24, 33, 18), torch.float32, "random"),
                                   ((8, 64, 128, 128), torch.bfloat16, "negative"),
                                   ((3, 5, 15, 14), torch.float32, "negative"),
                                   ((4, 64, 64, 66), torch.bfloat16, "nan")):
            x = pool_inputs(gen, dev, shape, dtype, kind)
            y = pool.max_pool_plain(x, mode)
            g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
            err, note = check_pool_bwd(pool, x, g, mode)
            bwd_err = max(bwd_err, err)
            tied = float((tie_count(x, y, mode) > 1).float().mean())
            pad = float((tie_count(x, y, mode, pad_only=True) > 0).float().mean())
            print(f"[13 modes] {mode} bwd {tuple(shape)} {dtype} {kind}: {note}; windows with "
                  f"a tied max {tied:.3f}" + (f", with a pad cell at the max {pad:.4f}"
                                             if mode == "keras" else ""))
        rec[mode, "bwd"] = {"max_abs_err": bwd_err}
        del x, y, g

        # times at the main-path shapes (serving: B=64 with its mirror; training: 96 rows)
        xf = pool_inputs(gen, dev, (128, 64, 128, 128), torch.bfloat16, "relu")
        rec[mode, "fwd"].update(
            ms=time_ms(lambda: pool.max_pool_cuda(xf, mode)),
            plain_ms=time_ms(lambda: pool.max_pool_plain(xf, mode)),
            bound=bound(nbytes(xf) * 1.25, 9 * xf.numel() / 4))
        if mode == "torch":
            rec[mode, "fwd"]["library_ms"] = time_ms(lambda: F.max_pool2d(xf, 3, 2, padding=1))
            if not torch.equal(F.max_pool2d(xf, 3, 2, padding=1), pool.max_pool_cuda(xf, mode)):
                fail("F.max_pool2d(x, 3, 2, 1) differs from the torch-mode kernel's forward")
        else:
            rec[mode, "fwd"]["library_ms"] = None
            rec[mode, "fwd"]["two_calls_ms"] = time_ms(
                lambda: F.max_pool2d(F.pad(xf, (1, 1, 1, 1)), 3, 2))
        rec[mode, "fwd"]["ms_scalar"] = time_ms(lambda: pool.max_pool_cuda(xf, mode, width=1))
        del xf
        # every backward record: `ms` on the random input, `ms_relu` post-ReLU
        xb = pool_inputs(gen, dev, (96, 64, 128, 128), torch.bfloat16, "random")
        xn = pool_inputs(gen, dev, (96, 64, 128, 128), torch.bfloat16, "relu")
        gb = torch.randn((96, 64, 64, 64), generator=gen, device=dev).to(torch.bfloat16)
        gb = gb.contiguous(memory_format=torch.channels_last)
        xr = xb.clone().requires_grad_(True)
        yr = F.max_pool2d(xr if mode == "torch" else F.pad(xr, (1, 1, 1, 1)), 3, 2,
                          padding=1 if mode == "torch" else 0)
        rec[mode, "bwd"].update(
            ms=time_ms(lambda: pool.max_pool_bwd_cuda(xb, gb, mode)),
            ms_relu=time_ms(lambda: pool.max_pool_bwd_cuda(xn, gb, mode)),
            ms_scalar=time_ms(lambda: pool.max_pool_bwd_cuda(xb, gb, mode, width=1)),
            plain_ms=time_ms(lambda: pool.max_pool_bwd_plain(xb, gb, mode)),
            bound=bound(2 * nbytes(xb) + nbytes(gb), 9 * gb.numel()),
            # the library's gradient hands each window's whole gradient to one
            # argmax: timed, but another function than the chain's gradient
            library_ms=None,
            argmax_gradient_ms=time_ms(
                lambda: torch.autograd.grad(yr, xr, gb, retain_graph=True)))
        del xb, xn, gb, xr, yr
        f, b = rec[mode, "fwd"], rec[mode, "bwd"]
        lib = (f"F.max_pool2d {f['library_ms']:.4f} ms" if mode == "torch"
               else f"F.pad + F.max_pool2d (two calls) {f['two_calls_ms']:.4f} ms")
        print(f"[13 modes] {mode} fwd [128,64,128,128] bf16: kernel {f['ms']:.4f} ms "
              f"(scalar variant {f['ms_scalar']:.4f}), plain {f['plain_ms']:.4f} ms, {lib}, "
              f"bound {f['bound'][0]:.4f} ms  [{card}]")
        print(f"[13 modes] {mode} bwd [96,64,128,128] bf16: kernel {b['ms']:.4f} ms random, "
              f"{b['ms_relu']:.4f} ms post-ReLU (scalar variant {b['ms_scalar']:.4f}), plain "
              f"{b['plain_ms']:.4f} ms, the library's argmax gradient (another function) "
              f"{b['argmax_gradient_ms']:.4f} ms, bound {b['bound'][0]:.4f} ms  [{card}]")
    torch.cuda.empty_cache()
    return rec


def decode_with_tf32(gen, dev, mcfg, b) -> str:
    """6: the 2D and 3D soft-argmax decode with TF32 matmuls turned on
    (`torch.set_float32_matmul_precision("high")`), card against CPU, within
    TF32_DECODE_TOL in (0,1) units, on logits at the heads' shapes. The
    flags are restored after."""
    from metro_pose3d_tpu_torch.ops.soft_argmax import soft_argmax_2d, soft_argmax_3d

    hm, j = mcfg.proc_side // mcfg.stride, 17
    l3 = 3 * torch.randn((b, hm, hm, mcfg.depth, j), generator=gen, device=dev)
    l2 = 3 * torch.randn((b, hm, hm, j), generator=gen, device=dev)
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    try:
        if not torch.backends.cuda.matmul.allow_tf32:
            fail("set_float32_matmul_precision('high') did not turn TF32 matmuls on")
        errs = {name: float((fn(lg).cpu() - fn(lg.cpu())).abs().max())
                for name, fn, lg in (("3d", soft_argmax_3d, l3), ("2d", soft_argmax_2d, l2))}
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]
    if not max(errs.values()) <= TF32_DECODE_TOL:
        fail(f"the decode with TF32 on differs from the CPU's by {errs} > {TF32_DECODE_TOL}")
    return (f"[6 parity] soft-argmax with TF32 matmuls on, card vs CPU, [{b},{hm},{hm},"
            f"{mcfg.depth},{j}] and [{b},{hm},{hm},{j}]: max abs diff 3d {errs['3d']:.2e}, 2d "
            f"{errs['2d']:.2e} (tol {TF32_DECODE_TOL}, (0,1) units)")


def family_cfg(name, extra=None):
    from metro_pose3d_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), {**FAMILIES[name][0], **(extra or {})})


def phase_families_serving(rng, dev, card):
    """14: the other model families through the serving entry points.
    -> {family: {"pool_<mode>": launches, "warp": launches}}."""
    from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, PoseEstimator, make_predict_fn
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.ops import pool, warp
    from metro_pose3d_tpu_torch.probes import time_ms

    launches = {}
    for name, (_, mode) in FAMILIES.items():
        cfg = family_cfg(name)
        side = cfg.model.proc_side
        model = init_metro_model(cfg.model, SEED + 10, dev)
        est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
        crop_reqs = [(rng.randint(0, 256, (BATCH, side, side, 3)).astype(np.uint8),
                      crop_params(rng, BATCH, TILE, side, "normal")[3]) for _ in range(3)]
        tile_reqs = [tile_batch(rng, BATCH, TILE, side) for _ in range(3)]
        pool.reset_launches()
        warp.reset_launches()
        outs = [est.predict_crops(c, i) for c, i in crop_reqs]
        outs += [est.predict_tiles(b) for b in tile_reqs]
        torch.cuda.synchronize()
        launches[name] = {"pool_" + mode: pool.MODE_LAUNCHES[mode], "warp": warp.LAUNCHES}
        if cfg.model.model_class == "twofive":
            shapes = {"pose25d": (BATCH, 17, 3), "pose2d_px": (BATCH, 17, 2)}
        else:
            shapes = {"pose3d_rootrel": (BATCH, 17, 3), "pose2d_px": (BATCH, 17, 2),
                      "pose3d_abs": (BATCH, 17, 3)}
        for out in outs:
            if set(out) != set(shapes):
                fail(f"{name}: serving outputs {sorted(out)}, want {sorted(shapes)}")
            for key, shape in shapes.items():
                if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                    fail(f"{name}: output {key} has shape {tuple(out[key].shape)} or is not finite")
        other = sum(n for m, n in pool.MODE_LAUNCHES.items() if m != mode)
        if min(launches[name].values()) == 0 or other:
            fail(f"{name}: the serving path did not launch its kernels: {launches[name]}, "
                 f"pool launches by mode {pool.MODE_LAUNCHES}")
        check_pool_variants(f"{name} serving")
        line = (f"[14 families] {name} ({cfg.model.backbone}, {mode} pool, bf16, TTA, B={BATCH}): "
                f"3 crop-in + 3 tile-in requests, outputs finite, launches {launches[name]}")
        if name != "d_twofive":
            fn = make_predict_fn(cfg, H36M_17.mirror_mapping, root_index=0, flip_tta=True,
                                 reconstruct=True)
            args = (model, torch.from_numpy(crop_reqs[0][0]).to(dev),
                    torch.from_numpy(crop_reqs[0][1]).to(dev))
            ms = time_ms(lambda: fn(*args), iters=10)
            line += f"; crop-in {ms:.3f} ms/batch, {BATCH / ms * 1e3:.1f} crops/s  [{card}]"
        print(line)
        del model, est
        torch.cuda.empty_cache()

    # float32 on the card against float32 on the CPU, (a) and (b)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("a_torchvision_r50", "b_keras_v2_r50"):
        cfg32 = family_cfg(name, {"model.compute_dtype": "float32"})
        side = cfg32.model.proc_side
        cpu_model = init_metro_model(cfg32.model, SEED + 11, "cpu")
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        batch = tile_batch(rng, 2, TILE, side)
        res = [PoseEstimator(cfg32, m, H36M_17, flip_tta=True, reconstruct=True).predict_tiles(
            {k: batch[k] for k in TILE_KEYS}) for m in (gpu_model, cpu_model)]
        worst = {}
        for key, tol in PARITY_TOL.items():
            worst[key] = float((res[0][key].float().cpu() - res[1][key].float()).abs().max())
            if not worst[key] <= tol:
                fail(f"{name}: card vs CPU float32 {key}: {worst[key]} > {tol}")
        print(f"[14 families] {name} float32 card vs CPU, tile-in B=2, TF32 off: max abs diff "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tol {PARITY_TOL})")
        del gpu_model, cpu_model
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    return launches


def torchvision_state_dict(rng, depths=(3, 4, 6, 3), base=64):
    """A state dict with torchvision's ResNet-50 names and shapes, drawn from
    `rng`: lecun-normal kernels, BN weights and variances in 0.5..1.5."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[name] = rng.normal(0, (cin * k * k) ** -0.5, (cout, cin, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    conv("conv1.weight", base, 3, 7)
    bn("bn1", base)
    cin = base
    for stage, n_blocks in enumerate(depths):
        f = base * 2 ** stage
        for b in range(n_blocks):
            pre = f"layer{stage + 1}.{b}"
            for k, (co, ci, ks) in enumerate(((f, cin, 1), (f, f, 3), (4 * f, f, 1)), start=1):
                conv(f"{pre}.conv{k}.weight", co, ci, ks)
                bn(f"{pre}.bn{k}", co)
            if cin != 4 * f:
                conv(f"{pre}.downsample.0.weight", 4 * f, cin, 1)
                bn(f"{pre}.downsample.1", 4 * f)
            cin = 4 * f
    return sd


def phase_families_training(rng, dev, card, bank_np):
    """15: training (a) from a converted backbone file, and (b) for the
    keras pool pair. -> {"pool_torch", "pool_torch_bwd", "pool_keras",
    "pool_keras_bwd", "warp", "occluder"} launches."""
    from metro_pose3d_tpu_torch.ops import occlusion, pool, warp
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state
    from metro_pose3d_tpu_torch.train.trainer import _train_on_batches
    from metro_pose3d_tpu_torch.utils.convert_backbone import (
        load_backbone_npz, save_backbone_npz, torchvision_resnet_to_state_dict,
    )

    side = 256
    host = [train_batch(rng, N3D, N2D, TILE, side, len(bank_np))]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "backbone_r50_torchvision.npz")
        trunk = torchvision_resnet_to_state_dict(torchvision_state_dict(rng))
        save_backbone_npz(trunk, npz)
        if set(load_backbone_npz(npz)) != set(trunk):
            fail("the backbone file does not hold the converted leaves")
        for name, steps in (("a_torchvision_r50", 6), ("b_keras_v2_r50", 3)):
            mode = FAMILIES[name][1]
            extra = {"train.checkpoint_every": str(steps), "train.log_every": "1",
                     "train.validate_every": "0", "train.warmup_steps": "0",
                     "data.cycle_batches": "1", "train.logdir": os.path.join(tmp, name)}
            if name.startswith("a_"):
                extra["train.backbone_init"] = npz
            cfg = family_cfg(name, extra)
            if name.startswith("a_"):
                warm = create_train_state(cfg, dev).model.backbone.state_dict()
                bad = [k for k, v in trunk.items()
                       if not torch.equal(warm[k].cpu(), torch.from_numpy(v))]
                if bad or len(trunk) != len(warm):
                    fail(f"train.backbone_init: {len(bad)} leaves differ from the file, "
                         f"{len(trunk)} in the file, {len(warm)} in the trunk")
                del warm
            pool.reset_launches()
            warp.reset_launches()
            occlusion.LAUNCHES = 0
            t0 = time.perf_counter()
            state = _train_on_batches(cfg, iter(host), occluder_bank=bank_np, max_steps=steps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            with open(os.path.join(cfg.train.logdir, "history.json")) as f:
                losses = [r["loss"] for r in json.load(f)]
            got = {f"pool_{mode}": pool.MODE_LAUNCHES[mode],
                   f"pool_{mode}_bwd": pool.MODE_BWD_LAUNCHES[mode],
                   "warp": warp.LAUNCHES, "occluder": occlusion.LAUNCHES}
            if (state.step != steps or len(losses) != steps or not np.isfinite(losses).all()
                    or not losses[-1] < losses[0]):
                fail(f"{name}: {steps} steps on one batch, losses {losses}")
            other = sum(n for m, n in pool.MODE_LAUNCHES.items() if m != mode)
            if min(got.values()) == 0 or other:
                fail(f"{name}: the training path did not launch its kernels: {got}, pool "
                     f"launches by mode {pool.MODE_LAUNCHES}")
            check_pool_variants(f"{name} training", ("fwd", "bwd"))
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            print(f"[15 f-train] {name} R50@256 bf16 B={N3D}+{N2D}"
                  + (", backbone from the converted file" if name.startswith("a_") else "")
                  + f": {steps} steps on one batch in {dt:.1f} s, loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}; launches {got}")
            del state
            torch.cuda.empty_cache()

    # one float32 step of (a) on the card and on the CPU, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = family_cfg("a_torchvision_r50", {"model.compute_dtype": "float32",
                                            "model.proc_side": "128", "train.warmup_steps": "0"})
    pbatch = train_batch(rng, 3, 1, TILE, 128, len(bank_np))
    res = []
    for d in (dev, torch.device("cpu")):
        st = create_train_state(pcfg, d, seed=SEED + 12)
        step = make_train_step(pcfg, 0, occluder_bank=pack_occluder_bank_for(bank_np, d))
        res.append({k: float(v) for k, v in step(st, batch_to_device(pbatch, d)).items()})
        del st
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    mg, mc = res
    for k, tol in TRAIN_PARITY_RTOL.items():
        if not abs(mg[k] - mc[k]) <= tol * abs(mc[k]):
            fail(f"(a) train parity {k}: card {mg[k]} CPU {mc[k]} (rtol {tol})")
    print("[15 f-train] (a) one float32 step R50@128 B=4, card vs CPU, TF32 off: rel diff "
          + ", ".join(f"{k} {abs(mg[k] - mc[k]) / abs(mc[k]):.1e}" for k in TRAIN_PARITY_RTOL)
          + f" (rtol {TRAIN_PARITY_RTOL})")
    torch.cuda.empty_cache()
    return launches


def rowsel_times(prims, args, want) -> dict:
    """The row select's device time (default split, and by split), its time a
    call by CUDA events, and the library yardstick: one `torch.bmm` of the
    rolled copies stacked as [B, reps*R, 160] @ [B, 160, 128] in float32 with
    TF32 off (exact: integer sums below 2^24), then its `.sum` over the reps,
    timed apart."""
    from metro_pose3d_tpu_torch.probes import time_ms

    p, s = args
    b, rows, _ = p.shape
    call = lambda: prims.rowsel_cuda(p, s)  # noqa: E731
    out = {"ms": device_ms(call, "rowsel"), "call_ms": time_ms(call),
           "split_ms": {k: device_ms(lambda: prims.rowsel_cuda(p, s, split=k), "rowsel")
                        for k in (1, 2, 4, 8)}}
    stacked = torch.stack([torch.roll(p.float(), k, 1) for k in range(prims.REPS)], 1)
    stacked = stacked.reshape(b, prims.REPS * rows, p.shape[2])
    sf = s.float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prod = torch.bmm(stacked, sf).reshape(b, prims.REPS, rows, s.shape[2])
        if not torch.equal(prod.sum(1), want):
            fail("the bmm over the stacked rolls differs from the row select")
        out["library_ms"] = time_ms(lambda: torch.bmm(stacked, sf))
        out["library_sum_ms"] = time_ms(lambda: prod.sum(1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def gather_times(gather, dev, case) -> dict:
    """One gather shape (H, W, axis, dtype, B): the kernel against
    take_along_dim, bit for bit; the kernel's device time, its launch floor
    (an empty kernel on its grid), its time a call by CUDA events, the plain
    version's device time (index cast and gather) and the library call's
    (`take_along_dim` on int64 indices cast beforehand: ATen's gather kernel
    alone), and its bound (bytes)."""
    from metro_pose3d_tpu_torch.probes import time_ms

    h, w, axis, dtype, b = case
    x, idx = gather.make_case(h, w, axis, dtype, b, device=dev)
    got, want = gather.gather_cuda(x, idx, axis), gather.gather_plain(x, idx, axis)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not torch.equal(got, want):
        fail(f"gather probe differs from take_along_dim at {(b, h, w)} axis {axis} {dtype}: "
             f"max abs err {err}")
    call = lambda: gather.gather_cuda(x, idx, axis)  # noqa: E731
    plain = lambda: gather.gather_plain(x, idx, axis)  # noqa: E731
    idx64 = idx.long()
    library = lambda: torch.take_along_dim(x, idx64, dim=axis + 1)  # noqa: E731
    kernel = "probe_gather_rows_kernel" if axis == 0 else "probe_gather_cols_kernel"
    ms = device_ms(call, kernel, iters=50)
    bms, by = bound(nbytes(x, idx, got), 0)
    lib_names = launched_kernels(library)
    return {"case": f"[{b},{h},{w}] axis {axis} {str(dtype)[6:]}", "max_abs_err": err,
            "ms": ms, "floor_ms": device_ms(lambda: gather.gather_floor(x, idx, axis),
                                            "probe_empty_kernel", iters=50),
            "call_ms": time_ms(call), "plain_ms": device_ms(plain, launched_kernels(plain)),
            "library_ms": device_ms(library, lib_names), "library_kernel": lib_names[0][:80],
            "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}


def phase_probes(dev, card, rates):
    """16: each probe kernel against its plain version (exact), then the
    probes' entry points; the roll's and the lane loop's bounds at the
    card's `rates` (`card_rates`). -> list of kernel records."""
    from metro_pose3d_tpu_torch.probes import gather, prims, time_ms

    ref = {"rows_i32": "scripts/exp_pallas_gather.py:51",
           "cols_i32": "scripts/exp_pallas_gather.py:71",
           "cols_f32": "scripts/exp_pallas_gather.py:110"}
    records = []
    src = "metro_pose3d_tpu_torch/csrc/probes.cu"
    sources = {"rowsel": "metro_pose3d_tpu_torch/csrc/rowsel_mma.cu"}

    # the three probes of the first script, then the sweep of the second
    sweep = []
    for i, case in enumerate(gather.SHAPES):
        r = gather_times(gather, dev, case)
        if i < len(ref):
            name = list(ref)[i]
            records.append({"name": f"probe_gather_{name}", "route": "cuda", "source": src,
                            "replaces": ref[name], **r, "cases": [case]})
        else:
            sweep.append(r)
    summed = {k: sum(r[k] for r in sweep) for k in ("ms", "floor_ms", "call_ms", "plain_ms",
                                                      "library_ms", "bound_ms")}
    records.append({"name": "probe_gather_sweep", "route": "cuda", "source": src,
                    "replaces": "scripts/exp_pallas_gather2.py:33",
                    "max_abs_err": max(r["max_abs_err"] for r in sweep), **summed,
                    "bound_by": "bytes", "bound_share": summed["bound_ms"] / summed["ms"],
                    "per_shape": sweep, "cases": list(gather.SHAPES[len(ref):])})
    for r in records:
        print(f"[16 probes] {r['name']} {r.get('case', 'summed over its shapes')}: kernel "
              f"{r['ms']:.4f} ms device time ({r['bound_share']:.0%} of its {r['bound_ms']:.4f} "
              f"ms bound, bytes; launch floor {r['floor_ms']:.4f} ms; {r['call_ms']:.4f} ms a "
              f"call by CUDA events), plain {r['plain_ms']:.4f} ms, take_along_dim on int64 "
              f"indices {r['library_ms']:.4f} ms  [{card}]")
    for r in sweep:
        print(f"[16 probes]   sweep {r['case']}: {r['ms']:.4f} ms (floor {r['floor_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f}, {r['bound_share']:.0%}), take_along_dim "
              f"{r['library_ms']:.4f} ms")
    edge = gather.edge_cases(device=dev)
    for name, (x, idx, axis) in edge.items():
        got, want = gather.gather_cuda(x, idx, axis), gather.gather_plain(x, idx, axis)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather edge case {name!r} differs from take_along_dim: max abs err "
                 f"{max_abs_err(got, want)}")
    for name, (x, idx, axis) in gather.untileable(device=dev).items():
        try:
            gather.gather_cuda(x, idx, axis)
        except ValueError:
            continue
        fail(f"gather_cuda took {name}, a shape its tile cannot hold")
    print(f"[16 probes] gather: {len(gather.SHAPES)} shapes and {len(edge)} edge cases, rows and "
          f"columns, int32 and float32: all equal to take_along_dim; "
          + ", ".join(gather.untileable()) + " raise")

    lines = {"lane_loop": 64, "rowsel": 100, "roll": 129, "dynslice": 158}
    by_kernel = {}
    for name, (cuda_fn, plain_fn, args, n_work) in prims.make_cases(device=dev).items():
        got, want = cuda_fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"probe {name!r} differs from its plain version: max abs err {err}")
        kernel = cuda_fn.__name__[:-len("_cuda")]
        kname = "probe_dynslice_kernel" if kernel == "dynslice" else f"{kernel}_kernel"
        n_bytes = nbytes(*args, got)
        if kernel == "dynslice":
            # the rows these starts touch, not the whole input
            x, start = args
            touched = prims.dynslice_touched_rows(start, x.shape[1], got.shape[1], prims.REPS)
            n_bytes = touched * x.shape[2] * x.element_size() + nbytes(start, got)
        if kernel == "rowsel":
            bms, by = bound(n_bytes, 2 * 160 * n_work, "bf16")  # multiply-adds
        else:
            # one int32 add a rep; the lane loop also reads one shared word a
            # rep, where a roll or row-slice thread's outputs share registers
            bms, by, term = loop_bound(n_bytes, n_work,
                                       4 * n_work if kernel == "lane_loop" else 0, rates)
        r = by_kernel.setdefault(kernel, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                          "bound_ms": 0.0, "bound_by": by, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if kernel == "rowsel":
            r.update(rowsel_times(prims, args, got))
        else:
            r["ms"] += device_ms(lambda: cuda_fn(*args), kname, iters=50)
            r["ms_reps0"] = r.get("ms_reps0", 0.0) + device_ms(
                lambda: cuda_fn(*args, reps=0), kname, iters=50)
            r["call_ms"] = r.get("call_ms", 0.0) + time_ms(lambda: cuda_fn(*args))
            r["bound_term"] = term
            r["bound_bytes_ms"] = r.get("bound_bytes_ms", 0.0) + bound(n_bytes, 0)[0]
        if kernel == "dynslice":
            r["floor_ms"] = device_ms(lambda: prims.dynslice_floor(*args), "probe_empty_kernel",
                                      iters=50)
            # one rep: each start's one run of 64 rows staged, one add an output
            r["ms_reps1"] = device_ms(lambda: cuda_fn(*args, reps=1), kname, iters=50)
            r["touched_rows"] = touched / x.shape[0]  # of H a batch element
        r["plain_ms"] += time_ms(lambda: plain_fn(*args), iters=3, warmup=1)
        r["bound_ms"] += bms
        print(f"[16 probes] {name}: equal to its plain version")
        if kernel == "rowsel":
            print(f"[16 probes] rowsel {tuple(args[0].shape)}@{tuple(args[1].shape)} "
                  f"x{prims.REPS}: "
                  f"kernel {r['ms']:.4f} ms device time (split {prims.ROWSEL_SPLIT}; "
                  f"{r['call_ms']:.4f} ms a call by CUDA events), by split "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["split_ms"].items())
                  + f"; bound {bms:.4f} ms ({by}); torch.bmm over the stacked rolls (float32, "
                  f"TF32 off) {r['library_ms']:.4f} ms, then its .sum over the reps "
                  f"{r['library_sum_ms']:.4f} ms  [{card}]")
    for kernel in ("roll", "lane_loop", "dynslice"):
        r = by_kernel[kernel]
        r.update(bound_share=r["bound_ms"] / r["ms"], bytes_share=r["bound_bytes_ms"] / r["ms"])
        floor = (f"; {r['ms_reps1']:.4f} ms at reps 1; launch floor {r['floor_ms']:.4f} ms; "
                 f"{r['touched_rows']:.1f} rows touched a batch element" if "floor_ms" in r
                 else "")
        print(f"[16 probes] {kernel} (summed over its shapes): kernel {r['ms']:.4f} ms device "
              f"time ({r['call_ms']:.4f} ms a call by CUDA events; {r['ms_reps0']:.4f} ms at "
              f"reps 0, its loads and stores alone{floor}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_term']}, {r['bound_share']:.0%}), bytes-only bound "
              f"{r['bound_bytes_ms']:.4f} ms ({r['bytes_share']:.0%}), plain "
              f"{r['plain_ms']:.4f} ms  [{card}]")
    edge = prims.edge_cases(device=dev)
    for name, (cuda_fn, plain_fn, args, kw) in edge.items():
        got, want = cuda_fn(*args, **kw), plain_fn(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"probe edge case {name!r} differs from its plain version: max abs err "
                 f"{max_abs_err(got, want)}")
    print(f"[16 probes] roll, lane loop and row slice equal to their plain versions on "
          f"{len(edge)} edge cases: " + "; ".join(edge))
    for kernel, r in by_kernel.items():
        records.append({"name": f"probe_{kernel}", "route": "cuda",
                        "source": sources.get(kernel, src),
                        "replaces": f"scripts/exp_pallas_prims.py:{lines[kernel]}", **r})

    # the probes' own entry points, counting launches
    gather.LAUNCHES.clear()
    for k in prims.LAUNCHES:
        prims.LAUNCHES[k] = 0
    print(f"[16 probes] probes.gather.main() and probes.prims.main()  [{card}]")
    gather.main()
    prims.main()
    for r in records:
        # a gather record counts the launches at its own shapes, and every one
        # of them must have been launched
        per_case = [gather.LAUNCHES.get(case, 0) for case in r.pop("cases", ())]
        r["launches"] = sum(per_case) if per_case else prims.LAUNCHES[r["name"][len("probe_"):]]
        if r["launches"] == 0 or 0 in per_case:
            fail(f"the probes' entry points did not launch {r['name']}: {per_case}")
    return records


# QK1 at the path's shapes: the 3x3 convs of R50 v2 @ 256 (stride 16, each
# stage's stride on its last unit) at the backbone batch of TTA at B=64,
# name -> (B, C, H, W, N, k, stride, dilation, launches a forward)
QK1_PATH = {
    "3x3_s1_64": (128, 64, 64, 64, 64, 3, 1, 1, 2),
    "3x3_s2_64": (128, 64, 64, 64, 64, 3, 2, 1, 1),
    "3x3_s1_128": (128, 128, 32, 32, 128, 3, 1, 1, 3),
    "3x3_s2_128": (128, 128, 32, 32, 128, 3, 2, 1, 1),
    "3x3_s1_256": (128, 256, 16, 16, 256, 3, 1, 1, 6),
    "3x3_dil2_512": (128, 512, 16, 16, 512, 3, 1, 2, 3),
}
# and its 1x1 convs (stride 1 everywhere on this path): conv1 with the
# junction into conv2 in its epilogue (requant), conv3 and proj with the
# dequant to bf16; name -> (B, C, H, W, N, 1, 1, 1, launches a forward,
# epilogue). 36 launches a forward.
QK1_PATH_1X1 = {
    "1x1_64_64_at64": (128, 64, 64, 64, 64, 1, 1, 1, 1, "requant"),
    "1x1_256_64_at64": (128, 256, 64, 64, 64, 1, 1, 1, 2, "requant"),
    "1x1_64_256_at64": (128, 64, 64, 64, 256, 1, 1, 1, 3, "dequant"),
    "1x1_64_256_at32": (128, 64, 32, 32, 256, 1, 1, 1, 1, "dequant"),
    "1x1_256_128_at32": (128, 256, 32, 32, 128, 1, 1, 1, 1, "requant"),
    "1x1_512_128_at32": (128, 512, 32, 32, 128, 1, 1, 1, 3, "requant"),
    "1x1_256_512_at32": (128, 256, 32, 32, 512, 1, 1, 1, 1, "dequant"),
    "1x1_128_512_at32": (128, 128, 32, 32, 512, 1, 1, 1, 3, "dequant"),
    "1x1_128_512_at16": (128, 128, 16, 16, 512, 1, 1, 1, 1, "dequant"),
    "1x1_512_256_at16": (128, 512, 16, 16, 256, 1, 1, 1, 1, "requant"),
    "1x1_1024_256_at16": (128, 1024, 16, 16, 256, 1, 1, 1, 5, "requant"),
    "1x1_512_1024_at16": (128, 512, 16, 16, 1024, 1, 1, 1, 1, "dequant"),
    "1x1_256_1024_at16": (128, 256, 16, 16, 1024, 1, 1, 1, 6, "dequant"),
    "1x1_1024_512_at16": (128, 1024, 16, 16, 512, 1, 1, 1, 1, "requant"),
    "1x1_2048_512_at16": (128, 2048, 16, 16, 512, 1, 1, 1, 2, "requant"),
    "1x1_1024_2048_at16": (128, 1024, 16, 16, 2048, 1, 1, 1, 1, "dequant"),
    "1x1_512_2048_at16": (128, 512, 16, 16, 2048, 1, 1, 1, 3, "dequant"),
}
# and its other shapes: the 7x7/2 stem under quantize_extras "stem" (C = 3,
# the scalar variant), odd sizes, a C with no 16-byte runs, torch pads with
# an N that ends inside a tile
QK1_EDGE = {
    "7x7_s2_stem_c3": (128, 3, 256, 256, 64, 7, 2, 1, "same"),
    "odd_13x11": (3, 32, 13, 11, 24, 3, 2, 1, "same"),
    "c24": (2, 24, 9, 10, 40, 3, 1, 1, "same"),
    "torch_pads_n70": (2, 16, 10, 10, 70, 3, 2, 1, "torch"),
}
# QK2 at stage 1 of the path (backbone batch 128): form -> (shape, input dtype)
QK2_PATH = {"quantize": ((128, 256, 64, 64), torch.bfloat16),
            "junction": ((128, 64, 64, 64), torch.int32),
            "dequant": ((128, 256, 64, 64), torch.int32)}
# whole-model int8 logits, card against CPU in float32: the JAX package's own
# bound for its fused against its unfused int8 graph (tests/test_quantize.py),
# 0.05 max|logits3d| + 0.02: a value near a rounding edge of an int8 step may
# round to the neighbouring step in one of two float32 computations
INT8_LOGIT_BOUND = (0.05, 0.02)


def int8_conv_inputs(gen, dev, b, c, h, w, n, k, stride, dil, padding="same"):
    """Seeded int8 input (channels_last) and OHWI weights, the conv's pads
    (XLA SAME or torch's symmetric), and a requant scale and offset as the
    path makes them (m ~ a * sa * sw / sa_next, b ~ c / sa_next)."""
    from metro_pose3d_tpu_torch.models.resnet import _same_pads

    x = torch.randint(-127, 128, (b, h, w, c), generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k, k, c), generator=gen, device=dev, dtype=torch.int8)
    if padding == "same":
        pads = (*_same_pads(h, k, stride, dil), *_same_pads(w, k, stride, dil))
    else:
        pads = ((k - 1) // 2 * dil,) * 4
    m = torch.rand(n, generator=gen, device=dev) * 2e-4 + 2e-5
    off = torch.randn(n, generator=gen, device=dev) * 20
    return x.permute(0, 3, 1, 2), wq, pads, m, off


def unfold_int8(x, k, stride, dil, pads):
    """The implicit GEMM's A made explicit: [B*OH*OW, k*k*C] int8, taps in
    (ky, kx, ci) order, zeros in the pads."""
    from metro_pose3d_tpu_torch.ops.int8 import conv_out_size

    b, c, h, w = x.shape
    top, bottom, left, right = pads
    oh = conv_out_size(h, k, stride, dil, top, bottom)
    ow = conv_out_size(w, k, stride, dil, left, right)
    xp = F.pad(x, (left, right, top, bottom))
    views = [xp[:, :, ky * dil: ky * dil + (oh - 1) * stride + 1: stride,
                kx * dil: kx * dil + (ow - 1) * stride + 1: stride].permute(0, 2, 3, 1)
             for ky in range(k) for kx in range(k)]
    return torch.stack(views, 3).reshape(b * oh * ow, k * k * c)


# every epilogue and output type of QK1: name -> (epilogue, arguments from
# the inputs' requant scale m and offset off)
QK1_FORMS = {
    "acc": ("acc", lambda m, off: {}),
    "requant": ("requant", lambda m, off: dict(scale=m, bias=off)),
    "requant_norelu": ("requant", lambda m, off: dict(scale=m, bias=off, relu=False)),
    "dequant_bf16": ("dequant", lambda m, off: dict(scale=m, bias=off, out_dtype=torch.bfloat16)),
    "dequant_bf16_nobias": ("dequant", lambda m, off: dict(scale=m, bias=None,
                                                           out_dtype=torch.bfloat16)),
    "dequant_f32": ("dequant", lambda m, off: dict(scale=m, bias=None, out_dtype=torch.float32)),
}


def check_int8_conv(int8, x, wq, stride, dil, pads, epilogue, where, scalar=True, **kw):
    """QK1 in the variant its plan picks, and with `scalar` in the scalar
    variant too, against its twin, bit for bit. -> the plan's variant."""
    want = int8.int8_conv_plain(x, wq, stride, dil, pads, epilogue, **kw)
    b, c, h, w = x.shape
    n, kh, kw_, _ = wq.shape
    variant = int8.qk1_plan(b, c, h, w, n, kh, kw_, stride, dil, pads)["variant"]
    for v in sorted({variant, "scalar"} if scalar else {variant}):
        got = int8.int8_conv_cuda(x, wq, stride, dil, pads, epilogue, variant=v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"QK1 {where} {epilogue} {kw.get('out_dtype')} variant {v} differs from its "
                 f"twin: max abs err {max_abs_err(got.float(), want.float())}")
    return variant


def phase_int8(rng, gen, dev, card, rates):
    """17: the int8 serving path. QK1 and QK2 against their twins, bit for
    bit, at the path's shapes and the edge shapes; `calibrate` on the card;
    int8 serving at full width; the calibrated model in float32 on the card
    and on the CPU; then times (informative). -> (kernel records, launches of
    K1 and K3 on this path)."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.evaluation.engine import (
        TILE_KEYS, PoseEstimator, make_predict_fn,
    )
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.models.metro import MetroModel
    from metro_pose3d_tpu_torch.models.quantize import QuantConv, calibrate
    from metro_pose3d_tpu_torch.ops import bn, int8, pool, warp
    from metro_pose3d_tpu_torch.ops.color import normalize
    from metro_pose3d_tpu_torch.probes import time_ms

    # QK1: every epilogue and output type at every path shape (3x3 and 1x1)
    # and edge shape, in the plan's variant; the scalar variant too at the
    # edge shapes and the 3x3 path shapes' requant
    inputs = {name: int8_conv_inputs(gen, dev, *shape[:8])
              for name, shape in {**QK1_PATH, **QK1_PATH_1X1}.items()}
    variants = {}
    for name, (x, wq, pads, m, off) in inputs.items():
        st, dil = {**QK1_PATH, **QK1_PATH_1X1}[name][6:8]
        for form, (epi, kw) in QK1_FORMS.items():
            variants[name] = check_int8_conv(int8, x, wq, st, dil, pads, epi, name,
                                             scalar=name in QK1_PATH and form == "requant",
                                             **kw(m, off))
    if set(variants.values()) != {"wgmma"}:
        fail(f"a path shape did not take QK1's wgmma variant: {variants}")
    for name, (b, c, h, w, n, k, st, dil, padding) in QK1_EDGE.items():
        x, wq, pads, m, off = int8_conv_inputs(gen, dev, b, c, h, w, n, k, st, dil, padding)
        for form, (epi, kw) in QK1_FORMS.items():
            variants[name] = check_int8_conv(int8, x, wq, st, dil, pads, epi, name, **kw(m, off))
        del x, wq
    print(f"[17 int8] QK1 == its twin bit for bit under {', '.join(QK1_FORMS)}: the path's "
          f"{len(QK1_PATH)} 3x3 and {len(QK1_PATH_1X1)} 1x1 shapes (B=128) in the wgmma variant, "
          f"the 3x3 ones' requant in the scalar variant too; "
          + ", ".join(f"{e} ({variants[e]} and scalar)" for e in QK1_EDGE))

    # QK2: every form at the path's stage-1 shapes and at small odd ones
    cases = []
    for form, (shape, dt) in QK2_PATH.items():
        cases += [(form, shape, dt), (form, (3, 17, 5, 7), dt)]
    cases += [("quantize", (2, 24, 9, 9), torch.float32),
              ("dequant", (2, 24, 9, 9), torch.float32)]
    qk2_inputs = {}
    for form, shape, dt in cases:
        c = shape[1]
        if form == "quantize":
            x = (torch.randn(shape, generator=gen, device=dev) * 3).to(
                torch.bfloat16 if dt == torch.bfloat16 else torch.float32)
            args, kw = (x.contiguous(memory_format=torch.channels_last),
                        torch.tensor(0.02, device=dev)), {}
        else:
            acc = torch.randint(-2 ** 24, 2 ** 24, shape, generator=gen, device=dev,
                                dtype=torch.int32)
            sc = torch.rand(c, generator=gen, device=dev) * 1e-5 + 1e-7
            args = (acc.contiguous(memory_format=torch.channels_last), sc)
            out_dt = torch.float32 if shape[0] == 2 else torch.bfloat16
            kw = (dict(bias=torch.randn(c, generator=gen, device=dev) * 5) if form == "junction"
                  else dict(bias=None, out_dtype=out_dt))
        want = int8.elementwise_plain(form, *args, **kw)
        for width in (16, 1):
            got = int8.int8_elementwise_cuda(form, *args, width=width, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"QK2 {form} {shape} width {width} differs from its twin")
        if shape[0] == 128:
            qk2_inputs[form] = (args, kw, want)
    print(f"[17 int8] QK2 == its twin bit for bit, both variants: "
          + "; ".join(f"{f} {tuple(s)} {str(d)[6:]}" for f, s, d in cases))

    # calibrate on the card, then serve: the main path of this phase
    side = 256
    cfg8 = apply_overrides(Config(), {"model.quantize": "int8"})
    model8 = init_metro_model(cfg8.model, SEED, dev)

    def norm_crops(b):
        u8 = torch.from_numpy(rng.randint(0, 256, (b, side, side, 3)).astype(np.uint8))
        return normalize(u8.to(dev).float() / 255.0)

    calib_batches = [norm_crops(BATCH) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrate(model8, calib_batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    amax = {n: float(m.amax) for n, m in model8.named_modules() if isinstance(m, QuantConv)}
    if not amax or min(amax.values()) <= 0:
        fail(f"calibration left a scale at 0: {sorted(amax.items(), key=lambda kv: kv[1])[:3]}")
    print(f"[17 int8] calibrate: 3 batches of {BATCH} (R50@256 bf16, p99.9) in {calib_s:.2f} s, "
          f"{len(amax)} int8 convs, amax {min(amax.values()):.4f}-{max(amax.values()):.4f}")
    del calib_batches

    est = PoseEstimator(cfg8, model8, H36M_17, flip_tta=True, reconstruct=True)
    crop_reqs = [(rng.randint(0, 256, (BATCH, side, side, 3)).astype(np.uint8),
                  crop_params(rng, BATCH, TILE, side, "normal")[3]) for _ in range(3)]
    tile_reqs = [tile_batch(rng, BATCH, TILE, side) for _ in range(3)]
    int_mm, int_mm_calls = torch._int_mm, []

    def counting_int_mm(*args):
        int_mm_calls.append(tuple(args[0].shape))
        return int_mm(*args)

    int8.reset_launches()
    pool.reset_launches()
    warp.reset_launches()
    bn.reset_launches()
    torch._int_mm = counting_int_mm
    try:
        outs = [est.predict_crops(c, i) for c, i in crop_reqs]
        bn_crop = bn.LAUNCHES
        outs += [est.predict_tiles(b) for b in tile_reqs]
        torch.cuda.synchronize()
    finally:
        torch._int_mm = int_mm
    path = {"qk1": int8.launches("int8_conv"), "qk2": int8.launches("int8_elementwise"),
            "pool": pool.MODE_LAUNCHES["same"], "warp": warp.LAUNCHES,
            "int_mm": len(int_mm_calls), "bn": bn.LAUNCHES}
    bn_forward = {"int8_crop": bn_crop / len(crop_reqs),
                  "int8_tile": (bn.LAUNCHES - bn_crop) / len(tile_reqs)}
    if set(bn_forward.values()) != {17} or bn.launches(act="none"):
        fail(f"int8 serving launched the batch norm kernel {bn_forward} times a forward, want "
             f"17 (bn_pre, bn_final), all with the ReLU: {bn.KERNEL_LAUNCHES}")
    path_warp_forms = dict(warp.KERNEL_LAUNCHES)
    by_kind = {f"{k[0][5:]}:{k[1]}:{k[2]}": n for k, n in int8.KERNEL_LAUNCHES.items() if n}
    for out in outs:
        for key, shape in (("pose3d_rootrel", (BATCH, 17, 3)), ("pose2d_px", (BATCH, 17, 2)),
                           ("pose3d_abs", (BATCH, 17, 3))):
            if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                fail(f"int8 serving output {key}: shape {tuple(out[key].shape)} or not finite")
    # route B, per backbone forward (one a request: TTA runs one doubled
    # batch): QK1 52 times in its wgmma variant (16 3x3 and 36 1x1 convs,
    # 32 requant into the next conv, 20 dequant), QK2 20 times to quantize,
    # and no `torch._int_mm`
    n_fwd = len(crop_reqs) + len(tile_reqs)
    got = {"qk1": path["qk1"], "qk1 wgmma": int8.launches("int8_conv", var="wgmma"),
           "qk1 requant": int8.launches("int8_conv", "requant"),
           "qk1 dequant": int8.launches("int8_conv", "dequant"), "qk2": path["qk2"],
           "qk2 quantize": int8.launches("int8_elementwise", "quantize")}
    want = {key: n * n_fwd for key, n in zip(got, (52, 52, 32, 20, 20, 20))}
    if got != want or path["int_mm"]:
        fail(f"int8 serving's launches are not route B's ({n_fwd} forwards): {got}, "
             f"_int_mm {path['int_mm']}, by kind {by_kind}")
    if min(path["pool"], path["warp"]) == 0:
        fail(f"int8 serving did not launch K3 and K1: {path}")
    check_pool_variants("int8 serving")
    check_warp_forms_launched("int8 serving", ("normalize", torch.bfloat16))
    print(f"[17 int8] serve: 3 crop-in + 3 tile-in requests of {BATCH} (R50@256 bf16 int8, TTA, "
          f"full reconstruction): outputs finite, launches {path}, by kind {by_kind} (route B: "
          f"52 QK1 wgmma and 20 QK2 quantize a forward, no _int_mm)")

    # the calibrated model in float32 on the card and on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = apply_overrides(Config(), {"model.quantize": "int8",
                                       "model.compute_dtype": "float32"})
    cpu32 = MetroModel(cfg32.model).eval()
    cpu32.load_state_dict({k: v.cpu() for k, v in model8.state_dict().items()})
    gpu32 = copy.deepcopy(cpu32).to(dev)
    xb = norm_crops(2)
    with torch.inference_mode():
        got = [t.cpu() for t in gpu32(xb)]
        want = cpu32(xb.cpu())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    rel, off = INT8_LOGIT_BOUND
    lim = rel * float(want[0].abs().max()) + off
    logit_err = [max_abs_err(g, w) for g, w in zip(got, want)]
    if not max(logit_err) < lim:
        fail(f"int8 float32 logits card vs CPU: {logit_err} >= {lim}")
    print(f"[17 int8] float32 int8 logits card vs CPU, B=2, TF32 off: max abs diff 3D "
          f"{logit_err[0]:.3e}, 2D {logit_err[1]:.3e} (bound {lim:.3e} = {rel} max|l3| + {off})")
    del cpu32, gpu32

    # times (informative; the card's name and power limit beside each): each
    # path shape in the epilogue the path gives it (3x3 requant; 1x1 as
    # QK1_PATH_1X1 says, dequant to bf16 without bias), beside its bound
    # (fused bytes, or int8 operations), `_int_mm` on the same integer sums
    # and, for a 1x1 conv, `_int_mm` + the QK2 form that route B replaced
    per_shape = {}
    keys = ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "replaced_ms")
    parts = {part: dict.fromkeys(keys, 0.0) for part in ("3x3", "1x1")}
    for name, (x, wq, pads, m, off) in inputs.items():
        part = "3x3" if name in QK1_PATH else "1x1"
        b, c, h, w, n, k, st, dil, count = {**QK1_PATH, **QK1_PATH_1X1}[name][:9]
        epi = QK1_PATH_1X1[name][9] if part == "1x1" else "requant"
        kw = (dict(scale=m, bias=off) if epi == "requant"
              else dict(scale=m, bias=None, out_dtype=torch.bfloat16))
        call = lambda: int8.int8_conv_cuda(x, wq, st, dil, pads, epi, **kw)  # noqa: E731
        out = call()
        a_unf = unfold_int8(x, k, st, dil, pads)
        w2 = wq.reshape(n, -1)
        lib = lambda: torch._int_mm(a_unf, w2.t())  # noqa: E731
        acc = lib()
        if not torch.equal(acc, int8.int8_conv_cuda(x, wq, st, dil, pads).permute(
                0, 2, 3, 1).reshape(-1, n)):
            fail(f"QK1 {name}: _int_mm on the unfolded input differs from the kernel's sums")
        macs = a_unf.shape[0] * n * a_unf.shape[1]
        vecs = [v for v in (kw["scale"], kw["bias"]) if v is not None]
        t_bytes = nbytes(x, wq, out, *vecs) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * macs / rates["int8"] * 1e3
        r = {"ms": device_ms(call, "int8_conv_wgmma_kernel"), "call_ms": time_ms(call),
             "plain_ms": time_ms(lambda: int8.int8_conv_plain(x, wq, st, dil, pads, epi, **kw),
                                 iters=5),
             "library_ms": device_ms(lib, launched_kernels(lib)),
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
             else "operations", "count": count, "epilogue": epi, "gmacs": macs / 1e9}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        extra = ""
        if part == "1x1":  # what route B replaced: the int32 sums' round trip through QK2
            acc4 = acc.view(b, out.shape[2], out.shape[3], n).permute(0, 3, 1, 2)
            form = "junction" if epi == "requant" else "dequant"
            qk2 = lambda: int8.int8_elementwise_cuda(form, acc4, m, kw["bias"],  # noqa: E731
                                                      out_dtype=kw.get("out_dtype"))
            r["qk2_ms"] = device_ms(qk2, "int8_elementwise_kernel")
            r["replaced_ms"] = r["library_ms"] + r["qk2_ms"]
            r["unfused_bytes_ms"] = t_bytes + 2 * nbytes(acc) / HBM_BYTES_PER_S * 1e3
            extra = (f", replaced _int_mm + QK2 {form} {r['replaced_ms']:.4f} ms (unfused bytes "
                     f"bound {r['unfused_bytes_ms']:.4f})")
            parts[part]["replaced_ms"] += count * r["replaced_ms"]
        if name == "3x3_s1_64":  # the int32 `acc` epilogue too: four times the bytes out
            r["acc_ms"] = device_ms(lambda: int8.int8_conv_cuda(x, wq, st, dil, pads),
                                    "int8_conv_wgmma_kernel")
            extra = f", acc epilogue {r['acc_ms']:.4f} ms"
        per_shape[name] = r
        for key in ("ms", "plain_ms", "library_ms"):
            parts[part][key] += count * r[key]
        parts[part]["bytes_ms"] += count * t_bytes
        parts[part]["ops_ms"] += count * t_ops
        print(f"[17 int8] QK1 {name} B={b} {c}->{n} {h}x{w} {epi} x{count}: {r['ms']:.4f} ms "
              f"device time, {r['call_ms']:.4f} ms a call by CUDA events "
              f"({r['gmacs']:.1f} G MACs, {2 * macs / r['ms'] / 1e9:.0f} TOP/s), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_share']:.0%}), _int_mm "
              f"on the same sums [{a_unf.shape[0]}, {a_unf.shape[1]}] {r['library_ms']:.4f} ms, "
              f"twin {r['plain_ms']:.3f} ms{extra}  [{card}]")
        del a_unf, acc, out
    stem = QK1_EDGE["7x7_s2_stem_c3"]
    x, wq, pads, m, off = int8_conv_inputs(gen, dev, *stem[:8])
    stem_ms = device_ms(lambda: int8.int8_conv_cuda(x, wq, 2, 1, pads, "dequant", m, None,
                                                    out_dtype=torch.bfloat16),
                        "int8_conv_scalar_kernel")
    del x, wq
    totals = {key: parts["3x3"][key] + parts["1x1"][key] for key in keys}
    qk1_bound = (max(totals["bytes_ms"], totals["ops_ms"]),
                 "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations")
    for part, t in parts.items():
        print(f"[17 int8] QK1 the {part} convs of a backbone forward (B=128): {t['ms']:.4f} ms, "
              f"bytes bound {t['bytes_ms']:.4f} ms, operations bound {t['ops_ms']:.4f} ms, "
              f"_int_mm on the same sums {t['library_ms']:.4f} ms"
              + (f", _int_mm + QK2 replaced {t['replaced_ms']:.4f} ms" if part == "1x1" else "")
              + f"  [{card}]")
    print(f"[17 int8] QK1 a backbone forward (52 convs, B=128): {totals['ms']:.4f} ms, bound "
          f"{qk1_bound[0]:.4f} ms ({qk1_bound[1]}; {qk1_bound[0] / totals['ms']:.0%}), _int_mm "
          f"on the same sums {totals['library_ms']:.4f} ms; the scalar 7x7/2 stem (extras "
          f"only) {stem_ms:.4f} ms  [{card}]")

    per_form, qk2_tot = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for form, (args, kw, want) in qk2_inputs.items():
        call = lambda: int8.int8_elementwise_cuda(form, *args, **kw)  # noqa: E731
        r = {"ms": device_ms(call, "int8_elementwise_kernel"),
             "plain_ms": time_ms(lambda: int8.elementwise_plain(form, *args, **kw), iters=5),
             "bound_ms": bound(nbytes(args[0], want), 0)[0]}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        per_form[form] = r
        for key in qk2_tot:
            qk2_tot[key] += r[key]
        print(f"[17 int8] QK2 {form} {tuple(args[0].shape)} {str(args[0].dtype)[6:]}: "
              f"{r['ms']:.4f} ms device time, bytes bound {r['bound_ms']:.4f} ms "
              f"({r['bound_share']:.0%}), twin {r['plain_ms']:.3f} ms  [{card}]")

    del inputs, qk2_inputs
    torch.cuda.empty_cache()
    bf16_model = init_metro_model(Config().model, SEED, dev)
    for form in ("crops", "tiles"):
        for flip_tta, b in ((True, BATCH), (False, 2 * BATCH)):
            if form == "tiles" and not flip_tta:
                continue
            fns = {name: make_predict_fn(cfg_, H36M_17.mirror_mapping, root_index=0,
                                         flip_tta=flip_tta, reconstruct=True,
                                         from_tiles=form == "tiles")
                   for name, cfg_ in (("bf16", Config()), ("int8", cfg8))}
            if form == "crops":
                u8 = torch.from_numpy(rng.randint(0, 256, (b, side, side, 3)).astype(np.uint8))
                i = torch.from_numpy(crop_params(rng, b, TILE, side, "normal")[3])
                inputs_ = (u8.to(dev), i.to(dev))
            else:
                tb = tile_batch(rng, b, TILE, side)
                inputs_ = ({k: torch.from_numpy(tb[k]).to(dev) for k in TILE_KEYS},)
            models = {"bf16": bf16_model, "int8": model8}
            ms = {"bf16": [], "int8": []}
            peak = {}
            for name in ("bf16", "int8", "int8", "bf16"):
                torch.cuda.reset_peak_memory_stats()
                ms[name].append(time_ms(lambda: fns[name](models[name], *inputs_), iters=10))
                peak[name] = torch.cuda.max_memory_allocated() / 2**30
            what = f"{form}-in {'TTA' if flip_tta else 'no TTA'} B={b}"
            print(f"[17 int8] serve {what}: int8 " + ", ".join(f"{t:.3f}" for t in ms["int8"])
                  + f" ms/batch ({b / min(ms['int8']) * 1e3:.1f} crops/s, peak "
                  f"{peak['int8']:.2f} GiB); bf16 " + ", ".join(f"{t:.3f}" for t in ms["bf16"])
                  + f" ms/batch ({b / min(ms['bf16']) * 1e3:.1f} crops/s, peak "
                  f"{peak['bf16']:.2f} GiB)  [{card}]")
            if form == "tiles":
                print(profile_breakdown(lambda: fns["int8"](model8, *inputs_), steps=5,
                                        label=f"[17 int8] profiler, int8 {what}"))
    del bf16_model, model8, est
    torch.cuda.empty_cache()

    records = [
        {"name": "int8_conv", "route": "cuda", "source": "metro_pose3d_tpu_torch/csrc/int8_conv.cu",
         "replaces": "metro_pose3d_tpu/models/quantize.py:185-195 (XLA's int8 conv and 1x1 "
                     "dot, not a TPU kernel)",
         "launches": path["qk1"], "max_abs_err": 0.0, "ms": totals["ms"],
         "plain_ms": totals["plain_ms"], "bound_ms": qk1_bound[0], "bound_by": qk1_bound[1],
         "library_ms": totals["library_ms"], "bound_share": qk1_bound[0] / totals["ms"],
         "timed": "the 52 convs of one backbone forward at B=128 (16 3x3 requant, 36 1x1 in "
                  "the path's epilogues), wgmma variant; library_ms: torch._int_mm on the "
                  "same integer sums (the unfolded input for a 3x3)",
         "parts": parts, "stem_scalar_ms": stem_ms, "per_shape": per_shape},
        {"name": "int8_elementwise", "route": "cuda",
         "source": "metro_pose3d_tpu_torch/csrc/int8_quant.cu",
         "replaces": "metro_pose3d_tpu/models/quantize.py:165-202 (elementwise passes XLA fuses "
                     "into its int8 convs, not a TPU kernel)",
         "launches": path["qk2"], "max_abs_err": 0.0, "ms": qk2_tot["ms"],
         "plain_ms": qk2_tot["plain_ms"], "bound_ms": qk2_tot["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "bound_share": qk2_tot["bound_ms"] / qk2_tot["ms"],
         "timed": "one launch of each form at stage 1 of the path (B=128), summed",
         "per_form": per_form},
    ]
    return records, {"pool": path["pool"], "warp": path["warp"], "warp_forms": path_warp_forms,
                     "bn": path["bn"], "bn_forward": bn_forward}


# --- phase 18: the host feed and train() from datasets -----------------------
# The datasets below are fixtures of this script, module-level so that a
# process pool can pickle them.


class CountingSynthetic:
    """The port's SyntheticDataset, counting the examples the loader asks
    for: one byte appended to `log` for each, so that loader processes count
    too (`prepared()`)."""

    root_joint = "pelv"
    has_masks = False

    def __init__(self, n_train, log, imshape=(TILE, TILE), seed=0):
        from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset

        self.base = SyntheticDataset(n_train=n_train, n_test=0, seed=seed, imshape=imshape)
        self.joint_info, self.n_train, self.n_test = self.base.joint_info, n_train, 0
        self.log = log
        open(log, "wb").close()

    def prepared(self) -> int:
        return os.path.getsize(self.log)

    def train_example(self, i):
        with open(self.log, "ab") as f:
            f.write(b".")
        return self.base.train_example(i)


class TwoDView(CountingSynthetic):
    """A 2D-only view in the MPII convention: the synthetic skeleton's joints
    that MPII names, projected into the frame, the others NaN and invalid."""

    def __init__(self, n_train, log, imshape=(TILE, TILE), seed=1):
        from metro_pose3d_tpu_torch.geom.joints import MPII_16

        super().__init__(n_train, log, imshape, seed)
        self.joint_info = MPII_16

    def train_example(self, i):
        import dataclasses

        ex = super().train_example(i)
        names = self.base.joint_info.names
        px = ex.camera.world_to_image(ex.world_coords)
        pts = np.full((self.joint_info.n_joints, 2), np.nan)
        valid = np.zeros(self.joint_info.n_joints, bool)
        for j, name in enumerate(self.joint_info.names):
            if name in names:
                pts[j], valid[j] = px[names.index(name)], True
        return dataclasses.replace(ex, world_coords=None, image_coords=pts,
                                   joint_validity=valid)


class MaskedView(CountingSynthetic):
    """Synthetic examples with a foreground mask (the discs' neighbourhood),
    which asks train() for background replacement, as 3DHP's does."""

    has_masks = True

    def train_example(self, i):
        ex = super().train_example(i)
        ex.mask = (ex.image != ex.image[0, 0]).any(-1)
        return ex


class HeldFrames:
    """Examples rendered once and held in memory: the feed without the render."""

    root_joint = "pelv"

    def __init__(self, examples):
        from metro_pose3d_tpu_torch.geom.joints import H36M_17

        self.examples, self.joint_info = examples, H36M_17
        self.n_train, self.n_test = len(examples), 0

    def train_example(self, i):
        return self.examples[i]


def feed_rate(ds, batch, n_batches, **kw) -> float:
    """Examples/s of `batch_iterator` over `ds` after one warm-up batch (pool
    start-up and first builds excluded)."""
    from metro_pose3d_tpu_torch.config import Config
    from metro_pose3d_tpu_torch.pipeline.loader import batch_iterator

    it = batch_iterator(ds.train_example, ds.n_train, ds.joint_info, batch, 256, TILE,
                        aug_cfg=Config().aug, seed=SEED, n_occluders=64, **kw)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return n_batches * batch / (time.perf_counter() - t0)
    finally:
        it.close()


def check_engines(rng) -> str:
    """`prepare_example` in the native engine against the python one on this
    host, over 64 draws: flips, large rotations, a distorted camera, 2D-only
    rows with NaN and invalid joints, and masks."""
    import dataclasses

    from metro_pose3d_tpu_torch.config import Config
    from metro_pose3d_tpu_torch.data.synthetic import make_example
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.pipeline.crops import prepare_example, sample_aug_params

    aug_rng, worst, kinds = np.random.default_rng(SEED), 0.0, {}
    for i in range(64):
        ex, kind, kw = make_example(i, imshape=(720, 960)), ("aug", "distorted_flip_rot",
                                                            "2d_nan", "mask")[i % 4], {}
        aug, occ = sample_aug_params(aug_rng, Config().aug, 64, 32)
        if kind == "distorted_flip_rot":
            ex.camera.dist[:] = [-0.2, 0.05, 1e-3, -5e-4, 0.01]
            aug = dataclasses.replace(aug, flip=True, rot_rad=np.deg2rad(rng.uniform(-88, 88)))
        elif kind == "2d_nan":
            pts = ex.camera.world_to_image(ex.world_coords)
            pts[3] = np.nan
            valid = np.ones(17, bool)
            valid[5] = False
            ex = dataclasses.replace(ex, world_coords=None, image_coords=pts,
                                     joint_validity=valid)
        elif kind == "mask":
            ex.mask = rng.random_sample((720, 960)) > 0.4
            kw = {"with_background": True}
        a, b = (prepare_example(ex, H36M_17, 256, TILE, aug=aug, occ_center=occ, engine=e, **kw)
                for e in ("python", "native"))
        if a.keys() != b.keys():
            fail(f"engines: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if x.dtype == np.uint8:
                if not np.array_equal(x, y):
                    fail(f"engines: {kind} draw {i}: {k} differs")
                continue
            diff = np.abs(x.astype(np.float64) - y) / (1.0 + np.abs(y))
            if np.any(diff > ENGINE_RTOL):
                fail(f"engines: {kind} draw {i}: {k} differs by more than rtol {ENGINE_RTOL}")
            worst = max(worst, float(diff.max(initial=0.0)))
        kinds[kind] = kinds.get(kind, 0) + 1
    return f"{kinds}, worst relative difference {worst:.1e} (rtol {ENGINE_RTOL})"


def phase_feed(rng, dev, card, resident_step_ms) -> dict:
    """18: the host runtime's build, the engines on this host, the feed's
    rates, the copy to the card, then train() from datasets. -> the K1 unit,
    K2 and K3 forward and backward launches of the train-from-dataset runs."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset
    from metro_pose3d_tpu_torch.native import build as native
    from metro_pose3d_tpu_torch.ops import occlusion, pool, warp
    from metro_pose3d_tpu_torch.pipeline import crops
    from metro_pose3d_tpu_torch.pipeline import device as pdevice
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device
    from metro_pose3d_tpu_torch.pipeline.loader import batch_iterator
    from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
    from metro_pose3d_tpu_torch.train.trainer import train
    from metro_pose3d_tpu_torch.utils import improc

    t_phase = time.perf_counter()
    # the host runtime: the crop engine, then the JPEG decoder
    t0 = time.perf_counter()
    if native.crop_library() is None:
        fail(f"the crop engine did not build: {native.build_error('croprep')}")
    t_crop = time.perf_counter() - t0
    t0 = time.perf_counter()
    have_jpeg = native.load("jpegdec") is not None
    t_jpeg = time.perf_counter() - t0
    cc = subprocess.run([native._compiler(), "--version"], capture_output=True, text=True,
                        timeout=60).stdout.splitlines()[:1]
    print(f"[18 feed] host runtime ({cc[0] if cc else native._compiler()}): crop engine built "
          f"in {native.build_seconds.get('croprep', 0.0):.2f} s (load {t_crop:.2f} s), JPEG "
          f"decoder " + (f"built in {native.build_seconds.get('jpegdec', 0.0):.2f} s (load "
                          f"{t_jpeg:.2f} s): libjpeg found" if have_jpeg else
                          "not built: libjpeg not found (no JPEG lies on this path): "
                          + (native.build_error("jpegdec") or "").strip().splitlines()[-1]))
    if have_jpeg:
        fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
        got = improc.imread(os.path.join(fixture, "rgb_48x64.jpg"))
        want = np.load(os.path.join(fixture, "rgb_48x64_pixels.npz"))["rgb"]
        if not np.array_equal(got, want):
            fail(f"JPEG decode of the fixture differs from its stored pixels at "
                 f"{int((got != want).any(-1).sum())} pixels")
        print("[18 feed] JPEG fixture tests/fixtures/rgb_48x64.jpg decodes to its stored "
              "pixels bit for bit")
    if crops.resolve_engine("auto") != "native":
        fail("data.host_prep='auto' did not resolve to the native engine")
    print(f"[18 feed] engines, native vs python on this host: {check_engines(rng)}")

    # the feed's rates (informative)
    ncpu = os.cpu_count() or 1
    many = min(ncpu, 32)
    b = N3D + N2D
    ds = SyntheticDataset(n_train=4096, n_test=0, imshape=(TILE, TILE))
    t0 = time.perf_counter()
    held = HeldFrames([ds.train_example(i) for i in range(2 * b)])
    render_ms = (time.perf_counter() - t0) / (2 * b) * 1e3
    rates = {}
    for engine, pool_type, workers, frames, n in (
            ("python", "thread", 4, "render", 2), ("native", "thread", 4, "render", 3),
            ("native", "thread", many, "render", 3), ("native", "process", 4, "render", 3),
            ("native", "process", many, "render", 4),
            ("python", "thread", many, "held", 2), ("native", "thread", 4, "held", 4),
            ("native", "thread", many, "held", 6)):
        rates[engine, pool_type, workers, frames] = r = feed_rate(
            held if frames == "held" else ds, b, n, n_workers=workers, pool_type=pool_type,
            host_prep=engine)
        print(f"[18 feed] batch_iterator {engine} engine, {pool_type} pool of {workers}, "
              f"{'synthetic render' if frames == 'render' else 'frames held in memory'}, "
              f"{TILE}^2 frames and tiles, proc 256, aug on: {r:.1f} examples/s  "
              f"[{ncpu} CPUs; {card}]")
    print(f"[18 feed] the synthetic render alone: {render_ms:.2f} ms a {TILE}^2 frame on one "
          f"thread; os.cpu_count() {ncpu}")

    # the copy of one train batch to the card, pageable (as batch_to_device
    # does) and staged through pinned memory
    hb = next(batch_iterator(held.train_example, held.n_train, held.joint_info, b, 256, TILE,
                             aug_cfg=Config().aug, n_workers=many, host_prep="native"))
    nbytes_batch = sum(v.nbytes for v in hb.values())
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in hb.items()}
    copies = {}
    for how, fn in (("pageable", lambda: batch_to_device(hb, dev)),
                    ("pinned", lambda: {k: v.to(dev, non_blocking=True)
                                        for k, v in pinned.items()})):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        copies[how] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"[18 feed] copy of one {b}-row batch ({nbytes_batch / 1e6:.1f} MB) to the card: "
          + ", ".join(f"{how} {ms:.2f} ms ({nbytes_batch / ms / 1e6:.2f} GB/s)"
                      for how, ms in copies.items()) + f"  [{card}]")
    del pinned, hb

    # train() from datasets, through the C engine, at full width, fed by a
    # pool of processes (threads starve the step of the interpreter lock
    # while they render)
    over = {"train.checkpoint_every": "5", "train.log_every": "1", "train.validate_every": "0",
            "data.host_prep": "auto", "data.workers": str(many), "data.pool_type": "process"}
    composites = []
    composite = pdevice.composite_background

    def counted_composite(src, mask, bg_bank, bg_params):
        composites.append(tuple(bg_bank.shape))
        return composite(src, mask, bg_bank, bg_params)

    def steady(hist):  # a leg past its first step: ms a step, crops/s, loader-wait share
        ms = float(np.median([b / r["crops_per_sec"] * 1e3 for r in hist[1:]]))
        return ms, b / ms * 1e3, float(np.median([r["loader_wait_share"] for r in hist[1:]]))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = apply_overrides(Config(), {**over, "train.logdir": os.path.join(tmp, "run")})
        d3 = CountingSynthetic(1024, os.path.join(tmp, "n3"))
        d2 = TwoDView(1024, os.path.join(tmp, "n2"))
        pool.reset_launches()
        warp.reset_launches()
        occlusion.LAUNCHES = 0
        t0 = time.perf_counter()
        state = train(cfg, d3, d2, max_steps=10)
        torch.cuda.synchronize()
        first_leg = time.perf_counter() - t0
        first_prepared = (d3.prepared(), d2.prepared())
        logdir = cfg.train.logdir
        with open(os.path.join(logdir, "history.json")) as f:
            hist = json.load(f)
        for name in os.listdir(os.path.join(logdir, "checkpoints")):
            if name != "5":
                shutil.rmtree(os.path.join(logdir, "checkpoints", name))
        if Checkpointer(logdir).latest_step() != 5:
            fail("the checkpoint of step 5 is missing")
        d3, d2 = CountingSynthetic(1024, d3.log), TwoDView(1024, d2.log)
        resumed = train(cfg, d3, d2, max_steps=10)
        torch.cuda.synchronize()
        launches = {"pool": pool.MODE_LAUNCHES["same"],
                    "pool_bwd": pool.MODE_BWD_LAUNCHES["same"],
                    "warp": warp.LAUNCHES, "occluder": occlusion.LAUNCHES}
        if any(v == 0 for v in launches.values()):
            fail(f"train() from datasets did not launch every kernel: {launches}")
        check_pool_variants("train() from datasets", ("fwd", "bwd"))
        check_warp_forms_launched("train() from datasets", ("unit", torch.float32))
        forms = dict(warp.KERNEL_LAUNCHES)
        if state.step != 10 or resumed.step != 10:
            fail(f"train() from datasets: steps {state.step}, {resumed.step} (want 10)")
        resumed_prepared = (d3.prepared(), d2.prepared())
        if resumed_prepared != (5 * N3D, 5 * N2D) or first_prepared != (10 * N3D, 10 * N2D):
            fail(f"examples prepared: {first_prepared} in 10 steps, {resumed_prepared} in the "
                 f"resumed 5 (want {(10 * N3D, 10 * N2D)} and {(5 * N3D, 5 * N2D)})")
        with open(os.path.join(logdir, "history.json")) as f:
            hist2 = json.load(f)
        for h in (hist, hist2):
            if [r["step"] for r in h] != list(range(1, 11)) or not all(
                    np.isfinite([r["loss"], r["loss3d"], r["loss2d"], r["grad_norm"]]).all()
                    for r in h):
                fail(f"train() from datasets: history not finite or not steps 1..10: {h}")
        print(f"[18 feed] train(Config(), SyntheticDataset, a 2D-only MPII view) R50@256 bf16, "
              f"B={N3D}+{N2D}, {TILE}^2 frames and tiles, data.host_prep auto -> native, process "
              f"pool of {many}, prefetch 2: 10 steps in {first_leg:.1f} s (loss "
              f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, finite), checkpoint at 5, "
              f"resumed 5 -> 10 preparing {resumed_prepared[0]} + {resumed_prepared[1]} = "
              f"{sum(resumed_prepared)} examples (5 x {b}); launches {launches}, warp forms "
              f"{fmt_forms(forms, 'd')}, pool variants {pool.VARIANT_LAUNCHES}")
        for what, h in (("steps 2-10", hist), ("resumed steps 7-10", hist2[6:])):
            ms, rate, wait = steady(h)
            print(f"[18 feed] train() from datasets, process pool of {many}, {what}: {ms:.1f} ms "
                  f"a step (wall), {rate:.1f} crops/s, waiting for the loader {wait:.0%} of the "
                  f"step; phase 12's device-resident step {resident_step_ms:.1f} ms  [{card}]")
        del state, resumed
        torch.cuda.empty_cache()

        # a dataset with masks: train() builds the background bank and
        # composites; fed by a pool of threads, for the comparison
        mcfg = apply_overrides(cfg, {"train.logdir": os.path.join(tmp, "masked"),
                                     "aug.background_prob": "0.7", "data.pool_type": "thread",
                                     "data.workers": "4", "train.checkpoint_every": "3"})
        pdevice.composite_background = counted_composite
        pool.reset_launches()
        warp.reset_launches()
        occlusion.LAUNCHES = 0
        try:
            t0 = time.perf_counter()
            state = train(mcfg, MaskedView(256, os.path.join(tmp, "m3")),
                          TwoDView(256, os.path.join(tmp, "m2")), max_steps=3)
            torch.cuda.synchronize()
        finally:
            pdevice.composite_background = composite
        for k, v in (("pool", pool.MODE_LAUNCHES["same"]),
                     ("pool_bwd", pool.MODE_BWD_LAUNCHES["same"]), ("warp", warp.LAUNCHES),
                     ("occluder", occlusion.LAUNCHES)):
            launches[k] += v
        for k, v in warp.KERNEL_LAUNCHES.items():
            forms[k] = forms.get(k, 0) + v
        if state.step != 3 or composites != [(32, TILE, TILE, 3)] * 3:
            fail(f"masked dataset: {state.step} steps, composites {composites} (want 3 with "
                 f"the bank of 32 that train() builds)")
        with open(os.path.join(tmp, "masked", "history.json")) as f:
            ms, rate, wait = steady(json.load(f))
        print(f"[18 feed] a dataset with has_masks, aug.background_prob 0.7: train() built the "
              f"bank of 32 {TILE}^2 tiles and composited at each of the 3 steps "
              f"({time.perf_counter() - t0:.1f} s with the bank's build); thread pool of 4, "
              f"steps 2-3: {ms:.1f} ms a step (wall), {rate:.1f} crops/s, waiting for the loader "
              f"{wait:.0%}  [{card}]")
        del state
    torch.cuda.empty_cache()
    print(f"[18 feed] phase time {time.perf_counter() - t_phase:.1f} s")
    return {**launches, "warp_forms": forms}


# --- phase 19: the --test protocol path from annotation files to scores ----------

# the H36M-layout shard: (subject, sequence, frame step) as the JAX package's
# synthetic shard names them; subjects 1/5 train (every 5th frame), 9/11 test
# (every 64th); frames drawn at the H36M frame size and stored as PNG
SHARD_SEQUENCES = (
    (1, "Walking 1.54138969", 5),
    (5, "Eating.55011271", 5),
    (9, "Walking 1.58860488", 64),
    (9, "WalkDog.54138969", 64),
    (9, "Greeting.60457274", 64),
    (11, "TakingPhoto.55011271", 64),
    (11, "WalkingTogether 1.58860488", 64),
)
SHARD_FRAMES = {1: 16, 5: 16, 9: 60, 11: 60}  # frames a sequence, by subject
SHARD_IMSHAPE = (1000, 1000)
SHARD_R_BASE = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
DATASET_OVERRIDES = {"eval.scale_recovery": "bone_lengths"}  # on Config(): R50@256 bf16 TTA
INT8_MPJPE_REL = 0.05  # |int8 - fp| MPJPE bound, tests/test_h36m_shard.py
# the int8 dump in float32, card against CPU on the first INT8_PARITY_N test
# examples: key -> (max, mean) abs diff. Float32 roundoff moves values across
# int8 rounding edges, so the two differ more than the float dumps do. On 8
# examples (H100, 700 W) they differed by max/mean 1.05/0.237 mm root-relative,
# 0.075/0.0185 px, 15.1/2.27 mm absolute, where int8 and float32 on the card
# differed by a mean of 3.36 mm, 0.164 px and 42.2 mm: the bounds sit ~3x
# above the former and ~4x below the latter
INT8_PARITY_N = 4
INT8_PARITY_TOL = {"pose3d_rootrel": (4.0, 0.75), "pose2d_px": (0.3, 0.06),
                   "pose3d_abs": (50.0, 8.0)}


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 [H, W, C] (C 1, 3 or 4) as a PNG: row y filtered with filter
    y % 5 (None, Sub, Up, Average, Paeth in turn, so that a reader meets
    every one), deflated by zlib."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch)
    above = np.zeros_like(x)
    above[1:] = x[:-1]
    raw = np.empty((h, 1 + w * ch), np.uint8)
    raw[:, 0] = np.arange(h) % 5
    for kind in range(5):  # the rows of each filter together
        a, b = x[kind::5].astype(np.int16), above[kind::5].astype(np.int16)
        left, corner = np.zeros_like(a), np.zeros_like(a)
        left[:, ch:], corner[:, ch:] = a[:, :-ch], b[:, :-ch]
        if kind == 4:
            p = left + b - corner
            pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - corner)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, b, corner))
        else:
            pred = (0, left, b, (left + b) // 2)[kind]
        raw[kind::5, 1:] = (a - pred).astype(np.uint8)  # modulo 256

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    color = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def write_png_shard(root: str, threads: int = 8) -> dict:
    """The H36M layout of `scripts/prepare_h36m.py` under `root`/h36m, with
    PNG frames: the JAX package's synthetic shard (its camera yaws, world
    transform and sequence names), drawn by the port's renderer. -> counts."""
    import concurrent.futures

    from metro_pose3d_tpu_torch.data.synthetic import make_example

    base = os.path.join(root, "h36m")
    rows = {k: [] for k in ("image_paths", "world_coords", "subjects", "frame_indices",
                            "intrinsics", "rotations", "positions", "distortions")}
    jobs, transforms = [], []
    for seq_i, (subj, seq_name, step) in enumerate(SHARD_SEQUENCES):
        yaw = seq_i * 2.399963
        c, sn = np.cos(-yaw), np.sin(-yaw)
        r_wc = SHARD_R_BASE @ np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]])
        center = np.array([1500.0 * np.cos(yaw), 1500.0 * np.sin(yaw), 1200.0 + 100.0 * seq_i])
        rel = os.path.join("images", f"S{subj}", seq_name)
        os.makedirs(os.path.join(base, rel), exist_ok=True)
        for k in range(SHARD_FRAMES[subj]):
            path = os.path.join(rel, f"frame_{k * step:06d}.png")
            jobs.append((len(jobs), path))
            rows["image_paths"].append(path)
            rows["subjects"].append(subj)
            rows["frame_indices"].append(k * step)
            rows["rotations"].append(r_wc)
            rows["positions"].append(center)
            rows["distortions"].append(np.zeros(5))
            transforms.append((r_wc, center))

    def render(job):
        index, path = job
        ex = make_example(index, seed=SEED, imshape=SHARD_IMSHAPE)
        with open(os.path.join(base, path), "wb") as f:
            f.write(png_bytes(ex.image))
        return ex.world_coords, ex.camera.K, (ex.image if index == 0 else None)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool_:
        done = list(pool_.map(render, jobs))
    # make_example's camera sits at the origin without rotation, so its world
    # coordinates are camera-frame points; re-expressed in the z-up world
    rows["world_coords"] = [p_cam @ r_wc + center
                            for (p_cam, _, _), (r_wc, center) in zip(done, transforms)]
    rows["intrinsics"] = [k for _, k, _ in done]
    np.savez_compressed(os.path.join(base, "annotations.npz"),
                        image_paths=np.array(rows["image_paths"]),
                        world_coords=np.array(rows["world_coords"], np.float32),
                        subjects=np.array(rows["subjects"], np.int32),
                        frame_indices=np.array(rows["frame_indices"], np.int32),
                        intrinsics=np.array(rows["intrinsics"], np.float32),
                        rotations=np.array(rows["rotations"], np.float32),
                        positions=np.array(rows["positions"], np.float32),
                        distortions=np.array(rows["distortions"], np.float32))
    return {"frames": len(jobs), "first_path": os.path.join(base, jobs[0][1]),
            "first_image": done[0][2]}


def phase_dataset(dev, card) -> dict:
    """19: the --test protocol path: a PNG-framed H36M-layout shard ->
    `get_dataset("h36m")` -> `predict_dataset` (R50@256 bf16, flip TTA,
    bone-length rescale, absolute reconstruction, the loader's thread pool)
    -> `save_predictions` -> `eval_h36m`; the card against the CPU on 8 test
    examples in float32; the int8 leg (`calibrate_on_dataset` on 2 batches,
    predict, score, and its float32 card against CPU on INT8_PARITY_N test
    examples). -> the K1, K3, QK1 and QK2 launches of its predict runs."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.data.datasets import get_dataset
    from metro_pose3d_tpu_torch.evaluation import eval_h36m
    from metro_pose3d_tpu_torch.evaluation.predict import (
        compute_mean_bones, predict_dataset, save_predictions,
    )
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.models.metro import MetroModel
    from metro_pose3d_tpu_torch.models.quantize import calibrate_on_dataset
    from metro_pose3d_tpu_torch.ops import bn, int8, pool, warp
    from metro_pose3d_tpu_torch.utils import improc

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    try:
        t0 = time.perf_counter()
        shard = write_png_shard(tmp)
        write_s = time.perf_counter() - t0
        # the port's PNG reader (zlib + the C unfilter, built here) gives
        # back the rendered pixels
        if not np.array_equal(improc.imread(shard["first_path"]), shard["first_image"]):
            fail("the PNG reader does not give back the pixels written")
        ds = get_dataset("h36m", tmp)
        n_test, n_train = ds.n_test, ds.n_train
        want = {"train": sum(SHARD_FRAMES[s] for s, _, _ in SHARD_SEQUENCES if s in (1, 5)),
                "test": sum(SHARD_FRAMES[s] for s, _, _ in SHARD_SEQUENCES if s in (9, 11))}
        if (n_train, n_test) != (want["train"], want["test"]):
            fail(f"h36m reader: {n_train} train, {n_test} test examples, want {want}")
        print(f"[19 dataset] shard: {shard['frames']} PNG frames of {SHARD_IMSHAPE[0]}x"
              f"{SHARD_IMSHAPE[1]} (rows filtered None, Sub, Up, Average, Paeth in turn) "
              f"written in {write_s:.1f} s; get_dataset('h36m'): {n_train} train, {n_test} "
              f"test examples; the first frame reads back equal")

        cfg = apply_overrides(Config(), DATASET_OVERRIDES)
        model = init_metro_model(cfg.model, SEED + 19, dev)
        t0 = time.perf_counter()
        mean_bones = compute_mean_bones(ds)
        bones_s = time.perf_counter() - t0
        n_batches = -(-n_test // cfg.eval.batch_size)

        def reset():
            pool.reset_launches()
            warp.reset_launches()
            int8.reset_launches()
            bn.reset_launches()

        def counts():
            return {"pool": pool.MODE_LAUNCHES["same"], "warp": warp.LAUNCHES,
                    "warp_forms": dict(warp.KERNEL_LAUNCHES),
                    "qk1": int8.launches("int8_conv"), "qk2": int8.launches("int8_elementwise"),
                    "bn": bn.LAUNCHES}

        def run(c, m, what, **kw):
            reset()
            stats = {}
            result = predict_dataset(c, m, ds, mean_bones=mean_bones, stats=stats, **kw)
            path = save_predictions(result, os.path.join(tmp, f"pred_{what}.npz"))
            return result, path, stats, counts()

        result, path, stats, fp_launches = run(cfg, model, "fp")
        rows = len(result["pose3d_rootrel"])
        if rows != n_test or set(result) != {
                "pose3d_rootrel", "pose3d_abs", "pose2d_px", "gt3d_rootrel", "gt3d_abs",
                "valid", "actions", "joint_names", "example_offset"}:
            fail(f"predict_dataset: {rows} rows of {n_test}, keys {sorted(result)}")
        for key in ("pose3d_rootrel", "pose3d_abs", "pose2d_px"):
            if not np.isfinite(result[key]).all():
                fail(f"predict_dataset: {key} is not finite")
        if fp_launches["warp_forms"].get(("normalize", torch.bfloat16), 0) != n_batches \
                or fp_launches["warp"] != n_batches or fp_launches["pool"] != n_batches \
                or fp_launches["bn"] != 49 * n_batches:
            fail(f"predict_dataset over {n_batches} batches: launches {fp_launches}")
        check_pool_variants("predict_dataset")
        scores = eval_h36m.evaluate(path)
        if not all(np.isfinite(scores[k]) for k in ("mpjpe", "pa_mpjpe", "abs_mpjpe")) \
                or set(scores["per_action_mpjpe"]) != {
                    "Walking", "WalkingDog", "Greeting", "Photo", "WalkTogether"}:
            fail(f"eval_h36m: {scores}")
        # again, on frames now in the decoded-frame cache and shapes seen once
        warm = run(cfg, model, "fp_warm")[2]

        def reading(st):
            return (f"{n_test / st['wall_s']:.1f} examples/s ({st['wall_s']:.2f} s for {n_test}), "
                    f"waiting for the loader {st['loader_wait_s'] / st['wall_s']:.0%} of it")

        print(f"[19 dataset] predict_dataset(Config(), R50@256 bf16, TTA, bone-length rescale, "
              f"absolute reconstruction, thread pool of {cfg.data.workers}) -> save_predictions "
              f"-> eval_h36m: {rows} rows of n_test {n_test} in {n_batches} batches of "
              f"{cfg.eval.batch_size} (the last padded); MPJPE {scores['mpjpe']:.4f}, PA-MPJPE "
              f"{scores['pa_mpjpe']:.4f}, absolute {scores['abs_mpjpe']:.4f} mm, per action "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(scores["per_action_mpjpe"].items()))
              + f"; launches K1 normalize bf16 {fp_launches['warp']}, K3 {fp_launches['pool']} "
              f"(= batches); compute_mean_bones {bones_s:.2f} s over {n_train} train frames")
        print(f"[19 dataset] rate, end to end: first pass (every frame decoded from PNG) "
              f"{reading(stats)}; second pass (frames cached) {reading(warm)}  [{card}]")

        # the card against the CPU, float32, TF32 off, first 8 test examples
        cfg32 = apply_overrides(cfg, {"model.compute_dtype": "float32",
                                      "model.matmul_precision": "highest"})
        cpu32 = MetroModel(cfg32.model).eval()
        cpu32.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        gpu32 = copy.deepcopy(cpu32).to(dev)
        got = run(cfg32, gpu32, "gpu32", n_examples=8)[0]
        want_cpu = run(cfg32, cpu32, "cpu32", n_examples=8)[0]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        worst = {}
        for key, tol in PARITY_TOL.items():
            worst[key] = float(np.abs(got[key] - want_cpu[key]).max())
            if not worst[key] <= tol:
                fail(f"predict_dataset float32 card vs CPU {key}: {worst[key]} > {tol}")
        for key in ("gt3d_abs", "valid", "actions"):
            if not np.array_equal(got[key], want_cpu[key]):
                fail(f"predict_dataset card vs CPU: {key} differs")
        print(f"[19 dataset] float32 card vs CPU, first 8 test examples, TF32 off: max abs diff "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tol {PARITY_TOL})")
        del cpu32, gpu32

        # the int8 leg: the same weights, calibrated on the test split's crops
        cfg8 = apply_overrides(cfg, {"model.quantize": "int8"})
        model8 = MetroModel(cfg8.model)
        missing, unexpected = model8.load_state_dict(
            {k: v.cpu() for k, v in model.state_dict().items()}, strict=False)
        if unexpected or not missing or not all(k.endswith(".amax") for k in missing):
            fail(f"int8 model from the fp weights: missing {missing[:3]}, unexpected {unexpected}")
        model8 = model8.to(dev).eval()
        reset()
        t0 = time.perf_counter()
        calibrate_on_dataset(cfg8, model8, ds, n_batches=2)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        calib_launches = counts()
        # calibration runs every batch norm as one (no fused bottleneck)
        if (calib_launches["warp"], calib_launches["pool"], calib_launches["bn"]) != (2, 2, 98):
            fail(f"calibrate_on_dataset over 2 batches: launches {calib_launches}")
        result8, path8, stats8, int8_launches = run(cfg8, model8, "int8")
        scores8 = eval_h36m.evaluate(path8)
        delta = scores8["mpjpe"] - scores["mpjpe"]
        if not abs(delta) < INT8_MPJPE_REL * scores["mpjpe"]:
            fail(f"int8 MPJPE {scores8['mpjpe']} against fp {scores['mpjpe']}: |delta| "
                 f">= {INT8_MPJPE_REL} fp")
        want8 = {"qk1": 52 * n_batches, "qk2": 20 * n_batches, "warp": n_batches,
                 "pool": n_batches, "bn": 17 * n_batches}
        if any(int8_launches[k] != n for k, n in want8.items()) or len(result8["valid"]) != n_test:
            fail(f"int8 predict_dataset: launches {int8_launches}, want {want8}; "
                 f"{len(result8['valid'])} rows")
        print(f"[19 dataset] int8: calibrate_on_dataset over 2 batches in {calib_s:.2f} s (K1 "
              f"{calib_launches['warp']}, K3 {calib_launches['pool']} launches), then "
              f"predict_dataset + eval_h36m: MPJPE {scores8['mpjpe']:.4f} against fp "
              f"{scores['mpjpe']:.4f} (delta {delta:+.4f} mm, bound {INT8_MPJPE_REL} fp), "
              f"{reading(stats8)} (frames cached); launches QK1 {int8_launches['qk1']}, "
              f"QK2 {int8_launches['qk2']}, K1 {int8_launches['warp']}, K3 "
              f"{int8_launches['pool']}, batch norm {int8_launches['bn']} (fp "
              f"{fp_launches['bn']}, calibration {calib_launches['bn']})  [{card}]")

        # the calibrated int8 model through predict_dataset in float32: on the
        # card (QK1, QK2) against the CPU (their plain twins), first test
        # examples; beside it, how far int8 lies from float32, and the card
        # against itself with the stem's weights scaled by 1 + 2^-20 (a change
        # of float32 roundoff's size)
        n8 = INT8_PARITY_N
        cfg8_32 = apply_overrides(cfg32, {"model.quantize": "int8"})
        cpu8 = MetroModel(cfg8_32.model).eval()
        cpu8.load_state_dict({k: v.cpu() for k, v in model8.state_dict().items()})
        gpu8 = copy.deepcopy(cpu8).to(dev)
        got8 = run(cfg8_32, gpu8, "gpu8_32", n_examples=n8)[0]
        want8_cpu = run(cfg8_32, cpu8, "cpu8_32", n_examples=n8)[0]
        with torch.no_grad():
            gpu8.backbone.conv_stem.weight.mul_(1 + 2**-20)
        nudged = run(cfg8_32, gpu8, "gpu8_nudged", n_examples=n8)[0]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        worst8, mean8, apart, floor = {}, {}, {}, {}
        for key in INT8_PARITY_TOL:
            d = np.abs(got8[key] - want8_cpu[key])
            worst8[key], mean8[key] = float(d.max()), float(d.mean())
            apart[key] = float(np.abs(got8[key] - got[key][:n8]).mean())
            floor[key] = float(np.abs(nudged[key] - got8[key]).mean())
        print(f"[19 dataset] int8 float32 card vs CPU, first {n8} test examples, TF32 off: abs "
              f"diff max/mean " + ", ".join(f"{k} {worst8[k]:.2e}/{mean8[k]:.2e}" for k in worst8)
              + f" (tol {INT8_PARITY_TOL}); mean abs diff of int8 against float32 on the card "
              + ", ".join(f"{k} {v:.2e}" for k, v in apart.items())
              + "; of the card against itself, stem scaled by 1 + 2^-20, "
              + ", ".join(f"{k} {v:.2e}" for k, v in floor.items()))
        for key, (tol_max, tol_mean) in INT8_PARITY_TOL.items():
            if not (worst8[key] <= tol_max and mean8[key] <= tol_mean):
                fail(f"int8 predict_dataset float32 card vs CPU {key}: max {worst8[key]}, mean "
                     f"{mean8[key]}, tol {(tol_max, tol_mean)}")
        del model, model8, cpu8, gpu8
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[19 dataset] phase time {time.perf_counter() - t_phase:.1f} s")
    legs = (fp_launches, calib_launches, int8_launches)
    forms = {}
    for leg in legs:
        for form, n in leg["warp_forms"].items():
            forms[form] = forms.get(form, 0) + n
    return {**{k: sum(leg[k] for leg in legs) for k in ("pool", "warp", "qk1", "qk2", "bn")},
            "warp_forms": forms, "bn_forward": {"dataset_fp": fp_launches["bn"] / n_batches,
                                                "dataset_int8": int8_launches["bn"] / n_batches}}


# --- phase 20: the multi-person frame path and the command line ----------------

MP_PERSONS, MP_FRAMES, MP_IMSHAPE = 6, 48, (720, 1280)
MP_BUCKET = 8  # the default buckets' bucket for 6 persons
MP_PASSES = 3  # stream and loop passes, in turns
MP_EQUAL_TOL = 1e-3  # the stream against the loop: mm and px (equal bits expected)
# frame mode against tile mode with tiles that cover the ROI (no decimation):
# tests/test_multiperson.py::TestFrameMode's bounds, mm and px
FRAME_TILE_TOL = {"pose3d_rootrel": 0.5, "pose2d_px": 0.1}
MP_CLI_STEPS, MP_CLI_VALIDATE = 20, 10


class FrameSequence:
    """Frames held in memory as a multi-person test split: the frame
    protocol of the 3DPW reader, which `predict_multiperson_dataset` reads."""

    root_joint = "pelv"

    def __init__(self, frames):
        from metro_pose3d_tpu_torch.geom.joints import H36M_17

        self.frames, self.joint_info = frames, H36M_17
        self.n_test_frames = len(frames)

    def test_frame(self, i):
        image, boxes, camera, world = self.frames[i]
        return image, boxes, camera, world, "synthetic_sequence"


def crop_zoom(boxes, camera, cfg) -> np.ndarray:
    """Frame pixels per crop pixel of each box's crop."""
    from metro_pose3d_tpu_torch.pipeline.crops import prepare_inference_crop_params

    return np.array([camera.K[0, 0] / prepare_inference_crop_params(
        b, camera, cfg.model.proc_side, cfg.data.test_box_expansion)["intrinsics"][0, 0]
        for b in boxes])


def phase_multiperson(rng, dev, card) -> dict:
    """20: the multi-person frame path (`MultiPersonEstimator`, Config():
    R50@256 bf16, TTA, frame mode, the default buckets) on a synthetic 720p
    sequence of 6 people: warmup, `estimate_stream(depth=2)` against an
    `estimate_frame` loop (frames/s, equal outputs, K1 normalize_div and K3
    launches); float32 card against CPU on one frame of 3 within PARITY_TOL;
    frame mode against tile mode; int8; `predict_multiperson_dataset` ->
    `eval_3dpw`; and the command line: --train with in-loop validation, --test,
    --eval-h36m, --export and `load_exported`. -> the kernels' launches."""
    from metro_pose3d_tpu_torch import main as cli
    from metro_pose3d_tpu_torch.config import Config, apply_overrides, parse_cli
    from metro_pose3d_tpu_torch.data.synthetic import (
        make_multiperson_frame, make_multiperson_sequence,
    )
    from metro_pose3d_tpu_torch.evaluation import eval_3dpw, eval_h36m
    from metro_pose3d_tpu_torch.evaluation.predict import (
        predict_multiperson_dataset, save_predictions,
    )
    from metro_pose3d_tpu_torch.export import load_exported
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.models.metro import MetroModel
    from metro_pose3d_tpu_torch.models.quantize import calibrate
    from metro_pose3d_tpu_torch.multiperson import MultiPersonEstimator
    from metro_pose3d_tpu_torch.ops import bn, int8, occlusion, pool, warp
    from metro_pose3d_tpu_torch.ops.color import normalize
    from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
    from metro_pose3d_tpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    frame_form = ("normalize_div", torch.bfloat16)
    legs = []

    def reset():
        pool.reset_launches()
        warp.reset_launches()
        int8.reset_launches()
        bn.reset_launches()
        occlusion.LAUNCHES = 0

    def counts(keep=True):
        c = {"pool": pool.MODE_LAUNCHES["same"], "pool_bwd": pool.MODE_BWD_LAUNCHES["same"],
             "warp": warp.LAUNCHES, "warp_forms": dict(warp.KERNEL_LAUNCHES),
             "occluder": occlusion.LAUNCHES, "qk1": int8.launches("int8_conv"),
             "qk2": int8.launches("int8_elementwise"), "bn": bn.LAUNCHES}
        if keep:
            legs.append(c)
        return c

    t0 = time.perf_counter()
    frames = list(make_multiperson_sequence(MP_PERSONS, MP_FRAMES, seed=SEED,
                                            imshape=MP_IMSHAPE))
    requests = [(img, boxes, cam) for img, boxes, cam, _ in frames]
    render_s = time.perf_counter() - t0
    cfg = Config()
    model = init_metro_model(cfg.model, SEED + 20, dev)
    est = MultiPersonEstimator(cfg, model, H36M_17)
    reset()
    t0 = time.perf_counter()
    built = est.warmup(8, MP_IMSHAPE)
    warm_s = time.perf_counter() - t0
    counts()
    if built != 4:
        fail(f"warmup(8) ran {built} buckets, want 4 (1, 2, 4, 8)")
    print(f"[20 multi] {MP_FRAMES} synthetic {MP_IMSHAPE[1]}x{MP_IMSHAPE[0]} frames of "
          f"{MP_PERSONS} people rendered in {render_s:.2f} s; warmup(8) ran buckets 1, 2, 4, 8 "
          f"in {warm_s:.2f} s")

    def serve(what, run, e=est, n=MP_FRAMES):
        """Time run(e) over n frames; also the host seconds spent in
        `_dispatch` and `_collect`, and the pinned host allocations made."""
        spent = {"_dispatch": 0.0, "_collect": 0.0}

        def timed(name):
            method = getattr(e, name)

            def call(*args):
                t0 = time.perf_counter()
                try:
                    return method(*args)
                finally:
                    spent[name] += time.perf_counter() - t0
            return call

        for name in spent:
            setattr(e, name, timed(name))
        host_stats = getattr(torch.cuda, "host_memory_stats", dict)
        allocs = host_stats().get("num_host_alloc", -1)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            outs = run(e)
        finally:
            sec = time.perf_counter() - t0
            for name in spent:
                delattr(e, name)  # the class's methods again
        c = counts()
        persons = sum(len(o["pose3d_abs"]) for o in outs)
        print(f"[20 multi] {what}: {n / sec:.2f} frames/s, {persons / sec:.1f} persons/s "
              f"({sec:.3f} s for {n} frames; a frame {1e3 * spent['_dispatch'] / n:.2f} ms in "
              f"_dispatch, {1e3 * spent['_collect'] / n:.2f} ms in _collect; pinned host "
              f"allocations {host_stats().get('num_host_alloc', -1) - allocs})  [{card}]")
        return outs, n / sec, c

    runs = {"estimate_stream(depth=2)": lambda e: list(e.estimate_stream(iter(requests),
                                                                         depth=2)),
            "estimate_frame loop": lambda e: [e.estimate_frame(*r) for r in requests]}
    outs, fps = {}, {what: [] for what in runs}
    for rep in range(MP_PASSES):  # in turns: the host clock drifts from pass to pass
        for what, run in runs.items():
            o, rate, c = serve(f"{what}, pass {rep + 1}", run)
            outs.setdefault(what, o)
            fps[what].append(rate)
            forms = {f: n for f, n in c["warp_forms"].items() if n}
            if forms != {frame_form: MP_FRAMES} or c["pool"] != MP_FRAMES \
                    or c["bn"] != 49 * MP_FRAMES:
                fail(f"multi-person {what}: K1 launches by form {forms}, K3 {c['pool']}, batch "
                     f"norm {c['bn']}; want {MP_FRAMES} of {frame_form}, {MP_FRAMES} of K3 (one "
                     f"a frame at bucket {MP_BUCKET}) and 49 batch norms a frame")
            bn_frame = c["bn"] / MP_FRAMES
    stream, loop = outs.values()
    check_pool_variants("multi-person serving")
    worst, same = {}, True
    for a, b in zip(stream, loop):
        for key in a:
            if a[key].shape != (MP_PERSONS, 17, 2 if key == "pose2d_px" else 3) \
                    or not np.isfinite(a[key]).all():
                fail(f"multi-person {key}: shape {a[key].shape} or not finite")
            same &= np.array_equal(a[key], b[key])
            worst[key] = max(worst.get(key, 0.0), float(np.abs(a[key] - b[key]).max()))
    if max(worst.values()) > MP_EQUAL_TOL:
        fail(f"estimate_stream against the estimate_frame loop: {worst} > {MP_EQUAL_TOL}")
    # where a frame's device time goes (informative)
    print(profile_breakdown(lambda: est.estimate_frame(*requests[0]), steps=8,
                            label="[20 multi] profiler, estimate_frame of 6 people"))
    side = cfg.model.proc_side
    x = torch.zeros((2 * MP_BUCKET, side, side, 3), dtype=model.dtype, device=dev)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model(x)
        launched = (time.perf_counter() - t0) / 10
        torch.cuda.synchronize()
        drained = (time.perf_counter() - t0) / 10
    print(f"[20 multi] the backbone and heads alone at B={2 * MP_BUCKET}: {1e3 * launched:.2f} "
          f"host ms a call to launch, {1e3 * drained:.2f} ms a call with the drain  [{card}]")
    med = {what: float(np.median(r)) for what, r in fps.items()}
    gain = ", ".join(f"{a / b:.2f}" for a, b in zip(*fps.values()))
    print(f"[20 multi] median of {MP_PASSES} passes: stream {med['estimate_stream(depth=2)']:.2f}, "
          f"loop {med['estimate_frame loop']:.2f} frames/s; the stream over the loop by pass: "
          f"{gain}x; outputs "
          + ("equal bit for bit" if same else f"differ by {worst}")
          + f"; launches a pass: K1 {frame_form[0]} bf16 {c['warp']}, K3 {c['pool']}, batch "
          f"norm {c['bn']} (bucket {MP_BUCKET}, {2 * MP_BUCKET} crops with TTA)")

    # float32 on the card (TF32 off) against the CPU, one frame of 3 people;
    # then frame mode against tile mode with tiles that cover the ROI
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = apply_overrides(Config(), {"model.compute_dtype": "float32"})
    cpu32 = MetroModel(cfg32.model).eval()
    cpu32.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gpu32 = copy.deepcopy(cpu32).to(dev)
    img, boxes, cam, _ = make_multiperson_frame(3, seed=SEED + 20, imshape=MP_IMSHAPE)
    got, want = (MultiPersonEstimator(cfg32, m, H36M_17, buckets=(4,)).estimate_frame(
        img, boxes, cam) for m in (gpu32, cpu32))
    zoom = crop_zoom(boxes, cam, cfg32)
    diffs = {}
    for key, tol in PARITY_TOL.items():
        d = np.abs(got[key] - want[key])
        if key == "pose2d_px":  # frame pixels: the crop-pixel bound times each crop's zoom
            tol = tol * zoom[:, None, None]
        diffs[key] = float(d.max())
        if not np.all(d <= tol):
            fail(f"multi-person float32 card vs CPU {key}: {diffs[key]} > {np.max(tol)}")
    cfg_tiles = apply_overrides(cfg32, {"data.source_side": str(MP_IMSHAPE[1])})
    tiles = MultiPersonEstimator(cfg_tiles, gpu32, H36M_17, buckets=(4,),
                                 frame_mode=False).estimate_frame(img, boxes, cam)
    ft = {k: float(np.abs(tiles[k] - got[k]).max()) for k in FRAME_TILE_TOL}
    if any(ft[k] > tol for k, tol in FRAME_TILE_TOL.items()):
        fail(f"multi-person frame mode against tile mode: {ft} (tol {FRAME_TILE_TOL})")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    print(f"[20 multi] float32 card vs CPU, one frame of 3 people, TF32 off: max abs diff "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
          + f" (tol {PARITY_TOL}, pose2d_px times the crops' zoom {np.round(zoom, 2).tolist()}); "
          f"frame mode against tile mode ({MP_IMSHAPE[1]}^2 tiles): "
          + ", ".join(f"{k} {v:.2e}" for k, v in ft.items()) + f" (tol {FRAME_TILE_TOL})")
    del cpu32, gpu32

    # int8: the same weights, calibrated as phase 17 calibrates, 8 frames
    cfg8 = apply_overrides(Config(), {"model.quantize": "int8"})
    model8 = MetroModel(cfg8.model)
    missing, unexpected = model8.load_state_dict(
        {k: v.cpu() for k, v in model.state_dict().items()}, strict=False)
    if unexpected or not all(k.endswith(".amax") for k in missing):
        fail(f"int8 model from the fp weights: missing {missing[:3]}, unexpected {unexpected}")
    model8 = model8.to(dev).eval()
    calibrate(model8, [normalize(torch.from_numpy(
        rng.randint(0, 256, (BATCH, side, side, 3)).astype(np.uint8)).to(dev).float() / 255.0)
        for _ in range(3)])
    est8 = MultiPersonEstimator(cfg8, model8, H36M_17)
    est8.warmup(8, MP_IMSHAPE)
    n8 = 8
    out8, fps8, c8 = serve("int8 estimate_stream(depth=2)",
                           lambda e: list(e.estimate_stream(iter(requests[:n8]), depth=2)),
                           e=est8, n=n8)
    if (c8["qk1"], c8["qk2"], c8["warp_forms"][frame_form], c8["pool"], c8["bn"]) != (
            52 * n8, 20 * n8, n8, n8, 17 * n8):
        fail(f"int8 multi-person over {n8} frames: launches {c8}")
    apart = {k: float(np.mean([np.abs(a[k] - b[k]).mean() for a, b in zip(out8, loop)]))
             for k in out8[0]}
    print(f"[20 multi] int8 over {n8} frames: launches QK1 {c8['qk1']}, QK2 {c8['qk2']}, batch "
          f"norm {c8['bn']} (52, 20 and 17 a forward), K1 {c8['warp']}, K3 {c8['pool']}; mean "
          f"abs diff from bf16 "
          + ", ".join(f"{k} {v:.2f}" for k, v in apart.items()))
    del model8, est8

    tmp = tempfile.mkdtemp(prefix="chip_smoke_multiperson_")
    try:
        # the dataset path: predict_multiperson_dataset -> the eval_3dpw dump
        n_ds = 16
        reset()
        t0 = time.perf_counter()
        result = predict_multiperson_dataset(cfg, model, FrameSequence(frames[:n_ds]))
        ds_s = time.perf_counter() - t0
        c = counts()
        scores = eval_3dpw.evaluate_3dpw(save_predictions(result, os.path.join(tmp, "mp.npz")))
        if len(result["pose3d"]) != n_ds * MP_PERSONS or not np.isfinite(
                result["pose3d_abs"]).all() or c["warp_forms"][frame_form] != n_ds:
            fail(f"predict_multiperson_dataset: {len(result['pose3d'])} rows, launches {c}")
        print(f"[20 multi] predict_multiperson_dataset over {n_ds} frames -> eval_3dpw: "
              f"{scores['n_instances']} instances, MPJPE {scores['mpjpe']:.2f}, PA-MPJPE "
              f"{scores['pa_mpjpe']:.2f}, absolute {scores['abs_mpjpe']:.2f} mm (random weights) "
              f"in {ds_s:.2f} s")

        # the command line at full width: train with in-loop validation, test
        # on the trained checkpoint, score, export and load the bundle
        logdir = os.path.join(tmp, "cli")
        common = ["--data.dataset=synthetic", "--data.synthetic_n_test=64",
                  f"--train.logdir={logdir}"]
        train_args = ["--train", *common, f"--train.num_steps={MP_CLI_STEPS}",
                      f"--train.validate_every={MP_CLI_VALIDATE}", "--train.validate_batches=1",
                      f"--train.log_every={MP_CLI_VALIDATE}",
                      f"--train.checkpoint_every={MP_CLI_VALIDATE}"]
        reset()
        t0 = time.perf_counter()
        if cli.main(train_args) != 0:
            fail("main --train returned non-zero")
        train_s = time.perf_counter() - t0
        counts()
        with open(os.path.join(logdir, "history.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        vals = [r for r in rows if "val_mpjpe" in r]
        if [r["step"] for r in vals] != [MP_CLI_VALIDATE, MP_CLI_STEPS] or not all(
                np.isfinite(r["val_mpjpe"]) for r in vals):
            fail(f"main --train: validation rows {vals}")
        ckpt = Checkpointer(logdir)
        _, best_step = ckpt.restore_best(create_train_state(parse_cli(train_args)[0], dev))
        low = min(vals, key=lambda r: r["val_mpjpe"])
        if (best_step, ckpt.best_metric()) != (low["step"], low["val_mpjpe"]):
            fail(f"best checkpoint {best_step} ({ckpt.best_metric()}) is not the validation "
                 f"minimum {low}")
        pred = os.path.join(tmp, "cli_pred.npz")
        reset()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):  # the scorer's JSON table
            rcs = (cli.main(["--test", *common, f"--eval.pred_path={pred}"]),
                   cli.main(["--eval-h36m", f"--eval.pred_path={pred}"]))
        test_s = time.perf_counter() - t0
        c = counts()
        text = printed.getvalue()
        h36m = json.loads(text[text.index("{"):])
        if rcs != (0, 0) or h36m != json.loads(json.dumps(eval_h36m.evaluate(pred))):
            fail(f"main --test / --eval-h36m: rcs {rcs}, printed {text[:300]}")
        if c["warp_forms"][("normalize", torch.bfloat16)] != 1 or not np.isfinite(h36m["mpjpe"]):
            fail(f"main --test: launches {c}, MPJPE {h36m['mpjpe']}")
        bundle = os.path.join(tmp, "bundle")
        if cli.main([f"--export={bundle}", *common]) != 0:
            fail("main --export returned non-zero")
        cfg_b, model_b, fn = load_exported(bundle, device=dev)
        want_sd = cli._load_model(parse_cli(common)[0], None, dev).state_dict()
        if cfg_b != parse_cli(common)[0] or any(
                not torch.equal(v, want_sd[k]) for k, v in model_b.state_dict().items()):
            fail("the exported bundle does not hold the checkpoint's config and weights")
        crops = torch.from_numpy(rng.randint(0, 256, (8, side, side, 3)).astype(np.uint8))
        intr = torch.from_numpy(crop_params(rng, 8, TILE, side, "normal")[3])
        out = fn(model_b, crops.to(dev), intr.to(dev))
        if tuple(out["pose3d_abs"].shape) != (8, 17, 3) or not bool(
                torch.isfinite(out["pose3d_abs"]).all()):
            fail("the exported bundle's predict fn gave no finite poses")
        print(f"[20 multi] main --train (Config(), synthetic, {MP_CLI_STEPS} steps, "
              f"validate_every {MP_CLI_VALIDATE}) in {train_s:.1f} s: val_mpjpe "
              + ", ".join(f"step {r['step']} {r['val_mpjpe']:.2f}" for r in vals)
              + f" mm, best checkpoint step {best_step} read back; main --test on it + "
              f"--eval-h36m in {test_s:.1f} s: MPJPE {h36m['mpjpe']:.2f} mm over 64; --export "
              f"+ load_exported: the checkpoint's weights bit for bit, one batch of 8 predicted")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[20 multi] phase time {time.perf_counter() - t_phase:.1f} s")
    total = {k: sum(leg[k] for leg in legs) for k in ("pool", "pool_bwd", "warp", "occluder",
                                                       "qk1", "qk2", "bn")}
    total["warp_forms"] = {f: sum(leg["warp_forms"][f] for leg in legs) for f in warp.FORMS}
    total["bn_forward"] = {"multiperson_bf16": bn_frame,
                           "multiperson_int8": c8["bn"] / n8}
    return total


# --- phase 21: data-parallel training over ranks --------------------------------
DP_WORLD = 2
DP_STEPS, DP_CUT = 5, 3  # the run's steps; its checkpoint and resume point
DP_TIMEOUT = 300  # seconds: a rank spawn, and the process group's collectives
DP_TIMED_STEPS = 3
DP_PARITY_ROWS = (6, 2)  # the float32 step's global 3D and 2D rows
DP_GHOST_PARITY = 8  # the float32 ghost step's group: all 8 global rows, 4 on each rank
DP_GHOST_GROUP = 32  # the timed ghost step's group: rows 32-63 of 96 straddle the 2 ranks
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def rank_rows(batch: dict, n3: int, n2: int, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of a global `train_batch` of n3 3D + n2 2D rows:
    its share of each, 3D first, as `trainer.mixed_batch_iterator` lays out
    a rank's batch. The ranks' batches in rank order make the global batch
    that `merged_rows` gives."""
    p3, p2 = n3 // world, n2 // world
    idx = np.r_[rank * p3:(rank + 1) * p3, n3 + rank * p2:n3 + (rank + 1) * p2]
    return {k: v[idx] for k, v in batch.items()}


def merged_rows(batch: dict, n3: int, n2: int, world: int) -> dict:
    parts = [rank_rows(batch, n3, n2, r, world) for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts]) for k in batch}


@contextlib.contextmanager
def timed_collectives(acc: dict):
    """Count the host seconds of every all_reduce, broadcast and barrier of
    `torch.distributed` into acc["s"] (the calls into acc["n"], and the
    seconds of those over a million elements, the flat gradient's, into
    acc["big_s"]), each between two device synchronizations, so that a
    collective's time holds no wait for the kernels queued before it."""
    import torch.distributed as dist

    saved = {name: getattr(dist, name) for name in ("all_reduce", "broadcast", "barrier")}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            acc["s"] += dt
            acc["n"] += 1
            if args and torch.is_tensor(args[0]) and args[0].numel() > 1_000_000:
                acc["big_s"] += dt
            return out
        return call

    for name, fn in saved.items():
        setattr(dist, name, timed(fn))
    try:
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def dp_step_times(step, state, batch) -> dict:
    """ms a step (CUDA events over back-to-back steps), then the share of a
    step's wall time spent in collectives, over DP_TIMED_STEPS steps that
    synchronize around each collective (informative)."""
    from metro_pose3d_tpu_torch.probes import time_ms

    ms = time_ms(lambda: step(state, batch), iters=DP_TIMED_STEPS, warmup=1)
    acc = {"s": 0.0, "n": 0, "big_s": 0.0}
    with timed_collectives(acc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"ms": ms, "sync_ms": 1e3 * wall / DP_TIMED_STEPS,
            "collective_ms": 1e3 * acc["s"] / DP_TIMED_STEPS,
            "gradient_ms": 1e3 * acc["big_s"] / DP_TIMED_STEPS,
            "collectives": acc["n"] // DP_TIMED_STEPS, "collective_share": acc["s"] / wall}


def state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256(str(state.step).encode())
    for k, v in state.model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_parity_step(dev, rank=0, world=1, group_size=0) -> tuple:
    """One float32 step (TF32 off) of R50@128 from seed SEED + 3 on this
    rank's rows of the global parity batch -> (metrics, state on the CPU).
    With world 1, on the whole global batch in the ranks' order. A
    `group_size` makes batch norm ghost BN over groups of that many global
    rows."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state

    n3, n2 = DP_PARITY_ROWS
    pcfg = apply_overrides(Config(), {"model.compute_dtype": "float32", "model.proc_side": "128",
                                      "train.warmup_steps": "0",
                                      "model.bn_group_size": str(group_size)})
    gb = train_batch(np.random.RandomState(SEED + 22), n3, n2, TILE, 128, 64)
    rows = (merged_rows(gb, n3, n2, DP_WORLD) if world == 1
            else rank_rows(gb, n3, n2, rank, world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        st = create_train_state(pcfg, dev, seed=SEED + 3)
        step = make_train_step(pcfg, 0, occluder_bank=pack_occluder_bank_for(
            make_procedural_occluders(64, 96), dev))
        m = step(st, batch_to_device(rows, dev))
        metrics = {k: float(v) for k, v in m.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    return metrics, {k: v.detach().cpu() for k, v in st.model.state_dict().items()}


def dp_rank(backend: str, rank: int, world: int, tmp: str) -> int:
    """One rank of phase 21, in a process of its own (`chip_smoke.py
    --dp-rank BACKEND RANK WORLD DIR`): joins the group through a file in
    DIR, trains its rows of the default Config()'s global batches (64 3D +
    32 2D rows, 512^2 tiles) through the batch-fed loop, device-resident:
    DP_CUT steps with a checkpoint, then a resume to DP_STEPS; then its
    step's times and, with Gloo, its share of the float32 parity step.
    Writes DIR/rank<r>.json."""
    import torch.distributed as dist

    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.kernels import build
    from metro_pose3d_tpu_torch.ops import occlusion, pool, warp
    from metro_pose3d_tpu_torch.parallel.distributed import initialize_distributed
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state
    from metro_pose3d_tpu_torch.train.trainer import _train_on_batches

    # two Gloo ranks share the one card; NCCL takes a card a rank
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    initialize_distributed(rank, world, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                           backend=backend, timeout=DP_TIMEOUT, device=dev)
    try:
        build.load()
        bank_np = make_procedural_occluders(64, 96)
        host = [rank_rows(train_batch(np.random.RandomState(SEED + 21 + k), N3D, N2D, TILE, 256,
                                      len(bank_np)), N3D, N2D, rank, world) for k in range(2)]
        cfg = apply_overrides(Config(), {
            "train.checkpoint_every": str(DP_CUT), "train.log_every": "1",
            "train.validate_every": "0", "data.cycle_batches": "2",
            "train.logdir": os.path.join(tmp, "run")})
        pool.reset_launches()
        warp.reset_launches()
        occlusion.LAUNCHES = 0
        t0 = time.perf_counter()
        _train_on_batches(cfg, iter(host), occluder_bank=bank_np, max_steps=DP_CUT, device=dev)
        state = _train_on_batches(cfg, iter(host), occluder_bank=bank_np, max_steps=DP_STEPS,
                                  device=dev)
        torch.cuda.synchronize()
        legs_s = time.perf_counter() - t0
        out = {"step": state.step, "legs_s": legs_s, "digest": state_digest(state),
               "launches": {"pool": pool.MODE_LAUNCHES["same"],
                            "pool_bwd": pool.MODE_BWD_LAUNCHES["same"],
                            "warp": warp.LAUNCHES, "occluder": occlusion.LAUNCHES},
               "pool_variants": {w: dict(c) for w, c in pool.VARIANT_LAUNCHES.items()},
               "warp_forms": {f"{e}_{str(d)[6:]}": n for (e, d), n in warp.KERNEL_LAUNCHES.items()}}
        check_pool_variants(f"[21 dp] rank {rank}", ("fwd", "bwd"))
        check_warp_forms_launched(f"[21 dp] rank {rank}", ("unit", torch.float32))
        step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(bank_np, dev))
        out["times"] = dp_step_times(step, state, batch_to_device(host[0], dev))
        if backend == "gloo":
            # ghost BN whose group 1 (global rows 32-63) straddles the ranks
            gcfg = apply_overrides(cfg, {"model.bn_group_size": str(DP_GHOST_GROUP)})
            gstep = make_train_step(gcfg, 0, occluder_bank=pack_occluder_bank_for(bank_np, dev))
            gstate = create_train_state(gcfg, dev, seed=SEED)
            out["ghost_times"] = dp_step_times(gstep, gstate, batch_to_device(host[0], dev))
            del gstate, gstep
        del state, step
        torch.cuda.empty_cache()
        if backend == "gloo":
            for name, gs in (("parity", 0), ("ghost_parity", DP_GHOST_PARITY)):
                metrics, sd = dp_parity_step(dev, rank, world, gs)
                out[f"{name}_metrics"] = metrics
                if rank == 0:
                    torch.save(sd, os.path.join(tmp, f"{name}_rank0.pt"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(backend: str, world: int, tmp: str) -> list:
    """Run `world` ranks of `dp_rank` -> their outputs. Every rank is killed
    and reaped when one fails or the spawn outlasts DP_TIMEOUT; then the
    phase fails with the ranks' last lines."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank", backend, str(r),
                 str(world), tmp], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n" + f.read()[-3000:])
        fail(f"[21 dp] {backend} ranks failed:\n" + "\n".join(tails))
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def fmt_times(t: dict) -> str:
    return (f"{t['ms']:.1f} ms a step; synchronized around its {t['collectives']} collectives "
            f"{t['sync_ms']:.1f} ms, of which collectives {t['collective_ms']:.1f} ms "
            f"({t['collective_share']:.0%}; the flat gradient's {t['gradient_ms']:.1f} ms)")


def phase_dp(dev, card, resident_step_ms) -> dict:
    """21: data-parallel training. Two ranks with Gloo on the one card; the
    float32 parity step against one process; NCCL as a group of one in this
    process (and two ranks where the machine has two cards). -> the ranks'
    summed launches."""
    import torch.distributed as dist

    from metro_pose3d_tpu_torch.config import Config
    from metro_pose3d_tpu_torch.parallel import mesh
    from metro_pose3d_tpu_torch.parallel.distributed import initialize_distributed
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        os.makedirs(os.path.join(tmp, "gloo"))
        t0 = time.perf_counter()
        outs = spawn_ranks("gloo", DP_WORLD, os.path.join(tmp, "gloo"))
        spawn_s = time.perf_counter() - t0
        for r, out in enumerate(outs):
            if out["step"] != DP_STEPS or any(n != DP_STEPS for n in out["launches"].values()):
                fail(f"[21 dp] rank {r}: step {out['step']}, launches {out['launches']} (want "
                     f"one of each kernel a step, {DP_STEPS} steps)")
        if len({out["digest"] for out in outs}) != 1:
            fail(f"[21 dp] the ranks' states differ: {[out['digest'][:16] for out in outs]}")
        with open(os.path.join(tmp, "gloo", "run", "history.json")) as f:
            hist = json.load(f)
        if [h["step"] for h in hist] != list(range(1, DP_STEPS + 1)) or not all(
                np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist):
            fail(f"[21 dp] rank 0's history is not steps 1..{DP_STEPS} with finite losses: {hist}")
        print(f"[21 dp] {DP_WORLD} ranks, Gloo, on one card: Config() R50@256 bf16, global "
              f"{N3D} 3D + {N2D} 2D rows (each rank {N3D // DP_WORLD} + {N2D // DP_WORLD}) of "
              f"{TILE}^2 tiles, device-resident: {DP_CUT} steps with a checkpoint, resumed "
              f"{DP_CUT} -> {DP_STEPS}, in {spawn_s:.1f} s with the ranks' start; losses "
              + ", ".join(f"{h['loss']:.4f}" for h in hist)
              + f"; the ranks' states equal (sha256 {outs[0]['digest'][:16]}); launches a rank "
              f"{outs[0]['launches']}, pool variants {outs[0]['pool_variants']}, warp forms "
              f"{outs[0]['warp_forms']}")
        for r, out in enumerate(outs):
            print(f"[21 dp] rank {r} of {DP_WORLD} (Gloo, one card shared), informative: "
                  f"{fmt_times(out['times'])}; one process's step (phase 12) "
                  f"{resident_step_ms:.1f} ms  [{card}]")

        for r, out in enumerate(outs):
            print(f"[21 dp] rank {r}, ghost BN in groups of {DP_GHOST_GROUP} global rows (rows "
                  f"32-63 on both ranks), informative: {fmt_times(out['ghost_times'])}  [{card}]")

        # the float32 step of the 2 ranks against one process, same global
        # batch: plain batch norm, then ghost BN in one group of both ranks' rows
        n3, n2 = DP_PARITY_ROWS
        lr = Config().train.base_lr
        for name, gs in (("parity", 0), ("ghost_parity", DP_GHOST_PARITY)):
            what = "" if not gs else f", ghost BN in groups of {gs} rows spanning both ranks"
            one_want, one_sd = dp_parity_step(dev, group_size=gs)
            if not gs:
                want = one_want
            got = outs[0][f"{name}_metrics"]
            for r, out in enumerate(outs[1:], 1):
                if out[f"{name}_metrics"] != got:
                    fail(f"[21 dp] rank {r}'s {name} metrics differ from rank 0's")
            for k, tol in TRAIN_PARITY_RTOL.items():
                if not abs(got[k] - one_want[k]) <= tol * abs(one_want[k]):
                    fail(f"[21 dp] float32 step{what}, 2 ranks vs one process, {k}: {got[k]} vs "
                         f"{one_want[k]} (rtol {tol})")
            got_sd = torch.load(os.path.join(tmp, "gloo", f"{name}_rank0.pt"), weights_only=True)
            stats = [k for k in one_sd if k.endswith((".mean", ".var"))]
            stat_err = max(float((got_sd[k] - one_sd[k]).abs().max()) for k in stats)
            diff = torch.cat([(got_sd[k] - one_sd[k]).abs().flatten() for k in one_sd
                              if k not in stats])
            near = float((diff <= 0.1 * lr).float().mean())
            if not (stat_err <= STATS_ATOL and float(diff.max()) <= 2 * lr + 1e-6
                    and near > 0.99):
                fail(f"[21 dp] float32 step{what}, 2 ranks vs one process: BN stats "
                     f"{stat_err:.2e} (tol {STATS_ATOL}), params max {float(diff.max()):.2e} "
                     f"(tol 2 lr), share within lr/10 {near:.4f} (want > 0.99)")
            print(f"[21 dp] one float32 step (TF32 off) R50@128, global {n3} + {n2} rows{what}, "
                  f"2 Gloo ranks vs one process on the card: rel diff "
                  + ", ".join(f"{k} {abs(got[k] - one_want[k]) / abs(one_want[k]):.1e}"
                              for k in TRAIN_PARITY_RTOL)
                  + f" (rtol {TRAIN_PARITY_RTOL}); BN stats {stat_err:.1e} (atol {STATS_ATOL}); "
                  f"params max {float(diff.max()):.1e} (<= 2 lr), share within lr/10 {near:.5f}")

        # NCCL as a group of one, in this process
        initialize_distributed(0, 1, init_method=f"file://{os.path.join(tmp, 'nccl_rdv')}",
                               backend="nccl", timeout=DP_TIMEOUT, device=dev)
        try:
            if dist.get_backend() != "nccl" or not mesh.in_group():
                fail(f"[21 dp] no NCCL group: backend {dist.get_backend()}")
            one, _ = dp_parity_step(dev)
            for k, tol in TRAIN_PARITY_RTOL.items():
                if not abs(one[k] - want[k]) <= tol * abs(want[k]):
                    fail(f"[21 dp] float32 step, NCCL group of one vs no group, {k}: {one[k]} vs "
                         f"{want[k]} (rtol {tol})")
            cfg = Config()
            st = create_train_state(cfg, dev, seed=SEED)
            step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(
                make_procedural_occluders(64, 96), dev))
            tb = batch_to_device(train_batch(np.random.RandomState(SEED + 21), N3D, N2D, TILE, 256,
                                             64), dev)
            times = dp_step_times(step, st, tb)
            del st, step, tb
        finally:
            dist.destroy_process_group()
        print(f"[21 dp] NCCL group of one in this process: the float32 step within "
              f"TRAIN_PARITY_RTOL of the step without a group (rel diff "
              + ", ".join(f"{k} {abs(one[k] - want[k]) / abs(want[k]):.1e}"
                          for k in TRAIN_PARITY_RTOL)
              + f"); Config() bf16 B={N3D + N2D}, informative: {fmt_times(times)}; without a "
              f"group (phase 12) {resident_step_ms:.1f} ms  [{card}]")
        if torch.cuda.device_count() >= 2:
            os.makedirs(os.path.join(tmp, "nccl"))
            nccl = spawn_ranks("nccl", 2, os.path.join(tmp, "nccl"))
            if len({out["digest"] for out in nccl}) != 1:
                fail("[21 dp] the NCCL ranks' states differ")
            print(f"[21 dp] 2 ranks, NCCL, one card each: states equal; informative: "
                  f"{fmt_times(nccl[0]['times'])}  [{card}]")
        else:
            print(f"[21 dp] NCCL with 2 ranks not run: this machine has "
                  f"{torch.cuda.device_count()} card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[21 dp] phase time {time.perf_counter() - t_phase:.1f} s")
    total = {k: sum(out["launches"][k] for out in outs) for k in outs[0]["launches"]}
    total["warp_unit"] = sum(out["warp_forms"]["unit_float32"] for out in outs)
    return total


# --- phase 22: real files: JPEG through nvJPEG, the VOC and background banks ------

REAL_FILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                          "real_files")  # written by tests/fixtures/make_real_files.py
REAL_JPEGS = ("s444", "s422", "s420", "gray", "progressive", "restart", "odd_37x53",
              "frame_1000", "mask_1000")
# nvJPEG against the fixtures' libjpeg pixels, in levels of [0, 255]: the
# largest and the mean absolute difference. They catch swapped channels, a
# wrong chroma siting or a missed colour conversion; they do not pretend to
# know nvJPEG's IDCT and upsampling rounding
NVJPEG_CEILINGS = (16, 1.0)
# the banks that the loaders build from the fixtures' libjpeg pixels on this
# host: their tile counts (tests/test_torch_real_files.py fixes them on the
# CPU) and the sha256 of their bytes there (uint8 and float32 alike: the
# C resize is held to cv2 bit for bit on those branches)
REAL_BANKS = {"voc": (6, "5fa191ec9090d56f"), "backgrounds": (4, "ab9e58b791f8c928")}
REAL_FRAME_SEED = 0  # frame_1000 renders the synthetic example 0 of this seed
# frames of the H36M-layout JPEG shard: 1 batch to predict, and train rows
# for the bone lengths; the 3DHP-layout shard has a training batch of rows
REAL_TEST_N, REAL_TRAIN_N = 128, 16
REAL_TRAIN_STEPS = 3


@contextlib.contextmanager
def libjpeg_pixels(improc):
    """`improc.imread` gives each fixture JPEG's stored libjpeg pixels
    (`<stem>.rgb.png` beside it, or under `backgrounds_pixels/`); other
    files, and JPEGs without stored pixels, read as before."""
    real = improc.imread

    def imread(path):
        p = str(path)
        if p.lower().endswith(".jpg"):
            stem = os.path.splitext(os.path.basename(p))[0]
            for cand in (p[:-4] + ".rgb.png", os.path.join(
                    os.path.dirname(os.path.dirname(p)), "backgrounds_pixels", stem + ".rgb.png")):
                if os.path.exists(cand):
                    return real(cand)
        return real(path)

    improc.imread = imread
    try:
        yield
    finally:
        improc.imread = real


def write_real_shard(root: str, layout: str, ext: str, n_train: int) -> str:
    """An H36M- or 3DHP-layout shard (the `scripts/prepare_*.py` layouts)
    under `root` whose every frame is a copy of the committed 1000x1000
    frame: the JPEG (`ext` "jpg") or its libjpeg pixels as a PNG ("png"),
    each row with that frame's annotation (the synthetic example it renders,
    in a z-up world): `n_train` train rows and, for H36M, REAL_TEST_N test
    rows. 3DHP's train rows carry the committed JPEG foreground mask. A
    training shard needs a batch of train rows at least: the loader, as the
    reference's, drops a short last batch and so loops over a shorter epoch
    without end. -> the dataset root."""
    from metro_pose3d_tpu_torch.data.synthetic import make_example

    ex = make_example(0, seed=REAL_FRAME_SEED, imshape=SHARD_IMSHAPE)
    r_wc, center = SHARD_R_BASE, np.array([0.0, 0.0, 1000.0])
    world = ex.world_coords @ r_wc + center
    frame = os.path.join(REAL_FILES, "jpeg", "frame_1000." + ("jpg" if ext == "jpg" else "rgb.png"))
    base = os.path.join(root, layout)

    def copies(rel_dir, names):
        paths = [os.path.join(rel_dir, f"{n}.{ext}") for n in names]
        os.makedirs(os.path.join(base, rel_dir), exist_ok=True)
        for p in paths:
            shutil.copyfile(frame, os.path.join(base, p))
        return paths

    def camera_rows(n):
        return {"world_coords": np.repeat(world[None], n, 0).astype(np.float32),
                "intrinsics": np.repeat(ex.camera.K[None], n, 0).astype(np.float32),
                "rotations": np.repeat(r_wc[None], n, 0).astype(np.float32),
                "positions": np.repeat(center[None], n, 0).astype(np.float32)}

    half = REAL_TEST_N // 2
    if layout == "h36m":
        paths = copies(os.path.join("images", "S1", "Walking 1.54138969"),
                       [f"frame_{5 * k:06d}" for k in range(n_train)])
        for subj, seq in ((9, "Walking 1.58860488"), (11, "Greeting.60457274")):
            paths += copies(os.path.join("images", f"S{subj}", seq),
                            [f"frame_{64 * k:06d}" for k in range(half)])
        n = len(paths)
        np.savez_compressed(
            os.path.join(base, "annotations.npz"), image_paths=np.array(paths),
            subjects=np.array([1] * n_train + [9] * half + [11] * half, np.int32),
            frame_indices=np.array([5 * k for k in range(n_train)]
                                   + [64 * k for k in range(half)] * 2, np.int32),
            distortions=np.zeros((n, 5), np.float32), **camera_rows(n))
        return root
    mask = os.path.join("masks", "mask_1000.jpg")
    os.makedirs(os.path.join(base, "masks"), exist_ok=True)
    shutil.copyfile(os.path.join(REAL_FILES, "jpeg", "mask_1000.jpg"), os.path.join(base, mask))
    for split, rel_dir, n in (("train", os.path.join("frames", "S1", "Seq1", "cam0"), n_train),
                              ("test", os.path.join("mpi_inf_3dhp_test_set", "TS1",
                                                    "imageSequence"), 8)):
        paths = copies(rel_dir, [f"frame_{5 * k:06d}" for k in range(n)])
        extra = ({"mask_paths": np.array([mask] * n)} if split == "train" else
                 {"mask_paths": np.array([""] * n), "univ_scale": np.ones(n, np.float32),
                  "activities": np.ones(n, np.int32)})
        np.savez_compressed(os.path.join(base, f"annotations_{split}.npz"),
                            image_paths=np.array(paths), valid=np.ones(n, bool),
                            **camera_rows(n), **extra)
    return root


def bank_digest(bank: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(bank).tobytes()).hexdigest()[:16]


def phase_real_files(dev, card) -> dict:
    """22: real files on the card's machine, which has no libjpeg and no cv2:
    the JPEG backend (nvJPEG), its decode held to the fixtures' libjpeg
    pixels, its ms a frame and a decoding process's device memory; the VOC
    occluder and background banks from the fixture trees, each against the
    bank built from the stored libjpeg pixels; the --test path on a JPEG-framed
    H36M-layout shard against the same shard framed as PNGs of the libjpeg
    pixels; train() at Config() on a 3DHP-layout shard of JPEG frames and
    JPEG masks with `data.occluder_root` and `data.background_root` set to
    the fixture trees. -> the K1, K2, K3 and K3-bwd launches of its runs."""
    import ctypes

    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.data.datasets import get_dataset
    from metro_pose3d_tpu_torch.evaluation.predict import compute_mean_bones, predict_dataset
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.native import build as native
    from metro_pose3d_tpu_torch.ops import occlusion, pool, warp
    from metro_pose3d_tpu_torch.pipeline import backgrounds, occluders
    from metro_pose3d_tpu_torch.pipeline import device as pdevice
    from metro_pose3d_tpu_torch.train import trainer
    from metro_pose3d_tpu_torch.utils import improc

    t_phase = time.perf_counter()
    backend = improc.jpeg_backend()
    if backend != "nvjpeg":
        fail(f"the JPEG backend on the card's machine is {backend!r}, want 'nvjpeg'")
    lib = native.nvjpeg_library()
    version = [ctypes.c_int() for _ in range(3)]
    if lib.metro_nvjpeg_version(*map(ctypes.byref, version)):
        fail("nvjpegGetProperty failed")
    with open("/proc/self/maps") as f:
        loaded = sorted({line.split()[-1] for line in f if "libnvjpeg" in line})
    build_s = native.build_seconds.get("nvjpegdec", 0.0)  # before build() reads it again
    nvcc, include, libdir = native.nvjpeg_paths()
    print(f"[22 real] improc.jpeg_backend() = {backend}: {native.build('nvjpegdec')} (nvcc build "
          f"{build_s:.1f} s, {nvcc}, nvjpeg.h in {include}) on nvJPEG "
          f"{'.'.join(str(v.value) for v in version)}, loaded from {loaded}")

    # decode parity: every fixture, colour and gray, against libjpeg's pixels
    worst = []
    for name in REAL_JPEGS:
        path = os.path.join(REAL_FILES, "jpeg", f"{name}.jpg")
        for gray in (False, True):
            got = improc.imread_gray(path) if gray else improc.imread(path)
            want = improc.imread(path[:-4] + (".gray.png" if gray else ".rgb.png"))
            want = want[..., 0] if gray else want
            if got.shape != want.shape:
                fail(f"nvJPEG {name} gray={gray}: shape {got.shape}, libjpeg's {want.shape}")
            d = np.abs(got.astype(np.int16) - want)
            st = (int(d.max()), float(d.mean()), float((d > 1).mean()))
            print(f"[22 real] nvJPEG vs libjpeg {name} {'gray' if gray else 'RGB'} "
                  f"{'x'.join(map(str, got.shape))}: max {st[0]}, mean {st[1]:.4f}, share > 1 "
                  f"level {st[2]:.5f}")
            if st[0] > NVJPEG_CEILINGS[0] or st[1] > NVJPEG_CEILINGS[1]:
                worst.append((name, gray, st))
    if worst:
        fail(f"nvJPEG above the ceilings {NVJPEG_CEILINGS} (max, mean levels): {worst}")
    with must_refuse(improc):
        improc.decode_jpeg_bytes(b"definitely not a jpeg")

    # the decode's time a frame (host clock: the host Huffman pass, the card's
    # IDCT and colour conversion, the copy back and the wait)
    with open(os.path.join(REAL_FILES, "jpeg", "frame_1000.jpg"), "rb") as f:
        data = f.read()
    for _ in range(3):
        improc.decode_jpeg_bytes(data)
    n = 40
    t0 = time.perf_counter()
    for _ in range(n):
        improc.decode_jpeg_bytes(data)
    single_ms = (time.perf_counter() - t0) / n * 1e3
    improc.decode_jpeg_batch([data] * 8, threads=4)
    t0 = time.perf_counter()
    improc.decode_jpeg_batch([data] * 64, threads=4)
    batch_ms = (time.perf_counter() - t0) / 64 * 1e3
    # a fresh process that decodes one frame: the device memory it holds
    # (its CUDA context and nvJPEG's buffers), as a loader worker process would
    torch.cuda.synchronize()
    smi = ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"]
    used0 = int(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.split()[0])
    code = ("import subprocess; from metro_pose3d_tpu_torch.utils import improc; "
            f"improc.imread({os.path.join(REAL_FILES, 'jpeg', 'frame_1000.jpg')!r}); "
            f"print(improc.jpeg_backend(), subprocess.run({smi!r}, capture_output=True, "
            "text=True, check=True).stdout.split()[0])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode or out.stdout.split()[:1] != ["nvjpeg"]:
        fail(f"a process decoding with nvJPEG: {out.returncode} {out.stdout} {out.stderr[-2000:]}")
    worker_mib = int(out.stdout.split()[1]) - used0
    print(f"[22 real] nvJPEG decode of the 1000x1000 4:2:0 frame to host RGB: {single_ms:.3f} ms "
          f"a frame one at a time, {batch_ms:.3f} ms a frame through decode_jpeg_batch on 4 "
          f"threads (64 frames); a process that has decoded one frame holds {worker_mib} MiB of "
          f"device memory (nvidia-smi memory.used)  [{card}]")

    # the banks: through nvJPEG, and from the stored libjpeg pixels
    voc_dir, bg_dir = REAL_FILES, os.path.join(REAL_FILES, "backgrounds")
    t0 = time.perf_counter()
    banks = {"voc": occluders.load_voc_occluders(voc_dir),
             "backgrounds": backgrounds.load_backgrounds_from_dir(bg_dir)}
    banks_s = time.perf_counter() - t0
    with libjpeg_pixels(improc):
        refs = {"voc": occluders.load_voc_occluders(voc_dir),
                "backgrounds": backgrounds.load_backgrounds_from_dir(bg_dir)}
    for what, (count, digest) in REAL_BANKS.items():
        got, ref = banks[what], refs[what]
        if len(got) != count or len(ref) != count or bank_digest(ref) != digest:
            fail(f"{what} bank: {len(got)} tiles through nvJPEG, {len(ref)} from libjpeg's pixels "
                 f"(digest {bank_digest(ref)}), want {count} and {digest}")
        scale = 255.0 if got.dtype == np.float32 else 1.0
        d = np.abs(got.astype(np.float64) - ref) * scale
        print(f"[22 real] {what} bank {got.shape} {got.dtype}: through nvJPEG against the bank "
              f"from libjpeg's pixels (equal to the CPU's, sha256 {digest}): max "
              f"{d.max():.4f}, mean {d.mean():.5f} levels of 255")
    print(f"[22 real] both banks through nvJPEG in {banks_s:.2f} s")

    launches = {"pool": 0, "pool_bwd": 0, "warp": 0, "occluder": 0}
    forms = {}

    def add_launches():
        for k, v in (("pool", pool.MODE_LAUNCHES["same"]),
                     ("pool_bwd", pool.MODE_BWD_LAUNCHES["same"]), ("warp", warp.LAUNCHES),
                     ("occluder", occlusion.LAUNCHES)):
            launches[k] += v
        for k, v in warp.KERNEL_LAUNCHES.items():
            forms[k] = forms.get(k, 0) + v

    def reset():
        pool.reset_launches()
        warp.reset_launches()
        occlusion.LAUNCHES = 0

    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        # the --test path on JPEG frames, and on PNGs of their libjpeg pixels
        cfg = apply_overrides(Config(), DATASET_OVERRIDES)
        model = init_metro_model(cfg.model, SEED + 22, dev)
        preds, rates, shards = {}, {}, {}
        for ext in ("jpg", "png"):
            shards[ext] = get_dataset("h36m", write_real_shard(os.path.join(tmp, ext), "h36m",
                                                               ext, REAL_TRAIN_N))
        # the model's first batch (cuDNN's choices) outside the timed passes
        predict_dataset(cfg, model, shards["png"], n_examples=8)
        for ext, ds in shards.items():
            if (ds.n_train, ds.n_test) != (REAL_TRAIN_N, REAL_TEST_N):
                fail(f"h36m reader on the {ext} shard: {ds.n_train} train, {ds.n_test} test")
            mean_bones = compute_mean_bones(ds)
            improc.FRAME_CACHE.clear()
            reset()
            first, warm = {}, {}
            preds[ext] = predict_dataset(cfg, model, ds, mean_bones=mean_bones, stats=first)
            predict_dataset(cfg, model, ds, mean_bones=mean_bones, stats=warm)
            torch.cuda.synchronize()
            if (warp.KERNEL_LAUNCHES.get(("normalize", torch.bfloat16), 0), warp.LAUNCHES,
                    pool.MODE_LAUNCHES["same"]) != (2, 2, 2):
                fail(f"predict_dataset on the {ext} shard, 2 passes of 1 batch: launches K1 "
                     f"{dict(warp.KERNEL_LAUNCHES)}, K3 {pool.MODE_LAUNCHES['same']}")
            add_launches()
            for key in ("pose3d_rootrel", "pose3d_abs", "pose2d_px"):
                if not np.isfinite(preds[ext][key]).all():
                    fail(f"predict_dataset on the {ext} shard: {key} is not finite")
            rates[ext] = tuple(REAL_TEST_N / st["wall_s"] for st in (first, warm))
        delta = {k: float(np.abs(preds["jpg"][k] - preds["png"][k]).max())
                 for k in ("pose3d_rootrel", "pose3d_abs", "pose2d_px")}
        print(f"[22 real] predict_dataset(Config(), R50@256 bf16, TTA) on an H36M-layout shard of "
              f"{REAL_TEST_N} test frames, copies of frame_1000.jpg: {rates['jpg'][0]:.1f} "
              f"examples/s first pass (every frame decoded by nvJPEG), {rates['jpg'][1]:.1f} "
              f"cached; the same shard framed as PNGs of libjpeg's pixels {rates['png'][0]:.1f} "
              f"and {rates['png'][1]:.1f}; JPEG (nvJPEG) against PNG (libjpeg's pixels), max abs "
              f"diff: root-relative {delta['pose3d_rootrel']:.4f} mm, absolute "
              f"{delta['pose3d_abs']:.4f} mm, 2D {delta['pose2d_px']:.4f} px  [{card}]")
        del model
        torch.cuda.empty_cache()

        # train() on JPEG frames and masks, with the real occluder and background banks
        tcfg = apply_overrides(Config(), {
            "train.logdir": os.path.join(tmp, "train"), "data.occluder_root": voc_dir,
            "data.background_root": bg_dir, "train.checkpoint_every": "1000",
            "train.log_every": "1", "train.validate_every": "0"})
        ds = get_dataset("mpi_inf_3dhp", write_real_shard(os.path.join(tmp, "hp"), "3dhp", "jpg",
                                                          tcfg.train.batch_size))
        built, composites = {}, []
        real_occ, real_bg = trainer.get_occluder_bank, trainer.get_background_bank
        composite = pdevice.composite_background

        def occ_bank(*a, **k):
            built["occluders"] = real_occ(*a, **k)
            return built["occluders"]

        def bg_bank(*a, **k):
            built["backgrounds"] = real_bg(*a, **k)
            return built["backgrounds"]

        def counted_composite(src, mask, bank, params):
            composites.append(tuple(bank.shape))
            return composite(src, mask, bank, params)

        trainer.get_occluder_bank, trainer.get_background_bank = occ_bank, bg_bank
        pdevice.composite_background = counted_composite
        reset()
        try:
            t0 = time.perf_counter()
            state = trainer.train(tcfg, ds, max_steps=REAL_TRAIN_STEPS, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            trainer.get_occluder_bank, trainer.get_background_bank = real_occ, real_bg
            pdevice.composite_background = composite
        step_launches = {"pool": pool.MODE_LAUNCHES["same"],
                         "pool_bwd": pool.MODE_BWD_LAUNCHES["same"],
                         "warp_unit": warp.KERNEL_LAUNCHES.get(("unit", torch.float32), 0),
                         "occluder": occlusion.LAUNCHES}
        add_launches()
        with open(os.path.join(tcfg.train.logdir, "history.json")) as f:
            hist = json.load(f)
        occ_shape = tuple(built["occluders"].shape)
        bg_shape = tuple(built["backgrounds"].shape)
        if (state.step != REAL_TRAIN_STEPS or occ_shape[0] != REAL_BANKS["voc"][0]
                or bg_shape != (REAL_BANKS["backgrounds"][0], tcfg.data.source_side,
                                tcfg.data.source_side, 3)
                or composites != [bg_shape] * REAL_TRAIN_STEPS
                or any(v != REAL_TRAIN_STEPS for v in step_launches.values())
                or [r["step"] for r in hist] != list(range(1, REAL_TRAIN_STEPS + 1))
                or not all(np.isfinite([r["loss"], r["loss3d"], r["grad_norm"]]).all()
                           for r in hist)):
            fail(f"train() on real assets: {state.step} steps, occluder bank {occ_shape}, "
                 f"background bank {bg_shape}, composites {composites}, launches "
                 f"{step_launches}, history {hist}")
        check_pool_variants("train() on real assets", ("fwd", "bwd"))
        print(f"[22 real] train(Config(), R50@256 bf16, B={tcfg.train.batch_size}) on a "
              f"3DHP-layout shard of {ds.n_train} JPEG frames with a JPEG mask, data."
              f"occluder_root the VOC fixture (bank {occ_shape}) and data.background_root the "
              f"background fixture (bank {bg_shape}): {REAL_TRAIN_STEPS} steps in {train_s:.1f} s "
              f"(the banks' builds included), loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}, finite; a composite at every step; launches "
              f"{step_launches}  [{card}]")
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[22 real] phase time {time.perf_counter() - t_phase:.1f} s")
    return {**launches, "warp_forms": forms}


# --- phase 23: aot_compile as a CUDA graph, the demo, profiling --------------------
AOT_BATCH = 64  # crop-in with flip TTA: the backbone sees 128 rows
AOT_SIDE = 256
AOT_TIMED = 20  # calls timed, eager and replayed
AOT_COUNTED = 3  # replays whose launches are counted
# kernel launches of one replay of the crop-in TTA predict (one forward)
AOT_PER_REPLAY = {"bf16": {"pool": 1, "qk1": 0, "qk2": 0, "bn": 49},
                  "int8": {"pool": 1, "qk1": 52, "qk2": 20, "bn": 17}}
DEMO_VIDEO_FRAMES = 8
DEMO_FRAME = (512, 910)  # make_multiperson_frame's and make_multiperson_sequence's
PROFILE_CALLS = 20


def path_counts() -> dict:
    """The wrappers' launch counts: K3 forward (`same`), QK1, QK2, K1 and its
    forms, the batch norm kernel."""
    from metro_pose3d_tpu_torch.ops import bn, int8, pool, warp

    return {"pool": pool.MODE_LAUNCHES["same"], "qk1": int8.launches("int8_conv"),
            "qk2": int8.launches("int8_elementwise"), "warp": warp.LAUNCHES,
            "warp_forms": dict(warp.KERNEL_LAUNCHES), "bn": bn.LAUNCHES}


def reset_path_counts() -> None:
    from metro_pose3d_tpu_torch.ops import bn, int8, pool, warp

    bn.reset_launches()
    pool.reset_launches()
    warp.reset_launches()
    int8.reset_launches()


def aot_request(rng, dev) -> tuple:
    crops = rng.randint(0, 256, (AOT_BATCH, AOT_SIDE, AOT_SIDE, 3)).astype(np.uint8)
    intr = crop_params(rng, AOT_BATCH, TILE, AOT_SIDE, "normal")[3]
    return torch.from_numpy(crops).to(dev), torch.from_numpy(intr).to(dev)


def replay_vs_eager(name: str, got: dict, want: dict, what: str) -> str:
    """The replay's outputs against the eager call's on the same inputs:
    equal bits expected (the graph holds the eager call's kernels); a
    difference is printed and held to PARITY_TOL (bf16) or INT8_PARITY_TOL
    (int8: max and mean)."""
    if set(got) != set(want):
        fail(f"[23 aot] {name} {what}: keys {sorted(got)} vs {sorted(want)}")
    if all(same_bits(got[k], want[k]) for k in want):
        return "equal bits"
    diffs = {k: (float((got[k].float() - want[k].float()).abs().max()),
                 float((got[k].float() - want[k].float()).abs().mean())) for k in want}
    print(f"[23 aot] {name} {what}: replay and eager differ (max, mean) "
          + ", ".join(f"{k} {a:.2e}, {m:.2e}" for k, (a, m) in diffs.items())
          + ": a kernel of the graph chose another algorithm or order than the eager call's")
    for k, (a, m) in diffs.items():
        tol = INT8_PARITY_TOL[k] if name == "int8" else (PARITY_TOL[k], float("inf"))
        if not (a <= tol[0] and m <= tol[1]):
            fail(f"[23 aot] {name} {what}: {k} replay vs eager max {a:.3e} mean {m:.3e} "
                 f"(tol {tol})")
    return "within " + ("INT8_PARITY_TOL" if name == "int8" else "PARITY_TOL")


def aot_leg(name: str, bundle: str, rng, dev, card) -> dict:
    """(a) for one bundle: load to first answer, eager and through
    `aot_compile`; steady ms a batch, eager and replayed; replay against
    eager on the same inputs and on fresh ones, an earlier answer untouched
    by a later replay; a wrong shape refused; the launches of a replay."""
    from metro_pose3d_tpu_torch.export import aot_compile, load_exported
    from metro_pose3d_tpu_torch.probes import time_ms

    (c1, i1), (c2, i2) = aot_request(rng, dev), aot_request(rng, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, model_e, fn_e = load_exported(bundle, flip_tta=True, device=dev)
    fn_e(model_e, c1, i1)
    torch.cuda.synchronize()
    eager_first_s = time.perf_counter() - t0
    del model_e, fn_e
    t0 = time.perf_counter()
    _, model, fn = load_exported(bundle, flip_tta=True, device=dev)
    compiled = aot_compile(fn, model, AOT_BATCH, AOT_SIDE)
    compile_s = time.perf_counter() - t0
    got1 = compiled(model, c1, i1)
    torch.cuda.synchronize()
    compiled_first_s = time.perf_counter() - t0
    kept = {k: v.clone() for k, v in got1.items()}
    same1 = replay_vs_eager(name, got1, fn(model, c1, i1), "same inputs")
    got2 = compiled(model, c2, i2)
    same2 = replay_vs_eager(name, got2, fn(model, c2, i2), "fresh inputs")
    if not all(torch.equal(got1[k], kept[k]) for k in kept):
        fail(f"[23 aot] {name}: a later replay changed an answer the caller holds")
    for k, shape in (("pose3d_rootrel", (AOT_BATCH, 17, 3)), ("pose2d_px", (AOT_BATCH, 17, 2)),
                     ("pose3d_abs", (AOT_BATCH, 17, 3))):
        if tuple(got2[k].shape) != shape or not bool(torch.isfinite(got2[k]).all()):
            fail(f"[23 aot] {name}: replay output {k} {tuple(got2[k].shape)} or not finite")
    try:
        compiled(model, c1[: AOT_BATCH // 2], i1[: AOT_BATCH // 2])
    except TypeError as e:
        refusal = str(e)
    else:
        fail(f"[23 aot] {name}: a batch of {AOT_BATCH // 2} was not refused")
    reset_path_counts()
    for _ in range(AOT_COUNTED):
        compiled(model, c2, i2)
    torch.cuda.synchronize()
    counts = path_counts()
    want = {k: AOT_COUNTED * n for k, n in AOT_PER_REPLAY[name].items()}
    if {k: counts[k] for k in want} != want or counts["warp"]:
        fail(f"[23 aot] {name}: {AOT_COUNTED} replays counted {counts}, want {want} (launches "
             f"a replay, from the capture: {compiled.launches})")
    eager_ms = time_ms(lambda: fn(model, c1, i1), iters=AOT_TIMED, warmup=2)
    replay_ms = time_ms(lambda: compiled(model, c1, i1), iters=AOT_TIMED, warmup=2)
    print(f"[23 aot] {name} Config() R50@{AOT_SIDE} crop-in TTA B={AOT_BATCH} from a "
          f"load_exported bundle: load to first answer eager {eager_first_s:.2f} s, "
          f"aot_compile {compiled_first_s:.2f} s ({compile_s:.2f} s of it loading, warming up "
          f"and capturing; this process has built the kernels already); steady eager "
          f"{eager_ms:.2f} ms a batch, replay {replay_ms:.2f} ms (copies in and clones out "
          f"included), {AOT_BATCH * 1000 / replay_ms:.1f} crops/s; replay vs eager: {same1}, "
          f"fresh inputs {same2}; an earlier answer kept its bits; batch {AOT_BATCH // 2} "
          f"refused ({refusal}); a replay launches K3 {AOT_PER_REPLAY[name]['pool']}, QK1 "
          f"{AOT_PER_REPLAY[name]['qk1']}, QK2 {AOT_PER_REPLAY[name]['qk2']}, batch norm "
          f"{AOT_PER_REPLAY[name]['bn']}  [{card}]")
    bad = None
    if name == "bf16":  # a capture that fails raises, and nothing falls back to eager

        def syncing(model_, crops, intrinsics):
            out = fn(model_, crops, intrinsics)
            if float(out["pose3d_abs"].abs().max()) < 0:  # a host read: no capture allows it
                fail("unreachable")
            return out

        try:
            aot_compile(syncing, model, AOT_BATCH, AOT_SIDE)
        except RuntimeError as e:
            if "into a CUDA graph failed" not in str(e):
                raise
            bad = str(e).splitlines()[0][:200]
        else:
            fail("[23 aot] a capture of a function that reads the card on the host did not raise")
        again = compiled(model, c1, i1)
        if not all(torch.equal(again[k], kept[k]) for k in kept):
            fail("[23 aot] after the failed capture the graph gives other answers")
        print(f"[23 aot] a capture that reads the card on the host raised: {bad}; the graph "
              f"replays as before")
    return {"counts": counts, "per_replay": AOT_PER_REPLAY[name], "eager_first_s": eager_first_s,
            "compiled_first_s": compiled_first_s, "eager_ms": eager_ms, "replay_ms": replay_ms,
            "parity": [same1, same2]}


def phase_finish(rng, dev, card) -> dict:
    """23: `export.aot_compile` as a CUDA graph (bf16, and int8 calibrated as
    phase 17 calibrates), the demo, and `utils/profiling.py`. -> the
    kernels' launches and each bundle's launches a replay."""
    from metro_pose3d_tpu_torch import demo
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.data.synthetic import make_multiperson_sequence
    from metro_pose3d_tpu_torch.export import export_model, load_exported
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.models.quantize import calibrate
    from metro_pose3d_tpu_torch.ops.color import normalize
    from metro_pose3d_tpu_torch.utils import improc, profiling

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_finish_")
    total = {"pool": 0, "qk1": 0, "qk2": 0, "bn": 0, "warp_forms": dict.fromkeys(
        [("normalize_div", torch.bfloat16)], 0)}
    per_replay = {}
    try:
        # (a) the bundles: seeded bf16 weights, and the same calibrated int8
        cfg = Config()
        model = init_metro_model(cfg.model, SEED, dev)
        export_model(cfg, model, os.path.join(tmp, "bf16"))
        cfg8 = apply_overrides(Config(), {"model.quantize": "int8"})
        model8 = init_metro_model(cfg8.model, SEED, dev)
        model8.load_state_dict(model.state_dict(), strict=False)
        calibrate(model8, [normalize(torch.from_numpy(rng.randint(
            0, 256, (BATCH, AOT_SIDE, AOT_SIDE, 3)).astype(np.uint8)).to(dev).float() / 255.0)
            for _ in range(3)])
        export_model(cfg8, model8, os.path.join(tmp, "int8"))
        del model, model8
        legs = {}
        for name in ("bf16", "int8"):
            legs[name] = aot_leg(name, os.path.join(tmp, name), rng, dev, card)
            torch.cuda.empty_cache()
            per_replay[name] = legs[name]["per_replay"]
            for k in ("pool", "qk1", "qk2", "bn"):
                total[k] += legs[name]["counts"][k]

        # (c) the demo on the card: a PNG of the synthetic frame, and --video
        reset_path_counts()
        png, clip = os.path.join(tmp, "demo.png"), os.path.join(tmp, "clip")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rcs = (demo.main(["--out", png]),
                   demo.main(["--video", str(DEMO_VIDEO_FRAMES), "--out", clip]))
        demo_s = time.perf_counter() - t0
        counts = path_counts()
        img = improc.imread(png)
        frames = np.load(clip + ".npz")["frames"]
        h, w = DEMO_FRAME
        n_frames = 1 + DEMO_VIDEO_FRAMES
        div = counts["warp_forms"][("normalize_div", torch.bfloat16)]
        if (rcs != (0, 0) or img.shape != (h, w + h, 3)
                or frames.shape != (DEMO_VIDEO_FRAMES, h, w, 3) or frames.dtype != np.uint8):
            fail(f"[23 demo] rcs {rcs}, PNG {img.shape}, frames {frames.shape} {frames.dtype}; "
                 f"printed {printed.getvalue()[-500:]}")
        if (div, counts["pool"], counts["bn"]) != (n_frames, n_frames, 49 * n_frames):
            fail(f"[23 demo] {n_frames} frames launched K1 normalize_div bf16 {div}, K3 "
                 f"{counts['pool']} and batch norm {counts['bn']} times (want one K1 and K3 and "
                 f"49 batch norms a frame): {counts}")
        loaded = sorted(m for m in ("cv2", "matplotlib") if m in sys.modules)
        if loaded:
            fail(f"[23 demo] the demo imported {loaded}")
        changed = (frames != np.stack([f for f, *_ in make_multiperson_sequence(
            3, DEMO_VIDEO_FRAMES, seed=0)])).any(-1)
        total["pool"] += counts["pool"]
        total["bn"] += counts["bn"]
        total["warp_forms"][("normalize_div", torch.bfloat16)] += div
        print(f"[23 demo] demo.main on the card (Config() R50@256 bf16, seeded weights): "
              f"{png} {img.shape[1]}x{img.shape[0]} PNG read back by the port, and --video "
              f"{DEMO_VIDEO_FRAMES}: {frames.shape} overlays, {changed.mean():.4%} of their "
              f"pixels drawn, in {demo_s:.1f} s; K1 normalize_div bf16 and K3 once a frame, "
              f"batch norm 49 times; neither cv2 nor matplotlib imported")

        # (d) profiling: StepTimer and sync around eager predicts, the
        # memory statistics, a trace
        reset_path_counts()
        _, model, fn = load_exported(os.path.join(tmp, "bf16"), flip_tta=True, device=dev)
        c, i = aot_request(rng, dev)
        fn(model, c, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timer = profiling.StepTimer(skip=2)
        timer.reset_clock()
        for _ in range(PROFILE_CALLS):
            out = fn(model, c, i)
            profiling.sync(out)
            timer.tick(AOT_BATCH)
        summary = timer.summary(items_per_step=AOT_BATCH)
        mem = profiling.device_memory_stats()
        limit = torch.cuda.get_device_properties(0).total_memory
        m0 = mem.get("cuda:0", {})
        if summary["steps"] != PROFILE_CALLS or not summary["p50_ms"] > 0:
            fail(f"[23 profiling] StepTimer summary {summary}")
        if not (m0.get("peak_bytes_in_use", 0) > 0 and m0.get("bytes_limit") == limit
                and len(mem) == torch.cuda.device_count()):
            fail(f"[23 profiling] device_memory_stats {mem} (card total {limit})")
        # the profiler may miss launches of a window (`launched_kernels`), so
        # a trace that names no stem pool kernel is taken again, eight at most
        for window in range(1, 9):
            trace_dir = os.path.join(tmp, f"trace{window}")
            with profiling.trace(trace_dir):
                for _ in range(3):
                    fn(model, c, i)
            with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
                events = json.load(f)["traceEvents"]
            kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
            pool_kernels = sorted(k for k in kernels if "maxpool3x3s2_kernel" in k)
            if pool_kernels:
                break
        else:
            fail(f"[23 profiling] eight traces named no stem pool kernel; the last named "
                 f"{len(kernels)} kernels: {sorted(kernels)[:10]}")
        total["pool"] += path_counts()["pool"]
        total["bn"] += path_counts()["bn"]
        print(f"[23 profiling] StepTimer over {PROFILE_CALLS} eager predicts (Config() bf16, "
              f"crop-in TTA B={AOT_BATCH}), each synced: {summary}; device_memory_stats cuda:0 "
              f"in use {m0['bytes_in_use'] / 2**30:.2f} GiB, peak "
              f"{m0['peak_bytes_in_use'] / 2**30:.2f} GiB, limit {m0['bytes_limit'] / 2**30:.2f} "
              f"GiB; trace() wrote {profiling.TRACE_FILE} with {len(kernels)} kernels, the stem "
              f"pool's among them ({pool_kernels[0][:60]}), in trace {window} of at most 8  "
              f"[{card}]")
        del model, fn, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[23 finish] phase time {time.perf_counter() - t_phase:.1f} s")
    total["per_replay"] = per_replay
    total["legs"] = legs
    return total


# --- phase 24: eval batch norm and its ReLU in one pass --------------------------

BN_BATCH = 64  # crop-in and tile-in with flip TTA: 128 rows a forward
BN_PATH = {"bf16": 49, "int8": 17}  # batch norm launches a forward
BN_TIMED = 5  # forwards profiled for the kernel's device time on the path


def bn_path_shapes(dev, cfg=None) -> list:
    """[(C, H, W, act)] of the batch norms of a `cfg` forward (Config() by
    default: R50 v2 @ 256), in order, from a forward of one crop."""
    from metro_pose3d_tpu_torch.config import Config
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.models.resnet import BatchNorm

    model = init_metro_model((cfg or Config()).model, SEED, dev).eval()
    shapes = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda _, args, kw: shapes.append((*args[0].shape[1:], kw.get("act", "none"))),
                with_kwargs=True)
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3, device=dev))
    return shapes


def bn_special(gen, dev, shape, dtype, memory_format):
    """A batch norm case with NaN, +-inf and -0.0 in x, and channel 0 taking
    -0.0 to -0.0: (x, mean, mul, bias)."""
    x = torch.randn(shape, generator=gen, device=dev) * 3
    flat = x.view(-1)
    for value in (float("nan"), float("inf"), float("-inf"), -0.0):
        flat[torch.randint(0, flat.numel(), (flat.numel() // 50,), generator=gen,
                           device=dev)] = value
    x = x.to(dtype).contiguous(memory_format=memory_format)
    c = shape[1]
    mean, scale, bias = (torch.randn(c, generator=gen, device=dev) for _ in range(3))
    var = torch.rand(c, generator=gen, device=dev) + 0.05
    mean[0], scale[0], bias[0] = 0.0, 1.0, -0.0
    return x, mean, torch.rsqrt(var + 1e-3) * scale, bias


def phase_bn(rng, gen, dev, card) -> dict:
    """24: the batch norm kernel bit for bit its twin at the 49 shapes of the
    bf16 forward (128 rows), in both variants, with and without the ReLU,
    and on NaN, +-inf and -0.0 in float32 and bf16, channels_last and NCHW;
    its launches on the crop-in and tile-in bf16 paths and on int8 crop-in,
    each forward's outputs equal to the same forward with the twin's chain;
    its device time over a crop-in forward's 49 launches (the profiler)
    beside the bytes bound, the kernel and the twin at the same 49 shapes
    alone (CUDA events), and the forward's time with the kernel and with
    the twin. -> its record."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.evaluation.engine import PoseEstimator
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.kernels import build
    from metro_pose3d_tpu_torch.models.quantize import calibrate
    from metro_pose3d_tpu_torch.ops import bn
    from metro_pose3d_tpu_torch.probes import time_ms

    t_phase = time.perf_counter()
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    usage, _ = kernel_resources(cuobjdump, build.build(), ("bn_act_nhwc_kernel",
                                                           "bn_act_flat_kernel"))
    print(f"[24 bn] cuobjdump: channels_last vec16 instances {usage.get('bn_act_nhwc_kernel')}, "
          f"flat instances {usage.get('bn_act_flat_kernel')}")
    shapes = bn_path_shapes(dev)
    if len(shapes) != BN_PATH["bf16"] or not all(act == "relu" for *_, act in shapes):
        fail(f"[24 bn] a Config() forward ran {len(shapes)} batch norms: {shapes}")

    # (a) bit for bit at the path's shapes, and its time alone there
    rows = 2 * BN_BATCH
    bn.reset_launches()
    alone_ms = plain_ms = bound_ms = 0.0
    for c, h, w, _ in shapes:
        x = (torch.randn((rows, c, h, w), generator=gen, device=dev) * 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        mean, scale, bias = (torch.randn(c, generator=gen, device=dev) for _ in range(3))
        mul = torch.rsqrt(torch.rand(c, generator=gen, device=dev) + 0.05 + 1e-3) * scale
        for act in ("relu", "none"):
            want = bn.bn_act_plain(x, mean, mul, bias, act)
            for width in (None, 1):
                if not same_bits(bn.bn_act_cuda(x, mean, mul, bias, act, width), want):
                    fail(f"[24 bn] [{rows},{c},{h},{w}] bf16 act {act} width {width}: the "
                         f"kernel differs from its twin")
        alone_ms += time_ms(lambda: bn.bn_act_cuda(x, mean, mul, bias, "relu"))
        plain_ms += time_ms(lambda: bn.bn_act_plain(x, mean, mul, bias, "relu"))
        bound_ms += bound(2 * nbytes(x), 5 * x.numel())[0]
        del x, want
    # a shape: 2 checks in each variant, then 3 + 20 timed calls in vec16
    if (bn.launches(var="scalar"), bn.launches(var="vec16")) != (2 * len(shapes),
                                                                 25 * len(shapes)):
        fail(f"[24 bn] variants launched {bn.KERNEL_LAUNCHES}")
    for dtype in (torch.float32, torch.bfloat16):
        for fmt in (torch.channels_last, torch.contiguous_format):
            for shape in ((8, 256, 64, 64), (3, 24, 7, 9)):
                x, mean, mul, bias = bn_special(gen, dev, shape, dtype, fmt)
                for act in bn.ACTIVATIONS:
                    want = bn.bn_act_plain(x, mean, mul, bias, act)
                    for width in (None, 1):
                        got = bn.bn_act_cuda(x, mean, mul, bias, act, width)
                        if got.stride() != want.stride() or not same_bits(got, want):
                            fail(f"[24 bn] {shape} {dtype} {fmt} act {act} width {width}: "
                                 f"the kernel differs from its twin on NaN, inf and -0.0")
    print(f"[24 bn] kernel == twin bit for bit at the {len(shapes)} batch norms of a Config() "
          f"forward of {rows} rows (bf16, channels_last, with and without the ReLU, vec16 and "
          f"scalar) and on NaN, +-inf, -0.0 in float32 and bf16, channels_last and NCHW; alone "
          f"at those shapes: kernel {alone_ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes), share {bound_ms / alone_ms:.1%}  [{card}]")

    # (b) the paths: launches, outputs against the twin's chain, times
    kernel_fn = bn.bn_act_cuda

    def plain_cuda(x, mean, mul, bias, act="none", width=None):
        return bn.bn_act_plain(x, mean, mul, bias, act)

    crops = rng.randint(0, 256, (BN_BATCH, 256, 256, 3)).astype(np.uint8)
    intr = crop_params(rng, BN_BATCH, TILE, 256, "normal")[3]
    tiles = tile_batch(rng, BN_BATCH, TILE, 256)
    per_path, times = {}, {}
    for name in ("bf16", "int8"):
        cfg = apply_overrides(Config(), {"model.quantize": "int8"} if name == "int8" else {})
        model = init_metro_model(cfg.model, SEED, dev)
        if name == "int8":
            calibrate(model, [torch.from_numpy(rng.uniform(-1, 1, (16, 256, 256, 3)).astype(
                np.float32)).to(dev) for _ in range(2)])
        est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
        bn.reset_launches()
        got = {"crops": est.predict_crops(crops, intr)}
        per_path[f"{name}_crop"] = bn.LAUNCHES
        if name == "bf16":
            got["tiles"] = est.predict_tiles(tiles)
            per_path["bf16_tile"] = bn.LAUNCHES - per_path["bf16_crop"]
        torch.cuda.synchronize()
        counted = {k: n for k, n in per_path.items() if k.startswith(name)}
        if set(counted.values()) != {BN_PATH[name]} or bn.launches(act="none") or \
                bn.launches(var="scalar"):
            fail(f"[24 bn] {name}: launches a forward {counted}, want {BN_PATH[name]}, all "
                 f"with the ReLU in the vec16 variant: {bn.KERNEL_LAUNCHES}")
        c_dev, i_dev = torch.from_numpy(crops).to(dev), torch.from_numpy(intr).to(dev)
        fn = est._crops_fn
        times[name] = {"forward_ms": time_ms(lambda: fn(model, c_dev, i_dev), iters=10)}
        if name == "bf16":
            times[name]["ms"] = device_ms(lambda: fn(model, c_dev, i_dev),
                                          ("bn_act_",) * BN_PATH[name], iters=BN_TIMED, warmup=1)
        bn.bn_act_cuda = plain_cuda
        try:
            want = {"crops": est.predict_crops(crops, intr)}
            if name == "bf16":
                want["tiles"] = est.predict_tiles(tiles)
            times[name]["forward_plain_ms"] = time_ms(lambda: fn(model, c_dev, i_dev), iters=10)
        finally:
            bn.bn_act_cuda = kernel_fn
        for path in got:
            for k in want[path]:
                if not torch.equal(got[path][k], want[path][k]):
                    fail(f"[24 bn] {name} {path}: {k} differs from the twin chain's")
        print(f"[24 bn] {name} Config() R50@256 TTA B={BN_BATCH}: {counted} launches a forward, "
              f"outputs equal to the twin chain's ({', '.join(got)}); crop-in forward "
              f"{times[name]['forward_ms']:.2f} ms with the kernel, "
              f"{times[name]['forward_plain_ms']:.2f} ms with the twin chain  [{card}]")
        del model, est, got, want
        torch.cuda.empty_cache()
    ms = times["bf16"]["ms"]
    print(f"[24 bn] the kernel's device time over a crop-in forward's {BN_PATH['bf16']} "
          f"launches (profiler, {BN_TIMED} forwards): {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes), share {bound_ms / ms:.1%}  [{card}]")
    print(f"[24 bn] phase time {time.perf_counter() - t_phase:.1f} s")
    return {"name": "bn_act", "route": "cuda", "source": "metro_pose3d_tpu_torch/csrc/bn_act.cu",
            "replaces": "none: XLA fuses flax's BatchNorm and its ReLU into the ops around them",
            "launches": sum(per_path.values()), "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "bound_share": bound_ms / ms, "ms_alone": alone_ms, "per_path": per_path,
            "forward_ms": {k: v["forward_ms"] for k, v in times.items()},
            "forward_plain_ms": {k: v["forward_plain_ms"] for k, v in times.items()}}


# --- phase 25: EfficientNetV2-L's depthwise convs and its serving path ---------

EFF_OVERRIDES = {"model.backbone": "efficientnetv2-l", "model.bn_epsilon": "0.001",
                 "model.bn_momentum": "0.9"}
EFF_PATH = {"dwconv": 61, "bn": 217, "bn_silu": 142}  # launches a forward


def dwconv_path_convs(dev, cfg) -> list:
    """[(conv, (C, H, W))] of the depthwise convs of a `cfg` forward, in
    order, from a forward of one crop."""
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.models.resnet import Conv

    model = init_metro_model(cfg.model, SEED, dev).eval()
    convs = []
    for m in model.modules():
        if isinstance(m, Conv) and m.groups > 1:
            m.register_forward_pre_hook(
                lambda mod, args: convs.append((mod, tuple(args[0].shape[1:]))))
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3, device=dev))
    return convs


def cudnn_depthwise(x, weight, conv):
    """The depthwise conv through F.conv2d (cuDNN's grouped kernel for a
    channels_last bf16 input), padded as `Conv` pads a dense conv."""
    top, bottom, left, right = conv.pads(*x.shape[2:])
    w = weight.to(x.dtype)
    if (top, left) == (bottom, right):
        return F.conv2d(x, w, None, conv.stride, (top, left), conv.dilation, x.shape[1])
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, None, conv.stride, 0,
                    conv.dilation, x.shape[1])


def phase_effv2(rng, gen, dev, card) -> tuple:
    """25: EfficientNetV2-L (`model.backbone="efficientnetv2-l"`). The
    depthwise kernel bit for bit its twin at the 61 convs of a bf16 forward
    of 128 rows, in both variants, and its time alone there (CUDA events)
    beside the twin's, cuDNN's grouped conv's and the bytes bound; the
    batch norm kernel bit for bit its twin at the 217 batch norms (142 with
    the SiLU); a crop-in TTA batch of 64 through `PoseEstimator`: 61
    depthwise and 217 batch norm launches (142 SiLU), outputs equal to the
    same batch with both kernels' twins, the two kernels' device time over
    the forward (the profiler), and the forward's time with the kernels and
    with the twins. -> (the depthwise kernel's record, the batch norm
    launches and their per-path count)."""
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.evaluation.engine import PoseEstimator
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.ops import bn, dwconv
    from metro_pose3d_tpu_torch.probes import time_ms

    t_phase = time.perf_counter()
    cfg = apply_overrides(Config(), EFF_OVERRIDES)
    rows = 2 * BN_BATCH

    # (a) the depthwise kernel at the path's shapes: bits, and times alone
    convs = dwconv_path_convs(dev, cfg)
    if len(convs) != EFF_PATH["dwconv"]:
        fail(f"[25 effv2] a forward ran {len(convs)} depthwise convs, want {EFF_PATH['dwconv']}")
    dwconv.reset_launches()
    alone_ms = plain_ms = cudnn_ms = bound_ms = 0.0
    for conv, (c, h, w) in convs:
        x = (torch.randn((rows, c, h, w), generator=gen, device=dev) * 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        weight = torch.randn((c, 1, 3, 3), generator=gen, device=dev) * 0.4
        pads = conv.pads(h, w)
        args = (x, weight, conv.stride, conv.dilation, pads)
        want = dwconv.depthwise_conv_plain(*args)
        for width in (None, 1):
            if not same_bits(dwconv.depthwise_conv_cuda(*args, width=width), want):
                fail(f"[25 effv2] depthwise [{rows},{c},{h},{w}] stride {conv.stride} dilation "
                     f"{conv.dilation} width {width}: the kernel differs from its twin")
        lib = cudnn_depthwise(x, weight, conv)
        if lib.shape != want.shape:
            fail(f"[25 effv2] cuDNN's depthwise conv gave {tuple(lib.shape)}, the twin "
                 f"{tuple(want.shape)}")
        alone_ms += time_ms(lambda: dwconv.depthwise_conv_cuda(*args))
        plain_ms += time_ms(lambda: dwconv.depthwise_conv_plain(*args), iters=5)
        cudnn_ms += time_ms(lambda: cudnn_depthwise(x, weight, conv), iters=5)
        bound_ms += bound(nbytes(x, want) + 9 * c * x.element_size(), 18 * want.numel())[0]
        del x, want, lib
    # a conv: 2 checks, then 3 + 20 timed calls in vec16
    if (dwconv.launches(var="scalar"), dwconv.launches(var="vec16")) != (len(convs),
                                                                         24 * len(convs)):
        fail(f"[25 effv2] depthwise variants launched {dwconv.KERNEL_LAUNCHES}")
    print(f"[25 effv2] depthwise kernel == twin bit for bit at the {len(convs)} depthwise convs "
          f"of an EfficientNetV2-L forward of {rows} rows (bf16, channels_last, vec16 and "
          f"scalar); alone at those shapes: kernel {alone_ms:.4f} ms, twin {plain_ms:.4f} ms, "
          f"cuDNN grouped conv {cudnn_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), share "
          f"{bound_ms / alone_ms:.1%}  [{card}]")

    # (b) the batch norm kernel at the path's shapes, each with its activation
    shapes = bn_path_shapes(dev, cfg)
    acts = [act for *_, act in shapes]
    if (len(shapes), acts.count("silu")) != (EFF_PATH["bn"], EFF_PATH["bn_silu"]):
        fail(f"[25 effv2] a forward ran {len(shapes)} batch norms, {acts.count('silu')} SiLU")
    differing = total = 0
    for c, h, w, act in shapes:
        x = (torch.randn((rows, c, h, w), generator=gen, device=dev) * 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        mean, scale, bias = (torch.randn(c, generator=gen, device=dev) for _ in range(3))
        mul = torch.rsqrt(torch.rand(c, generator=gen, device=dev) + 0.05 + 1e-3) * scale
        want = bn.bn_act_plain(x, mean, mul, bias, act)
        for width in (None, 1):
            got = bn.bn_act_cuda(x, mean, mul, bias, act, width)
            if not same_bits(got, want):
                differing += int((got.view(torch.int16) != want.view(torch.int16)).sum())
            total += got.numel()
        del x, want, got
    if differing:
        fail(f"[25 effv2] batch norm: {differing} of {total} elements differ from the twin")
    print(f"[25 effv2] batch norm kernel == twin bit for bit at the {len(shapes)} batch norms "
          f"of the forward ({acts.count('silu')} SiLU, {acts.count('none')} none; vec16 and "
          f"scalar): 0 of {total} elements differ  [{card}]")

    # (c) the serving path
    model = init_metro_model(cfg.model, SEED, dev)
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    crops = rng.randint(0, 256, (BN_BATCH, 256, 256, 3)).astype(np.uint8)
    intr = crop_params(rng, BN_BATCH, TILE, 256, "normal")[3]
    est.predict_crops(crops, intr)  # warm-up: cuBLAS and cuDNN pick their kernels
    torch.cuda.synchronize()
    bn.reset_launches()
    dwconv.reset_launches()
    got = est.predict_crops(crops, intr)
    torch.cuda.synchronize()
    counted = {"dwconv": dwconv.launches("bfloat16", "vec16"), "bn": bn.LAUNCHES,
               "bn_silu": bn.launches("bfloat16", "silu", "vec16")}
    if counted != EFF_PATH or dwconv.LAUNCHES != EFF_PATH["dwconv"] or bn.launches(var="scalar"):
        fail(f"[25 effv2] crop-in launches {counted}, want {EFF_PATH}: {bn.KERNEL_LAUNCHES} "
             f"{dwconv.KERNEL_LAUNCHES}")
    c_dev, i_dev = torch.from_numpy(crops).to(dev), torch.from_numpy(intr).to(dev)
    fn = est._crops_fn
    forward_ms = time_ms(lambda: fn(model, c_dev, i_dev), iters=10)
    dw_ms = device_ms(lambda: fn(model, c_dev, i_dev), ("dwconv_nhwc_kernel",) * EFF_PATH["dwconv"],
                      iters=BN_TIMED, warmup=1)
    bn_ms = device_ms(lambda: fn(model, c_dev, i_dev), ("bn_act_",) * EFF_PATH["bn"],
                      iters=BN_TIMED, warmup=1)
    kernels = bn.bn_act_cuda, dwconv.depthwise_conv_cuda

    def bn_plain(x, mean, mul, bias, act="none", width=None):
        return bn.bn_act_plain(x, mean, mul, bias, act)

    def dw_plain(x, weight, stride, dilation, pads, width=None):
        return dwconv.depthwise_conv_plain(x, weight, stride, dilation, pads)

    bn.bn_act_cuda, dwconv.depthwise_conv_cuda = bn_plain, dw_plain
    try:
        want = est.predict_crops(crops, intr)
        forward_plain_ms = time_ms(lambda: fn(model, c_dev, i_dev), iters=5)
    finally:
        bn.bn_act_cuda, dwconv.depthwise_conv_cuda = kernels
    for k in want:
        if not (torch.isfinite(got[k]).all() and torch.equal(got[k], want[k])):
            fail(f"[25 effv2] crop-in {k} differs from the twins' chain's or is not finite")
    print(f"[25 effv2] EfficientNetV2-L@256 bf16 crop-in TTA B={BN_BATCH} through PoseEstimator: "
          f"{counted} launches a forward, outputs equal to the twins' chain's; forward "
          f"{forward_ms:.2f} ms with the kernels, {forward_plain_ms:.2f} ms with the twins; device "
          f"time over the forward (profiler, {BN_TIMED} forwards): depthwise {dw_ms:.4f} ms "
          f"(bound {bound_ms:.4f}, share {bound_ms / dw_ms:.1%}), batch norm {bn_ms:.4f} ms  "
          f"[{card}]")
    del model, est, got, want
    torch.cuda.empty_cache()
    print(f"[25 effv2] phase time {time.perf_counter() - t_phase:.1f} s")
    record = {"name": "dwconv", "route": "cuda", "source": "metro_pose3d_tpu_torch/csrc/dwconv.cu",
              "replaces": "none: the JAX package has no EfficientNetV2",
              "launches": EFF_PATH["dwconv"], "max_abs_err": 0.0, "ms": dw_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": cudnn_ms, "bound_share": bound_ms / dw_ms, "ms_alone": alone_ms,
              "per_path": {"effv2_crop": EFF_PATH["dwconv"]}, "forward_ms": forward_ms,
              "forward_plain_ms": forward_plain_ms}
    return record, {"bn": EFF_PATH["bn"], "bn_forward": {"effv2_crop": EFF_PATH["bn"]},
                    "bn_ms": bn_ms}


@contextlib.contextmanager
def must_refuse(improc):
    """The block must raise improc.CorruptImage (the smoke has no pytest)."""
    try:
        yield
    except improc.CorruptImage:
        return
    fail("nvJPEG took bytes that are not a JPEG")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-rank":  # a rank of phase 21
        backend, rank, world, tmp = sys.argv[2:6]
        return dp_rank(backend, int(rank), int(world), tmp)
    from metro_pose3d_tpu_torch.config import Config, apply_overrides
    from metro_pose3d_tpu_torch.geom.joints import H36M_17
    from metro_pose3d_tpu_torch.evaluation.engine import TILE_KEYS, PoseEstimator
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.kernels import build
    from metro_pose3d_tpu_torch.ops import bn, occlusion, pool, warp
    from metro_pose3d_tpu_torch.probes import time_ms

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
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    usage, hgmma = kernel_resources(cuobjdump, build.build(),
                                    ("warp_crop", "rowsel", "roll_kernel", "lane_loop_kernel",
                                     "probe_gather_rows_kernel", "probe_gather_cols_kernel",
                                     "probe_dynslice_kernel", "int8_conv_wgmma_kernel"))
    if not hgmma.get("rowsel"):
        fail(f"no HGMMA instruction in the row select's SASS: {hgmma}")
    print(f"[2 build] cuobjdump: warp_crop instances {usage.get('warp_crop')}, rowsel "
          f"{usage.get('rowsel')}, roll {usage.get('roll_kernel')}, lane loop "
          f"{usage.get('lane_loop_kernel')}, gather rows {usage.get('probe_gather_rows_kernel')}, "
          f"gather columns {usage.get('probe_gather_cols_kernel')}, row slice "
          f"{usage.get('probe_dynslice_kernel')}, QK1 wgmma (BN 256, 128, 64) "
          f"{usage.get('int8_conv_wgmma_kernel')}; HGMMA instructions in the rowsel SASS: "
          f"{hgmma['rowsel']}, IGMMA in QK1's: {hgmma.get('int8_conv_wgmma_kernel', 0)}")
    rates = card_rates()
    print(f"[2 build] rates for the looped probes' bounds: {rates['sms']} SMs at "
          f"{rates['mhz']:.0f} MHz: int32 adds {rates['int32'] / 1e12:.2f} T/s, shared memory "
          f"{rates['shared'] / 1e12:.2f} TB/s")

    # 3 K3: pool kernel == plain version, bit for bit
    pool_err = 0.0
    for shape, dtype, kind in (((64, 64, 128, 128), torch.bfloat16, "random"),
                               ((16, 64, 128, 128), torch.float32, "random"),
                               ((8, 64, 127, 129), torch.bfloat16, "random"),
                               ((8, 24, 33, 18), torch.float32, "random"),
                               ((8, 64, 128, 128), torch.bfloat16, "relu"),
                               ((4, 64, 127, 129), torch.bfloat16, "nan"),
                               ((3, 5, 15, 13), torch.float32, "nan"),
                               ((2, 8, 9, 16), torch.bfloat16, "ties")):
        x = pool_inputs(gen, dev, shape, dtype, kind)
        err, variants = check_pool_fwd(pool, x)
        pool_err = max(pool_err, err)
        print(f"[3 k3] pool {tuple(shape)} {dtype} {kind}: bit-exact ({variants})")

    # 4 K1: every form of the warp kernel against its plain chain, and the
    # fused epilogue against the unfused kernel output, bit for bit
    warp_max = 0.0
    cases = {kind: tile_batch(rng, BATCH, TILE, 256, kind) for kind in ("normal", "rot90", "behind")}
    for kind, batch in cases.items():
        t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        args = (t["source"], t["warp_h"], t["warp_k"], t["warp_dist"], 256)
        errs = check_warp_forms(warp, args, f"{kind} crops")
        warp_max = max(warp_max, errs[WARP_FORM_NONE])
        _, in_front = warp.warp_coords(t["warp_h"], t["warp_k"], t["warp_dist"], 256)
        behind = float((~in_front).float().mean())
        if kind == "behind" and behind == 0.0:
            fail("the behind-camera case has no ray behind the camera")
        print(f"[4 k1] warp {kind} B={BATCH} {TILE}^2->256^2, behind-camera share {behind:.3f}: "
              f"max abs err by form {fmt_forms(errs)}; fused == unfused bit for bit")
    frame = torch.from_numpy(rng.randint(0, 256, (1, 720, 1280, 3)).astype(np.uint8)).to(dev)
    h, k, d, _ = (torch.from_numpy(a).to(dev) for a in crop_params(rng, 16, 720, 256, "normal"))
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    errs = check_warp_forms(warp, (frame, h, k, d, 256, idx), "a shared frame")
    warp_max = max(warp_max, errs[WARP_FORM_NONE])
    idx[-1] = 7  # out of range: a zero crop through the epilogue
    for epi, dt in warp.FORMS:
        got = warp.warp_images_cuda(frame, h, k, d, 256, idx, epi, dt)[-1]
        if not same_bits(got, warp.apply_epilogue(torch.zeros_like(got, dtype=torch.float32),
                                                   epi, dt)):
            fail(f"K1 ({epi}, {dt}): an out-of-range source index did not give a zero crop")
    print(f"[4 k1] warp shared 1280x720 frame, 16 crops: max abs err by form {fmt_forms(errs)}; "
          f"fused == unfused bit for bit; an out-of-range index gives the epilogue of zeros")

    # 5 serve: the main path, counting kernel launches
    cfg = Config()
    model = init_metro_model(cfg.model, SEED, dev)
    est = PoseEstimator(cfg, model, H36M_17, flip_tta=True, reconstruct=True)
    side = cfg.model.proc_side
    crop_reqs = [(rng.randint(0, 256, (BATCH, side, side, 3)).astype(np.uint8),
                  crop_params(rng, BATCH, TILE, side, "normal")[3]) for _ in range(3)]
    tile_reqs = [tile_batch(rng, BATCH, TILE, side) for _ in range(3)]
    pool.reset_launches()
    warp.reset_launches()
    outs = [est.predict_crops(c, i) for c, i in crop_reqs]
    outs += [est.predict_tiles(b) for b in tile_reqs]
    torch.cuda.synchronize()
    launches = {"pool": pool.MODE_LAUNCHES["same"], "warp": warp.LAUNCHES}
    serve_forms = dict(warp.KERNEL_LAUNCHES)
    for out in outs:
        for key, shape in (("pose3d_rootrel", (BATCH, 17, 3)), ("pose2d_px", (BATCH, 17, 2)),
                           ("pose3d_abs", (BATCH, 17, 3))):
            if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                fail(f"serving output {key}: shape {tuple(out[key].shape)} or not finite")
    if launches["pool"] == 0 or launches["warp"] == 0:
        fail(f"the serving path did not launch every kernel: {launches}")
    check_pool_variants("serving")
    check_warp_forms_launched("serving", ("normalize", torch.bfloat16))
    print(f"[5 serve] 3 crop-in + 3 tile-in requests of {BATCH} (R50@256 bf16, TTA, "
          f"full reconstruction): outputs finite, launches {launches}, pool variants "
          f"{pool.VARIANT_LAUNCHES['fwd']}, warp launches by form {fmt_forms(serve_forms, 'd')}")

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
    print(decode_with_tf32(gen, dev, cfg.model, 2 * BATCH))

    # 7 timings (informative; the card's name and power limit beside each)
    xp = torch.randn((2 * BATCH, 64, 128, 128), generator=gen, device=dev)
    xp = xp.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    pool_ms, pool_plain_ms = time_ms(lambda: pool.max_pool_cuda(xp)), time_ms(
        lambda: pool.max_pool_plain(xp))
    pool_two_calls_ms = time_ms(lambda: F.max_pool2d(
        F.pad(xp, (0, 1, 0, 1), value=float("-inf")), 3, 2))
    pool_scalar_ms = time_ms(lambda: pool.max_pool_cuda(xp, width=1))
    pool_bound = bound(nbytes(xp) * 1.25, 9 * xp.numel() / 4)
    print(f"[7 time] K3 pool [{2 * BATCH},64,128,128] bf16: kernel {pool_ms:.4f} ms "
          f"(scalar variant {pool_scalar_ms:.4f}), plain {pool_plain_ms:.4f} ms, F.pad + "
          f"F.max_pool2d (two calls) {pool_two_calls_ms:.4f} ms, bound {pool_bound[0]:.4f} ms"
          f"  [{card}]")
    del xp
    t = {k: torch.from_numpy(v).to(dev) for k, v in tile_reqs[0].items()}
    wargs = (t["source"], t["warp_h"], t["warp_k"], t["warp_dist"], side)
    # each tile, its parameters and each output pixel once; about 60 float32
    # operations for an output pixel's ray, distortion and bilinear blend
    warp_out = BATCH * side * side * 3
    warp_forms = {}
    for epi, dt in warp.FORMS:
        call = lambda: warp.warp_images_cuda(*wargs, epilogue=epi, out_dtype=dt)  # noqa: E731
        r = warp_forms[epi, dt] = {
            "ms": device_ms(call, "warp_crop"), "call_ms": time_ms(call),
            "plain_ms": time_ms(lambda: warp.warp_images_plain(*wargs, epilogue=epi,
                                                               out_dtype=dt)),
            # the unfused chain: the kernel's [0,255] output through the plain epilogue
            "unfused_ms": time_ms(lambda: warp.apply_epilogue(warp.warp_images_cuda(*wargs),
                                                              epi, dt))}
        bms, by = bound(nbytes(*wargs[:4]) + warp_out * dt.itemsize, 60 * warp_out / 3)
        r.update(bound_ms=bms, bound_by=by, bound_share=bms / r["ms"])
        print(f"[7 time] K1 warp ({epi}, {str(dt)[6:]}) B={BATCH} {TILE}^2->256^2: kernel "
              f"{r['ms']:.4f} ms device time ({r['call_ms']:.4f} ms a call by CUDA events), "
              f"bound {bms:.4f} ms ({by}, {bms / r['ms']:.0%}), kernel + plain epilogue "
              f"{r['unfused_ms']:.4f} ms, plain chain {r['plain_ms']:.4f} ms  [{card}]")
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
            if form == "tiles" and flip_tta:
                print(profile_breakdown(lambda: fn(*args), steps=5,
                                        label=f"[7 time] profiler, tile-in TTA B={b}"))

    del model, est, fn, args
    torch.cuda.empty_cache()
    from metro_pose3d_tpu_torch.pipeline import device as pdevice
    from metro_pose3d_tpu_torch.pipeline.backgrounds import get_background_bank
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state
    from metro_pose3d_tpu_torch.train.trainer import _train_on_batches

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
    for shape, dtype, kind in (((96, 64, 128, 128), torch.bfloat16, "random"),
                               ((96, 64, 128, 128), torch.float32, "random"),
                               ((96, 64, 128, 128), torch.bfloat16, "relu"),
                               ((8, 64, 127, 129), torch.bfloat16, "ties"),
                               ((8, 24, 33, 18), torch.float32, "ties"),
                               ((8, 64, 128, 128), torch.bfloat16, "negative"),
                               ((4, 64, 127, 129), torch.bfloat16, "nan"),
                               ((3, 5, 15, 13), torch.float32, "relu")):
        x = pool_inputs(gen, dev, shape, dtype, kind)
        g = torch.randn((shape[0], shape[1], (shape[2] + 1) // 2, (shape[3] + 1) // 2),
                        generator=gen, device=dev).to(dtype)
        err, note = check_pool_bwd(pool, x, g, "same")
        bwd_err = max(bwd_err, err)
        y = pool.max_pool_plain(x)
        share = float((tie_count(x, y) > 1).float().mean())
        print(f"[9 k3-bwd] {tuple(shape)} {dtype} {kind}: {note}; windows with a tied max "
              f"{share:.3f}")
    del x, g, y

    # 10 train: the main path of this slice, counting kernel launches; the
    # batches carry foreground masks, so every step composites a background
    t0 = time.perf_counter()
    bg_np = get_background_bank(None, side=TILE)  # what train() builds for Config()
    n_bg = len(bg_np)
    host = [train_batch(rng, N3D, N2D, TILE, side, len(bank_np), n_bg=n_bg) for _ in range(10)]
    print(f"[10 train] 10 host batches of {N3D} 3D + {N2D} 2D rows, {TILE}^2 tiles with "
          f"foreground masks, and the background bank, made in {time.perf_counter() - t0:.1f} s")
    over = {"train.checkpoint_every": "5", "train.log_every": "1", "train.validate_every": "0"}
    composites = []  # (bank shape, device) of each background composite
    composite = pdevice.composite_background

    def counted_composite(src, mask, bg_bank, bg_params):
        composites.append((tuple(bg_bank.shape), bg_bank.device.type))
        return composite(src, mask, bg_bank, bg_params)

    pdevice.composite_background = counted_composite

    def run(logdir, extra, batches, steps, bg_bank=bg_np):
        tcfg = apply_overrides(Config(), {**over, **extra, "train.logdir": logdir})
        state = _train_on_batches(tcfg, batches, occluder_bank=bank_np, max_steps=steps,
                                  background_bank=bg_bank)
        torch.cuda.synchronize()
        with open(os.path.join(logdir, "history.json")) as f:
            return state, json.load(f)

    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "run")
        pool.reset_launches()
        warp.reset_launches()
        bn.reset_launches()
        occlusion.LAUNCHES = 0
        t0 = time.perf_counter()
        state, hist = run(logdir, {}, iter(host), 10, bg_bank=None)  # train() builds it
        first_leg = time.perf_counter() - t0
        # as if the run had been cut after its checkpoint at step 5
        for name in os.listdir(os.path.join(logdir, "checkpoints")):
            if name != "5":
                shutil.rmtree(os.path.join(logdir, "checkpoints", name))
        if Checkpointer(logdir).latest_step() != 5:
            fail("the checkpoint of step 5 is missing")
        warp_before = warp.LAUNCHES
        resumed, hist2 = run(logdir, {}, iter(host), 10)
        train_launches = {"pool": pool.MODE_LAUNCHES["same"],
                          "pool_bwd": pool.MODE_BWD_LAUNCHES["same"],
                          "warp": warp.LAUNCHES, "occluder": occlusion.LAUNCHES}
        if any(v == 0 for v in train_launches.values()):
            fail(f"the training path did not launch every kernel: {train_launches}")
        if bn.LAUNCHES:  # train-mode batch norm is PyTorch code
            fail(f"the training path launched the eval batch norm kernel: {bn.KERNEL_LAUNCHES}")
        check_pool_variants("training", ("fwd", "bwd"))
        check_warp_forms_launched("training", ("unit", torch.float32))
        train_forms = dict(warp.KERNEL_LAUNCHES)
        grad_copies = pool.GRAD_COPIES
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
              f"resumed 5 -> 10 (step-10 loss rel diff {d10:.1e}); launches {train_launches}, "
              f"warp launches by form {fmt_forms(train_forms, 'd')}, "
              f"pool variants {pool.VARIANT_LAUNCHES}; the gradient reaching the pool was "
              + ("channels_last at every backward launch" if grad_copies == 0 else
                 f"not channels_last at {grad_copies} of {train_launches['pool_bwd']} backward "
                 f"launches, and was copied"))
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
    pdevice.composite_background = composite
    want = [((n_bg, TILE, TILE, 3), "cuda")] * (10 + 5 + 20)
    if composites != want:
        fail(f"the train step did not composite every masked batch on the card with the bank "
             f"train() built: {len(composites)} composites, {sorted(set(composites))}")
    print(f"[10 train] background composite on the card at each of the {len(composites)} steps, "
          f"bank of {n_bg} procedural {TILE}^2 tiles, built by train() in the first run "
          f"(aug.background_prob {Config().aug.background_prob})")
    torch.cuda.empty_cache()

    # 11 train parity: one float32 step of a masked batch with the background
    # bank on the card and on the CPU, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = apply_overrides(Config(), {"model.compute_dtype": "float32", "model.proc_side": "128",
                                      "train.warmup_steps": "0"})
    pbatch = train_batch(rng, 3, 1, TILE, 128, len(bank_np), n_bg=n_bg)
    res = []
    for d in (dev, torch.device("cpu")):
        st = create_train_state(pcfg, d, seed=SEED + 2)
        step = make_train_step(pcfg, 0, occluder_bank=pack_occluder_bank_for(bank_np, d),
                               background_bank=torch.from_numpy(bg_np).to(d))
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
    print(f"[11 t-parity] one float32 step R50@128 B=4, masked, background bank of "
          f"{len(bg_np)}, {int(pbatch['bg_params'][:, 0].sum())}/4 composited, card vs CPU, TF32 "
          f"off: rel diff "
          + ", ".join(f"{k} {abs(mg[k] - mc[k]) / abs(mc[k]):.1e}" for k in TRAIN_PARITY_RTOL)
          + f" (rtol {TRAIN_PARITY_RTOL}); BN stats {stat_err:.1e} (atol {STATS_ATOL}); "
          f"params: median {float(diff.median()):.1e}, max {float(diff.max()):.1e} "
          f"(<= 2 lr), share within lr/10 {near:.5f}")
    del res, sg, sc

    # 12 timings (informative; the card's name and power limit beside each)
    occ_ms, occ_plain_ms = time_ms(lambda: occlusion.occlude_cuda(*k2_args)), time_ms(
        lambda: occlusion.occlude_plain(*k2_args))
    # crops in and out, the bank once; about 40 float32 operations a pixel
    occ_bound = bound(2 * nbytes(k2_args[0]) + nbytes(*k2_args[1:]), 40 * 96 * side * side)
    print(f"[12 t-time] K2 occluder paste B=96 {side}^2: kernel {occ_ms:.4f} ms, "
          f"plain {occ_plain_ms:.4f} ms, bound {occ_bound[0]:.4f} ms  [{card}]")
    xb = pool_inputs(gen, dev, (96, 64, 128, 128), torch.bfloat16, "random")
    xr = pool_inputs(gen, dev, (96, 64, 128, 128), torch.bfloat16, "relu")
    gb = torch.randn((96, 64, 64, 64), generator=gen, device=dev).to(torch.bfloat16)
    gb = gb.contiguous(memory_format=torch.channels_last)
    bwd_ms, bwd_plain_ms = time_ms(lambda: pool.max_pool_bwd_cuda(xb, gb)), time_ms(
        lambda: pool.max_pool_bwd_plain(xb, gb))
    bwd_relu_ms = time_ms(lambda: pool.max_pool_bwd_cuda(xr, gb))
    bwd_scalar_ms = time_ms(lambda: pool.max_pool_bwd_cuda(xb, gb, width=1))
    bwd_bound = bound(2 * nbytes(xb) + nbytes(gb), 9 * gb.numel())
    print(f"[12 t-time] K3-bwd [96,64,128,128] bf16: kernel {bwd_ms:.4f} ms random, "
          f"{bwd_relu_ms:.4f} ms post-ReLU (scalar variant {bwd_scalar_ms:.4f}), plain "
          f"{bwd_plain_ms:.4f} ms, bound {bwd_bound[0]:.4f} ms  [{card}]")
    del xb, xr, gb
    tcfg = Config()
    st = create_train_state(tcfg, dev, seed=SEED)
    tb = batch_to_device(host[0], dev)
    bg = torch.from_numpy(bg_np).to(dev)
    resident_ms = {}
    for what, step in (("no background bank", make_train_step(tcfg, 0, occluder_bank=bank)),
                       ("masked batch with the background bank",
                        make_train_step(tcfg, 0, occluder_bank=bank, background_bank=bg))):
        torch.cuda.reset_peak_memory_stats()
        step_ms = resident_ms[what] = time_ms(lambda: step(st, tb), iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[12 t-time] train step Config() R50@256 bf16 B={N3D + N2D}, {what}: "
              f"{step_ms:.2f} ms, {(N3D + N2D) / step_ms * 1e3:.1f} crops/s, peak {peak:.2f} GiB"
              f"  [{card}]")
    print(profile_breakdown(lambda: step(st, tb), steps=2))

    del st, step, tb, bg
    torch.cuda.empty_cache()

    modes = phase_pool_modes(gen, dev, card)  # 13
    fam_launches = phase_families_serving(rng, dev, card)  # 14
    ftrain_launches = phase_families_training(rng, dev, card, bank_np)  # 15
    probe_records = phase_probes(dev, card, rates)  # 16
    int8_records, int8_path = phase_int8(rng, gen, dev, card, rates)  # 17
    feed = phase_feed(rng, dev, card, resident_ms["no background bank"])  # 18
    dataset = phase_dataset(dev, card)  # 19
    mp = phase_multiperson(rng, dev, card)  # 20
    dp = phase_dp(dev, card, resident_ms["no background bank"])  # 21
    real = phase_real_files(dev, card)  # 22
    fin = phase_finish(rng, dev, card)  # 23
    bn_record = phase_bn(rng, gen, dev, card)  # 24
    dw_record, effv2 = phase_effv2(rng, gen, dev, card)  # 25
    bn_record["graph_replay_launches"] = {k: v["bn"] for k, v in fin["per_replay"].items()}
    bn_record["launches"] += int8_path["bn"] + dataset["bn"] + mp["bn"] + fin["bn"] + effv2["bn"]
    bn_record["per_path"].update({**int8_path["bn_forward"], **dataset["bn_forward"],
                                  **mp["bn_forward"], **effv2["bn_forward"], "train_step": 0})
    bn_record["effv2_forward_ms"] = effv2["bn_ms"]
    int8_records[0]["launches"] += dataset["qk1"] + mp["qk1"] + fin["qk1"]
    int8_records[1]["launches"] += dataset["qk2"] + mp["qk2"] + fin["qk2"]
    # launches of one replay of phase 23's CUDA graphs, by bundle
    int8_records[0]["graph_replay_launches"] = {k: v["qk1"] for k, v in fin["per_replay"].items()}
    int8_records[1]["graph_replay_launches"] = {k: v["qk2"] for k, v in fin["per_replay"].items()}

    def kernel(name, source, replaces, n_launches, err, ms, plain_ms, bnd, library_ms, **more):
        return {"name": name, "route": "cuda",
                "source": f"metro_pose3d_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms, **more}


    pallas_pool = "metro_pose3d_tpu/ops/pool_pallas.py:90"
    none = warp_forms[WARP_FORM_NONE]
    mode_launches = {
        ("torch", "fwd"): fam_launches["a_torchvision_r50"]["pool_torch"]
        + fam_launches["c_torchvision_r34"]["pool_torch"] + ftrain_launches["pool_torch"],
        ("torch", "bwd"): ftrain_launches["pool_torch_bwd"],
        ("keras", "fwd"): fam_launches["b_keras_v2_r50"]["pool_keras"]
        + ftrain_launches["pool_keras"],
        ("keras", "bwd"): ftrain_launches["pool_keras_bwd"],
    }
    record = {"kernels": [
        kernel("maxpool3x3s2_same", "maxpool3x3s2.cu", pallas_pool,
               launches["pool"] + train_launches["pool"] + fam_launches["d_twofive"]["pool_same"]
               + int8_path["pool"] + feed["pool"] + dataset["pool"] + mp["pool"] + dp["pool"]
               + real["pool"] + fin["pool"],
               pool_err, pool_ms, pool_plain_ms, pool_bound, None,
               bound_share=pool_bound[0] / pool_ms, two_calls_ms=pool_two_calls_ms,
               ms_scalar=pool_scalar_ms,
               graph_replay_launches={k: v["pool"] for k, v in fin["per_replay"].items()}),
        kernel("maxpool3x3s2_same_bwd", "maxpool3x3s2_bwd.cu", pallas_pool,
               train_launches["pool_bwd"] + feed["pool_bwd"] + mp["pool_bwd"] + dp["pool_bwd"]
               + real["pool_bwd"],
               bwd_err, bwd_ms,
               bwd_plain_ms, bwd_bound, None,
               bound_share=bwd_bound[0] / bwd_ms, ms_relu=bwd_relu_ms, ms_scalar=bwd_scalar_ms),
        *[kernel(f"maxpool3x3s2_{mode}" + ("_bwd" if way == "bwd" else ""),
                 "maxpool3x3s2_bwd.cu" if way == "bwd" else "maxpool3x3s2.cu", pallas_pool,
                 mode_launches[mode, way], r["max_abs_err"], r["ms"], r["plain_ms"], r["bound"],
                 r["library_ms"], bound_share=r["bound"][0] / r["ms"],
                 **{k: r[k] for k in ("two_calls_ms", "argmax_gradient_ms", "ms_relu",
                                      "ms_scalar") if k in r})
          for (mode, way), r in modes.items()],
        kernel("warp_crop", "warp_crop.cu", "metro_pose3d_tpu/ops/warp_pallas.py:415",
               launches["warp"] + train_launches["warp"] + int8_path["warp"] + feed["warp"]
               + dataset["warp"] + mp["warp"] + dp["warp"] + real["warp"]
               + sum(fin["warp_forms"].values()),
               warp_max, none["ms"],
               none["plain_ms"],
               (none["bound_ms"], none["bound_by"]), None, call_ms=none["call_ms"],
               bound_share=none["bound_share"],
               forms={f"{e}_{str(d)[6:]}": {**r, "launches": serve_forms[e, d] + train_forms[e, d]
                                                + int8_path["warp_forms"][e, d]
                                                + feed["warp_forms"].get((e, d), 0)
                                                + dataset["warp_forms"].get((e, d), 0)
                                                + mp["warp_forms"][e, d]
                                                + (dp["warp_unit"] if e == "unit" else 0)
                                                + real["warp_forms"].get((e, d), 0)
                                                + fin["warp_forms"].get((e, d), 0)}
                      for (e, d), r in warp_forms.items()}),
        kernel("occluder_paste", "occluder_paste.cu", "metro_pose3d_tpu/ops/warp_pallas.py:507",
               train_launches["occluder"] + feed["occluder"] + mp["occluder"] + dp["occluder"]
               + real["occluder"],
               occ_err, occ_ms,
               occ_plain_ms, occ_bound, None),
        *probe_records,
        *int8_records,
        bn_record,
        dw_record,
    ]}
    for k in record["kernels"]:
        if k["launches"] == 0:
            fail(f"kernel {k['name']} was launched by no path of this run")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
