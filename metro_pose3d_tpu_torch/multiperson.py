"""Multi-person estimation on full frames (`metro_pose3d_tpu/multiperson.py`;
BASELINE.json configuration 5).

Full frame + detector boxes -> batched MeTRo crops -> crop-in/skeleton-out
forward -> absolute metric back-projection, with every person's pose in the
ORIGINAL camera's frame, so that a frame's skeletons share one 3D space.

* Frame mode (the default) ships the frame to the device once and warps
  every person's crop out of it in one K1 launch (`ops.warp.warp_from_frame`,
  crop parameters in frame pixels, the `normalize_div` epilogue: the
  reference normalizes `warp / 255.0`). Tile mode cuts one source tile per
  person on the host and runs the tile-in leg (`pipeline.device.device_augment`).
* The person count varies from frame to frame; the crops are padded to the
  next bucket (powers of two, by repeating the last crop), so the kernels
  and cuDNN see a few batch shapes only, each planned once (`warmup`).
* `_dispatch` queues a frame's work, and the copy of its outputs into
  pinned host memory behind it, without waiting for the card; `_collect`
  waits for that copy alone (an event, not `.cpu()`, which would also wait
  for every frame queued behind it on the stream): the only
  synchronisation. `estimate_stream` keeps frames in flight, so that the
  host's work on frame i+1 may overlap the card's on frame i.
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.config import Config
from metro_pose3d_tpu_torch.geom.camera import Camera, reproject_image_points
from metro_pose3d_tpu_torch.geom.joints import JointInfo
from metro_pose3d_tpu_torch.models.metro import MetroModel, decode_metro
from metro_pose3d_tpu_torch.ops.decode import root_relative
from metro_pose3d_tpu_torch.ops.pose3d import reconstruct_absolute, rescale_to_bone_lengths
from metro_pose3d_tpu_torch.ops.tta import flip_crop, unflip_pose2d, unflip_pose3d
from metro_pose3d_tpu_torch.ops.warp import warp_from_frame
from metro_pose3d_tpu_torch.pipeline.crops import (
    prepare_inference_crop, prepare_inference_crop_params,
)
from metro_pose3d_tpu_torch.pipeline.device import device_augment

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
PARAM_KEYS = ("warp_h", "warp_k", "warp_dist", "intrinsics", "rot_to_orig")  # float32, per crop
TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


def rotate(rot, points):
    """rot [B,3,3] applied to points [B,J,3]: out[b,k,i] = sum_j rot[b,i,j]
    points[b,k,j], as float32 products and sums. A matmul may round its
    inputs to TF32 on the card, millimetres at metre-scale coordinates; the
    reference asks for Precision.HIGHEST."""
    r = rot.float()[:, None]  # [B,1,3,3]
    p = points.float()
    return r[..., 0] * p[..., 0:1] + r[..., 1] * p[..., 1:2] + r[..., 2] * p[..., 2:3]


def make_multiperson_predict_fn(
    cfg: Config,
    mirror_mapping: np.ndarray,
    root_index: int = 0,
    flip_tta: bool | None = None,
    bone_edges: np.ndarray | None = None,
    mean_bones: np.ndarray | None = None,
    frame_mode: bool = False,
):
    """-> predict(model, batch): per-crop poses rotated into the original
    camera's frame by the batch's `rot_to_orig` [B,3,3].

    The batch holds tensors on the model's device: "warp_h", "warp_k",
    "warp_dist", "intrinsics", "rot_to_orig" and, in frame mode, "frame"
    uint8 [H,W,3] with the warp parameters in frame pixels, else "source"
    uint8 [B,T,T,3] tiles. Returns pose3d_abs and pose3d_rootrel (mm, in the
    original camera's frame) and pose2d_crop_px. Flip TTA runs as one
    doubled batch. The absolute reconstruction is the full perspective one
    whatever `eval.reconstruction` says, as in the reference."""
    mcfg = cfg.model
    flip_tta = cfg.eval.flip_tta if flip_tta is None else flip_tta
    use_bones = (cfg.eval.scale_recovery == "bone_lengths"
                 and bone_edges is not None and mean_bones is not None)
    host = {
        "mirror": torch.as_tensor(np.asarray(mirror_mapping), dtype=torch.long),
        "edges": None if bone_edges is None else torch.as_tensor(
            np.asarray(bone_edges), dtype=torch.long),
        "bones": None if mean_bones is None else torch.as_tensor(
            np.asarray(mean_bones), dtype=torch.float32),
    }
    per_device = {}

    def consts(device):
        if device not in per_device:
            per_device[device] = {k: None if v is None else v.to(device)
                                  for k, v in host.items()}
        return per_device[device]

    @torch.inference_mode()
    def predict(model: MetroModel, batch: dict) -> dict:
        if frame_mode:
            crops = warp_from_frame(batch["frame"], batch["warp_h"], batch["warp_k"],
                                    batch["warp_dist"], mcfg.proc_side,
                                    epilogue="normalize_div", out_dtype=model.dtype)
        else:
            crops = device_augment(batch, mcfg.proc_side, train=False, out_dtype=model.dtype)
        c = consts(crops.device)
        b = crops.shape[0]
        if flip_tta:
            both = torch.cat([crops, flip_crop(crops)], dim=0)
            p3, p2 = decode_metro(*model(both), mcfg)
            pose3d = 0.5 * (p3[:b] + unflip_pose3d(p3[b:], c["mirror"]))
            pose2d = 0.5 * (p2[:b] + unflip_pose2d(p2[b:], c["mirror"], mcfg.proc_side))
        else:
            pose3d, pose2d = decode_metro(*model(crops), mcfg)

        pose3d_rel = root_relative(pose3d, root_index)
        if use_bones:
            pose3d_rel = rescale_to_bone_lengths(pose3d_rel, c["edges"], c["bones"])
        pose3d_abs = reconstruct_absolute(pose3d_rel, pose2d, batch["intrinsics"])
        rot = batch["rot_to_orig"]
        return {"pose3d_abs": rotate(rot, pose3d_abs),
                "pose3d_rootrel": rotate(rot, pose3d_rel),
                "pose2d_crop_px": pose2d}

    return predict


class MultiPersonEstimator:
    """image + boxes -> absolute skeletons (mm) in the frame's camera, with a
    `MetroModel` on its device."""

    def __init__(self, cfg: Config, model: MetroModel, joint_info: JointInfo,
                 root_name: str = "pelv", buckets=DEFAULT_BUCKETS, frame_mode: bool = True,
                 **predict_kw):
        self.cfg = cfg
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.joint_info = joint_info
        self.buckets = tuple(sorted(buckets))
        self.frame_mode = frame_mode
        root = joint_info.names.index(root_name) if root_name in joint_info.names else 0
        self._predict = make_multiperson_predict_fn(
            cfg, joint_info.mirror_mapping, root_index=root, frame_mode=frame_mode,
            **predict_kw)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def warmup(self, max_people: int, imshape=None, camera=None) -> int:
        """Run every bucket up to the one of `max_people` once on a blank
        frame of `imshape` (default 720p), so that a stream meets no
        first-call cost (cuDNN's plans, the kernel build) mid-video.
        Returns the number of buckets run."""
        h, w = imshape if imshape is not None else (720, 1280)
        image = np.zeros((h, w, 3), np.uint8)
        if camera is None:
            camera = Camera.from_fov(60.0, (h, w))
        side = min(h, w) // 3
        box = [w // 2 - side // 2, h // 2 - side // 2, side, side]
        built = 0
        for b in self.buckets:
            if b > self._bucket(max_people):
                break
            self._collect(*self._dispatch(image, np.asarray([box] * b, np.float64), camera))
            built += 1
        return built

    def _staged(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of the host array `arr` on the model's device, made without
        waiting for the card, so the caller may reuse `arr` at once. On the
        card the copy goes through a pinned buffer of its own: PyTorch's
        pinned allocator hands it to no one else before the copy to the
        device is done."""
        pinned = self.device.type == "cuda"
        t = torch.empty(arr.shape, dtype=TORCH_DTYPES[arr.dtype], pin_memory=pinned)
        t.numpy()[...] = arr
        return t.to(self.device, non_blocking=True) if pinned else t

    def _dispatch(self, image: np.ndarray, boxes: np.ndarray, camera: Camera):
        """Host prep, copies and the predict call for one frame (0 < N <=
        the largest bucket), with no synchronisation. Returns the outputs
        (on the card: their copies to pinned host memory under way, and the
        event that marks the end of the copies) and the host context
        `_collect` needs."""
        n = len(boxes)
        cfg = self.cfg
        if self.frame_mode:
            prepared = [prepare_inference_crop_params(
                box, camera, cfg.model.proc_side, cfg.data.test_box_expansion,
                engine=cfg.data.host_prep) for box in boxes]
        else:
            prepared = [prepare_inference_crop(
                image, box, camera, cfg.model.proc_side, cfg.data.source_side,
                cfg.data.test_box_expansion, engine=cfg.data.host_prep) for box in boxes]
        crop_cams = [p.pop("_crop_cam") for p in prepared]
        prepared += [prepared[-1]] * (self._bucket(n) - n)  # pad with the last crop
        batch = {k: self._staged(np.stack([p[k] for p in prepared])) for k in PARAM_KEYS}
        if self.frame_mode:
            # cut to an even width, as the reference does: a box on the right
            # edge of an odd-width frame samples zeros past column W//2*2
            batch["frame"] = self._staged(image[:, : image.shape[1] // 2 * 2])
        else:
            batch["source"] = self._staged(np.stack([p["source"] for p in prepared]))
        out = {k: v[:n] for k, v in self._predict(self.model, batch).items()}
        done = None
        if self.device.type == "cuda":
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in out.items()}
            for k, v in out.items():
                host[k].copy_(v, non_blocking=True)
            out, done = host, torch.cuda.Event()
            done.record()
        return (out, done), n, crop_cams, camera

    def _collect(self, pending: tuple, n: int, crop_cams: list, camera: Camera) -> dict:
        """Wait for one dispatched frame's outputs to reach the host and
        finish the host work: the 2D joints back in full-image pixels
        through each crop camera."""
        out, done = pending
        if done is not None:
            done.synchronize()
        # copies: an array that shared a pinned buffer would keep it from the
        # allocator for as long as the caller keeps the result
        out = {k: v.numpy().copy() for k, v in out.items()}
        pose2d_px = np.stack([
            reproject_image_points(out["pose2d_crop_px"][i], crop_cams[i], camera)
            for i in range(n)]).astype(np.float32)
        return {"pose3d_abs": out["pose3d_abs"], "pose3d_rootrel": out["pose3d_rootrel"],
                "pose2d_px": pose2d_px}

    def estimate_frame(self, image: np.ndarray, boxes, camera: Camera | None = None) -> dict:
        """boxes: [N, 4] (x, y, w, h) detector boxes. `camera` defaults to a
        60-degree pinhole at the image centre. Returns a dict of [N, ...]
        numpy arrays; `pose2d_px` is in full-image pixels."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        if camera is None:
            camera = Camera.from_fov(60.0, image.shape[:2])
        n = len(boxes)
        if n == 0:
            j = self.joint_info.n_joints
            return {"pose3d_abs": np.zeros((0, j, 3), np.float32),
                    "pose3d_rootrel": np.zeros((0, j, 3), np.float32),
                    "pose2d_px": np.zeros((0, j, 2), np.float32)}
        if n > self.buckets[-1]:  # in chunks of the largest bucket
            top = self.buckets[-1]
            parts = [self.estimate_frame(image, boxes[s:s + top], camera)
                     for s in range(0, n, top)]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return self._collect(*self._dispatch(image, boxes, camera))

    def estimate_stream(self, frames, depth: int = 2):
        """Per-frame estimation of a stream of (image, boxes[, camera]),
        yielding what `estimate_frame` gives, in order, with up to `depth`
        frames in flight. Frames without boxes ride the queue as ready
        results; a frame with more boxes than the largest bucket drains it
        (its chunks run one after another)."""
        pending: list = []  # ("d", dispatched frame) | ("r", ready result)

        def pop():
            kind, payload = pending.pop(0)
            return payload if kind == "r" else self._collect(*payload)

        for frame in frames:
            image, boxes, *rest = frame
            camera = rest[0] if rest else None
            boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
            if camera is None:
                camera = Camera.from_fov(60.0, image.shape[:2])
            if len(boxes) > self.buckets[-1]:
                while pending:
                    yield pop()
                yield self.estimate_frame(image, boxes, camera)
                continue
            if len(boxes) == 0:
                pending.append(("r", self.estimate_frame(image, boxes, camera)))
            else:
                pending.append(("d", self._dispatch(image, boxes, camera)))
            if len(pending) >= max(depth, 1):
                yield pop()
        while pending:
            yield pop()

    def estimate_batch(self, frames) -> list:
        """A list of (image, boxes[, camera]) -> the list of results, through
        `estimate_stream`."""
        return list(self.estimate_stream(iter(frames)))
