"""Crop warp: homography + lens distortion + bilinear sampling, on the device.

Map for output pixel p = (x, y, 1) of crop b (`metro_pose3d_tpu/ops/warp.py`):
    ray    = H_b @ p                (H = R_src R_dst^T K_dst^{-1})
    (xn,yn)= ray.xy / ray.z         (perspective divide)
    (xd,yd)= distort(xn, yn)        (OpenCV k1,k2,p1,p2,k3 model)
    src_px = (fx*xd + cx, fy*yd + cy)
then bilinear sampling with a zero border, and zero where the ray is not in
front of the camera (ray.z <= 1e-9).

An epilogue maps the float32 [0,255] samples to what the caller feeds on:
    none       float32 [0,255]
    unit       `x * (1/255)`, float32 [0,1] (the train leg, before the
               occluder paste)
    normalize  `normalize(x * (1/255))`, float32 or bf16 [-1,1] (tile-in
               serving)
    normalize_div  `normalize(x / 255)`, float32 or bf16 [-1,1] (the
               multi-person frame path, whose reference divides)
each step rounded in float32 as the unfused PyTorch chain rounds it.
`warp_from_frame` samples many crops out of one shared frame.

`warp_images` takes the plain PyTorch version for CPU tensors and launches
the CUDA kernel (csrc/warp_crop.cu, the epilogue fused into its store) for
CUDA tensors. Both compute the exact direct map; the TPU's two-pass
approximation is not carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch import reference_constants as C
from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.ops.color import normalize

EPILOGUES = ("none", "unit", "normalize", "normalize_div")
# (epilogue, output dtype) -> kernel launches on CUDA tensors. `LAUNCHES`
# (the total) is a view of it.
FORMS = (("none", torch.float32), ("unit", torch.float32), ("normalize", torch.float32),
         ("normalize", torch.bfloat16), ("normalize_div", torch.float32),
         ("normalize_div", torch.bfloat16))
KERNEL_LAUNCHES = dict.fromkeys(FORMS, 0)
# the epilogue's constants as PyTorch rounds the Python scalars of
# `x * (1.0 / 255.0)` and `normalize`: float32 values
UNIT = float(np.float32(1.0 / 255.0))
SCALE = float(np.float32(255.0 * C.IMAGE_SCALE))
OFFSET = float(np.float32(C.IMAGE_OFFSET))


def __getattr__(name: str):
    if name == "LAUNCHES":
        return sum(KERNEL_LAUNCHES.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    KERNEL_LAUNCHES.update(dict.fromkeys(KERNEL_LAUNCHES, 0))


def distort_points(xn, yn, dist):
    """OpenCV distortion of normalized coords; dist [B,5] against xn, yn [B,...]."""
    k1, k2, p1, p2, k3 = (dist[:, i].reshape(-1, *([1] * (xn.dim() - 1))) for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def warp_coords(h_mats, k_vecs, dists, out_side: int):
    """Source-pixel coordinates of every output pixel, per crop.

    h_mats [B,3,3], k_vecs [B,4] = fx,fy,cx,cy, dists [B,5] ->
    coords [B,S,S,2] (x, y) float32 and in_front [B,S,S] bool.
    """
    dev = h_mats.device
    h = h_mats.float().reshape(-1, 9, 1, 1)
    ys = torch.arange(out_side, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_side, dtype=torch.float32, device=dev)[None, :]
    # written out term by term in float32, the reference's Precision.HIGHEST
    rx = h[:, 0] * xs + h[:, 1] * ys + h[:, 2]
    ry = h[:, 3] * xs + h[:, 4] * ys + h[:, 5]
    rz = h[:, 6] * xs + h[:, 7] * ys + h[:, 8]
    in_front = rz > 1e-9
    zsafe = torch.where(in_front, rz, torch.ones_like(rz))
    xd, yd = distort_points(rx / zsafe, ry / zsafe, dists.float())
    k = k_vecs.float()[:, :, None, None]
    u = xd * k[:, 0] + k[:, 2]
    v = yd * k[:, 1] + k[:, 3]
    return torch.stack([u, v], dim=-1), in_front


def bilinear_sample(images, coords, valid_mask=None, source_indices=None):
    """Bilinear sample of images [N,Hs,Ws,C] at coords [B,S,S,2] (x, y).

    Crop b reads image `source_indices[b]` (default: image b). Zero outside
    the image and where `valid_mask` is false; pixel centres at integers.
    Returns float32 [B,S,S,C].
    """
    n, hs, ws, c = images.shape
    b = coords.shape[0]
    if source_indices is None:
        source_indices = torch.arange(b, device=images.device)
    flat = images.float().reshape(n * hs * ws, c)
    base = (source_indices.long() * (hs * ws)).reshape(b, 1, 1)
    u, v = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0

    def tap(yf, xf):
        # inside-ness tested on the float tap, which also sends NaN outside
        inside = (xf >= 0) & (xf < ws) & (yf >= 0) & (yf < hs)
        lin = base + (torch.where(inside, yf, 0.0).long() * ws
                      + torch.where(inside, xf, 0.0).long())
        vals = flat[lin.reshape(-1)].reshape(*lin.shape, c)
        return torch.where(inside[..., None], vals, 0.0)

    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    out = (w00 * tap(y0, x0) + w01 * tap(y0, x0 + 1)
           + w10 * tap(y0 + 1, x0) + w11 * tap(y0 + 1, x0 + 1))
    if valid_mask is not None:
        out = torch.where(valid_mask[..., None], out, 0.0)
    return out


def apply_epilogue(crops, epilogue: str = "none", out_dtype=torch.float32):
    """The plain epilogue: float32 [0,255] crops -> the epilogue's units in
    `out_dtype`, by the unfused chain the kernel's store reproduces."""
    if epilogue == "normalize_div":
        # an IEEE division: on CUDA, a tensor divided by a Python scalar is
        # multiplied by the scalar's reciprocal, so divide by a tensor
        crops = crops / crops.new_full((), 255.0)
    elif epilogue != "none":
        crops = crops * (1.0 / 255.0)
    if epilogue.startswith("normalize"):
        crops = normalize(crops)
    return crops.to(out_dtype)


def warp_images_plain(sources, h_mats, k_vecs, dists, out_side: int,
                      source_indices=None, epilogue: str = "none", out_dtype=torch.float32):
    """The direct map in plain PyTorch, then the epilogue:
    [N,Hs,Ws,C] -> [B,S,S,C] in `out_dtype`."""
    coords, in_front = warp_coords(h_mats, k_vecs, dists, out_side)
    return apply_epilogue(bilinear_sample(sources, coords, in_front, source_indices),
                          epilogue, out_dtype)


def _check_form(epilogue, out_dtype):
    if (epilogue, out_dtype) not in KERNEL_LAUNCHES:
        raise ValueError(f"warp epilogue {epilogue!r} in {out_dtype}: the forms are "
                         f"{[(e, str(d)) for e, d in FORMS]}")


def _check(sources, h_mats, k_vecs, dists, source_indices):
    if sources.dtype != torch.uint8 or sources.dim() != 4 or sources.shape[-1] != 3:
        raise ValueError(
            f"warp takes uint8 [N,H,W,3] sources, got {sources.dtype} {tuple(sources.shape)}")
    b = h_mats.shape[0]
    if (tuple(h_mats.shape) != (b, 3, 3) or tuple(k_vecs.shape) != (b, 4)
            or tuple(dists.shape) != (b, 5)):
        raise ValueError(
            f"warp takes H [B,3,3], K [B,4], dist [B,5]; got {tuple(h_mats.shape)}, "
            f"{tuple(k_vecs.shape)}, {tuple(dists.shape)}")
    if source_indices is None:
        if sources.shape[0] != b:
            raise ValueError(
                f"{sources.shape[0]} sources for {b} crops need source_indices")
    elif tuple(source_indices.shape) != (b,):
        raise ValueError(f"source_indices must be [B], got {tuple(source_indices.shape)}")
    tensors = (sources, h_mats, k_vecs, dists) + (
        () if source_indices is None else (source_indices,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("warp inputs must all lie on one device")


def warp_images_cuda(sources, h_mats, k_vecs, dists, out_side: int,
                     source_indices=None, epilogue: str = "none", out_dtype=torch.float32):
    """Launch the CUDA kernel (csrc/warp_crop.cu) with its fused epilogue."""
    if not sources.is_cuda:
        raise ValueError(f"warp_images_cuda needs CUDA tensors, got {sources.device}")
    _check(sources, h_mats, k_vecs, dists, source_indices)
    _check_form(epilogue, out_dtype)
    b = h_mats.shape[0]
    n, th, tw, _ = sources.shape
    if th * tw * 3 >= 2**31:
        raise ValueError(f"warp: a {th}x{tw} source is too large for 32-bit offsets")
    dev = sources.device
    src = sources.contiguous()
    params = torch.cat([h_mats.reshape(b, 9), k_vecs, dists], dim=1).float().contiguous()
    if source_indices is None:
        idx = torch.arange(b, dtype=torch.int32, device=dev)
    else:
        # out-of-range indices give zero crops in the kernel (no host sync here)
        idx = source_indices.to(torch.int32).contiguous()
    out = torch.empty((b, out_side, out_side, 3), dtype=out_dtype, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.metro_warp_crop(
            src.data_ptr(), params.data_ptr(), idx.data_ptr(), out.data_ptr(),
            b, n, th, tw, out_side, EPILOGUES.index(epilogue), int(out_dtype == torch.bfloat16),
            UNIT, SCALE, OFFSET, torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_warp_crop")
    KERNEL_LAUNCHES[epilogue, out_dtype] += 1
    return out


def warp_images(sources, h_mats, k_vecs, dists, out_side: int, source_indices=None,
                epilogue: str = "none", out_dtype=torch.float32):
    """Batched crop warp: uint8 [N,Hs,Ws,3] -> [B,S,S,3], float32 in [0,255]
    by default, or through `epilogue` (`EPILOGUES`) in `out_dtype` (bf16 only
    with "normalize").

    With `source_indices` [B], crop b samples source `source_indices[b]`
    (one shared frame: N=1 and all-zero indices); by default crop b samples
    source b. The plain version runs for CPU tensors, the kernel for CUDA.
    """
    if sources.device.type == "cpu":
        _check(sources, h_mats, k_vecs, dists, source_indices)
        _check_form(epilogue, out_dtype)
        if source_indices is not None and source_indices.numel() and (
                int(source_indices.min()) < 0
                or int(source_indices.max()) >= sources.shape[0]):
            raise ValueError(f"source_indices out of range [0, {sources.shape[0]})")
        return warp_images_plain(sources, h_mats, k_vecs, dists, out_side, source_indices,
                                 epilogue, out_dtype)
    if sources.is_cuda:
        return warp_images_cuda(sources, h_mats, k_vecs, dists, out_side, source_indices,
                                epilogue, out_dtype)
    raise ValueError(f"warp_images: unsupported device {sources.device}")


def warp_from_frame(frame_u8, h_mats, k_vecs, dists, out_side: int, epilogue: str = "none",
                    out_dtype=torch.float32):
    """Warp many crops out of one shared frame (the multi-person frame path):
    frame_u8 uint8 [H,W,3], per-crop parameters in frame pixel coordinates
    -> [B,S,S,3]. One K1 launch with every crop reading source 0."""
    b = h_mats.shape[0]
    idx = torch.zeros(b, dtype=torch.int32, device=frame_u8.device)
    return warp_images(frame_u8[None], h_mats, k_vecs, dists, out_side, idx, epilogue,
                       out_dtype)
