"""Synthetic occlusion: paste an RGBA occluder from a uint8 bank over each
crop (`metro_pose3d_tpu/ops/occlusion.py::occlude_with_bank`).

Per crop b, with the [2,3] placement A_b (crop pixel -> tile pixel):
    (u, v)  = A_b (x, y, 1)                    (products and sums in float32)
    rgba    = bilinear sample of bank tile idx[b] at (u, v), each of the
              four taps zero outside the tile, texels scaled by 1/255
    rgba   *= enabled[b]                       (0 = no occluder)
    out     = crop * (1 - alpha) + rgb * alpha (`paste_rgba`)
An index outside the bank gives a transparent occluder.

The bank lives on the device once, as uint8 RGBA [N,T,T,4], quantised as
the JAX package quantises it: clip(round(x * 255)). `occlude_with_bank`
takes the plain PyTorch version for CPU tensors and launches the CUDA
kernel (csrc/occluder_paste.cu) for CUDA tensors. Both compute the direct
affine map; the TPU's packed int32 texels, transposed-tile route and
128-lane padding are not carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.kernels import build

LAUNCHES = 0  # kernel launches by `occlude_with_bank` on CUDA tensors

_INV255 = 1.0 / 255.0  # one float32 constant in both versions


def pack_occluder_bank(bank_rgba01) -> torch.Tensor:
    """[N,T,T,4] float RGBA in [0, 1] -> uint8 [N,T,T,4] (CPU tensor)."""
    x = torch.as_tensor(np.asarray(bank_rgba01, np.float32))
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def paste_rgba(crops, rgba):
    """Alpha-composite [B,S,S,4] occluders over [B,S,S,3] crops."""
    alpha = rgba[..., 3:4]
    return crops * (1.0 - alpha) + rgba[..., :3] * alpha


def occlude_plain(crops, bank_u8, tile_indices, placements, enabled):
    """The direct map in plain PyTorch: float32 crops [B,S,S,3] -> [B,S,S,3]."""
    b, s = crops.shape[0], crops.shape[1]
    n, t = bank_u8.shape[0], bank_u8.shape[1]
    dev = crops.device
    idx = tile_indices.long()
    valid = (idx >= 0) & (idx < n)
    on = enabled.float() * valid.float()
    base = (torch.where(valid, idx, 0) * (t * t)).reshape(b, 1, 1)
    a = placements.float().reshape(b, 6, 1, 1)
    ys = torch.arange(s, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    u = a[:, 0] * xs + a[:, 1] * ys + a[:, 2]
    v = a[:, 3] * xs + a[:, 4] * ys + a[:, 5]
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    flat = bank_u8.reshape(n * t * t, 4)

    def tap(yf, xf):
        # inside-ness tested on the float tap, which also sends NaN outside
        inside = (xf >= 0) & (xf < t) & (yf >= 0) & (yf < t)
        lin = base + (torch.where(inside, yf, 0.0).long() * t
                      + torch.where(inside, xf, 0.0).long())
        vals = flat[lin.reshape(-1)].reshape(*lin.shape, 4).float() * _INV255
        return torch.where(inside[..., None], vals, 0.0)

    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    rgba = (w00 * tap(y0, x0) + w01 * tap(y0, x0 + 1)
            + w10 * tap(y0 + 1, x0) + w11 * tap(y0 + 1, x0 + 1))
    rgba = rgba * on[:, None, None, None]
    return paste_rgba(crops, rgba)


def _check(crops, bank_u8, tile_indices, placements, enabled):
    if crops.dtype != torch.float32 or crops.dim() != 4 or crops.shape[-1] != 3:
        raise ValueError(
            f"occluder paste takes float32 [B,S,S,3] crops, got {crops.dtype} "
            f"{tuple(crops.shape)}")
    if (bank_u8.dtype != torch.uint8 or bank_u8.dim() != 4 or bank_u8.shape[-1] != 4
            or bank_u8.shape[1] != bank_u8.shape[2]):
        raise ValueError(
            f"occluder paste takes a uint8 [N,T,T,4] bank, got {bank_u8.dtype} "
            f"{tuple(bank_u8.shape)}")
    b = crops.shape[0]
    if (tuple(tile_indices.shape) != (b,) or tuple(placements.shape) != (b, 2, 3)
            or tuple(enabled.shape) != (b,)):
        raise ValueError(
            f"occluder paste takes indices [B], placements [B,2,3], enabled [B]; got "
            f"{tuple(tile_indices.shape)}, {tuple(placements.shape)}, {tuple(enabled.shape)}")
    if len({t.device for t in (crops, bank_u8, tile_indices, placements, enabled)}) != 1:
        raise ValueError("occluder paste inputs must all lie on one device")


def occlude_cuda(crops, bank_u8, tile_indices, placements, enabled):
    """Launch the CUDA kernel (csrc/occluder_paste.cu)."""
    global LAUNCHES
    if not crops.is_cuda:
        raise ValueError(f"occlude_cuda needs CUDA tensors, got {crops.device}")
    _check(crops, bank_u8, tile_indices, placements, enabled)
    b, s = crops.shape[0], crops.shape[1]
    n, t = bank_u8.shape[0], bank_u8.shape[1]
    src = crops.contiguous()
    bank = bank_u8.contiguous()
    idx = tile_indices.to(torch.int32).contiguous()
    aff = placements.float().contiguous()
    on = enabled.float().contiguous()
    out = torch.empty_like(src)
    lib = build.load()
    with torch.cuda.device(crops.device):
        err = lib.metro_occluder_paste(
            src.data_ptr(), bank.data_ptr(), idx.data_ptr(), aff.data_ptr(), on.data_ptr(),
            out.data_ptr(), b, n, t, s, torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_occluder_paste")
    LAUNCHES += 1
    return out


def occlude_with_bank(crops, bank_u8, tile_indices, placements, enabled):
    """Paste occluders from the uint8 bank: crops [B,S,S,3] float32 in [0, 1],
    bank [N,T,T,4] uint8, tile_indices [B] int, placements [B,2,3] crop px ->
    tile px, enabled [B] {0, 1}. The plain version runs for CPU tensors, the
    kernel for CUDA."""
    if crops.device.type == "cpu":
        _check(crops, bank_u8, tile_indices, placements, enabled)
        return occlude_plain(crops, bank_u8, tile_indices, placements, enabled)
    if crops.is_cuda:
        return occlude_cuda(crops, bank_u8, tile_indices, placements, enabled)
    raise ValueError(f"occlude_with_bank: unsupported device {crops.device}")
