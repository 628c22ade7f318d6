"""3x3 stride-2 SAME max pool (the ResNet stem pool): CUDA kernel + plain version.

Semantics match TF/XLA "SAME" (`metro_pose3d_tpu/ops/pool_pallas.py`):
output (i, j) is the max over input rows and columns 2i..2i+2 (for even
sizes; the pad is on the high side only), with -inf outside. For odd sizes
the pad splits as XLA splits it, lo = total // 2, like
`_maxpool_reference_odd`.

Trap: `F.max_pool2d(x, 3, 2, padding=1)` pads symmetrically, which puts the
window at 2i-1..2i+1, one pixel off SAME.

Tensors are NCHW; the kernels take them in `torch.channels_last` memory
format (NHWC in memory), the layout the backbone runs in.

Gradient: JAX training differentiates the shift-and-max chain
(`stem_max_pool(train=True)` -> `_maxpool_reference[_odd]`), and so does
autograd through `max_pool_plain`: `torch.maximum` splits a tie 0.5/0.5 as
`lax.max` does. On CUDA tensors `stem_max_pool` is an autograd Function
whose backward is a kernel too (csrc/maxpool_same_bwd.cu), with the same
tie rule.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.kernels import build

LAUNCHES = 0  # forward kernel launches by `stem_max_pool` on CUDA tensors
BWD_LAUNCHES = 0  # backward kernel launches, from its gradient on CUDA tensors

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _same_geometry(h: int, w: int):
    """(out_h, out_w, (top, bottom), (left, right)) of the SAME 3x3/2 window."""
    oh, ow = (h + 1) // 2, (w + 1) // 2
    ph, pw = 2 * oh + 1 - h, 2 * ow + 1 - w
    return oh, ow, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"stem max pool takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"stem max pool takes [B,C,H,W], got {tuple(x.shape)}")


def max_pool_plain(x: torch.Tensor) -> torch.Tensor:
    """Shift-and-max form of the SAME pool, any spatial size, any device."""
    _check(x)
    _, _, h, w = x.shape
    oh, ow, (top, bottom), (left, right) = _same_geometry(h, w)
    xp = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    out = None
    for dy in range(3):
        for dx in range(3):
            s = xp[:, :, dy: dy + 2 * oh: 2, dx: dx + 2 * ow: 2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous(memory_format=torch.channels_last)


def max_pool_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/maxpool_same.cu) on a channels_last tensor."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"max_pool_cuda needs a CUDA tensor, got {x.device}")
    _check(x)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max pool kernel takes a channels_last-contiguous tensor")
    b, c, h, w = x.shape
    oh, ow, (top, _), (left, _) = _same_geometry(h, w)
    y = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.metro_maxpool3x3s2_same(
            x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, h, w, c, oh, ow, top, left,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_maxpool3x3s2_same")
    LAUNCHES += 1
    return y


def max_pool_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of `max_pool_plain` at x for the output gradient g, by
    autograd through the shift-and-max chain (the reference gradient)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(max_pool_plain(xr), xr, g)
    return dx.contiguous(memory_format=torch.channels_last)


def max_pool_bwd_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel (csrc/maxpool_same_bwd.cu): dx for x and
    the output gradient g, channels_last, in x's dtype."""
    global BWD_LAUNCHES
    if not (x.is_cuda and g.is_cuda):
        raise ValueError(f"max_pool_bwd_cuda needs CUDA tensors, got {x.device}, {g.device}")
    _check(x)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max pool kernel takes a channels_last-contiguous tensor")
    b, c, h, w = x.shape
    oh, ow, (top, _), (left, _) = _same_geometry(h, w)
    if tuple(g.shape) != (b, c, oh, ow) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"pool gradient {g.dtype} {tuple(g.shape)} does not fit the "
                         f"output {x.dtype} {(b, c, oh, ow)}")
    g = g.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.metro_maxpool3x3s2_same_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), _DTYPES[x.dtype], b, h, w, c, oh, ow,
            top, left, torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_maxpool3x3s2_same_bwd")
    BWD_LAUNCHES += 1
    return dx


class _StemPoolCuda(torch.autograd.Function):
    """The pool on CUDA tensors: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return max_pool_cuda(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool_bwd_cuda(x, g)


def stem_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Differentiable SAME 3x3/2 max pool: the plain version on the CPU, the
    kernels (forward, and backward under autograd) on CUDA."""
    if x.device.type == "cpu":
        return max_pool_plain(x)
    if x.is_cuda:
        return _StemPoolCuda.apply(x)
    raise ValueError(f"stem_max_pool: unsupported device {x.device}")
