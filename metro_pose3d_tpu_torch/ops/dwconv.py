"""Depthwise k x k convolution (groups = channels, no bias): a CUDA kernel
for k = 3 (csrc/dwconv.cu) and its plain twin. The MBConv blocks of the EfficientNetV2
trunk (`models/efficientnet.py`) run their depthwise convs through it, by way
of `models/resnet.py::Conv` with `groups`.

For x [N,C,H,W] and a weight [C,1,k,k], with zero padding (top, bottom,
left, right), a stride and a dilation,

    y[n,c,i,j] = sum over taps (a, b), row-major, of
                 float(x_pad[n, c, i*stride + a*dil, j*stride + b*dil]) * float(w[c, a, b])

from 0.0 in float32, each product and each sum rounded, then rounded once to
x's dtype; the weight is first rounded to x's dtype, as `Conv` casts its
weights. The twin, `depthwise_conv_plain`, sums the shifted float32 slices in
that order with PyTorch's mul and add; the kernel does the same operations
(built with `-fmad=false`): on the card the two are equal bit for bit.

The kernel takes x in `torch.channels_last` memory format (the backbone's
layout), float32 or bfloat16, k = 3, and writes y in x's dtype and layout.
A thread computes a 16-byte vector of channels (8 bf16, 4 float32) where C
holds whole vectors and the pointers are 16-byte aligned, one channel
otherwise (`vector_width`). It has no backward: a CUDA input that needs a
gradient raises (the EfficientNetV2 trunk serves in eval mode only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.utils.profiling import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIZE = 3  # the EfficientNetV2 trunks' only depthwise kernel
VARIANTS = ("vec16", "scalar")
# kernel launches on CUDA tensors by (dtype, variant); `LAUNCHES` is their total
KERNEL_LAUNCHES = {(str(d)[6:], var): 0 for d in _DTYPES for var in VARIANTS}


def launches(dtype: str | None = None, var: str | None = None) -> int:
    """Launches counted in `KERNEL_LAUNCHES` that match every key given."""
    return sum(n for (d, v), n in KERNEL_LAUNCHES.items()
               if dtype in (None, d) and var in (None, v))


def __getattr__(name: str):
    if name == "LAUNCHES":
        return launches()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    KERNEL_LAUNCHES.update(dict.fromkeys(KERNEL_LAUNCHES, 0))


def out_size(size: int, k: int, stride: int, dilation: int, low: int, high: int) -> int:
    return (size + low + high - dilation * (k - 1) - 1) // stride + 1


def _check_weight(x: torch.Tensor, weight: torch.Tensor) -> int:
    """-> k; ValueError unless weight is a depthwise [C,1,k,k] for x [N,C,H,W]."""
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != 1 \
            or weight.shape[0] != x.shape[1] or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"depthwise conv takes x [N,C,H,W] and a weight [C,1,k,k], got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    return weight.shape[-1]


def depthwise_conv_plain(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation: int,
                         pads) -> torch.Tensor:
    """The depthwise conv as shifted float32 slices summed tap by tap in
    row-major order from 0, rounded to x's dtype: the kernel's arithmetic in
    PyTorch, any device; y keeps x's memory format."""
    k = _check_weight(x, weight)
    top, bottom, left, right = pads
    n, c, h, w = x.shape
    oh, ow = out_size(h, k, stride, dilation, top, bottom), out_size(w, k, stride, dilation,
                                                                     left, right)
    xf = F.pad(x.float(), (left, right, top, bottom))
    wf = weight.to(x.dtype).float().view(c, k, k)
    acc = torch.zeros((n, c, oh, ow), device=x.device)
    for a in range(k):
        for b in range(k):
            tap = xf[:, :, a * dilation:a * dilation + (oh - 1) * stride + 1:stride,
                     b * dilation:b * dilation + (ow - 1) * stride + 1:stride]
            acc = acc + tap * wf[:, a, b].view(1, c, 1, 1)
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return acc.to(x.dtype).contiguous(memory_format=fmt)


def vector_width(x: torch.Tensor, *data_ptrs: int) -> int:
    """Channels a kernel thread takes at once: a 16-byte vector (8 bf16, 4
    float32) where C holds whole vectors and every pointer is 16-byte
    aligned, else 1."""
    vec = 16 // x.dtype.itemsize
    return vec if x.shape[1] % vec == 0 and all(p % 16 == 0 for p in data_ptrs) else 1


def depthwise_conv_cuda(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation: int,
                        pads, width: int | None = None) -> torch.Tensor:
    """Launch the kernel (csrc/dwconv.cu): y in x's dtype, channels_last;
    `width` (1 or the vector) overrides `vector_width`'s choice."""
    k = _check_weight(x, weight)
    if x.dtype not in _DTYPES:
        raise TypeError(f"depthwise conv kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda or weight.device != x.device:
        raise ValueError(f"depthwise_conv_cuda needs x and the weight on one CUDA device, got "
                         f"{x.device} and {weight.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise conv kernel takes a channels_last tensor, got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    if k != KERNEL_SIZE:
        raise ValueError(f"depthwise conv kernel takes k = {KERNEL_SIZE}, got {k}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError("the depthwise conv kernel has no backward: run it under "
                           "torch.no_grad() or torch.inference_mode()")
    top, bottom, left, right = pads
    n, c, h, w = x.shape
    oh, ow = out_size(h, k, stride, dilation, top, bottom), out_size(w, k, stride, dilation,
                                                                     left, right)
    taps = torch.empty((k * k, c), dtype=x.dtype, device=x.device)
    taps.copy_(weight.view(c, k * k).t())  # tap-major, in x's dtype
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    allowed = vector_width(x, x.data_ptr(), taps.data_ptr(), y.data_ptr())
    if width not in (None, 1, allowed):
        raise ValueError(f"depthwise conv kernel width {width} does not fit {tuple(x.shape)} "
                         f"{x.dtype} at these pointers (allowed: 1, {allowed})")
    vec = allowed if width is None else width
    if y.numel():
        lib = build.load()
        launch("metro_dwconv")
        with torch.cuda.device(x.device):
            err = lib.metro_dwconv(x.data_ptr(), taps.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
                                   vec, n, h, w, c, oh, ow, k, stride, dilation, top, left,
                                   torch.cuda.current_stream().cuda_stream)
        build.check(err, "metro_dwconv")
        KERNEL_LAUNCHES[str(x.dtype)[6:], "scalar" if vec == 1 else "vec16"] += 1
    return y


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation: int,
                   pads) -> torch.Tensor:
    """The depthwise conv of x with a [C,1,k,k] weight and zero padding
    `pads` (top, bottom, left, right): the twin on the CPU, the kernel on
    CUDA."""
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, weight, stride, dilation, pads)
    if not x.is_cuda:
        raise ValueError(f"depthwise_conv: unsupported device {x.device}")
    return depthwise_conv_cuda(x, weight, stride, dilation, pads)
