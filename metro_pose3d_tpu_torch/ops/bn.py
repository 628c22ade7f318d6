"""Batch norm's inference affine and the activation after it, in one pass: a
CUDA kernel (csrc/bn_act.cu) and its plain twin.

Eval-mode batch norm (`models/resnet.py::BatchNorm`) computes, per channel c,

    mul = rsqrt(var + eps) * scale                      (on [C] vectors)
    y = ((float(x) - mean[c]) * mul[c] + bias[c]).to(dtype)

and the activation after it (`act`): "none", "relu" (F.relu(y), the ResNet
trunks) or "silu" (F.silu(y), the EfficientNetV2 trunk). The twin,
`bn_act_plain`, is that chain as PyTorch runs it, op by op. The kernel does
the same float32 operations in the same order, each rounded (the library is
built with `-fmad=false`), rounds once to the output type and then clamps
the rounded value at 0 as F.relu does, or applies F.silu's formula to it in
float32 and rounds once more: on the card it equals the twin bit for bit
where its `expf` and division are PyTorch's. The module computes `mul`
with PyTorch, as it always did; `batch_norm_act` hands the rest to the
twin on the CPU and to the kernel on CUDA.

The kernel takes [N,C,H,W] in `torch.channels_last` memory format (the
backbone's layout) or NCHW-contiguous, in float32 or bfloat16, and writes
x's dtype and layout. A thread loads a 16-byte vector (8 bf16, 4 float32)
where the channels (channels_last) or a plane (NCHW) hold whole vectors and
both pointers are 16-byte aligned, and one element otherwise (the scalar
variant); `vector_width` makes that choice. It has no backward: a CUDA
input that needs a gradient raises (training runs batch norm in train mode,
which is PyTorch code).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.utils.profiling import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"channels_last": 0, "nchw": 1}
_ACTS = {"none": 0, "relu": 1, "silu": 2}  # the kernel's activation codes
ACTIVATIONS = tuple(_ACTS)
_ACT_FNS = {"none": lambda y: y, "relu": F.relu, "silu": F.silu}
VARIANTS = ("vec16", "scalar")  # 16-byte vectors, or one element a step
# kernel launches on CUDA tensors by (dtype, act, variant), dtype "float32"
# or "bfloat16"; `LAUNCHES` (the total) is a view of it
KERNEL_LAUNCHES = {(str(d)[6:], act, var): 0
                   for d in _DTYPES for act in ACTIVATIONS for var in VARIANTS}


def launches(dtype: str | None = None, act: str | None = None, var: str | None = None) -> int:
    """Launches counted in `KERNEL_LAUNCHES` that match every key given."""
    return sum(n for (d, a, v), n in KERNEL_LAUNCHES.items()
               if dtype in (None, d) and act in (None, a) and var in (None, v))


def __getattr__(name: str):
    if name == "LAUNCHES":
        return launches()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    KERNEL_LAUNCHES.update(dict.fromkeys(KERNEL_LAUNCHES, 0))


def check_act(act: str) -> str:
    if act not in _ACTS:
        raise ValueError(f"unknown batch norm activation {act!r}; valid: {ACTIVATIONS}")
    return act


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """F.relu or F.silu of y as `act` says ("none": y itself)."""
    return _ACT_FNS[check_act(act)](y)


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                 act: str = "none") -> torch.Tensor:
    """The inference affine in float32, cast to x's dtype, then F.relu or
    F.silu on that value as `act` says: the chain as PyTorch runs it, any
    device."""
    check_act(act)
    shape = (1, -1, 1, 1)
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return activation(y.to(x.dtype), act)


def layout(x: torch.Tensor) -> str:
    """The dense layout the kernel reads x in, "channels_last" or "nchw"
    (channels_last where x is dense in both); ValueError for any other."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    if x.is_contiguous():
        return "nchw"
    raise ValueError("batch norm kernel takes a channels_last- or NCHW-contiguous tensor, got "
                     f"strides {x.stride()} for shape {tuple(x.shape)}")


def vector_width(x: torch.Tensor, kind: str, *data_ptrs: int) -> int:
    """Elements a kernel thread takes at once: a 16-byte vector (8 bf16, 4
    float32) where the channels (channels_last) or a plane (NCHW) hold whole
    vectors and every pointer is 16-byte aligned, else 1."""
    vec = 16 // x.dtype.itemsize
    _, c, h, w = x.shape
    whole = (c if kind == "channels_last" else h * w) % vec == 0
    return vec if whole and all(p % 16 == 0 for p in data_ptrs) else 1


def _check(x, mean, mul, bias) -> str:
    """Raise on what the kernel does not take; -> x's layout."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"batch norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"batch norm kernel takes [N,C,H,W], got {tuple(x.shape)}")
    kind = layout(x)
    c = x.shape[1]
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"batch norm kernel takes a float32 {name} of shape ({c},) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not x.is_cuda:
        raise ValueError(f"bn_act_cuda needs a CUDA tensor, got {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, mean, mul, bias)):
        raise RuntimeError("the batch norm kernel has no backward: run eval-mode batch norm "
                           "on CUDA under torch.no_grad() or torch.inference_mode()")
    return kind


def bn_act_cuda(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                act: str = "none", width: int | None = None) -> torch.Tensor:
    """Launch the kernel (csrc/bn_act.cu): y in x's dtype and layout;
    `width` (1 or the vector) overrides `vector_width`'s choice."""
    check_act(act)
    kind = _check(x, mean, mul, bias)
    y = torch.empty_like(x)  # keeps x's dense layout
    allowed = vector_width(x, kind, x.data_ptr(), y.data_ptr())
    if width not in (None, 1, allowed):
        raise ValueError(f"batch norm kernel width {width} does not fit {tuple(x.shape)} "
                         f"{x.dtype} {kind} at these pointers (allowed: 1, {allowed})")
    vec = allowed if width is None else width
    _, c, h, w = x.shape
    if x.numel():
        lib = build.load()
        launch("metro_bn_act")
        with torch.cuda.device(x.device):
            err = lib.metro_bn_act(
                x.data_ptr(), y.data_ptr(), mean.contiguous().data_ptr(),
                mul.contiguous().data_ptr(), bias.contiguous().data_ptr(), _DTYPES[x.dtype],
                _LAYOUTS[kind], _ACTS[act], vec, x.numel(), c, h * w,
                torch.cuda.current_stream().cuda_stream)
        build.check(err, "metro_bn_act")
        KERNEL_LAUNCHES[str(x.dtype)[6:], act, "scalar" if vec == 1 else "vec16"] += 1
    return y


def batch_norm_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                   act: str = "none") -> torch.Tensor:
    """Eval-mode batch norm of x with the running `mean`, the multiplier
    `mul` = rsqrt(var + eps) * scale and `bias`, in x's dtype, and the
    activation `act` after it: the twin on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, mul, bias, act)
    if not x.is_cuda:
        raise ValueError(f"batch_norm_act: unsupported device {x.device}")
    return bn_act_cuda(x, mean, mul, bias, act)
