"""3x3 stride-2 max pool (the ResNet stem pool) in three alignments: CUDA
kernels + plain version.

`mode` follows `model.conv_padding` (`metro_pose3d_tpu/ops/pool_pallas.py`):

  same   TF/XLA "SAME": output (i, j) is the max over input rows and columns
         2i..2i+2 for even sizes (the pad is on the high side only), with
         -inf outside. For odd sizes the pad splits as XLA splits it,
         lo = total // 2, like `_maxpool_reference_odd`.
  torch  `MaxPool2d(3, 2, 1)`: symmetric pad 1 of -inf, the window at
         2i-1..2i+1, one pixel off SAME. What a torchvision backbone needs.
  keras  the torch window, but the pad is an explicit 0.0 that takes part in
         the max (`ZeroPadding2D` + a valid pool): a border window whose real
         values are all negative returns 0. Only the pad cells are 0; the
         reduction is not seeded with 0, so an interior window keeps its
         negative max. What a Keras ResNet-v2 backbone needs.

Tensors are NCHW; the kernels take them in `torch.channels_last` memory
format (NHWC in memory), the layout the backbone runs in.

Gradient: JAX training differentiates the shift-and-max chain
(`stem_max_pool(mode, train=True)` -> `_maxpool_reference[_odd|_torch|_keras]`),
and so does autograd through `max_pool_plain`: `torch.maximum` splits a tie
0.5/0.5 as `lax.max` does. A pad cell is a link of that chain: in `keras`
mode a 0 pad that wins or ties keeps its share of the gradient, which is
dropped with the pad. On CUDA tensors `stem_max_pool` is an autograd
Function whose backward is a kernel too (csrc/maxpool3x3s2_bwd.cu), with
the same tie rule. `F.max_pool2d` is used nowhere: its backward hands the
whole gradient to one argmax, which is another function.

Each kernel is one template with a vector width: a thread loads a 16-byte
vector of channels (8 bf16 or 4 float32) where C is a multiple of it and
every pointer is 16-byte aligned, and one element otherwise (the scalar
variant, the same hand-written kernel). `vector_width` makes that choice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.utils.profiling import launch

MODES = ("same", "torch", "keras")
WAYS = ("fwd", "bwd")
VARIANTS = ("vec16", "scalar")  # 16-byte vectors, or one element a thread
# kernel launches on CUDA tensors by (way, mode, variant): "fwd" by
# `stem_max_pool`, "bwd" from its gradient. The module attributes
# `LAUNCHES`, `BWD_LAUNCHES` (totals), `MODE_LAUNCHES`, `MODE_BWD_LAUNCHES`
# ({mode: n}) and `VARIANT_LAUNCHES` ({way: {variant: n}}) are views of it.
KERNEL_LAUNCHES = {(way, mode, var): 0 for way in WAYS for mode in MODES for var in VARIANTS}
# backward launches whose output gradient was not channels_last and was copied
GRAD_COPIES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launches(way: str | None = None, mode: str | None = None, var: str | None = None) -> int:
    """Launches counted in `KERNEL_LAUNCHES` that match every key given."""
    return sum(n for (w, m, v), n in KERNEL_LAUNCHES.items()
               if way in (None, w) and mode in (None, m) and var in (None, v))


def __getattr__(name: str):
    views = {
        "LAUNCHES": lambda: launches("fwd"),
        "BWD_LAUNCHES": lambda: launches("bwd"),
        "MODE_LAUNCHES": lambda: {m: launches("fwd", m) for m in MODES},
        "MODE_BWD_LAUNCHES": lambda: {m: launches("bwd", m) for m in MODES},
        "VARIANT_LAUNCHES": lambda: {w: {v: launches(w, var=v) for v in VARIANTS} for w in WAYS},
    }
    if name in views:
        return views[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    global GRAD_COPIES
    KERNEL_LAUNCHES.update(dict.fromkeys(KERNEL_LAUNCHES, 0))
    GRAD_COPIES = 0


def vector_width(c: int, dtype: torch.dtype, *data_ptrs: int) -> int:
    """Channels a kernel thread loads at once: a 16-byte vector (8 bf16, 4
    float32) when C is a multiple of it and every pointer is 16-byte
    aligned, else 1 (the scalar variant)."""
    vec = 16 // dtype.itemsize
    return vec if c % vec == 0 and all(p % 16 == 0 for p in data_ptrs) else 1


def _width(c, dtype, ptrs, width):
    """The width to launch: `vector_width`'s choice, or the caller's `width`
    (1, or the vector where the tensors allow it)."""
    allowed = vector_width(c, dtype, *ptrs)
    if width is None:
        return allowed
    if width not in (1, allowed):
        raise ValueError(f"pool kernel width {width} does not fit C={c} {dtype} at these "
                         f"pointers (allowed: 1, {allowed})")
    return width


def variant(width: int) -> str:
    """The variant a launch of `width` channels a thread runs: "vec16" or "scalar"."""
    return "scalar" if width == 1 else "vec16"


def _count(way: str, mode: str, width: int) -> None:
    KERNEL_LAUNCHES[way, mode, variant(width)] += 1


def pool_geometry(h: int, w: int, mode: str = "same"):
    """(out_h, out_w, (top, bottom), (left, right), fill) of the 3x3/2 window:
    the pad that the nine shifted views read, and the value of a pad cell."""
    if mode not in MODES:
        raise ValueError(f"stem max pool mode {mode!r} not in {MODES}")
    oh, ow = (h + 1) // 2, (w + 1) // 2
    ph, pw = 2 * oh + 1 - h, 2 * ow + 1 - w
    if mode == "same":
        return oh, ow, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), float("-inf")
    # one pad cell on the low side; on the high side one for odd sizes, and
    # none for even sizes, whose last window ends on the last row
    return oh, ow, (1, ph - 1), (1, pw - 1), 0.0 if mode == "keras" else float("-inf")


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"stem max pool takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"stem max pool takes [B,C,H,W], got {tuple(x.shape)}")


def max_pool_plain(x: torch.Tensor, mode: str = "same") -> torch.Tensor:
    """Shift-and-max form of the pool, any spatial size, any device."""
    _check(x)
    _, _, h, w = x.shape
    oh, ow, (top, bottom), (left, right), fill = pool_geometry(h, w, mode)
    xp = F.pad(x, (left, right, top, bottom), value=fill)
    out = None
    for dy in range(3):
        for dx in range(3):
            s = xp[:, :, dy: dy + 2 * oh: 2, dx: dx + 2 * ow: 2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous(memory_format=torch.channels_last)


def max_pool_cuda(x: torch.Tensor, mode: str = "same", width: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/maxpool3x3s2.cu) on a channels_last
    tensor; `width` (1 or the vector) overrides `vector_width`'s choice."""
    if not x.is_cuda:
        raise ValueError(f"max_pool_cuda needs a CUDA tensor, got {x.device}")
    _check(x)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max pool kernel takes a channels_last-contiguous tensor")
    b, c, h, w = x.shape
    oh, ow, (top, _), (left, _), fill = pool_geometry(h, w, mode)
    y = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    vec = _width(c, x.dtype, (x.data_ptr(), y.data_ptr()), width)
    lib = build.load()
    launch("metro_maxpool3x3s2")
    with torch.cuda.device(x.device):
        err = lib.metro_maxpool3x3s2(
            x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], vec, b, h, w, c, oh, ow, top, left,
            fill, torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_maxpool3x3s2")
    _count("fwd", mode, vec)
    return y


def max_pool_bwd_plain(x: torch.Tensor, g: torch.Tensor, mode: str = "same") -> torch.Tensor:
    """Gradient of `max_pool_plain` at x for the output gradient g, by
    autograd through the shift-and-max chain (the reference gradient)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(max_pool_plain(xr, mode), xr, g)
    return dx.contiguous(memory_format=torch.channels_last)


def chain_tap_weights(x: torch.Tensor, mode: str = "same") -> torch.Tensor:
    """[B, C, OH, OW, 9] float32: the weight of each window's tap k (k = 3 dy
    + dx) in the gradient of the shift-and-max chain, the backward kernel's
    inner step written out: r_k * l_{k+1} * ... * l_8, with (l, r) = (1, 0),
    (0, 1), (1/2, 1/2) where the running max is above, below or equal to the
    tap, and (1, 1) where either is NaN. Used by the tests."""
    _check(x)
    _, _, h, w = x.shape
    oh, ow, (top, bottom), (left, right), fill = pool_geometry(h, w, mode)
    xp = F.pad(x.float(), (left, right, top, bottom), value=fill)
    taps = [xp[:, :, dy: dy + 2 * oh: 2, dx: dx + 2 * ow: 2] for dy in range(3) for dx in range(3)]
    m, ls, rs = taps[0], [None], [torch.ones_like(taps[0])]
    for v in taps[1:]:
        ls.append(torch.where(m == v, 0.5, torch.where(m < v, 0.0, 1.0)))
        rs.append(torch.where(m == v, 0.5, torch.where(m > v, 0.0, 1.0)))
        m = torch.where((v > m) | torch.isnan(v), v, m)
    weights, s = [None] * 9, torch.ones_like(m)
    for k in range(8, -1, -1):
        weights[k] = rs[k] * s
        if k:
            s = s * ls[k]
    return torch.stack(weights, -1)


def max_pool_bwd_cuda(x: torch.Tensor, g: torch.Tensor, mode: str = "same",
                      width: int | None = None) -> torch.Tensor:
    """Launch the backward kernel (csrc/maxpool3x3s2_bwd.cu): dx for x and
    the output gradient g, channels_last, in x's dtype; `width` as in
    `max_pool_cuda`."""
    global GRAD_COPIES
    if not (x.is_cuda and g.is_cuda):
        raise ValueError(f"max_pool_bwd_cuda needs CUDA tensors, got {x.device}, {g.device}")
    _check(x)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max pool kernel takes a channels_last-contiguous tensor")
    b, c, h, w = x.shape
    oh, ow, (top, _), (left, _), fill = pool_geometry(h, w, mode)
    if tuple(g.shape) != (b, c, oh, ow) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"pool gradient {g.dtype} {tuple(g.shape)} does not fit the "
                         f"output {x.dtype} {(b, c, oh, ow)}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
        GRAD_COPIES += 1
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    vec = _width(c, x.dtype, (x.data_ptr(), g.data_ptr(), dx.data_ptr()), width)
    lib = build.load()
    launch("metro_maxpool3x3s2_bwd")
    with torch.cuda.device(x.device):
        err = lib.metro_maxpool3x3s2_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), _DTYPES[x.dtype], vec, b, h, w, c, oh, ow,
            top, left, fill, torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_maxpool3x3s2_bwd")
    _count("bwd", mode, vec)
    return dx


class _StemPoolCuda(torch.autograd.Function):
    """The pool on CUDA tensors: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.save_for_backward(x)
        ctx.mode = mode
        return max_pool_cuda(x, mode)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool_bwd_cuda(x, g, ctx.mode), None


def stem_max_pool(x: torch.Tensor, mode: str = "same") -> torch.Tensor:
    """Differentiable 3x3/2 max pool in the alignment `mode` ("same" |
    "torch" | "keras"): the plain version on the CPU, the kernels (forward,
    and backward under autograd) on CUDA."""
    if x.device.type == "cpu":
        return max_pool_plain(x, mode)
    if x.is_cuda:
        return _StemPoolCuda.apply(x, mode)
    raise ValueError(f"stem_max_pool: unsupported device {x.device}")
