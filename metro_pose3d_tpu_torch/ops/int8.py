"""int8 kernels of the quantized serving path and their plain twins
(`metro_pose3d_tpu/models/quantize.py` computes the same integer sums with
XLA's int8 convolution and dot).

  QK1 `int8_conv`        k x k convolution, 1 x 1 included, int8 x int8 ->
                         exact int32, as an implicit GEMM (csrc/int8_conv.cu),
                         with one of three epilogues:
                           acc      int32 out;
                           requant  int8 out, clip(round(relu?(acc * m[c] + b[c])));
                           dequant  (acc * s[c]).to(dtype) + bias[c].to(dtype).
  QK2 `int8_elementwise` the same per-element forms apart from a conv
                         (csrc/int8_quant.cu):
                           quantize  float -> int8, clip(round(x / sa));
                           junction  int32 -> int8, the requant epilogue;
                           dequant   int32 -> dtype, the dequant epilogue.

Every float step is float32 in the JAX package's order: a product, then a
sum (the kernels build without FMA contraction), a true division, and
round half to even; acc converts to float32 with round to nearest. On the
card each kernel equals its twin bit for bit.

Tensors are NCHW in `torch.channels_last` memory (NHWC in memory), as the
backbone runs; a per-channel vector runs along the last memory axis. The
weights of a conv are OHWI int8 ([Cout, kh, kw, Cin], contiguous), so a
row of the GEMM's B operand is one output channel's taps in (ky, kx, ci)
order, the order in which an input pixel's channels lie in memory.

On a CPU tensor each wrapper runs its twin; on a CUDA tensor it launches
its kernel or raises. The twins take any device: `chip_smoke.py` compares
them with the kernels on the card. QK1 has two variants, which
`qk1_plan` picks from the shapes alone: "wgmma" (Hopper's warpgroup
products fed by TMA, Cin % 16 == 0 and 16-byte aligned tensors) and
"scalar" (byte loads and `mma.sync`, any Cin: the 7x7 stem's 3 channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.utils.profiling import launch

EPILOGUES = ("acc", "requant", "dequant")
FORMS = ("quantize", "junction", "dequant")
CONV_VARIANTS = ("wgmma", "scalar")  # QK1: `qk1_plan` picks one
ELEMENTWISE_VARIANTS = ("vec16", "scalar")  # QK2: 16-byte vectors, or one element at a time
# kernel launches on CUDA tensors by (kernel, epilogue or form, variant)
KERNEL_LAUNCHES = {
    **{("int8_conv", e, v): 0 for e in EPILOGUES for v in CONV_VARIANTS},
    **{("int8_elementwise", f, v): 0 for f in FORMS for v in ELEMENTWISE_VARIANTS},
}

_EPILOGUE_CODES = {"acc": 0, "requant": 1, "dequant": 2}
_FORM_CODES = {"quantize": 0, "junction": 1, "dequant": 2}
_CONV_VARIANT_CODES = {"scalar": 0, "wgmma": 1}
# element types as the kernels number them
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2, torch.int8: 3}
OUT_DTYPES = (torch.float32, torch.bfloat16)
# torch._int_mm on CUDA takes m > 16 rows and k, n multiples of 8; the
# twins pad with zeros up to that, which is exact
_INT_MM_MIN_ROWS, _INT_MM_MULTIPLE = 17, 8


def launches(kernel: str | None = None, kind: str | None = None, var: str | None = None) -> int:
    """Launches counted in `KERNEL_LAUNCHES` that match every key given."""
    return sum(n for (k, e, v), n in KERNEL_LAUNCHES.items()
               if kernel in (None, k) and kind in (None, e) and var in (None, v))


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    KERNEL_LAUNCHES.update(dict.fromkeys(KERNEL_LAUNCHES, 0))


def conv_out_size(size: int, k: int, stride: int, dilation: int, lo: int, hi: int) -> int:
    return (size + lo + hi - ((k - 1) * dilation + 1)) // stride + 1


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _is_dense(t: torch.Tensor) -> bool:
    """NHWC in memory (4-D channels_last) or a contiguous [M, C] matrix."""
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    return t.dim() == 2 and t.is_contiguous()


def _cvec(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over `like` (NCHW or [M, C])."""
    return v.view(1, -1, 1, 1) if like.dim() == 4 else v.view(1, -1)


# ------------------------------------------------------------ plain twins


def quantize_plain(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """float -> int8: clip(round(x.f32 / sa), -127, 127), sa a float32 scalar."""
    return torch.clamp(torch.round(x.float() / sa), -127.0, 127.0).to(torch.int8)


def requant_plain(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                  relu: bool = True) -> torch.Tensor:
    """int32 -> int8: clip(round(relu?(acc.f32 * m[c] + b[c])), -127, 127)."""
    y = acc.float() * _cvec(m, acc) + _cvec(b, acc)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)


def dequant_plain(acc: torch.Tensor, s: torch.Tensor, bias: torch.Tensor | None,
                  dtype: torch.dtype) -> torch.Tensor:
    """int32 -> dtype: (acc.f32 * s[c]).to(dtype), then + bias[c].to(dtype) in dtype."""
    y = (acc.float() * _cvec(s, acc)).to(dtype)
    return y if bias is None else y + _cvec(bias, acc).to(dtype)


def elementwise_plain(form: str, x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor | None = None, relu: bool = True,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """QK2's twin: `form` as in `int8_elementwise`."""
    if form == "quantize":
        y = quantize_plain(x, scale)
    elif form == "junction":
        y = requant_plain(x, scale, bias, relu)
    elif form == "dequant":
        y = dequant_plain(x, scale, bias, out_dtype)
    else:
        raise ValueError(f"int8 elementwise form {form!r} not in {FORMS}")
    return _channels_last(y) if y.dim() == 4 else y.contiguous()


def int_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact, by `torch._int_mm`.
    On CUDA, zero rows and columns pad the operands to the shapes that call
    takes (exact), and B goes in column-major, the layout cuBLASLt's int8
    product takes at every shape; on the CPU it takes any shape."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b)
    up = lambda v: -(-v // _INT_MM_MULTIPLE) * _INT_MM_MULTIPLE  # noqa: E731
    kp, np_ = up(max(k, 1)), up(max(n, 1))
    mp = max(m, _INT_MM_MIN_ROWS)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()  # [N, K]
    if (kp, np_) != (k, n):
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return acc if (mp, np_) == (m, n) else acc[:m, :n].contiguous()


def _check_epilogue(epilogue, n, scale, bias, out_dtype):
    if epilogue not in EPILOGUES:
        raise ValueError(f"int8 conv epilogue {epilogue!r} not in {EPILOGUES}")
    if epilogue == "acc":
        return
    if scale is None or scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"int8 conv epilogue {epilogue!r} takes a float32 scale of shape ({n},)")
    if epilogue == "requant" and bias is None:
        raise ValueError("the requant epilogue takes a float32 bias (the junction's offset)")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise ValueError(f"int8 conv bias must be float32 of shape ({n},)")
    if epilogue == "dequant" and out_dtype not in OUT_DTYPES:
        raise ValueError(f"the dequant epilogue writes one of {OUT_DTYPES}, got {out_dtype}")


def _conv_shapes(xq, wq, stride, dilation, pads):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8 input and weights, got {xq.dtype}, {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[3]:
        raise ValueError(f"int8 conv takes x [B,C,H,W] and OHWI weights [N,kh,kw,C], got "
                         f"{tuple(xq.shape)}, {tuple(wq.shape)}")
    top, bottom, left, right = pads
    b, c, h, w = xq.shape
    n, kh, kw, _ = wq.shape
    oh = conv_out_size(h, kh, stride, dilation, top, bottom)
    ow = conv_out_size(w, kw, stride, dilation, left, right)
    if oh < 1 or ow < 1 or min(pads) < 0 or stride < 1 or dilation < 1:
        raise ValueError(f"int8 conv: no output for input {h}x{w}, kernel {kh}x{kw}, stride "
                         f"{stride}, dilation {dilation}, pads {pads}")
    return b, c, h, w, n, kh, kw, oh, ow


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int, dilation: int, pads,
                    epilogue: str = "acc", scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, relu: bool = True,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """QK1's twin: the kh*kw shifted views of the zero-padded input, each an
    integer product with its tap's weights, summed in int32; then the
    epilogue. Any device."""
    b, c, h, w, n, kh, kw, oh, ow = _conv_shapes(xq, wq, stride, dilation, pads)
    _check_epilogue(epilogue, n, scale, bias, out_dtype)
    top, bottom, left, right = pads
    xp = F.pad(xq, (left, right, top, bottom))
    acc = None
    for ky in range(kh):
        for kx in range(kw):
            y0, x0 = ky * dilation, kx * dilation
            view = xp[:, :, y0: y0 + (oh - 1) * stride + 1: stride,
                      x0: x0 + (ow - 1) * stride + 1: stride]
            p = int_products(view.permute(0, 2, 3, 1).reshape(-1, c), wq[:, ky, kx, :].t())
            acc = p if acc is None else acc + p
    acc = acc.reshape(b, oh, ow, n).permute(0, 3, 1, 2)
    if epilogue == "acc":
        return _channels_last(acc)
    form = "junction" if epilogue == "requant" else "dequant"
    return elementwise_plain(form, acc, scale, bias, relu, out_dtype)


# ------------------------------------------------------------ kernels


# QK1's wgmma variant (csrc/int8_conv.cu): a tile is 128 output pixels (a
# rectangle of one image) x BN channels; each (tap, chunk of BK channels) of
# it is one pipeline stage of (128 + BN) x BK bytes; a block also holds two
# consumers' staging buffers and the stages' barriers in its shared memory
QK1_TILE_M = 128
QK1_MAX_STAGES = 8
QK1_STAGING_BYTES = 2 * 64 * (64 * 4 + 16)
QK1_BARRIER_BYTES = 2 * QK1_MAX_STAGES * 8
QK1_SMEM_BYTES = 232448  # a block's shared memory on sm_90
QK1_MAX_K = 133000  # |acc| <= 127^2 K < 2^31


def qk1_plan(b: int, c: int, h: int, w: int, n: int, kh: int, kw: int, stride: int,
             dilation: int, pads, aligned: bool = True) -> dict:
    """QK1's variant and tiling for a conv of these shapes, from the shapes
    alone. "wgmma" where Cin % 16 == 0, stride <= 2 and every tensor is
    16-byte aligned (`aligned`), with:
      bn      output channels a tile: 64 up to N = 64, 128 up to 128, else 256;
      bk      channels a stage: 128 where Cin % 128 == 0, else 64 (the 128B
              or 64B swizzle); a chunk past Cin loads zeros;
      tile_w  output pixels a tile row: OW up to a power of two, at most 128
              (tile_h = 128 / tile_w rows);
      stages  the ring's depth: as many as shared memory holds, at most 8;
      tiles   output tiles; the kernel runs min(tiles, SMs) persistent blocks.
    "scalar" otherwise. Raises where no variant takes the conv."""
    top, bottom, left, right = pads
    oh = conv_out_size(h, kh, stride, dilation, top, bottom)
    ow = conv_out_size(w, kw, stride, dilation, left, right)
    k = kh * kw * c
    if k == 0 or k > QK1_MAX_K or stride < 1 or dilation < 1 or oh < 1 or ow < 1:
        raise ValueError(f"int8 conv: no QK1 variant takes K={k} (at most {QK1_MAX_K}), "
                         f"stride {stride}, dilation {dilation}, output {oh}x{ow}")
    if c % 16 or stride > 2 or not aligned:
        return {"variant": "scalar"}
    bn = 64 if n <= 64 else 128 if n <= 128 else 256
    bk = 128 if c % 128 == 0 else 64
    tile_w = min(QK1_TILE_M, 1 << (ow - 1).bit_length())
    tile_h = QK1_TILE_M // tile_w
    room = QK1_SMEM_BYTES - QK1_STAGING_BYTES - QK1_BARRIER_BYTES
    stages = min(QK1_MAX_STAGES, room // ((QK1_TILE_M + bn) * bk))
    tiles = b * -(-oh // tile_h) * -(-ow // tile_w) * -(-n // bn)
    return {"variant": "wgmma", "bn": bn, "bk": bk, "tile_w": tile_w, "tile_h": tile_h,
            "stages": stages, "tiles": tiles}


def _check_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got one on {t.device}")
        if t is not None and t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and {t.device}")


def int8_conv_cuda(xq: torch.Tensor, wq: torch.Tensor, stride: int, dilation: int, pads,
                   epilogue: str = "acc", scale: torch.Tensor | None = None,
                   bias: torch.Tensor | None = None, relu: bool = True,
                   out_dtype: torch.dtype | None = None,
                   variant: str | None = None) -> torch.Tensor:
    """Launch QK1 (csrc/int8_conv.cu) on a channels_last int8 input and
    contiguous OHWI int8 weights, in the variant `qk1_plan` picks;
    `variant="scalar"` forces the scalar one, which takes any conv."""
    _check_cuda("int8_conv_cuda", xq, wq, scale, bias)
    b, c, h, w, n, kh, kw, oh, ow = _conv_shapes(xq, wq, stride, dilation, pads)
    _check_epilogue(epilogue, n, scale, bias, out_dtype)
    if not xq.is_contiguous(memory_format=torch.channels_last) or not wq.is_contiguous():
        raise ValueError("int8 conv kernel takes a channels_last input and contiguous weights")
    dtype = {"acc": torch.int32, "requant": torch.int8, "dequant": out_dtype}[epilogue]
    out = torch.empty((b, n, oh, ow), dtype=dtype, device=xq.device,
                      memory_format=torch.channels_last)
    aligned = all(p % 16 == 0 for p in (xq.data_ptr(), wq.data_ptr(), out.data_ptr()))
    plan = qk1_plan(b, c, h, w, n, kh, kw, stride, dilation, pads, aligned)
    if variant not in (None, "scalar", plan["variant"]):
        raise ValueError(f"int8 conv variant {variant!r} does not take Cin={c}, stride "
                         f"{stride} at these pointers (the plan: {plan['variant']!r})")
    if variant == "scalar":
        plan = {"variant": "scalar"}
    if out.numel():
        lib = build.load()
        tiling = [plan.get(key, 0) for key in ("bn", "bk", "stages", "tile_w")]
        launch("metro_int8_conv")
        with torch.cuda.device(xq.device):
            err = lib.metro_int8_conv(
                xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
                0 if scale is None else scale.contiguous().data_ptr(),
                0 if bias is None else bias.contiguous().data_ptr(),
                b, h, w, c, oh, ow, n, kh, kw, stride, dilation, pads[0], pads[2],
                _EPILOGUE_CODES[epilogue], _DTYPE_CODES[dtype], int(relu),
                _CONV_VARIANT_CODES[plan["variant"]], *tiling,
                torch.cuda.current_stream().cuda_stream)
        build.check(err, "metro_int8_conv")
    KERNEL_LAUNCHES["int8_conv", epilogue, plan["variant"]] += 1
    return out


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, dilation: int, pads,
              epilogue: str = "acc", scale: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, relu: bool = True,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """k x k int8 convolution (QK1): x [B,C,H,W] int8 channels_last, OHWI
    int8 weights, `pads` (top, bottom, left, right) of zeros; the plain
    twin on the CPU, the kernel on CUDA."""
    args = (xq, wq, stride, dilation, pads, epilogue, scale, bias, relu, out_dtype)
    if xq.device.type == "cpu":
        return int8_conv_plain(*args)
    if xq.is_cuda:
        return int8_conv_cuda(*args)
    raise ValueError(f"int8_conv: unsupported device {xq.device}")


def _check_elementwise(form, x, scale, bias, out_dtype):
    if form not in FORMS:
        raise ValueError(f"int8 elementwise form {form!r} not in {FORMS}")
    if not _is_dense(x):
        raise ValueError("int8 elementwise takes a channels_last [B,C,H,W] or a contiguous "
                         "[M, C] tensor")
    want = (torch.float32, torch.bfloat16) if form == "quantize" else (torch.int32,)
    if x.dtype not in want:
        raise TypeError(f"int8 elementwise {form!r} takes {want}, got {x.dtype}")
    c = x.shape[1] if x.dim() == 4 else x.shape[-1]
    if form == "quantize":
        if scale is None or scale.dtype != torch.float32 or scale.numel() != 1:
            raise ValueError("quantize takes its input scale as a float32 scalar tensor")
        return torch.int8
    if scale is None or scale.dtype != torch.float32 or scale.shape != (c,):
        raise ValueError(f"{form!r} takes a float32 per-channel scale of shape ({c},)")
    if form == "junction" and bias is None:
        raise ValueError("junction takes a float32 per-channel offset")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (c,)):
        raise ValueError(f"{form!r} takes a float32 per-channel bias of shape ({c},)")
    if form == "dequant":
        if out_dtype not in OUT_DTYPES:
            raise ValueError(f"dequant writes one of {OUT_DTYPES}, got {out_dtype}")
        return out_dtype
    return torch.int8


def elementwise_vector_width(*data_ptrs: int) -> int:
    """Elements a QK2 thread takes at once: 16 where every pointer is
    16-byte aligned, else 1 (the scalar variant)."""
    return 16 if all(p % 16 == 0 for p in data_ptrs) else 1


def int8_elementwise_cuda(form: str, x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor | None = None, relu: bool = True,
                          out_dtype: torch.dtype | None = None,
                          width: int | None = None) -> torch.Tensor:
    """Launch QK2 (csrc/int8_quant.cu); `width` (1 or 16) overrides
    `elementwise_vector_width`'s choice where the pointers allow it."""
    _check_cuda("int8_elementwise_cuda", x, scale, bias)
    dtype = _check_elementwise(form, x, scale, bias, out_dtype)
    out = torch.empty_like(x, dtype=dtype)  # keeps x's dense layout
    c = x.shape[1] if x.dim() == 4 else x.shape[-1]
    allowed = elementwise_vector_width(x.data_ptr(), out.data_ptr())
    if width not in (None, 1, allowed):
        raise ValueError(f"int8 elementwise width {width} does not fit these pointers "
                         f"(allowed: 1, {allowed})")
    vec = allowed if width is None else width
    if x.numel():
        lib = build.load()
        launch("metro_int8_elementwise")
        with torch.cuda.device(x.device):
            err = lib.metro_int8_elementwise(
                x.data_ptr(), scale.contiguous().data_ptr(),
                0 if bias is None else bias.contiguous().data_ptr(), out.data_ptr(),
                _FORM_CODES[form], _DTYPE_CODES[x.dtype], _DTYPE_CODES[dtype], int(relu), vec,
                x.numel(), c, torch.cuda.current_stream().cuda_stream)
        build.check(err, "metro_int8_elementwise")
    KERNEL_LAUNCHES["int8_elementwise", form, "scalar" if vec == 1 else "vec16"] += 1
    return out


def int8_elementwise(form: str, x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor | None = None, relu: bool = True,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """QK2: `form` "quantize" (float32/bf16 -> int8 with the scalar input
    scale sa), "junction" (int32 -> int8 with per-channel m and b, ReLU if
    `relu`) or "dequant" (int32 -> `out_dtype` with per-channel s and an
    optional bias); the plain twin on the CPU, the kernel on CUDA."""
    args = (form, x, scale, bias, relu, out_dtype)
    if x.device.type == "cpu":
        _check_elementwise(form, x, scale, bias, out_dtype)
        return elementwise_plain(*args)
    if x.is_cuda:
        return int8_elementwise_cuda(*args)
    raise ValueError(f"int8_elementwise: unsupported device {x.device}")
