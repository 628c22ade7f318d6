"""Device operations by kind, from their names in the trace."""
from __future__ import annotations

# the port's hand-written kernels (`metro_pose3d_tpu_torch/csrc/`)
PORT = ("maxpool3x3s2", "warp_crop_kernel", "occluder_paste_kernel", "int8_conv_",
        "int8_elementwise_kernel")
# cuDNN's and cuBLAS's convolution and matrix-product kernels
LIBRARY_CONV = ("xmma", "cudnn", "cutlass", "gemm", "conv", "fprop", "dgrad", "wgrad",
                "implicit", "nchwToNhwc", "nhwcToNchw", "nvjet", "cublas", "sm90_", "sm80_",
                "nhwcAddPadding")
TRANSFERS = ("Memcpy", "Memset")
OPTIMIZER_MARK = "multi_tensor_apply_kernel"  # the foreach norm and fused Adam
STEP_START = "warp_crop_kernel"  # a train step's first kernel of its own: K1


def is_port(name: str) -> bool:
    return any(k in name for k in PORT)


def is_transfer(name: str) -> bool:
    return any(name.startswith(k) for k in TRANSFERS)


def is_conv(name: str) -> bool:
    return not is_port(name) and any(k in name for k in LIBRARY_CONV)


def is_torch_other(name: str) -> bool:
    """torch's own kernels besides convolutions: elementwise, copies,
    casts, reductions, softmax, indexing."""
    return not (is_port(name) or is_transfer(name) or is_conv(name))


def optimizer_spans(device: list) -> list:
    """[(start, end)] of each step's optimizer phase on the device timeline:
    from its first multi-tensor kernel (the gradient norm) to its last (Adam)
    before the next step's K1; the clip's kernels lie between them."""
    spans, first, last = [], None, None
    for s, t, n in device:
        if STEP_START in n and first is not None:
            spans.append((first, last))
            first = last = None
        if OPTIMIZER_MARK in n:
            first = s if first is None else first
            last = t
    if first is not None:
        spans.append((first, last))
    return spans


def in_spans(spans: list, s: float) -> bool:
    return any(a <= s < b for a, b in spans)
