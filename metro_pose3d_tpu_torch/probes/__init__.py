"""Primitive probes: what the card does with the access patterns a warp
sampler is built from (gathers, rolls, row selects, slices with a run-time
start). Measurement tools: nothing on the serving or training path calls
them. Each probe is a CUDA kernel (`csrc/probes.cu`) beside a plain PyTorch
version; `python -m metro_pose3d_tpu_torch.probes.gather` and `...prims`
print one line per probe."""
from __future__ import annotations

import torch


def check_cuda(name: str, *tensors, dtypes=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if dtypes is not None:
        for t, want in zip(tensors, dtypes):
            allowed = want if isinstance(want, tuple) else (want,)
            if t.dtype not in allowed:
                raise TypeError(f"{name}: dtype {t.dtype} not in {allowed}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
