"""Gather probes: `out[b,i,j] = x[b, idx[b,i,j], j]` (along rows, axis 0) and
`out[b,i,j] = x[b, i, idx[b,i,j]]` (along columns, axis 1) on `[B,H,W]`
int32 or float32 with int32 indices of the same shape.

Counterparts of the Pallas probes in `scripts/exp_pallas_gather.py`
(`build_sublane`, `build_lane`, `build_lane_f32`: B=64, 512x512) and
`scripts/exp_pallas_gather2.py` (`probe`: 8x128 ... 512x512, both axes). The
plain version is `torch.take_along_dim`. Results are exact: a gather copies.

    python -m metro_pose3d_tpu_torch.probes.gather
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.probes import check_cuda, time_ms

LAUNCHES: dict = {}  # kernel launches by `gather_cuda`, by `case_key`

# (H, W, axis, dtype, B) of the two scripts, in their order
SHAPES = ([(512, 512, 0, torch.int32, 64), (512, 512, 1, torch.int32, 64),
           (512, 512, 1, torch.float32, 64)]
          + [(h, w, axis, torch.int32, 8) for axis in (0, 1)
             for h, w in ((8, 128), (64, 128), (128, 128), (256, 256), (512, 512))]
          + [(256, 256, 1, torch.float32, 8), (512, 512, 0, torch.float32, 64)])


def case_key(x: torch.Tensor, axis: int) -> tuple:
    """(H, W, axis, dtype, B), as in `SHAPES`: the key of `LAUNCHES`."""
    b, h, w = x.shape
    return h, w, axis, x.dtype, b


def gather_plain(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """`take_along_axis` within each batch element; axis 0 = rows, 1 = columns."""
    if axis not in (0, 1):
        raise ValueError(f"axis {axis} not in (0, 1)")
    return torch.take_along_dim(x, idx.long(), dim=axis + 1)


def gather_cuda(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the gather kernel (csrc/probes.cu) on `[B,H,W]` CUDA tensors."""
    check_cuda("gather_cuda", x, idx, dtypes=((torch.int32, torch.float32), torch.int32))
    if x.dim() != 3 or idx.shape != x.shape or axis not in (0, 1):
        raise ValueError(f"gather_cuda takes x and idx [B,H,W] and axis 0 or 1, got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, axis {axis}")
    out = torch.empty_like(x)
    b, h, w = x.shape
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.metro_probe_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, h, w, axis,
                                     torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_probe_gather")
    key = case_key(x, axis)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def make_case(h: int, w: int, axis: int, dtype, b: int, seed: int = 0, device="cpu"):
    """Seeded inputs as the scripts draw them: values 0..999, indices in the axis."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 1000, (b, h, w)).astype(np.int32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, h if axis == 0 else w, (b, h, w)).astype(np.int32))
    return x.to(device), idx.to(device)


def main() -> None:
    from metro_pose3d_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    for h, w, axis, dtype, b in SHAPES:
        x, idx = make_case(h, w, axis, dtype, b, device=dev)
        ok = torch.equal(gather_cuda(x, idx, axis), gather_plain(x, idx, axis))
        ms = time_ms(lambda: gather_cuda(x, idx, axis))
        plain = time_ms(lambda: gather_plain(x, idx, axis))
        name = str(dtype).replace("torch.", "")
        print(f"[{h}x{w}] axis={axis} {name} b={b}: ok={ok} {ms:7.4f} ms "
              f"{b * h * w / ms / 1e3:8.0f}M idx/s (take_along_dim {plain:7.4f} ms)")


if __name__ == "__main__":
    main()
