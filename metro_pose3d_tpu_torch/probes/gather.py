"""Gather probes: `out[b,i,j] = x[b, idx[b,i,j], j]` (along rows, axis 0) and
`out[b,i,j] = x[b, i, idx[b,i,j]]` (along columns, axis 1) on `[B,H,W]`
int32 or float32 with int32 indices of the same shape.

Counterparts of the Pallas probes in `scripts/exp_pallas_gather.py`
(`build_sublane`, `build_lane`, `build_lane_f32`: B=64, 512x512) and
`scripts/exp_pallas_gather2.py` (`probe`: 8x128 ... 512x512, both axes). The
plain version is `torch.take_along_dim`. Results are exact: a gather copies.

The kernels (csrc/probes.cu) stage what a block gathers from in shared
memory: a strip of `STRIP` columns of all H rows along rows, whole rows
along columns. A shape whose strip or row outgrows a block's shared memory
(H above `ROWS_MAX_H`, W above `COLS_MAX_W`) raises.

    python -m metro_pose3d_tpu_torch.probes.gather
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.probes import check_cuda, time_ms

LAUNCHES: dict = {}  # kernel launches by `gather_cuda`, by `case_key`
STRIP = 32  # columns a row-gather block stages (csrc/probes.cu, kGatherStrip)
SMEM_MAX = 232448  # bytes of shared memory a block may opt in to
ROWS_MAX_H = SMEM_MAX // (STRIP * 4)  # 1816
COLS_MAX_W = SMEM_MAX // 4  # 58112

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


def _launch(name: str, x: torch.Tensor, idx: torch.Tensor, axis: int,
            floor_only: bool) -> torch.Tensor:
    check_cuda(name, x, idx, dtypes=((torch.int32, torch.float32), torch.int32))
    if x.dim() != 3 or idx.shape != x.shape or axis not in (0, 1):
        raise ValueError(f"{name} takes x and idx [B,H,W] and axis 0 or 1, got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, axis {axis}")
    b, h, w = x.shape
    if b > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"{name} takes B <= 65535 and H * W < 2^31, got {tuple(x.shape)}")
    if axis == 0 and h > ROWS_MAX_H or axis == 1 and w > COLS_MAX_W:
        raise ValueError(f"{name}: a block's shared memory holds a {STRIP}-column strip of at "
                         f"most {ROWS_MAX_H} rows (axis 0) or a row of at most {COLS_MAX_W} "
                         f"words (axis 1), got {tuple(x.shape)} along axis {axis}")
    out = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.metro_probe_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, h, w, axis,
                                     int(floor_only), torch.cuda.current_stream().cuda_stream)
    build.check(err, "metro_probe_gather")
    return out


def gather_cuda(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the gather kernel (csrc/probes.cu: `probe_gather_rows_kernel`
    on axis 0, `probe_gather_cols_kernel` on axis 1) on `[B,H,W]` CUDA
    tensors."""
    out = _launch("gather_cuda", x, idx, axis, False)
    key = case_key(x, axis)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def gather_floor(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The launch floor of `gather_cuda`: an empty kernel on the grid, block
    and shared memory the gather would take (the output is left unwritten).
    Not a launch of the gather: `LAUNCHES` does not count it."""
    return _launch("gather_floor", x, idx, axis, True)


def make_case(h: int, w: int, axis: int, dtype, b: int, seed: int = 0, device="cpu"):
    """Seeded inputs as the scripts draw them: values 0..999, indices in the axis."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 1000, (b, h, w)).astype(np.int32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, h if axis == 0 else w, (b, h, w)).astype(np.int32))
    return x.to(device), idx.to(device)


def edge_cases(device="cpu", seed: int = 2) -> dict:
    """name -> (x, idx, axis): both axes and both dtypes at W = 1, 13, 130
    (not a multiple of 4, or of a strip), H = 1, B = 1, the tile's largest
    strip and row, and a contiguous x or idx at a storage offset that breaks
    16-byte alignment."""
    rng = np.random.RandomState(seed)
    cases = {}
    for axis in (0, 1):
        for dtype in (torch.int32, torch.float32):
            name = str(dtype).replace("torch.", "")
            shapes = {"W=1": (2, 7, 1), "W=13": (3, 9, 13), "W=130": (2, 5, 130),
                      "H=1": (4, 1, 40), "B=1": (1, 37, 64),
                      "largest tile": (1, ROWS_MAX_H, 8) if axis == 0 else (1, 2, COLS_MAX_W),
                      "x offset": (2, 11, 36), "idx offset": (2, 11, 36)}
            for what, (b, h, w) in shapes.items():
                x = rng.randint(-1000, 1000, b * h * w + 1).astype(np.int32)
                idx = rng.randint(0, h if axis == 0 else w, b * h * w + 1).astype(np.int32)
                x = torch.from_numpy(x).to(dtype).to(device)
                idx = torch.from_numpy(idx).to(device)
                # one word past a 16-byte aligned allocation: contiguous, unaligned
                x = x[1:] if what == "x offset" else x[:-1]
                idx = idx[1:] if what == "idx offset" else idx[:-1]
                cases[f"{what} [{b},{h},{w}] axis={axis} {name}"] = (
                    x.view(b, h, w), idx.view(b, h, w), axis)
    return cases


def untileable(device="cpu") -> dict:
    """name -> (x, idx, axis): shapes a block's shared memory cannot hold,
    on which `gather_cuda` raises."""
    rows = torch.zeros((1, ROWS_MAX_H + 1, 4), dtype=torch.int32, device=device)
    cols = torch.zeros((1, 1, COLS_MAX_W + 1), dtype=torch.int32, device=device)
    return {f"H={ROWS_MAX_H + 1} axis=0": (rows, rows, 0),
            f"W={COLS_MAX_W + 1} axis=1": (cols, cols, 1)}


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
