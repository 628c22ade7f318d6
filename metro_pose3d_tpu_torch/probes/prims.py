"""In-kernel primitive probes: each repeats one access pattern `REPS` = 64
times on a tile held on chip (shared memory here, VMEM on the TPU) and sums.

Counterparts of the Pallas probes in `scripts/exp_pallas_prims.py`:

  lane_loop  `sum_k x[b, i, (idx[b,i,j] + k) % W]`, `[64,H,128]` int32
             (`build_lane_loop`)
  rowsel     `sum_k roll(P[b], k, 0) @ S[b]` with P `[64,160]` one-hot bf16,
             S `[160,128]` bf16, float32 sum (`build_rowsel`); every rep's
             product on the tensor cores (`wgmma`, csrc/rowsel_mma.cu)
  roll       `sum_k roll(x[b], shift[b] + k, 1)`, `[64,64,512]` int32
             (`build_roll`)
  dynslice   `sum_k x[b, (start[b] + k) % 448 : +64]` from `[64,512,128]`
             int32 (`build_dynslice`)

All are exact: integer sums, and one-hot rows times integers below 256
summed in float32. Rep k's position is computed as the JAX kernels compute
it: index, shift or start plus k as int32 addition, which wraps past
INT32_MAX to INT32_MIN (`wrap32`), then taken modulo its axis as Python
takes it, so any int32 works; `edge_cases` draws such inputs, with widths
and counts of reps the script does not use.

    python -m metro_pose3d_tpu_torch.probes.prims
"""
from __future__ import annotations

import numpy as np
import torch

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.probes import check_cuda, time_ms

REPS = 64
B = 64
# the lane loop's and the roll's rows in one block's shared memory
# (csrc/probes.cu, kLoopSmemBytes / 4): a row's staged words must fit
LOOP_SMEM_WORDS = 48 * 1024 // 4
LAUNCHES = dict.fromkeys(("lane_loop", "rowsel", "roll", "dynslice"), 0)  # kernel launches


def wrap32(t: torch.Tensor) -> torch.Tensor:
    """An integer tensor folded into int32's range as two's-complement int32
    addition folds it (jnp's int32 `+`), kept as int64."""
    return (t.long() + 2 ** 31) % 2 ** 32 - 2 ** 31


def _call(fn_name: str, out: torch.Tensor, *args) -> torch.Tensor:
    lib = build.load()
    with torch.cuda.device(out.device):
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    build.check(err, fn_name)
    return out


def _launch(name: str, fn_name: str, out: torch.Tensor, *args) -> torch.Tensor:
    _call(fn_name, out, *args)
    LAUNCHES[name] += 1
    return out


def _check_loop(name: str, x: torch.Tensor, reps: int, row_words: int) -> None:
    if x.dim() != 3 or 0 in x.shape or x.numel() >= 2 ** 31 or x.shape[0] > 65535:
        raise ValueError(f"{name} takes x [B<=65535,H,W], nonempty, under 2^31 elements, "
                         f"got {tuple(x.shape)}")
    if reps < 0 or row_words > LOOP_SMEM_WORDS:
        raise ValueError(f"{name}: reps {reps} at W {x.shape[2]} needs {row_words} staged "
                         f"words a row, at most {LOOP_SMEM_WORDS}, and reps >= 0")


def lane_loop_plain(x: torch.Tensor, idx: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """x, idx [B,H,W] int32: sum_k x[b, i, (idx[b,i,j] + k) % W], idx + k in
    int32 arithmetic."""
    w = x.shape[2]
    acc = torch.zeros_like(x)
    for k in range(reps):
        acc += torch.take_along_dim(x, wrap32(idx.long() + k) % w, dim=2)
    return acc


def lane_loop_cuda(x: torch.Tensor, idx: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """The kernel: each window staged contiguous in shared memory, every
    warp's reads rotated onto distinct banks."""
    check_cuda("lane_loop_cuda", x, idx, dtypes=(torch.int32, torch.int32))
    if idx.shape != x.shape:
        raise ValueError(f"lane_loop_cuda takes x and idx of one shape, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    _check_loop("lane_loop_cuda", x, reps, x.shape[-1] + max(reps, 1) - 1)
    out = torch.empty_like(x)
    b, h, w = x.shape
    return _launch("lane_loop", "metro_probe_lane_loop", out, x.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), b, h, w, reps)


def rowsel_plain(p: torch.Tensor, s: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """p [B,R,K] one-hot bf16, s [B,K,N] bf16 -> [B,R,N] float32."""
    acc = torch.zeros(p.shape[0], p.shape[1], s.shape[2], dtype=torch.float32, device=p.device)
    pf, sf = p.float(), s.float()
    for k in range(reps):
        acc += torch.roll(pf, k, 1) @ sf
    return acc


ROWSEL_ROWS = 64  # the rowsel kernel's row tile: one warpgroup's wgmma M
ROWSEL_MAX_ROWS = 512  # P's rows and S fit in one block's shared memory
ROWSEL_SPLIT = 2  # blocks that share the reps of each 64 rows: 2 x 64 blocks for 132 SMs


def rowsel_cuda(p: torch.Tensor, s: torch.Tensor, reps: int = REPS,
                split: int = ROWSEL_SPLIT) -> torch.Tensor:
    """The tensor-core kernel: p [B,R,160] bf16 (R a multiple of 64, at most
    512), s [B,160,128] bf16 -> [B,R,128] float32; `split` blocks share the
    reps of each 64 rows and add their partial sums."""
    if (p.dim() != 3 or s.dim() != 3 or p.shape[0] != s.shape[0] or p.shape[2] != 160
            or tuple(s.shape[1:]) != (160, 128) or p.shape[1] % ROWSEL_ROWS
            or not 0 < p.shape[1] <= ROWSEL_MAX_ROWS):
        raise ValueError(f"rowsel_cuda takes p [B,R,160] with R a multiple of {ROWSEL_ROWS} up "
                         f"to {ROWSEL_MAX_ROWS} and s [B,160,128], got {tuple(p.shape)}, "
                         f"{tuple(s.shape)}")
    if split < 1 or reps < 0:
        raise ValueError(f"rowsel_cuda: split {split} and reps {reps}")
    check_cuda("rowsel_cuda", p, s, dtypes=(torch.bfloat16, torch.bfloat16))
    b, r, k = p.shape
    out = torch.zeros((b, r, 128), dtype=torch.float32, device=p.device)
    return _launch("rowsel", "metro_probe_rowsel", out, p.data_ptr(), s.data_ptr(),
                   out.data_ptr(), b, r, k, 128, reps, split)


def roll_plain(x: torch.Tensor, shift: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """x [B,H,W] int32, shift [B] int32: sum_k roll(x[b], shift[b] + k, columns),
    shift[b] + k in int32 arithmetic."""
    w = x.shape[2]
    cols = torch.arange(w, device=x.device)
    acc = torch.zeros_like(x)
    for k in range(reps):
        src = (cols[None, :] - wrap32(shift[:, None].long() + k)) % w  # [B, W]
        acc += torch.take_along_dim(x, src[:, None, :].expand_as(x), dim=2)
    return acc


def roll_cuda(x: torch.Tensor, shift: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """The kernel: a tile of rows staged rolled once by 16-byte copies, 4
    outputs a thread on a sliding window of registers."""
    check_cuda("roll_cuda", x, shift, dtypes=(torch.int32, torch.int32))
    if x.dim() != 3 or tuple(shift.shape) != (x.shape[0],):
        raise ValueError(f"roll_cuda takes x [B,H,W] and shift [B], got {tuple(x.shape)}, "
                         f"{tuple(shift.shape)}")
    _check_loop("roll_cuda", x, reps, 4 * -(-x.shape[2] // 4) + 4 * (reps // 4) + 8)
    out = torch.empty_like(x)
    b, h, w = x.shape
    return _launch("roll", "metro_probe_roll", out, x.data_ptr(), shift.data_ptr(),
                   out.data_ptr(), b, h, w, reps)


def dynslice_plain(x: torch.Tensor, start: torch.Tensor, rows: int = 64,
                   reps: int = REPS) -> torch.Tensor:
    """x [B,H,W] int32, start [B] int32 -> [B,rows,W]:
    sum_k x[b, (start[b] + k) % (H - rows) : + rows], start[b] + k in int32
    arithmetic."""
    b, h, w = x.shape
    r = torch.arange(rows, device=x.device)
    acc = torch.zeros((b, rows, w), dtype=x.dtype, device=x.device)
    for k in range(reps):
        src = (wrap32(start.long() + k) % (h - rows))[:, None] + r[None, :]  # [B, rows]
        acc += torch.take_along_dim(x, src[:, :, None].expand(b, rows, w), dim=1)
    return acc


def slice_runs(start: int, m: int, reps: int) -> list:
    """[(position, length), ...]: the row slice's reps as runs of consecutive
    positions, split where a position reaches m (back to 0) and where
    start + k passes INT32_MAX (to INT32_MIN's position), as
    `probe_dynslice_kernel` walks them (csrc/probes.cu)."""
    kw = min(reps, 2 ** 31 - int(start))  # reps before the int32 wrap
    runs, k, p = [], 0, int(start) % m
    while k < reps:
        n = min(reps - k, m - p, kw - k if k < kw else reps)
        runs.append((p, n))
        k, p = k + n, (p + n) % m
        if k == kw:
            p = -2 ** 31 % m
    return runs


def dynslice_touched_rows(start: torch.Tensor, h: int, rows: int, reps: int) -> int:
    """Rows of x the row slice reads at these starts, summed over the batch:
    a run of n positions from p reads rows p .. p + n + rows - 2."""
    total = 0
    for s in start.tolist():
        touched = np.zeros(h, bool)
        for p, n in slice_runs(s, h - rows, reps):
            touched[p:p + n + rows - 1] = True
        total += int(touched.sum())
    return total


def _dynslice(name: str, x: torch.Tensor, start: torch.Tensor, rows: int, reps: int,
              floor_only: bool) -> torch.Tensor:
    check_cuda(name, x, start, dtypes=(torch.int32, torch.int32))
    if (x.dim() != 3 or tuple(start.shape) != (x.shape[0],) or x.shape[1] > 512
            or not 0 < rows < x.shape[1] or reps < 0 or x.shape[0] > 65535):
        raise ValueError(f"{name} takes x [B<=65535,H<=512,W], start [B], 0 < rows < H and "
                         f"reps >= 0, got {tuple(x.shape)}, {tuple(start.shape)}, rows {rows}, "
                         f"reps {reps}")
    b, h, w = x.shape
    out = torch.empty((b, rows, w), dtype=x.dtype, device=x.device)
    return _call("metro_probe_dynslice", out, x.data_ptr(), start.data_ptr(), out.data_ptr(), b,
                 h, w, rows, reps, int(floor_only))


def dynslice_cuda(x: torch.Tensor, start: torch.Tensor, rows: int = 64,
                  reps: int = REPS) -> torch.Tensor:
    """The kernel: the reps split into runs of consecutive positions
    (`slice_runs`), only the rows the runs touch staged, a thread's 4 output
    rows of 4 columns summed in registers from each staged row."""
    out = _dynslice("dynslice_cuda", x, start, rows, reps, False)
    LAUNCHES["dynslice"] += 1
    return out


def dynslice_floor(x: torch.Tensor, start: torch.Tensor, rows: int = 64,
                   reps: int = REPS) -> torch.Tensor:
    """The launch floor of `dynslice_cuda`: an empty kernel on its grid,
    block and shared memory (the output is left unwritten). Not a launch of
    the row slice: `LAUNCHES` does not count it."""
    return _dynslice("dynslice_floor", x, start, rows, reps, True)


def make_cases(seed: int = 0, device="cpu", b: int = B) -> dict:
    """name -> (cuda fn, plain fn, args, elements of work), inputs drawn as the
    script draws them."""
    rng = np.random.RandomState(seed)

    def i32(lo, hi, shape):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int32)).to(device)

    cases = {}
    for h in (128, 256, 8):
        cases[f"lane gather x{REPS} [{h},128] i32"] = (
            lane_loop_cuda, lane_loop_plain, (i32(0, 1000, (b, h, 128)), i32(0, 128, (b, h, 128))),
            b * h * 128 * REPS)
    slab = i32(0, 255, (b, 160, 128)).to(torch.bfloat16)
    onehot = torch.from_numpy(np.eye(160, dtype=np.float32)[rng.randint(0, 160, (b, 64))])
    cases[f"one-hot rowsel x{REPS} [64,160]@[160,128] bf16"] = (
        rowsel_cuda, rowsel_plain, (onehot.to(device).to(torch.bfloat16), slab),
        b * 64 * 128 * REPS)
    cases[f"dyn roll x{REPS} [64,512] i32"] = (
        roll_cuda, roll_plain, (i32(0, 1000, (b, 64, 512)), i32(0, 512, (b,))),
        b * 64 * 512 * REPS)
    cases[f"dyn row slice x{REPS} [64,128] from [512,128]"] = (
        dynslice_cuda, dynslice_plain, (i32(0, 1000, (b, 512, 128)), i32(0, 512 - 64, (b,))),
        b * 64 * 128 * REPS)
    return cases


def edge_cases(device="cpu", seed: int = 1) -> dict:
    """name -> (cuda fn, plain fn, args, keyword args): the roll, lane loop
    and row slice at widths that are not a multiple of 4 or below 32, row
    counts that are not a multiple of a block's rows, reps 0, 1, 33 and above
    W, and shifts, indices and starts that are negative, at least the axis,
    or the ends of int32; the roll at many batch elements and at rows
    longer than a block's threads take in one pass; and the row slice's
    reps split at H - rows, at the int32 wrap, and at both."""
    rng = np.random.RandomState(seed)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)

    def data(*shape):
        return i32(rng.randint(-1000, 1000, shape))

    def starts(n, w):
        """n draws in [-3w, 3w), with the ends of int32 and -1, w first."""
        return np.r_[[lo, hi, -1, w], rng.randint(-3 * w, 3 * w, n)][:n]

    cases = {}
    for b, h, w, reps in ((4, 5, 13, 33), (2, 9, 8, 1), (2, 3, 8, 0), (3, 7, 8, 100),
                          (4, 3, 30, 64), (4, 5, 512, 64), (4, 3, 130, 7)):
        cases[f"roll [{b},{h},{w}] x{reps}"] = (
            roll_cuda, roll_plain, (data(b, h, w), i32(starts(b, w))), {"reps": reps})
        idx = starts(b * h * w, w)
        rng.shuffle(idx)
        cases[f"lane loop [{b},{h},{w}] x{reps}"] = (
            lane_loop_cuda, lane_loop_plain, (data(b, h, w), i32(idx.reshape(b, h, w))),
            {"reps": reps})
    # the roll at many batch elements, each with a short tile, and at rows
    # with more 4-column groups than a block has threads
    for b, h, w, reps in ((600, 9, 130, 7), (2, 3, 2000, 64)):
        cases[f"roll [{b},{h},{w}] x{reps}"] = (
            roll_cuda, roll_plain, (data(b, h, w), i32(starts(b, w))), {"reps": reps})
    for b, h, w, rows, reps in ((4, 40, 13, 10, 33), (4, 512, 128, 64, 64), (2, 20, 16, 5, 0),
                                (2, 20, 3, 19, 1)):
        cases[f"row slice [{b},{h},{w}] rows {rows} x{reps}"] = (
            dynslice_cuda, dynslice_plain, (data(b, h, w), i32(starts(b, h - rows))),
            {"rows": rows, "reps": reps})
    # the row slice's run splits: at H - rows alone, at the int32 wrap alone
    # (its script's shape, and m = 30), and both in one batch element, in
    # either order (m = 30: INT32_MAX - 10 wraps at 30 first, INT32_MAX - 2
    # at INT32_MAX first)
    for what, (b, h, w, rows), st in (
            ("modular wrap", (4, 512, 128, 64), [447, 440, 385, 0]),
            ("int32 wrap", (4, 512, 128, 64), [hi, hi - 5, hi - 62, hi - 63]),
            ("int32 wrap", (3, 40, 13, 10), [hi - 1, hi - 8, hi - 31]),
            ("both wraps", (4, 40, 13, 10), [hi - 10, hi - 2, hi - 20, 29])):
        cases[f"row slice [{b},{h},{w}] rows {rows} x{REPS if h == 512 else 33} {what}"] = (
            dynslice_cuda, dynslice_plain, (data(b, h, w), i32(st)),
            {"rows": rows, "reps": REPS if h == 512 else 33})
    return cases


def main() -> None:
    from metro_pose3d_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    for name, (cuda_fn, plain_fn, args, n_work) in make_cases(device=dev).items():
        out = cuda_fn(*args)
        ok = torch.equal(out, plain_fn(*args))
        ms = time_ms(lambda: cuda_fn(*args))
        print(f"{name}: ok={ok} {ms:8.4f} ms  {n_work / ms / 1e6:7.2f} G/s  "
              f"(sum={float(out.double().sum()):.3g})")


if __name__ == "__main__":
    main()
