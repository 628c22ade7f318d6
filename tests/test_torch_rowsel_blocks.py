"""The row-select probe's tensor-core kernel (`csrc/rowsel_mma.cu`), mirrored
on the CPU: its decomposition gives `rowsel_plain`'s bits, and its wrapper
refuses the shapes the kernel does not take before it looks for a card.

The kernel computes `out[b] = sum_k roll(P[b], k, rows) @ S[b]` with blocks
of 64 rows (one warpgroup's M), each taking a share of the reps (`split`
blocks an element), ten k16 products a rep, A rows read at (r - k) mod R, and
the blocks' float32 partial sums added into the output. Inputs are made from
a seed with numpy.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from metro_pose3d_tpu_torch.probes import prims

CSRC = Path(prims.__file__).resolve().parent.parent / "csrc" / "rowsel_mma.cu"


def _kernel_constants():
    """(rows a block, depth of a product step) as the kernel's source sets them."""
    src = CSRC.read_text()
    rows = int(re.search(r"kM = (\d+);", src).group(1))
    step = int(re.search(r"kKSteps = kK / (\d+);", src).group(1))
    return rows, step


def _blocks(p: np.ndarray, s: np.ndarray, reps: int, split: int) -> np.ndarray:
    """The kernel's decomposition in float32 numpy: grid (split, R / 64, B);
    block (sp, m, b) takes reps [sp * reps // split, (sp + 1) * reps // split),
    sums its k16 products in registers, then adds them to the output."""
    rows, step = _kernel_constants()
    b_n, r_n, k_n = p.shape
    out = np.zeros((b_n, r_n, s.shape[2]), np.float32)
    for b in range(b_n):
        for m in range(r_n // rows):
            r = m * rows + np.arange(rows)
            for sp in range(split):
                acc = np.zeros((rows, s.shape[2]), np.float32)
                for k in range(sp * reps // split, (sp + 1) * reps // split):
                    a = p[b, (r - k) % r_n]  # the roll, in the row addresses
                    for ks in range(0, k_n, step):
                        acc += a[:, ks:ks + step] @ s[b, ks:ks + step]
                out[b, r] += acc
    return out


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("reps", [1, 5, 64])
def test_decomposition_gives_the_plain_bits(reps, split, rows):
    rng = np.random.RandomState(reps * 100 + split * 10 + rows)
    p = np.eye(160, dtype=np.float32)[rng.randint(0, 160, (2, rows))]
    s = rng.randint(0, 255, (2, 160, 128)).astype(np.float32)
    want = prims.rowsel_plain(torch.from_numpy(p).bfloat16(), torch.from_numpy(s).bfloat16(),
                              reps)
    got = _blocks(p, s, reps, split)
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("p_shape,s_shape", [
    ((2, 48, 160), (2, 160, 128)),    # R not a multiple of the 64-row tile
    ((2, 100, 160), (2, 160, 128)),
    ((2, 576, 160), (2, 160, 128)),   # R beyond what shared memory holds
    ((2, 64, 128), (2, 128, 128)),    # K not 160
    ((2, 64, 160), (2, 160, 64)),     # N not 128
    ((2, 64, 160), (3, 160, 128)),    # batch sizes differ
], ids=["r48", "r100", "r576", "k128", "n64", "batch"])
def test_wrapper_refuses_other_shapes_before_the_device(p_shape, s_shape):
    p = torch.zeros(p_shape, dtype=torch.bfloat16)  # CPU tensors: the shape is checked first
    s = torch.zeros(s_shape, dtype=torch.bfloat16)
    before = dict(prims.LAUNCHES)
    with pytest.raises(ValueError, match="rowsel_cuda takes"):
        prims.rowsel_cuda(p, s)
    assert prims.LAUNCHES == before


def test_wrapper_takes_the_tile_shapes_then_needs_the_card():
    for rows in (64, 128, 512):
        with pytest.raises(ValueError, match="CUDA"):
            prims.rowsel_cuda(torch.zeros((1, rows, 160), dtype=torch.bfloat16),
                              torch.zeros((1, 160, 128), dtype=torch.bfloat16))
