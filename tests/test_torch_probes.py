"""The probes' plain versions against numpy at small shapes, and the looped
probes against the JAX kernels' own loop bodies on the CPU, exact; the CUDA
launchers refuse CPU tensors. The kernels themselves are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 16)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from metro_pose3d_tpu_torch.kernels import build
from metro_pose3d_tpu_torch.probes import gather, prims

PROBES_CU = Path(build.CSRC) / "probes.cu"


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "cols"])
@pytest.mark.parametrize("h,w", [(8, 128), (16, 24)])
def test_gather_plain_is_take_along_axis(h, w, axis, dtype):
    x, idx = gather.make_case(h, w, axis, dtype, b=3, seed=1)
    want = np.take_along_axis(x.numpy(), idx.numpy().astype(np.int64), axis=axis + 1)
    got = gather.gather_plain(x, idx, axis)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_shapes_are_the_scripts():
    assert gather.SHAPES[:3] == [(512, 512, 0, torch.int32, 64), (512, 512, 1, torch.int32, 64),
                                 (512, 512, 1, torch.float32, 64)]
    assert len(gather.SHAPES) == 15 and (8, 128, 0, torch.int32, 8) in gather.SHAPES
    assert (512, 512, 0, torch.float32, 64) in gather.SHAPES


def _np(t):
    return t.float().numpy().astype(np.float64) if t.dtype == torch.bfloat16 else t.numpy()


def test_lane_loop_plain():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 1000, (2, 5, 16)).astype(np.int32)
    idx = rng.randint(0, 16, (2, 5, 16)).astype(np.int32)
    want = sum(np.take_along_axis(x, (idx + k) % 16, axis=2) for k in range(7))
    got = prims.lane_loop_plain(torch.from_numpy(x), torch.from_numpy(idx), reps=7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rowsel_plain_is_the_one_hot_product():
    rng = np.random.RandomState(1)
    rows = rng.randint(0, 160, (2, 64))
    p = np.eye(160, dtype=np.float32)[rows]  # [2, 64, 160]
    s = rng.randint(0, 255, (2, 160, 128)).astype(np.float32)
    want = sum(np.roll(p, k, axis=1) @ s for k in range(5))
    got = prims.rowsel_plain(torch.from_numpy(p).bfloat16(), torch.from_numpy(s).bfloat16(), reps=5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)  # integers below 256: exact in bf16
    # a one-hot row selects: roll(P, k)[r] picks row rows[(r - k) % 64] of S
    np.testing.assert_array_equal(want[0, 3], sum(s[0, rows[0, (3 - k) % 64]] for k in range(5)))


def test_roll_plain():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 1000, (3, 4, 32)).astype(np.int32)
    shift = rng.randint(0, 32, 3).astype(np.int32)
    want = np.stack([sum(np.roll(x[b], int(shift[b]) + k, axis=1) for k in range(6))
                     for b in range(3)])
    got = prims.roll_plain(torch.from_numpy(x), torch.from_numpy(shift), reps=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dynslice_plain():
    rng = np.random.RandomState(3)
    x = rng.randint(0, 1000, (3, 40, 8)).astype(np.int32)
    start = rng.randint(0, 30, 3).astype(np.int32)
    want = np.stack([sum(x[b, (int(start[b]) + k) % 30:][:10] for k in range(9))
                     for b in range(3)])
    got = prims.dynslice_plain(torch.from_numpy(x), torch.from_numpy(start), rows=10, reps=9)
    assert got.shape == (3, 10, 8)
    np.testing.assert_array_equal(got.numpy(), want)


I32 = np.iinfo(np.int32)


def _wrap32(v):
    """v as two's-complement int32 addition leaves it: the JAX kernels add
    the rep to the index, shift or start in int32."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _roll_ref(x, shift, reps):
    return np.stack([sum(np.roll(x[b], _wrap32(int(shift[b]) + k), axis=1) for k in range(reps))
                     if reps else np.zeros_like(x[b]) for b in range(len(x))])


def _lane_loop_ref(x, idx, reps):
    w = x.shape[2]
    return sum((np.take_along_axis(x, _wrap32(idx.astype(np.int64) + k) % w, axis=2)
                for k in range(reps)), np.zeros_like(x))


def _dynslice_ref(x, start, rows, reps):
    h = x.shape[1]
    return np.stack([sum((x[b, _wrap32(int(start[b]) + k) % (h - rows):][:rows]
                          for k in range(reps)),
                         np.zeros_like(x[b, :rows])) for b in range(len(x))])


# The JAX kernels' loop bodies (scripts/exp_pallas_prims.py, closures in its
# main(), so written out here), one batch element each, vmapped, in int32 on
# the CPU: the rep k is an int32 loop index, so start + k wraps.
def _jax_loop(body, acc, reps):
    return lax.fori_loop(jnp.int32(0), jnp.int32(reps), body, acc)


def _jax_lane_loop(x, idx, reps):
    w = x.shape[2]

    def one(xx, ii):  # exp_pallas_prims.py:58-61
        return _jax_loop(lambda k, acc: acc + jnp.take_along_axis(xx, (ii + k) % w, axis=1),
                         jnp.zeros_like(xx), reps)
    return np.asarray(jax.vmap(one)(jnp.asarray(x), jnp.asarray(idx)))


def _jax_roll(x, shift, reps):
    def one(xx, sh):  # exp_pallas_prims.py:124-127
        return _jax_loop(lambda k, acc: acc + jnp.roll(xx, sh + k, 1), jnp.zeros_like(xx), reps)
    return np.asarray(jax.vmap(one)(jnp.asarray(x), jnp.asarray(shift)))


def _jax_dynslice(x, start, rows, reps):
    h, w = x.shape[1:]

    def one(xx, st):  # exp_pallas_prims.py:150-155
        return _jax_loop(lambda k, acc: acc + lax.dynamic_slice_in_dim(
            xx, (st + k) % (h - rows), rows, 0), jnp.zeros((rows, w), jnp.int32), reps)
    return np.asarray(jax.vmap(one)(jnp.asarray(x), jnp.asarray(start)))


def _int32_ends(n, reps, rng, lo, hi):
    """n starts: every start within reps + 1 of INT32_MAX and of INT32_MIN,
    then draws in [lo, hi)."""
    ends = np.r_[I32.max - np.arange(reps + 2), I32.min + np.arange(reps + 2)]
    return np.r_[ends, rng.randint(lo, hi, max(0, n - len(ends)))][:max(n, len(ends))]


@pytest.mark.parametrize("w,reps", [(13, 64), (30, 33), (130, 64), (128, 64), (8, 100)])
def test_lane_loop_plain_is_the_jax_kernels_int32_body(w, reps):
    rng = np.random.RandomState(w + reps)
    idx = _int32_ends(2 * 3 * w, reps, rng, -3 * w, 3 * w)
    rng.shuffle(idx)
    h = -(-len(idx) // (2 * w))
    idx = np.resize(idx, (2, h, w)).astype(np.int32)
    x = rng.randint(-1000, 1000, (2, h, w)).astype(np.int32)
    got = prims.lane_loop_plain(torch.from_numpy(x), torch.from_numpy(idx), reps=reps)
    np.testing.assert_array_equal(got.numpy(), _jax_lane_loop(x, idx, reps))


@pytest.mark.parametrize("w,reps", [(13, 64), (30, 33), (130, 64), (512, 64), (8, 100)])
def test_roll_plain_is_the_jax_kernels_int32_body(w, reps):
    rng = np.random.RandomState(w * reps)
    shift = _int32_ends(0, reps, rng, -3 * w, 3 * w).astype(np.int32)
    x = rng.randint(-1000, 1000, (len(shift), 3, w)).astype(np.int32)
    got = prims.roll_plain(torch.from_numpy(x), torch.from_numpy(shift), reps=reps)
    np.testing.assert_array_equal(got.numpy(), _jax_roll(x, shift, reps))


@pytest.mark.parametrize("h,rows,reps", [(512, 64, 64), (40, 10, 33), (143, 13, 64),
                                         (20, 19, 5), (40, 10, 70)])
def test_dynslice_plain_is_the_jax_kernels_int32_body(h, rows, reps):
    """m = H - rows: 448 is the script's row slice, 30 and 130 the edge
    cases' widths, 1 a slice that can only start at row 0."""
    rng = np.random.RandomState(h + rows + reps)
    start = _int32_ends(0, reps, rng, 0, h - rows).astype(np.int32)
    x = rng.randint(-1000, 1000, (len(start), h, 3)).astype(np.int32)
    got = prims.dynslice_plain(torch.from_numpy(x), torch.from_numpy(start), rows=rows, reps=reps)
    np.testing.assert_array_equal(got.numpy(), _jax_dynslice(x, start, rows, reps))


def test_int32_wrap_moves_the_row_slice():
    """Start 2^31 - 1 at m = 448: JAX's positions run 127, 320, 321 (2^32
    mod 448 = 192 back at the wrap), exact arithmetic's 127, 128, 129."""
    assert [_wrap32(I32.max + k) % 448 for k in range(3)] == [127, 320, 321]
    x = np.arange(512, dtype=np.int32)[None, :, None] * np.ones((1, 1, 2), np.int32)
    start = np.array([I32.max], np.int32)
    got = prims.dynslice_plain(torch.from_numpy(x), torch.from_numpy(start), rows=64, reps=3)
    np.testing.assert_array_equal(got.numpy(), _jax_dynslice(x, start, 64, 3))
    assert int(got[0, 0, 0]) == 127 + 320 + 321


@pytest.mark.parametrize("w,reps", [(32, 6), (13, 33), (8, 100), (30, 0)])
def test_roll_plain_takes_any_int32_shift(w, reps):
    rng = np.random.RandomState(w + reps)
    x = rng.randint(-1000, 1000, (6, 3, w)).astype(np.int32)
    shift = np.array([I32.min, I32.max, -1, w, -3 * w - 2, 5 * w + 1], np.int32)
    got = prims.roll_plain(torch.from_numpy(x), torch.from_numpy(shift), reps=reps)
    np.testing.assert_array_equal(got.numpy(), _roll_ref(x, shift, reps))


@pytest.mark.parametrize("w,reps", [(16, 7), (13, 33), (8, 100), (30, 1)])
def test_lane_loop_plain_takes_any_int32_start(w, reps):
    rng = np.random.RandomState(w * reps)
    x = rng.randint(-1000, 1000, (2, 5, w)).astype(np.int32)
    idx = rng.randint(-3 * w, 3 * w, (2, 5, w)).astype(np.int32)
    idx[0, 0, :4] = [I32.min, I32.max, -1, w]
    got = prims.lane_loop_plain(torch.from_numpy(x), torch.from_numpy(idx), reps=reps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _lane_loop_ref(x, idx, reps))


@pytest.mark.parametrize("h,rows,reps", [(40, 10, 9), (40, 10, 70), (20, 19, 1)])
def test_dynslice_plain_takes_any_int32_start(h, rows, reps):
    rng = np.random.RandomState(h + rows + reps)
    x = rng.randint(-1000, 1000, (5, h, 3)).astype(np.int32)
    start = np.array([I32.min, I32.max, -1, h - rows, -7 * h], np.int32)
    got = prims.dynslice_plain(torch.from_numpy(x), torch.from_numpy(start), rows=rows, reps=reps)
    np.testing.assert_array_equal(got.numpy(), _dynslice_ref(x, start, rows, reps))


def test_edge_cases_match_numpy_and_cover_the_edges():
    """Every edge case the card checks its kernels on, through the plain
    versions against numpy; and together they cover widths not a multiple
    of 4 and below 32, reps 0, 1, 33 and above the width, row counts that
    are not a multiple of a block's rows, and shifts, indices and starts
    that are negative, at least the axis, and the ends of int32."""
    cases = prims.edge_cases()
    seen = {"w%4": False, "w<32": False, "reps0": False, "reps1": False, "reps33": False,
            "reps>w": False, "negative": False, "past": False, "int32": False, "odd_h": False,
            "slice_modular_wrap": False, "slice_int32_wrap": False, "slice_both_wraps": False}
    for name, (cuda_fn, plain_fn, args, kw) in cases.items():
        x, s = (a.numpy() for a in args)
        reps = kw["reps"]
        got = plain_fn(*args, **kw).numpy()
        if cuda_fn is prims.roll_cuda:
            want, axis = _roll_ref(x, s, reps), x.shape[2]
        elif cuda_fn is prims.lane_loop_cuda:
            want, axis = _lane_loop_ref(x, s, reps), x.shape[2]
        else:
            want, axis = _dynslice_ref(x, s, kw["rows"], reps), x.shape[1] - kw["rows"]
        np.testing.assert_array_equal(got, want, err_msg=name)
        w = x.shape[2]
        seen["w%4"] |= w % 4 != 0
        seen["w<32"] |= w < 32
        seen["reps0"] |= reps == 0
        seen["reps1"] |= reps == 1
        seen["reps33"] |= reps == 33
        seen["reps>w"] |= reps > w
        seen["negative"] |= bool((s < 0).any())
        seen["past"] |= bool((s >= axis).any())
        seen["int32"] |= bool((s == I32.min).any() and (s == I32.max).any())
        seen["odd_h"] |= x.shape[1] % 2 == 1
        if cuda_fn is prims.dynslice_cuda:
            for start in s.tolist():
                kw = 2 ** 31 - start
                mod = any(p + n == axis for p, n in prims.slice_runs(start, axis, reps)[:-1])
                seen["slice_modular_wrap"] |= mod and kw >= reps
                seen["slice_int32_wrap"] |= kw < reps and not mod
                seen["slice_both_wraps"] |= kw < reps and mod
    assert all(seen.values()), seen


@pytest.mark.parametrize("m,reps", [(448, 64), (30, 33), (30, 100), (1, 5), (130, 64),
                                    (13, 64), (128, 64), (2, 0)])
def test_slice_runs_are_the_int32_positions(m, reps):
    """The row slice kernel's runs (mirrored by `prims.slice_runs`) lay the
    reps' positions end to end: position k is (start + k as int32) % m, and
    a run breaks only where a position reaches m or the sum wraps, so there
    are at most three runs where reps <= m."""
    rng = np.random.RandomState(m + reps)
    ends = np.r_[I32.max - np.arange(reps + 2), I32.min + np.arange(reps + 2)]
    for start in np.r_[ends, rng.randint(-3 * m, 3 * m, 50), rng.randint(I32.min, I32.max, 50)]:
        runs = prims.slice_runs(int(start), m, reps)
        got = [p + q for p, n in runs for q in range(n)]
        assert got == [_wrap32(int(start) + k) % m for k in range(reps)], start
        assert all(n > 0 and p + n <= m for p, n in runs)
        if reps <= m:
            assert len(runs) <= 3, (start, runs)


def test_dynslice_touched_rows_are_the_rows_read():
    rng = np.random.RandomState(5)
    for h, rows, reps in ((512, 64, 64), (40, 10, 33), (20, 19, 5), (40, 10, 0)):
        start = np.r_[I32.max - 3, I32.min, rng.randint(-100, 100, 6)].astype(np.int32)
        want = sum(len({(_wrap32(int(s) + k) % (h - rows)) + r for k in range(reps)
                        for r in range(rows)}) for s in start)
        assert prims.dynslice_touched_rows(torch.from_numpy(start), h, rows, reps) == want
    # the script's draws touch about 136 of 512 rows on average
    start = prims.make_cases(b=64)["dyn row slice x64 [64,128] from [512,128]"][2][1]
    assert 125 < prims.dynslice_touched_rows(start, 512, 64, 64) / 64 < 150


def test_gather_edge_cases_match_numpy_and_cover_the_edges():
    cases = gather.edge_cases()
    seen = set()
    for name, (x, idx, axis) in cases.items():
        want = np.take_along_axis(x.numpy(), idx.numpy().astype(np.int64), axis=axis + 1)
        np.testing.assert_array_equal(gather.gather_plain(x, idx, axis).numpy(), want,
                                      err_msg=name)
        b, h, w = x.shape
        assert x.is_contiguous() and idx.is_contiguous()
        for what, hit in (("W=1", w == 1), ("W=13", w == 13), ("W=130", w == 130),
                          ("H=1", h == 1), ("B=1", b == 1),
                          ("unaligned", x.data_ptr() % 16 != 0 or idx.data_ptr() % 16 != 0),
                          ("largest tile", h == gather.ROWS_MAX_H and axis == 0
                           or w == gather.COLS_MAX_W and axis == 1)):
            if hit:
                seen.add((what, axis, x.dtype))
    assert len(seen) == 7 * 2 * 2, sorted(seen)
    too_big = gather.untileable()
    assert {axis for _, _, axis in too_big.values()} == {0, 1}
    for x, _, axis in too_big.values():
        assert (x.shape[1] > gather.ROWS_MAX_H) if axis == 0 else (x.shape[2] > gather.COLS_MAX_W)


def test_gather_limits_are_the_kernels():
    """The wrapper's tile limits are the kernel's: its strip, and the shared
    memory a block may opt in to (csrc/probes.cu)."""
    src = PROBES_CU.read_text()
    assert int(re.search(r"constexpr int kGatherStrip = (\d+);", src).group(1)) == gather.STRIP
    assert int(re.search(r"constexpr int kSmemMax = (\d+);", src).group(1)) == gather.SMEM_MAX
    assert gather.ROWS_MAX_H * gather.STRIP * 4 <= gather.SMEM_MAX
    assert (gather.ROWS_MAX_H + 1) * gather.STRIP * 4 > gather.SMEM_MAX
    assert gather.COLS_MAX_W * 4 <= gather.SMEM_MAX < (gather.COLS_MAX_W + 1) * 4


def test_build_signatures_match_the_c_entry_points():
    """Each `extern "C"` entry point of csrc/ takes the ctypes arguments
    `build.SIGNATURES` gives it: a pointer for each pointer, int for int,
    float for float, long long for long long."""
    kinds = {"_VP": build._VP, "int": build._I, "float": build._F, "long": build._LL}
    found = {}
    for path in Path(build.CSRC).glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            found[name] = [kinds["_VP"] if "*" in p else kinds[p.split()[0]]
                           for p in params.split(",")]
    assert found == build.SIGNATURES


def test_prims_cases_have_the_scripts_shapes():
    cases = prims.make_cases(b=2)
    assert len(cases) == 6 and prims.REPS == 64 and prims.B == 64
    shapes = {name: [tuple(a.shape) for a in args] for name, (_, _, args, _) in cases.items()}
    assert shapes["one-hot rowsel x64 [64,160]@[160,128] bf16"] == [(2, 64, 160), (2, 160, 128)]
    assert shapes["dyn roll x64 [64,512] i32"] == [(2, 64, 512), (2,)]
    assert shapes["dyn row slice x64 [64,128] from [512,128]"] == [(2, 512, 128), (2,)]
    assert shapes["lane gather x64 [256,128] i32"] == [(2, 256, 128), (2, 256, 128)]
    onehot = cases["one-hot rowsel x64 [64,160]@[160,128] bf16"][2][0]
    assert onehot.dtype == torch.bfloat16 and bool((onehot.float().sum(-1) == 1).all())


@pytest.mark.parametrize("name", ["gather", "gather_floor", "lane_loop", "rowsel", "roll",
                                  "dynslice", "dynslice_floor"])
def test_cuda_launchers_raise_on_cpu_tensors(name):
    i = torch.zeros((2, 8, 16), dtype=torch.int32)
    calls = {
        "gather": lambda: gather.gather_cuda(i, i, 0),
        "gather_floor": lambda: gather.gather_floor(i, i, 1),
        "dynslice_floor": lambda: prims.dynslice_floor(i, torch.zeros(2, dtype=torch.int32),
                                                       rows=4),
        "lane_loop": lambda: prims.lane_loop_cuda(i, i),
        "rowsel": lambda: prims.rowsel_cuda(torch.zeros((2, 64, 160), dtype=torch.bfloat16),
                                            torch.zeros((2, 160, 128), dtype=torch.bfloat16)),
        "roll": lambda: prims.roll_cuda(i, torch.zeros(2, dtype=torch.int32)),
        "dynslice": lambda: prims.dynslice_cuda(i, torch.zeros(2, dtype=torch.int32), rows=4),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[name]()
    assert not gather.LAUNCHES and not any(prims.LAUNCHES.values())


def test_probe_mains_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for main in (gather.main, prims.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()
