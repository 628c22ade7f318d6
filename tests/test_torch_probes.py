"""The probes' plain versions against numpy at small shapes, exact; the CUDA
launchers refuse CPU tensors. The kernels themselves are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 16)."""
import numpy as np
import pytest
import torch

from metro_pose3d_tpu_torch.probes import gather, prims


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


def _roll_ref(x, shift, reps):
    return np.stack([sum(np.roll(x[b], int(shift[b]) + k, axis=1) for k in range(reps))
                     if reps else np.zeros_like(x[b]) for b in range(len(x))])


def _lane_loop_ref(x, idx, reps):
    w = x.shape[2]
    return sum((np.take_along_axis(x, (idx.astype(np.int64) + k) % w, axis=2)
                for k in range(reps)), np.zeros_like(x))


def _dynslice_ref(x, start, rows, reps):
    h = x.shape[1]
    return np.stack([sum((x[b, (int(start[b]) + k) % (h - rows):][:rows] for k in range(reps)),
                         np.zeros_like(x[b, :rows])) for b in range(len(x))])


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
            "reps>w": False, "negative": False, "past": False, "int32": False, "odd_h": False}
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
    assert all(seen.values()), seen


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


@pytest.mark.parametrize("name", ["gather", "lane_loop", "rowsel", "roll", "dynslice"])
def test_cuda_launchers_raise_on_cpu_tensors(name):
    i = torch.zeros((2, 8, 16), dtype=torch.int32)
    calls = {
        "gather": lambda: gather.gather_cuda(i, i, 0),
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
