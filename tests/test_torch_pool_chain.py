"""The stem pool backward kernel's inner step and its variant choice, on the CPU.

`pool.chain_tap_weights` writes out what the backward kernel
(csrc/maxpool3x3s2_bwd.cu) computes for each window: the nine weights of the
shift-and-max chain, one suffix product of its links. Scattered in the
kernel's window order, g * w must give the gradient that autograd gives
through `max_pool_plain` and that `jax.vjp` gives through the JAX package's
training pool. `pool.vector_width` picks the kernels' variant, and
`pool.KERNEL_LAUNCHES` counts launches by way, mode and variant.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.ops import pool_pallas
from metro_pose3d_tpu_torch.ops import pool


def _input(shape, kind, seed=0):
    """NHWC float32: "random"; "ties" (quarters: neighbours often equal);
    "relu" (a smooth field through a ReLU: whole windows tie at 0)."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4) / 4
    elif kind == "relu":
        b, h, w, c = shape
        coarse = rng.normal(size=(b, -(-h // 4), -(-w // 4), c)).astype(np.float32)
        x = np.maximum(np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w] + 0.3 * x, 0)
    return x


def _port(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def scatter_in_kernel_order(x, g, mode):
    """dx from `chain_tap_weights` as the backward kernel sums it: each input
    cell takes its windows' shares in the order (row above, column left),
    (row above, own column), (own row, column left), (own row, own column),
    in float32, skipping weights of 0."""
    b, c, h, w = x.shape
    oh, ow, (top, _), (left, _), _ = pool.pool_geometry(h, w, mode)
    weights = pool.chain_tap_weights(x, mode)
    acc = torch.zeros(b, c, 2 * oh + 1, 2 * ow + 1)
    # a window of the row (column) above reaches a cell with its tap row
    # (column) 2, its own window with tap rows (columns) 0 and 1; within one
    # pass every tap lands on cells of its own parity, so each cell takes at
    # most one share a pass
    for dys, dxs in (((2,), (2,)), ((2,), (0, 1)), ((0, 1), (2,)), ((0, 1), (0, 1))):
        for dy in dys:
            for dx in dxs:
                wk = weights[..., 3 * dy + dx]
                share = torch.where(wk != 0, g.float() * wk, torch.zeros(()))
                acc[:, :, dy: dy + 2 * oh: 2, dx: dx + 2 * ow: 2] += share
    return acc[:, :, top: top + h, left: left + w]


@pytest.mark.parametrize("kind", ["random", "ties", "relu"])
@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (2, 15, 13, 5)], ids=["even", "odd"])
@pytest.mark.parametrize("mode", ["same", "torch", "keras"])
def test_chain_tap_weights_scatter_to_the_gradient(mode, shape, kind):
    x = _input(shape, kind, seed=3)
    y, vjp = jax.vjp(lambda t: pool_pallas.stem_max_pool(t, mode=mode, train=True),
                     jnp.asarray(x))
    g = np.random.RandomState(4).normal(size=y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    xt, gt = _port(x), _port(g)
    weights = pool.chain_tap_weights(xt, mode)
    assert weights.shape == (*gt.shape, 9)
    # every weight is 0 or a power of two down to 2^-8: exact in any order
    nonzero = weights[weights != 0]
    assert bool((torch.frexp(nonzero).mantissa == 0.5).all()) and float(nonzero.min()) >= 2 ** -8
    got = scatter_in_kernel_order(xt, gt, mode)
    # sums of at most four products of g with a power of two
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-7, rtol=0)
    torch.testing.assert_close(got, pool.max_pool_bwd_plain(xt, gt, mode), atol=1e-7, rtol=0)
    if kind == "relu":
        # whole windows tie at 0: the first two taps take 2^-8, tap k > 1 2^-(9-k)
        tied = (weights != 0).all(-1)
        assert bool(tied.any())
        ladder = torch.tensor([2.0 ** -8] + [2.0 ** -(9 - k) for k in range(1, 9)])
        assert torch.equal(weights[tied], ladder.expand(int(tied.sum()), 9))


def test_chain_tap_weights_give_nan_taps_and_those_after_them_weight_one():
    x = torch.full((1, 1, 4, 4), -1.0)
    x[0, 0, :3, :3] = torch.arange(9.0).reshape(3, 3)  # window (0, 0): taps 0..8 rising
    x[0, 0, 1, 1] = float("nan")  # tap 4
    w = pool.chain_tap_weights(x.contiguous(memory_format=torch.channels_last))[0, 0, 0, 0]
    # torch.maximum's backward gives a NaN link (1, 1): taps 4..8 keep the
    # whole gradient, and taps 0..3 get the weights of the chain over them
    assert w.tolist() == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("c, dtype, ptrs, width", [
    (64, torch.bfloat16, (0, 256), 8),
    (64, torch.float32, (0, 256), 4),
    (24, torch.bfloat16, (16,), 8),
    (24, torch.float32, (16,), 4),
    (8, torch.bfloat16, (32, 48), 8),
    (5, torch.float32, (0,), 1),
    (12, torch.bfloat16, (0,), 1),
    (6, torch.float32, (0,), 1),
    (64, torch.bfloat16, (0, 2), 1),
    (64, torch.float32, (8, 0), 1),
], ids=lambda v: str(v).replace("torch.", "") if not isinstance(v, tuple) else "p" + "_".join(map(str, v)))
def test_vector_width_choice(c, dtype, ptrs, width):
    # a 16-byte vector where C is a multiple of it and every pointer is
    # 16-byte aligned; one element (the scalar variant) otherwise
    assert pool.vector_width(c, dtype, *ptrs) == width


def test_launch_counts_reset_by_variant():
    pool.KERNEL_LAUNCHES["fwd", "same", "vec16"] += 1
    pool.KERNEL_LAUNCHES["bwd", "keras", "scalar"] += 1
    pool.reset_launches()
    assert pool.VARIANT_LAUNCHES == {"fwd": {"vec16": 0, "scalar": 0},
                                     "bwd": {"vec16": 0, "scalar": 0}}
    assert pool.GRAD_COPIES == 0 and pool.LAUNCHES == 0 and pool.BWD_LAUNCHES == 0


def test_cpu_tensors_take_the_plain_path_and_count_no_variant():
    x = torch.from_numpy(_input((1, 8, 8, 8), "random")).permute(0, 3, 1, 2)
    before = dict(pool.KERNEL_LAUNCHES)
    xr = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    pool.stem_max_pool(xr, "torch").sum().backward()
    assert pool.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):  # no quiet fallback to the plain path
        pool.max_pool_bwd_cuda(xr.detach(), torch.zeros(1, 8, 4, 4), "torch")


@pytest.mark.parametrize("var, width", [("vec16", 8), ("scalar", 1)])
@pytest.mark.parametrize("mode", pool.MODES)
@pytest.mark.parametrize("way", pool.WAYS)
def test_one_launch_shows_in_every_view_of_the_counts(way, mode, var, width):
    pool.reset_launches()
    pool._count(way, mode, width)
    assert pool.KERNEL_LAUNCHES[way, mode, var] == 1 and sum(pool.KERNEL_LAUNCHES.values()) == 1
    fwd = way == "fwd"
    assert (pool.LAUNCHES, pool.BWD_LAUNCHES) == ((1, 0) if fwd else (0, 1))
    by_mode = {m: int(m == mode) for m in pool.MODES}
    none = dict.fromkeys(pool.MODES, 0)
    assert pool.MODE_LAUNCHES == (by_mode if fwd else none)
    assert pool.MODE_BWD_LAUNCHES == (none if fwd else by_mode)
    assert pool.VARIANT_LAUNCHES == {w: {v: int(w == way and v == var) for v in pool.VARIANTS}
                                     for w in pool.WAYS}
    pool.reset_launches()
    assert pool.launches() == 0
