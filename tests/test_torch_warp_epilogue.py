"""K1's epilogues on the CPU: the port's plain chain against the JAX package,
the serving leg's dtype, and a mirror of the kernel's pixel-to-thread map.

The crop warp (`metro_pose3d_tpu_torch/ops/warp.py`) maps its float32 [0,255]
samples through an epilogue: `none`, `unit` (x 1/255) or `normalize`
(x 1/255, then `normalize`), in float32 or, for `normalize`, bf16. On the CPU
the wrapper runs the plain chain; on the card the kernel fuses it into its
store (checked there by `tests/test_torch_cuda.py` and `chip_smoke.py`
phase 4). Inputs are made from a seed with numpy.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metro_pose3d_tpu.ops import color as jcolor
from metro_pose3d_tpu.ops import warp as jwarp
from metro_pose3d_tpu_torch.ops import warp
from metro_pose3d_tpu_torch.pipeline.device import device_augment

TILE, SIDE, B = 64, 48, 3
# [0,255] units: test_torch_kernels_plain.py's warp tolerance (float32
# coordinate roundoff through the bilinear weights, summed in another order)
WARP_ATOL = 1e-2
UNITS = {"none": 1.0, "unit": 1 / 255, "normalize": 2 / 255,  # [0,255] -> the epilogue's units
         "normalize_div": 2 / 255}
FORMS = {f"{e}-{str(d)[6:]}": (e, d) for e, d in warp.FORMS}


def _params(rng, case):
    """H [B,3,3] (output px -> ray), K [B,4], dist [B,5] for one case: a
    rotation, scale and shift with a slight perspective row; "distortion"
    adds OpenCV lens distortion; "behind" turns the right half of each crop
    behind the camera (ray.z = 1 - 2x/side); "near_90" rotates by about
    +-90 degrees."""
    rot = {"near_90": (1.55, 1.6)}.get(case, (-0.5, 0.5))
    hs = []
    for i in range(B):
        ang = rng.uniform(*rot) * (-1) ** i
        sc = rng.uniform(0.8, 1.8)
        a = sc * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        hmat = np.eye(3)
        hmat[:2, :2] = a
        hmat[:2, 2] = TILE / 2 + rng.uniform(-6, 6, 2) - a @ [SIDE / 2, SIDE / 2]
        hmat[2, :2] = rng.uniform(-1, 1, 2) * 1e-3
        hs.append(hmat)
    h = np.stack(hs)
    k = np.tile([1.0, 1.0, 0.0, 0.0], (B, 1))
    d = np.zeros((B, 5))
    if case in ("distortion", "shared_frame"):
        f = float(TILE)
        pre = np.array([[1 / f, 0, -TILE / 2 / f], [0, 1 / f, -TILE / 2 / f], [0, 0, 1]])
        h = np.einsum("ij,bjk->bik", pre, h)
        k = np.tile([f, f, TILE / 2, TILE / 2], (B, 1))
        d = np.tile([-0.15, 0.03, 5e-4, -5e-4, 0.01], (B, 1))
    if case == "behind":
        h[:, 2] = [-2.0 / SIDE, 0.0, 1.0]
    return h.astype(np.float32), k.astype(np.float32), d.astype(np.float32)


def _jax_chain(tiles, h, k, d, epilogue):
    """The JAX package's float32 chain: the reference warp, x 1/255, normalize."""
    x = jwarp.warp_images_reference(jnp.asarray(tiles, jnp.float32), jnp.asarray(h),
                                    jnp.asarray(k), jnp.asarray(d), SIDE)
    if epilogue == "normalize_div":  # the multi-person frame path's chain
        x = x / 255.0
    elif epilogue != "none":
        x = x * (1.0 / 255.0)
    if epilogue.startswith("normalize"):
        x = jcolor.normalize(x)
    return x


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (8 bits of significand)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("case", ["plain", "distortion", "behind", "near_90", "shared_frame"])
def test_plain_chain_matches_jax(case, form):
    epilogue, dtype = FORMS[form]
    rng = np.random.RandomState(sum(map(ord, case)))
    h, k, d = _params(rng, case)
    if case == "shared_frame":
        frame = rng.randint(0, 256, (1, TILE, TILE + 16, 3)).astype(np.uint8)
        got = warp.warp_images(torch.from_numpy(frame), *map(torch.from_numpy, (h, k, d)), SIDE,
                               torch.zeros(B, dtype=torch.int32), epilogue, dtype)
        tiles = np.repeat(frame, B, 0)
    else:
        tiles = rng.randint(0, 256, (B, TILE, TILE, 3)).astype(np.uint8)
        got = warp.warp_images(torch.from_numpy(tiles), *map(torch.from_numpy, (h, k, d)), SIDE,
                               epilogue=epilogue, out_dtype=dtype)
    assert got.dtype == dtype and got.shape == (B, SIDE, SIDE, 3)
    want32 = _jax_chain(tiles, h, k, d, epilogue)
    atol = WARP_ATOL * UNITS[epilogue]
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want32), atol=atol, rtol=0)
    else:  # the same chain rounded to bf16 by JAX: within one bf16 ulp
        want = np.asarray(want32.astype(jnp.bfloat16).astype(jnp.float32))
        err = np.abs(got.float().numpy() - want)
        assert np.all(err <= _bf16_ulp(want) + atol), float(err.max())
    if case == "behind":  # a ray behind the camera samples zeros, through the epilogue
        _, in_front = warp.warp_coords(*map(torch.from_numpy, (h, k, d)), SIDE)
        assert 0 < int(in_front.sum()) < in_front.numel()
        zero = warp.apply_epilogue(torch.zeros(1), epilogue, dtype)
        assert bool((got[~in_front] == zero).all())


def _tile_batch(seed=3):
    rng = np.random.RandomState(seed)
    h, k, d = _params(rng, "distortion")
    return {"source": torch.from_numpy(rng.randint(0, 256, (B, TILE, TILE, 3)).astype(np.uint8)),
            "warp_h": torch.from_numpy(h), "warp_k": torch.from_numpy(k),
            "warp_dist": torch.from_numpy(d)}


def test_serving_leg_in_bf16_is_the_float32_leg_rounded():
    batch = _tile_batch()
    got = device_augment(batch, SIDE, train=False, out_dtype=torch.bfloat16)
    want = device_augment(batch, SIDE, train=False).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_serving_leg_is_the_unfused_chain():
    from metro_pose3d_tpu_torch.ops.color import normalize

    batch = _tile_batch(4)
    got = device_augment(batch, SIDE, train=False)
    raw = warp.warp_images(batch["source"], batch["warp_h"], batch["warp_k"],
                           batch["warp_dist"], SIDE)
    want = normalize(raw * (1.0 / 255.0))
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_train_leg_refuses_a_narrower_dtype():
    with pytest.raises(ValueError, match="float32"):
        device_augment(_tile_batch(), SIDE, train=True, out_dtype=torch.bfloat16)


def test_forms_are_checked():
    batch = _tile_batch()
    args = (batch["source"], batch["warp_h"], batch["warp_k"], batch["warp_dist"], SIDE)
    for epilogue, dtype in (("none", torch.bfloat16), ("unit", torch.bfloat16),
                            ("clip", torch.float32), ("normalize", torch.float16)):
        with pytest.raises(ValueError, match="epilogue"):
            warp.warp_images(*args, epilogue=epilogue, out_dtype=dtype)


# ---------------------------------------------- the kernel's pixel-to-thread map

CSRC = Path(warp.__file__).resolve().parent.parent / "csrc" / "warp_crop.cu"


def _kernel_constants():
    """kWarps and the pixels a lane takes for each output type, read from the
    kernel's source, so the mirror below follows the kernel."""
    src = CSRC.read_text()
    warps = int(re.search(r"constexpr int kWarps = (\d+)", src).group(1))
    pix = {torch.float32: {int(n) for n in re.findall(r"launch<k\w+, float, (\d+)>", src)},
           torch.bfloat16: {int(n) for n in re.findall(r"launch<k\w+, __nv_bfloat16, (\d+)>",
                                                       src)}}
    assert all(len(v) == 1 for v in pix.values()), pix
    return warps, {dt: v.pop() for dt, v in pix.items()}


def _thread_map(side: int, batch: int, dtype):
    """Replay the kernel's launch and its lanes' loads and stores in numpy.
    -> (how many times each output element is stored, the byte offsets of the
    16-byte stores, how many times each pixel is sampled)."""
    warps, pix = _kernel_constants()
    kpix = pix[dtype]
    seg = 32 * kpix
    size = dtype.itemsize
    grid = (-(-side // seg), -(-side // warps), batch)
    stores = np.zeros(batch * side * side * 3, np.int64)
    sampled = np.zeros(batch * side * side, np.int64)
    vector_offsets = []
    lanes = np.arange(32)
    for b in range(grid[2]):
        for by in range(grid[1]):
            for w in range(warps):
                y = by * warps + w
                if y >= side:
                    continue
                for bx in range(grid[0]):
                    first = bx * seg
                    npix = min(seg, side - first)
                    for i in range(kpix):  # lane l samples pixel first + 32 i + l
                        p = i * 32 + lanes
                        p = p[p < npix]
                        np.add.at(sampled, (b * side + y) * side + first + p, 1)
                    e0 = ((b * side + y) * side + first) * 3
                    nbytes = npix * 3 * size
                    if (e0 * size) % 16 == 0 and nbytes % 16 == 0:
                        for j in range(nbytes // 16):  # lane j % 32 stores chunk j
                            start = e0 + j * 16 // size
                            stores[start:start + 16 // size] += 1
                            vector_offsets.append((e0 * size + 16 * j))
                    else:
                        stores[e0:e0 + npix * 3] += 1
    return stores, np.asarray(vector_offsets), sampled


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("side", [1, 7, 8, 255, 256, 257])
def test_thread_map_covers_each_output_once(side, dtype):
    stores, vector_offsets, sampled = _thread_map(side, 2, dtype)
    assert np.all(stores == 1)
    assert np.all(sampled == 1)
    assert np.all(vector_offsets % 16 == 0)
    if side % 8 == 0:  # every row segment aligned: all of it in 16-byte stores
        assert len(vector_offsets) * 16 == stores.size * dtype.itemsize
