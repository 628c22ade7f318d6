"""The traffic generator. A traffic file (`benchmark/traffic/<name>.json`)
gives its parameters and its `kind`; the kind (`benchmark/kinds/<kind>.py`)
makes its pool from the parts here, and the seed gives the contents. Every
seed gets the same sizes and the same order of work: only pixels, cameras,
poses and augmentation parameters change with it.

The training pool: device-resident train batches of `rows_3d` 3D and
`rows_2d` 2D rows of source tiles, with foreground masks and background,
occluder and colour parameters, plus the occluder and background banks.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.camera import crop_params


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator for (seed, stream); any integer seed."""
    return np.random.default_rng([seed % 2**64, stream])


def torch_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % 2**63)
    return g


def uint8_noise(r: np.random.Generator, shape) -> np.ndarray:
    return np.frombuffer(r.bytes(int(np.prod(shape))), np.uint8).reshape(shape).copy()


def calibration_crops(cfg: dict, seed: int) -> list:
    """The int8 mode's calibration set: `calib_batches` batches of
    `calib_batch` uint8 crops (seeded noise, not real data)."""
    s = cfg["proc_side"]
    return [uint8_noise(rng(seed, 1000 + i), (cfg["calib_batch"], s, s, 3))
            for i in range(cfg["calib_batches"])]


def _ellipse_masks(r, b, tile, device):
    """Foreground masks: an ellipse with a soft edge, 255 inside."""
    c = torch.from_numpy(r.uniform(0.3, 0.7, (b, 2)).astype(np.float32)).to(device)
    rad = torch.from_numpy(r.uniform(0.1, 0.3, (b, 2)).astype(np.float32)).to(device)
    g = torch.arange(tile, dtype=torch.float32, device=device) / tile
    ys, xs = g.view(1, -1, 1), g.view(1, 1, -1)
    r2 = (((xs - c[:, 0, None, None]) / rad[:, 0, None, None]) ** 2
          + ((ys - c[:, 1, None, None]) / rad[:, 1, None, None]) ** 2)
    return (torch.clamp((1 - r2) * 4, 0, 1) * 255).to(torch.uint8)


def train_batch(r, traffic: dict, cfg: dict, gen, device) -> dict:
    """Rows in the system's host->device layout: warps from the camera model,
    a random skeleton 3.5-5 m in front of the crop camera projected into the
    crop, colour parameters (80% of rows), an occluder (70%), a background
    (70%); the last `rows_2d` rows are 2D-only."""
    n3, n2, tile, side = traffic["rows_3d"], traffic["rows_2d"], traffic["tile_side"], \
        cfg["proc_side"]
    b, j = n3 + n2, cfg["num_joints"]
    h, k, d, intr = crop_params(r, b, tile, side)
    root = np.stack([r.uniform(-300, 300, b), r.uniform(-300, 300, b),
                     r.uniform(3500, 5000, b)], 1)
    xyz = (root[:, None] + r.uniform(-600, 600, (b, j, 3))).astype(np.float32)
    uv = np.einsum("bij,bkj->bki", intr, xyz)
    uv = (uv[..., :2] / uv[..., 2:]).astype(np.float32)
    valid2d = ((uv >= 0) & (uv < side)).all(-1).astype(np.float32)
    is3d = np.r_[np.ones(n3), np.zeros(n2)].astype(np.float32)
    do_color = r.random(b) < 0.8
    color = np.where(do_color[:, None], np.stack(
        [r.uniform(-0.125, 0.125, b), r.uniform(0.75, 1.25, b),
         r.uniform(0.75, 1.25, b), r.uniform(-0.3, 0.3, b)], 1), [0.0, 1.0, 1.0, 0.0])
    occ_side = traffic["occluder_side"]
    scale, centre, rot = r.uniform(0.2, 0.7, b), r.uniform(0.1, 0.9, (b, 2)), \
        r.uniform(-np.pi, np.pi, b)
    m = np.stack([np.stack([np.cos(rot), -np.sin(rot)], -1),
                  np.stack([np.sin(rot), np.cos(rot)], -1)], 1) / scale[:, None, None]
    occ_aff = np.concatenate([m, (occ_side / 2.0 - np.einsum("bij,bj->bi", m, centre * side))
                              [..., None]], -1)
    occ = np.stack([r.random(b) < 0.7, r.integers(0, traffic["occluders"], b)], 1)
    bg = np.stack([r.random(b) < 0.7, r.integers(0, traffic["backgrounds"], b)], 1)
    host = {"warp_h": h, "warp_k": k, "warp_dist": d,
            "coords3d_true": xyz * is3d[:, None, None], "coords2d_true": uv,
            "joint_validity": np.repeat(is3d[:, None], j, 1), "joint_validity_2d": valid2d,
            "is_3d": is3d, "intrinsics": intr, "color_params": color, "occ_params": occ,
            "occ_affine": occ_aff, "bg_params": bg}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
             for k, v in host.items()}
    batch["source"] = torch.randint(0, 256, (b, tile, tile, 3), generator=gen, device=device,
                                    dtype=torch.uint8)
    batch["source_mask"] = _ellipse_masks(r, b, tile, device)
    return batch


def occluder_bank(r, n: int, side: int, device) -> torch.Tensor:
    """uint8 RGBA [N,T,T,4]: textured ellipses with soft alpha edges."""
    g = torch.arange(side, dtype=torch.float32, device=device) - (side - 1) / 2.0
    ys, xs = g.view(1, -1, 1), g.view(1, 1, -1)
    p = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in {
        "a": r.uniform(0.25, 0.48, n) * side, "b": r.uniform(0.25, 0.48, n) * side,
        "th": r.uniform(0, np.pi, n), "f": r.uniform(0.02, 0.12, (n, 2)),
        "ph": r.uniform(0, 2 * np.pi, (n, 2, 3)), "base": r.uniform(0.1, 0.9, (n, 3))}.items()}
    ct, st = torch.cos(p["th"]).view(-1, 1, 1), torch.sin(p["th"]).view(-1, 1, 1)
    u, v = xs * ct + ys * st, -xs * st + ys * ct
    alpha = torch.clamp((1 - (u / p["a"].view(-1, 1, 1)) ** 2 - (v / p["b"].view(-1, 1, 1)) ** 2)
                        * 4, 0, 1)
    tex = (p["base"].view(n, 1, 1, 3)
           + 0.25 * torch.sin(p["f"][:, 0].view(n, 1, 1, 1) * u[..., None] * 2 * np.pi
                              + p["ph"][:, 0].view(n, 1, 1, 3))
           + 0.25 * torch.sin(p["f"][:, 1].view(n, 1, 1, 1) * v[..., None] * 2 * np.pi
                              + p["ph"][:, 1].view(n, 1, 1, 3)))
    rgba = torch.cat([torch.clamp(tex, 0, 1), alpha[..., None]], -1)
    return torch.round(rgba * 255).to(torch.uint8)


def background_bank(r, n: int, side: int, device) -> torch.Tensor:
    """uint8 [N,T,T,3] low-frequency colour fields."""
    g = torch.arange(side, dtype=torch.float32, device=device) / side
    ys, xs = g.view(1, -1, 1, 1), g.view(1, 1, -1, 1)
    img = torch.from_numpy(r.uniform(0.15, 0.75, (n, 1, 1, 3)).astype(np.float32)).to(device)
    for _ in range(4):
        f = torch.from_numpy(r.uniform(0.5, 4.0, (n, 2)).astype(np.float32)).to(device)
        ph = torch.from_numpy(r.uniform(0, 2 * np.pi, (n, 2, 3)).astype(np.float32)).to(device)
        amp = torch.from_numpy(r.uniform(0.05, 0.25, (n, 1, 1, 3)).astype(np.float32)).to(device)
        img = img + amp * (torch.sin(f[:, 0].view(n, 1, 1, 1) * xs * 2 * np.pi
                                     + ph[:, 0].view(n, 1, 1, 3))
                           + torch.sin(f[:, 1].view(n, 1, 1, 1) * ys * 2 * np.pi
                                       + ph[:, 1].view(n, 1, 1, 3)))
    return torch.clamp(img * 255, 0, 255).to(torch.uint8)


def train_pool(traffic: dict, cfg: dict, seed: int, device) -> dict:
    """{"batches": [...], "occluders": uint8 [N,T,T,4], "backgrounds": uint8
    [N,T,T,3]}, all on `device`."""
    gen = torch_generator(seed, device)
    batches = [train_batch(rng(seed, 1 + i), traffic, cfg, gen, device)
               for i in range(traffic["pool"])]
    return {"batches": batches,
            "occluders": occluder_bank(rng(seed, 2000), traffic["occluders"],
                                       traffic["occluder_side"], device),
            "backgrounds": background_bank(rng(seed, 3000), traffic["backgrounds"],
                                           traffic["tile_side"], device)}
