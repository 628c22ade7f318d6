"""Absolute reconstruction and bone-length scale recovery, in float32
(`metro_pose3d_tpu/ops/pose3d.py`)."""
from __future__ import annotations

import torch


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # solve_ex: no host-side error check, so no device sync on CUDA; `a` is
    # regularized to be nonsingular below
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def reconstruct_absolute(pose3d_rootrel, pose2d_px, intrinsics, weights=None,
                         weak_perspective: bool = False):
    """Closed-form least-squares camera-frame translation of a metric pose.

    Each joint j with normalized ray (x_j, y_j) = K^-1 pose2d_j gives two
    linear equations in t = (tx, ty, tz):
        tx - x_j tz = x_j P_jz - P_jx
        ty - y_j tz = y_j P_jz - P_jy
    solved through the 3x3 normal equations, with a Tikhonov term and two
    steps of iterative refinement.

    pose3d_rootrel [B,J,3] mm, pose2d_px [B,J,2] crop px, intrinsics
    [B,3,3], optional weights [B,J] -> absolute pose [B,J,3] mm.
    `weak_perspective` drops the x_j P_jz coupling (orthographic depth).
    """
    p = pose3d_rootrel.float()
    b, j, _ = p.shape
    k = intrinsics.float()
    fx, fy = k[:, 0, 0][:, None], k[:, 1, 1][:, None]
    cx, cy = k[:, 0, 2][:, None], k[:, 1, 2][:, None]
    skew = k[:, 0, 1][:, None]
    y = (pose2d_px[..., 1] - cy) / fy
    x = (pose2d_px[..., 0] - cx - skew * y) / fx

    w = torch.ones((b, j), dtype=torch.float32, device=p.device) if weights is None \
        else weights.float()
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-6)

    if weak_perspective:
        bx, by = -p[..., 0], -p[..., 1]
    else:
        bx = x * p[..., 2] - p[..., 0]
        by = y * p[..., 2] - p[..., 1]

    sw = w.sum(-1)
    swx = (w * x).sum(-1)
    swy = (w * y).sum(-1)
    swxx = (w * (x * x + y * y)).sum(-1)
    zero = torch.zeros_like(sw)
    ata = torch.stack([
        torch.stack([sw, zero, -swx], -1),
        torch.stack([zero, sw, -swy], -1),
        torch.stack([-swx, -swy, swxx], -1),
    ], dim=-2)  # [B, 3, 3]
    atb = torch.stack([
        (w * bx).sum(-1),
        (w * by).sum(-1),
        (w * (-x * bx - y * by)).sum(-1),
    ], dim=-1)  # [B, 3]
    # Tikhonov epsilon relative to the matrix scale: well-posed for
    # degenerate 2D configurations without biasing tz
    trace = ata[:, 0, 0] + ata[:, 1, 1] + ata[:, 2, 2]
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device)
    ata = ata + (1e-6 * trace + 1e-9)[:, None, None] * eye
    t = _solve(ata, atb)

    # the system couples |x|, |y| << 1 weakly to tz ~ metres, so one float32
    # solve leaves ~1 mm of roundoff in tz; refine in the residual space
    def refine(t):
        tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
        rx = bx - (tx - x * tz)
        ry = by - (ty - y * tz)
        atr = torch.stack([
            (w * rx).sum(-1),
            (w * ry).sum(-1),
            (w * (-x * rx - y * ry)).sum(-1),
        ], dim=-1)
        return t + _solve(ata, atr)

    t = refine(refine(t))
    return p + t[:, None, :]


def bone_lengths(pose: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """[..., J, 3] pose + (E, 2) edges -> [..., E] bone lengths."""
    return torch.linalg.vector_norm(pose[..., edges[:, 0], :] - pose[..., edges[:, 1], :], dim=-1)


def mean_bone_lengths(poses: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Dataset-mean bone lengths [E] from [N, J, 3] ground-truth poses."""
    return bone_lengths(poses, edges).mean(dim=0)


def rescale_to_bone_lengths(pose_rootrel, edges, ref_lengths):
    """Uniformly rescale the skeleton to the reference bone lengths
    (least-squares scale s = sum(l_ref l) / sum(l^2))."""
    lens = bone_lengths(pose_rootrel, edges)
    num = (lens * ref_lengths).sum(-1)
    den = torch.clamp((lens * lens).sum(-1), min=1e-8)
    return pose_rootrel * (num / den)[..., None, None]
