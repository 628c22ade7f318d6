"""Map soft-argmax outputs to metric and image coordinates
(`metro_pose3d_tpu/ops/decode.py`)."""
from __future__ import annotations


def heatmap_to_metric(coords01, box_size_mm: float):
    """(0,1)^3 soft-argmax coords -> millimetres, centred in the metric cube."""
    return (coords01 - 0.5) * box_size_mm


def heatmap_to_image(coords01, proc_side: int):
    """(0,1)^2 soft-argmax coords -> crop pixels (u = 0.5 is pixel (S-1)/2)."""
    return coords01 * proc_side - 0.5


def image_to_unit(coords_px, proc_side: int):
    """Inverse of `heatmap_to_image` (crop pixels -> (0,1) units)."""
    return (coords_px + 0.5) / proc_side


def root_relative(coords, root_index: int):
    """Subtract the root joint: [..., J, C] -> root-relative coords."""
    return coords - coords[..., root_index: root_index + 1, :]
