"""Pointcloud normalization + channel concat for the model input crops.

Counterpart of ``foundationpose_cpp_tpu.ops.pointcloud``:
- threshold_and_downscale_pointcloud_kernel: foundationpose_render.cu:61-118
- concat_kernel: foundationpose_render.cu:121-140
"""

from __future__ import annotations

import torch


def threshold_and_downscale_pointcloud(
    xyz: torch.Tensor,
    poses: torch.Tensor,
    downscale_factor: float | torch.Tensor,
    min_depth: float,
    max_depth: float,
) -> torch.Tensor:
    """Center xyz crops on their pose translation and normalize by diameter/2.

    Per point: invalid if z < min_depth (checked BEFORE centering); subtract
    the pose translation; divide by downscale_factor; then zero each
    coordinate whose |value| > max_depth, and all coordinates of invalid
    points -- per coordinate, like the reference kernel (render.cu:99-116).

    xyz (N, H, W, 3), poses (N, 4, 4); downscale_factor a number, or an
    (N,) tensor of each pose's in xyz's dtype.
    """
    t = poses[:, :3, 3][:, None, None, :]
    invalid = xyz[..., 2:3] < min_depth
    if isinstance(downscale_factor, torch.Tensor):
        downscale_factor = downscale_factor[:, None, None, None]
    scaled = (xyz - t) / downscale_factor
    drop = (torch.abs(scaled) > max_depth) | invalid
    return torch.where(drop, torch.zeros_like(scaled), scaled)


def concat_channels(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC channel concat (concat_kernel, foundationpose_render.cu:121-140)."""
    return torch.cat([a, b], dim=-1)
