"""Batched pose-conditioned crop warps of the observed RGB / xyz images.

Counterpart of the gather warps of ``foundationpose_cpp_tpu.ops.warp``
(warp.py:30-118), which replace the reference's 252-iteration host loop of
cvcuda::WarpPerspective calls (TransfProcess, foundationpose_render.cpp:
731-812) with one batched inverse-affine gather.

OpenCV/cvcuda warpPerspective semantics: destination pixel (x, y) samples
the source at M^-1 (x, y, 1) -- integer pixel coordinates, no half-pixel
offset -- with INTERP_LINEAR for RGB (computed on u8 values and rounded, as
cvcuda does, before the 1/255 ConvertTo), INTERP_NEAREST for xyz, and
BORDER_CONSTANT 0 outside. ``torch.round`` and ``jnp.round`` both round half
to even, so both warps agree bit for bit with the JAX ones.

Both warps take one image shared by the N poses (Register, Track: there they
are the plain version of ``ops/crop.py``'s kernel) or a batch of N images,
pose i sampling image i (the trainer, where every hypothesis has its own
observed frame; the JAX trainer vmaps the one-image warp).
"""

from __future__ import annotations

import torch

from foundationpose_cpp_tpu_torch.geometry.transforms import invert_affine3


def _source_coords(tfs: torch.Tensor, crop_h: int, crop_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-image sampling coordinates for every (pose, crop pixel)."""
    inv = invert_affine3(tfs)
    xs = torch.arange(crop_w, dtype=torch.float32, device=tfs.device)[None, :].expand(crop_h, crop_w)
    ys = torch.arange(crop_h, dtype=torch.float32, device=tfs.device)[:, None].expand(crop_h, crop_w)
    sx = (
        inv[:, 0, 0][:, None, None] * xs
        + inv[:, 0, 1][:, None, None] * ys
        + inv[:, 0, 2][:, None, None]
    )
    sy = (
        inv[:, 1, 0][:, None, None] * xs
        + inv[:, 1, 1][:, None, None] * ys
        + inv[:, 1, 2][:, None, None]
    )
    return sx, sy


def _frame_base(img: torch.Tensor, h: int, w: int) -> torch.Tensor | None:
    """Offset of image i's first pixel in the flattened batch, (N, 1, 1);
    None for one shared (H, W, C) image."""
    if img.dim() == 3:
        return None
    n = img.shape[0]
    return (torch.arange(n, dtype=torch.int64, device=img.device) * (h * w))[:, None, None]


def _index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Clamped gather index; NaN coordinates (a failed translation guess
    puts poses at z = 0) read index 0 and are masked out by the caller."""
    return torch.clamp(torch.nan_to_num(coord, nan=0.0), 0, size - 1).to(torch.int64)


def warp_crop_linear_u8(
    rgb: torch.Tensor, tfs: torch.Tensor, crop_h: int, crop_w: int
) -> torch.Tensor:
    """Bilinear warp of a (H, W, 3) u8 image, or of N such images one per
    pose, into (N, crop_h, crop_w, 3) f32 in [0,1]."""
    h, w, c = rgb.shape[-3:]
    if c != 3:
        raise ValueError(f"warp_crop_linear_u8 takes 3 channels, got {c}")
    base = _frame_base(rgb, h, w)
    sx, sy = _source_coords(tfs, crop_h, crop_w)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    planes = rgb.to(torch.float32).movedim(-1, 0).reshape(3, -1)

    def corner(xc, yc):
        inb = (xc >= 0) & (xc < w) & (yc >= 0) & (yc < h)
        xi = _index(xc, w)
        yi = _index(yc, h)
        flat = yi * w + xi if base is None else yi * w + xi + base
        vals = planes[:, flat.reshape(-1)].reshape(3, *xi.shape)
        return torch.where(inb[None], vals, torch.zeros_like(vals))

    v00 = corner(x0, y0)
    v10 = corner(x0 + 1, y0)
    v01 = corner(x0, y0 + 1)
    v11 = corner(x0 + 1, y0 + 1)
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    out = [
        torch.round(v00[k] * w00 + v10[k] * w10 + v01[k] * w01 + v11[k] * w11)
        * (1.0 / 255.0)
        for k in range(3)
    ]
    return torch.stack(out, dim=-1)


def warp_crop_nearest_f32(
    img: torch.Tensor, tfs: torch.Tensor, crop_h: int, crop_w: int
) -> torch.Tensor:
    """Nearest-neighbor warp of a (H, W, C) f32 image, or of N such images
    one per pose, into (N, ch, cw, C)."""
    h, w, c = img.shape[-3:]
    base = _frame_base(img, h, w)
    sx, sy = _source_coords(tfs, crop_h, crop_w)
    xr = torch.round(sx)
    yr = torch.round(sy)
    inb = (xr >= 0) & (xr < w) & (yr >= 0) & (yr < h)
    xi = _index(xr, w)
    yi = _index(yr, h)
    flat = yi * w + xi if base is None else yi * w + xi + base
    vals = img.reshape(-1, c)[flat.reshape(-1)].reshape(*xi.shape, c)
    return torch.where(inb[..., None], vals, torch.zeros_like(vals))
