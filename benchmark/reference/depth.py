"""Register's depth front end and the observed crops: erosion, the
mean-banded bilateral filter, back-projection, the translation guess, and
the two crop warps (the reference deployment's sampling and render CUDA
kernels and cvcuda::WarpPerspective), in plain PyTorch."""

from __future__ import annotations

import torch


def _shift(img: torch.Tensor, dy: int, dx: int):
    """img shifted by (dy, dx), zero outside, and the in-bounds mask."""
    h, w = img.shape
    out = torch.zeros_like(img)
    inb = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = img[ys, xs]
    inb[yd, xd] = True
    return out, inb


def erode(d: torch.Tensor, radius: int, diff_thres: float, ratio_thres: float, zfar: float):
    """Keep a pixel with depth in [0.1, zfar) unless more than ratio_thres of
    its in-bounds neighbourhood is invalid or off by more than diff_thres."""
    bad = torch.zeros_like(d)
    total = torch.zeros_like(d)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb, inb = _shift(d, dy, dx)
            is_bad = (nb < 0.1) | (nb >= zfar) | (torch.abs(nb - d) > diff_thres)
            bad = bad + (inb & is_bad).to(d.dtype)
            total = total + inb.to(d.dtype)
    keep = (bad / torch.clamp(total, min=1.0)) <= ratio_thres
    return torch.where((d >= 0.1) & (d < zfar) & keep, d, torch.zeros_like(d))


def bilateral(d: torch.Tensor, radius: int, sigma_d: float, sigma_r: float, zfar: float,
              band: float):
    """Bilateral filter over the valid neighbours within ``band`` of the
    neighbourhood's valid mean; 0 where none is left."""
    vsum = torch.zeros_like(d)
    vcnt = torch.zeros_like(d)
    shifts = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb, inb = _shift(d, dy, dx)
            ok = inb & (nb >= 0.1) & (nb < zfar)
            vsum = vsum + torch.where(ok, nb, torch.zeros_like(nb))
            vcnt = vcnt + ok.to(d.dtype)
            shifts.append((dy, dx, nb, ok))
    mean = vsum / torch.clamp(vcnt, min=1.0)
    sw = torch.zeros_like(d)
    swd = torch.zeros_like(d)
    inv_sd, inv_sr = 1.0 / (2.0 * sigma_d * sigma_d), 1.0 / (2.0 * sigma_r * sigma_r)
    for dy, dx, nb, ok in shifts:
        use = ok & (torch.abs(nb - mean) < band)
        wgt = torch.exp(-(float(dx * dx + dy * dy) * inv_sd + (d - nb) * (d - nb) * inv_sr))
        wgt = torch.where(use, wgt, torch.zeros_like(wgt))
        sw = sw + wgt
        swd = swd + wgt * nb
    ok = (vcnt > 0) & (sw > 0.0)
    return torch.where(ok, swd / torch.clamp(sw, min=1e-30), torch.zeros_like(d))


def to_xyz(depth: torch.Tensor, K: torch.Tensor, min_depth: float) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame points, 0 below min_depth."""
    h, w = depth.shape
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    xyz = torch.stack([(cols - K[0, 2]) * depth / K[0, 0], (rows - K[1, 2]) * depth / K[1, 1],
                       depth], dim=-1)
    return torch.where(depth[..., None] >= min_depth, xyz, torch.zeros_like(xyz))


def guess_translation(depth: torch.Tensor, mask: torch.Tensor, K: torch.Tensor,
                      min_depth: float) -> torch.Tensor:
    """Object centre: the mask's bounding-box centre pixel at the median
    valid depth under the mask (mean of the middle pair), back-projected."""
    ys, xs = torch.nonzero(mask > 0, as_tuple=True)
    if ys.numel() == 0:
        raise ValueError("empty mask")
    uc = (xs.min() + xs.max()).to(torch.float32) / 2.0
    vc = (ys.min() + ys.max()).to(torch.float32) / 2.0
    z = torch.sort(depth[(mask > 0) & (depth >= min_depth)]).values
    if z.numel() == 0:
        raise ValueError("no valid depth under the mask")
    zc = (z[(z.numel() - 1) // 2] + z[z.numel() // 2]) / 2.0
    uv1 = torch.stack([uc, vc, torch.ones((), device=depth.device)])
    return torch.linalg.solve(K, uv1) * zc


def _sources(tfs: torch.Tensor, crop: int):
    from benchmark.reference.geometry import invert_affine

    inv = invert_affine(tfs)
    xs = torch.arange(crop, dtype=torch.float32, device=tfs.device)[None, :].expand(crop, crop)
    ys = torch.arange(crop, dtype=torch.float32, device=tfs.device)[:, None].expand(crop, crop)
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    return sx, sy


def _gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (H, W, C) at integer coordinates (N, h, w), 0 outside."""
    h, w, c = img.shape
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xi = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, w - 1).to(torch.int64)
    yi = torch.clamp(torch.nan_to_num(y, nan=0.0), 0, h - 1).to(torch.int64)
    vals = img.reshape(-1, c)[(yi * w + xi).reshape(-1)].reshape(*xi.shape, c)
    return torch.where(inb[..., None], vals, torch.zeros_like(vals))


def warp_rgb(rgb: torch.Tensor, tfs: torch.Tensor, crop: int) -> torch.Tensor:
    """Bilinear warp of (H, W, 3) uint8 into (N, crop, crop, 3) in [0, 1]:
    the destination pixel (x, y) samples M^-1 (x, y, 1), computed on the
    0-255 values and rounded half to even before the division."""
    sx, sy = _sources(tfs, crop)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    img = rgb.to(torch.float32)
    v00, v10 = _gather(img, x0, y0), _gather(img, x0 + 1, y0)
    v01, v11 = _gather(img, x0, y0 + 1), _gather(img, x0 + 1, y0 + 1)
    w00, w10 = ((1 - fx) * (1 - fy))[..., None], (fx * (1 - fy))[..., None]
    w01, w11 = ((1 - fx) * fy)[..., None], (fx * fy)[..., None]
    return torch.round(v00 * w00 + v10 * w10 + v01 * w01 + v11 * w11) * (1.0 / 255.0)


def warp_xyz(xyz: torch.Tensor, tfs: torch.Tensor, crop: int) -> torch.Tensor:
    """Nearest-neighbour warp of (H, W, 3) f32 into (N, crop, crop, 3)."""
    sx, sy = _sources(tfs, crop)
    return _gather(xyz, torch.round(sx), torch.round(sy))
