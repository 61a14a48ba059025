"""Depth-image preprocessing: erode, bilateral filter, xyz back-projection,
translation guess.

Counterpart of ``foundationpose_cpp_tpu.ops.depth``, after the reference
CUDA kernels:
- erode_depth_kernel: foundationpose_sampling.cu:21-82
- bilateral_filter_depth_kernel: foundationpose_sampling.cu:84-164
- convert_depth_to_xyz_map_kernel: foundationpose_utils.cu:3-75
- GuessTranslation: foundationpose_sampling.cpp:250-298

The (2r+1)^2 neighborhood is unrolled into shifted-image tensor ops, as in the
JAX package; these are image-sized elementwise passes, left to PyTorch.
"""

from __future__ import annotations

import torch


def _shifted(img: torch.Tensor, dy: int, dx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Image shifted by (dy, dx), zero outside, plus the in-bounds mask."""
    h, w = img.shape
    shifted = torch.zeros_like(img)
    mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    ys_src = slice(max(dy, 0), h + min(dy, 0))
    ys_dst = slice(max(-dy, 0), h + min(-dy, 0))
    xs_src = slice(max(dx, 0), w + min(dx, 0))
    xs_dst = slice(max(-dx, 0), w + min(-dx, 0))
    shifted[ys_dst, xs_dst] = img[ys_src, xs_src]
    mask[ys_dst, xs_dst].fill_(True)  # a Python scalar assigned would become a tensor first
    return shifted, mask


def erode_depth(
    depth: torch.Tensor,
    radius: int = 2,
    depth_diff_thres: float = 0.001,
    ratio_thres: float = 0.8,
    zfar: float = 100.0,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Zero out pixels whose neighborhood disagrees (sampling.cu:21-82).

    A pixel survives iff its own depth is in [0.1, zfar) and at most
    ratio_thres of its in-bounds (2r+1)^2 neighbors (itself included) are
    invalid or differ by more than depth_diff_thres.

    ``valid`` (bool (H, W), optional) marks the real image extent when the
    array is padded to a size bucket: a neighbor outside it counts as out of
    bounds (in neither ``bad`` nor ``total``), and a pixel outside it is 0,
    so a padded frame erodes as the unpadded one does.
    """
    d = depth
    bad = torch.zeros_like(d)
    total = torch.zeros_like(d)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb, inb = _shifted(d, dy, dx)
            if valid is not None:
                nb_valid, _ = _shifted(valid, dy, dx)
                inb = inb & nb_valid
            is_bad = (nb < 0.1) | (nb >= zfar) | (torch.abs(nb - d) > depth_diff_thres)
            bad = bad + (inb & is_bad).to(d.dtype)
            total = total + inb.to(d.dtype)
    keep = (bad / torch.clamp(total, min=1.0)) <= ratio_thres
    valid_center = (d >= 0.1) & (d < zfar)
    if valid is not None:
        valid_center = valid_center & valid
    return torch.where(valid_center & keep, d, torch.zeros_like(d))


def bilateral_filter_depth(
    depth: torch.Tensor,
    radius: int = 2,
    sigma_d: float = 2.0,
    sigma_r: float = 100000.0,
    zfar: float = 100.0,
    mean_band: float = 0.01,
) -> torch.Tensor:
    """Mean-banded bilateral depth filter (sampling.cu:84-164).

    Neighbors take part only if valid ([0.1, zfar)) and within mean_band of
    the local valid-neighborhood mean. 0 where no valid neighbor exists or
    all weights vanish.
    """
    d = depth
    valid_sum = torch.zeros_like(d)
    valid_cnt = torch.zeros_like(d)
    shifts = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb, inb = _shifted(d, dy, dx)
            nb_valid = inb & (nb >= 0.1) & (nb < zfar)
            valid_sum = valid_sum + torch.where(nb_valid, nb, torch.zeros_like(nb))
            valid_cnt = valid_cnt + nb_valid.to(d.dtype)
            shifts.append((dy, dx, nb, nb_valid))

    mean_depth = valid_sum / torch.clamp(valid_cnt, min=1.0)

    sum_w = torch.zeros_like(d)
    sum_wd = torch.zeros_like(d)
    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    inv_2sr2 = 1.0 / (2.0 * sigma_r * sigma_r)
    for dy, dx, nb, nb_valid in shifts:
        use = nb_valid & (torch.abs(nb - mean_depth) < mean_band)
        spatial = float(dx * dx + dy * dy) * inv_2sd2
        w = torch.exp(-(spatial + (d - nb) * (d - nb) * inv_2sr2))
        w = torch.where(use, w, torch.zeros_like(w))
        sum_w = sum_w + w
        sum_wd = sum_wd + w * nb
    ok = (valid_cnt > 0) & (sum_w > 0.0)
    return torch.where(ok, sum_wd / torch.clamp(sum_w, min=1e-30), torch.zeros_like(d))


def depth_to_xyz(depth: torch.Tensor, K: torch.Tensor, min_depth: float = 0.001) -> torch.Tensor:
    """Pinhole back-projection depth (..., H, W) -> (..., H, W, 3)
    camera-frame xyz: one frame, or a batch of frames seen through one K.

    Pixels with depth < min_depth are exact zeros (the CUDA kernel skips them
    and relies on zeroed memory, foundationpose_utils.cu:3-75).
    """
    h, w = depth.shape[-2:]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    x = (cols - cx) * depth / fx
    y = (rows - cy) * depth / fy
    xyz = torch.stack([x, y, depth], dim=-1)
    return torch.where(depth[..., None] >= min_depth, xyz, torch.zeros_like(xyz))


def guess_translation(
    depth: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
    min_depth: float = 0.001,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Object-center guess on the device (GuessTranslation, sampling.cpp:250-298).

    Center pixel = mask-bbox center; z = median of the depths where mask > 0
    and depth >= min_depth (the mean of the middle pair for an even count);
    center = K^-1 (uc, vc, 1) * z.

    Returns (center (3,), ok 0-d bool tensor). ok is False when the mask is
    empty or holds no valid depth; the center is then zero. Nothing here
    synchronizes with the host.
    """
    h, w = depth.shape
    maskp = mask > 0
    cols = torch.arange(w, device=depth.device)[None, :].expand(h, w)
    rows = torch.arange(h, device=depth.device)[:, None].expand(h, w)
    big = 1 << 30
    any_mask = torch.any(maskp)
    u_min = torch.where(maskp, cols, big).min()
    u_max = torch.where(maskp, cols, -big).max()
    v_min = torch.where(maskp, rows, big).min()
    v_max = torch.where(maskp, rows, -big).max()
    uc = (u_min + u_max).to(torch.float32) / 2.0
    vc = (v_min + v_max).to(torch.float32) / 2.0

    valid = maskp & (depth >= min_depth)
    n_valid = valid.sum()
    flat = torch.where(valid, depth, torch.full_like(depth, float("inf"))).reshape(-1)
    sorted_d = torch.sort(flat).values
    i1 = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), min=0)
    i2 = torch.clamp(torch.div(n_valid, 2, rounding_mode="floor"), min=0)
    # gathered, not indexed: a 0-d index tensor would be read on the host
    mid = torch.gather(sorted_d, 0, torch.stack([i1, i2]))
    zc = (mid[0] + mid[1]) / 2.0

    uv1 = torch.stack([uc, vc, torch.ones((), device=depth.device)])
    # solve_ex leaves the LAPACK/cuSOLVER error code on the device (solve
    # reads it back); K is a camera matrix, never singular
    center = torch.linalg.solve_ex(K, uv1, check_errors=False)[0] * zc
    ok = any_mask & (n_valid > 0)
    return torch.where(ok, center, torch.zeros_like(center)), ok
