"""Triangle rasterization, attribute interpolation, texturing and shading.

Contract (nvdiffrast's, as the reference deployment uses it): per pixel
(b0, b1, z/w, face id + 1), nearest z/w wins and the lowest face id wins a
tie, 0 on the background. With pixel centres fx = (2 px + 1) / W - 1,
fy = (2 py + 1) / H - 1 the three edge functions, z and w are affine in
(fx, fy); a pixel is covered when the edge functions share a sign and do
not sum to 0, and its z/w lies in [-1, 1]. A face with a vertex at w <= 0
is culled whole.

The faces are not tested against every pixel: each (view, face) pair is
tested at the pixel centres of its projected bounding box widened by half
a pixel, and the winner of each pixel is the least of the 64-bit keys
(z/w's order-preserving bits, then the face id). The arithmetic of each
test is the same per pixel as a dense evaluation's, so the two agree
exactly.
"""

from __future__ import annotations

import torch

_PAIRS_BUDGET = 1 << 24  # (face, pixel) tests held at once


def edge_coefficients(clip: torch.Tensor, faces: torch.Tensor):
    """clip (N, V, 4), faces (F, 3) -> coeffs (N, F, 5, 3) of (a0, a1, a2,
    z, w), each (c_fx, c_fy, c_1); valid (N, F)."""
    tri = clip[:, faces]
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]

    def xyw(p):
        return torch.stack([p[..., 0], p[..., 1], p[..., 3]], dim=-1)

    c_a0 = torch.linalg.cross(xyw(p1), xyw(p2))
    c_a1 = torch.linalg.cross(xyw(p2), xyw(p0))
    c_a2 = torch.linalg.cross(xyw(p0), xyw(p1))
    c_z = p0[..., 2:3] * c_a0 + p1[..., 2:3] * c_a1 + p2[..., 2:3] * c_a2
    c_w = p0[..., 3:4] * c_a0 + p1[..., 3:4] * c_a1 + p2[..., 3:4] * c_a2
    coeffs = torch.stack([c_a0, c_a1, c_a2, c_z, c_w], dim=2)
    w_pos = torch.all(tri[..., 3] > 0.0, dim=-1)
    edges = torch.stack([c_a0, c_a1, c_a2], dim=2)
    return coeffs, w_pos & (torch.amax(torch.abs(edges), dim=(2, 3)) > 0.0)


def pixel_centres(h: int, w: int, device):
    """NDC pixel centres fx (w,), fy (h,), divided on the CPU."""
    fx = (2.0 * torch.arange(w, dtype=torch.float32) + 1.0) / w - 1.0
    fy = (2.0 * torch.arange(h, dtype=torch.float32) + 1.0) / h - 1.0
    return fx.to(device), fy.to(device)


def _plane(c: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * fx + c[..., 1] * fy + c[..., 2]


def _boxes(clip, faces, valid, h: int, w: int):
    """(N, F, 4) int64 inclusive pixel ranges x0, x1, y0, y1 (empty where
    invalid): the pixel centres within half a pixel of the projected
    corners' box."""
    tri = clip[:, faces]
    wv = torch.where(valid[..., None], tri[..., 3], torch.ones_like(tri[..., 3]))
    ndc = torch.nan_to_num(tri[..., :2] / wv[..., None], nan=0.0, posinf=4.0, neginf=-4.0)
    size = torch.tensor([w, h], dtype=torch.float32, device=clip.device)
    lo = torch.ceil(((ndc.amin(dim=2).clamp(-2.0, 2.0) + 1.0) * size - 1.0) / 2.0 - 0.5)
    hi = torch.floor(((ndc.amax(dim=2).clamp(-2.0, 2.0) + 1.0) * size - 1.0) / 2.0 + 0.5)
    lo = torch.maximum(lo, torch.zeros_like(lo))
    hi = torch.minimum(hi, size - 1.0)
    box = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], dim=-1).long()
    empty = torch.tensor([1, 0, 1, 0], device=clip.device)
    return torch.where(valid[..., None], box, empty)


def _order_bits(zw: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 whose order is the floats' (-0.0 taken as +0.0)."""
    bits = (zw + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, (~bits) & 0x7FFFFFFF, bits | 0x80000000)


def rasterize(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int,
              face_valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, V, 4) clip-space vertices -> (N, h, w, 4) (b0, b1, z/w, id + 1)."""
    n, f = clip.shape[0], faces.shape[0]
    dev = clip.device
    coeffs, valid = edge_coefficients(clip, faces)
    if face_valid is not None:
        valid = valid & face_valid[None]
    fxs, fys = pixel_centres(h, w, dev)
    box = _boxes(clip, faces, valid, h, w)
    bw = (box[..., 1] - box[..., 0] + 1).clamp(min=0)
    bh = (box[..., 3] - box[..., 2] + 1).clamp(min=0)
    count = (bw * bh).reshape(-1)  # tests per (view, face), view-major
    pair_ids = torch.nonzero(count > 0)[:, 0]
    cum = torch.cumsum(count[pair_ids], 0)
    best = torch.full((n * h * w,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    flat_coeffs = coeffs.reshape(n * f, 5, 3)
    start = 0
    while start < pair_ids.numel():
        # the pairs whose tests fit in the budget (at least one pair)
        base = cum[start - 1] if start else torch.zeros((), dtype=torch.int64, device=dev)
        stop = int(torch.searchsorted(cum, base + _PAIRS_BUDGET, right=True))
        stop = max(stop, start + 1)
        ids = pair_ids[start:stop]
        k = count[ids]
        rep = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), k)
        first = torch.cumsum(k, 0) - k
        local = torch.arange(rep.numel(), device=dev) - first[rep]
        pid = ids[rep]
        b = box.reshape(n * f, 4)[pid]
        width = bw.reshape(-1)[pid]
        px = b[:, 0] + local % width
        py = b[:, 2] + local // width
        fx, fy = fxs[px], fys[py]
        c = flat_coeffs[pid]
        a0, a1, a2 = _plane(c[:, 0], fx, fy), _plane(c[:, 1], fx, fy), _plane(c[:, 2], fx, fy)
        covered = ((a0 >= 0) & (a1 >= 0) & (a2 >= 0)) | ((a0 <= 0) & (a1 <= 0) & (a2 <= 0))
        covered &= (a0 + a1 + a2) != 0.0
        zw = _plane(c[:, 3], fx, fy) / _plane(c[:, 4], fx, fy)
        covered &= (zw >= -1.0) & (zw <= 1.0)
        view, face = pid // f, pid % f
        key = (_order_bits(zw[covered]) << 31) | face[covered]
        pix = (view * h + py) * w + px
        best.scatter_reduce_(0, pix[covered], key, "amin")
        start = stop

    fg = best != torch.iinfo(torch.int64).max
    face_idx = torch.where(fg, best & 0x7FFFFFFF, torch.zeros_like(best)).reshape(n, h * w)
    win = torch.gather(coeffs.reshape(n, f, 15), 1,
                       face_idx[..., None].expand(n, h * w, 15)).reshape(n, h * w, 5, 3)
    fx = fxs.repeat(h)
    fy = fys.repeat_interleave(w)
    a0 = win[:, :, 0, 0] * fx + win[:, :, 0, 1] * fy + win[:, :, 0, 2]
    a1 = win[:, :, 1, 0] * fx + win[:, :, 1, 1] * fy + win[:, :, 1, 2]
    a2 = win[:, :, 2, 0] * fx + win[:, :, 2, 1] * fy + win[:, :, 2, 2]
    zw = (win[:, :, 3, 0] * fx + win[:, :, 3, 1] * fy + win[:, :, 3, 2]) / (
        win[:, :, 4, 0] * fx + win[:, :, 4, 1] * fy + win[:, :, 4, 2])
    iw = 1.0 / (a0 + a1 + a2)
    out = torch.stack([torch.clamp(a0 * iw, 0.0, 1.0), torch.clamp(a1 * iw, 0.0, 1.0),
                       torch.clamp(zw, -1.0, 1.0), (face_idx + 1).to(torch.float32)], dim=-1)
    out = torch.where(fg.reshape(n, h * w, 1), out, torch.zeros_like(out))
    return out.reshape(n, h, w, 4)


def interpolate(attr: torch.Tensor, rast: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of (N, V, C) or (V, C) vertex attributes ->
    (N, H, W, C), 0 on the background."""
    n, h, w, _ = rast.shape
    tri = rast[..., 3].to(torch.int64) - 1
    fg = tri >= 0
    fidx = torch.clamp(tri, min=0).reshape(n, h * w)
    bary = (rast[..., 0], rast[..., 1], 1.0 - rast[..., 0] - rast[..., 1])
    if attr.dim() == 2:
        attr = attr[None].expand(n, *attr.shape)
    c = attr.shape[-1]
    acc = None
    for k in range(3):
        vals = torch.gather(attr, 1, faces[:, k][fidx][..., None].expand(n, h * w, c))
        term = bary[k][..., None] * vals.reshape(n, h, w, c)
        acc = term if acc is None else acc + term
    return torch.where(fg[..., None], acc, torch.zeros_like(acc))


def texture_wrap(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with wrap-around: (Th, Tw, C), (N, H, W, 2) -> (N, H, W, C)."""
    th, tw, c = tex.shape
    mu = uv[..., 0] * tw - 0.5
    mv = uv[..., 1] * th - 0.5
    iu, iv = torch.floor(mu), torch.floor(mv)
    fu, fv = mu - iu, mv - iv
    iu, iv = iu.to(torch.int64), iv.to(torch.int64)
    u0, u1 = torch.remainder(iu, tw), torch.remainder(iu + 1, tw)
    v0, v1 = torch.remainder(iv, th), torch.remainder(iv + 1, th)
    flat = tex.reshape(th * tw, c)
    return (flat[v0 * tw + u0] * ((1 - fu) * (1 - fv))[..., None]
            + flat[v0 * tw + u1] * (fu * (1 - fv))[..., None]
            + flat[v1 * tw + u0] * ((1 - fu) * fv)[..., None]
            + flat[v1 * tw + u1] * (fu * fv)[..., None])


def shade(color, diffuse, rast, w_ambient: float, w_diffuse: float) -> torch.Tensor:
    """Lambert: color * (ambient + diffuse * w) on the foreground, in [0, 1]."""
    fg = torch.clamp(rast[..., 3:4], 0.0, 1.0)
    return torch.clamp(color * (w_ambient + diffuse * w_diffuse) * fg, 0.0, 1.0)
