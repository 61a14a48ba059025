"""Batched triangle rasterization + attribute interpolation + texturing.

Counterpart of ``foundationpose_cpp_tpu.ops.rasterize`` (the JAX package's
pure-XLA render stack, itself a redesign of the reference's vendored
nvdiffrast rasterizer, interpolation and bilinear-wrap texturing). Together
these functions are the plain PyTorch version of the CUDA render kernel
(``ops/render.py``, ``csrc/render.cu``): the kernel computes exactly this
chain per pixel.

Contract: given N clip-space vertex batches (N, V, 4) and a shared (F, 3)
index buffer, emit per pixel (b0, b1, z/w, triangle_id + 1) with
nearest-depth visibility (lowest face id on ties) and 0 for background.
With pixel-center NDC coordinates fx = (2*px+1)/W - 1, fy = (2*py+1)/H - 1,
the three edge functions, z and w are affine in (fx, fy): 15 coefficients per
(pose, face), evaluated as ``c_fx*fx + c_fy*fy + c_1``. Faces with a vertex
at w <= 0 are culled whole, not clipped.
"""

from __future__ import annotations

import torch

BACKGROUND_ID = 0  # rast.w == 0 marks background, ids are tri_idx + 1

# elements of one (views, faces, pixels) plane the plain rasterizer keeps
# live per face chunk; bounds its memory at any view count
_PLANE_BUDGET = 1 << 25


def edge_coefficients(clip: torch.Tensor, faces: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(pose, face) affine coefficients for edges, z and w.

    clip (N, V, 4), faces (F, 3) int ->
      coeffs (N, F, 5, 3): [..., k, :] = (c_fx, c_fy, c_1) of quantity k in
        (a0, a1, a2, z, w);
      valid (N, F) bool: False for faces with a vertex at w <= 0 or a
        degenerate (all-zero) edge system.
    """
    tri = clip[:, faces.long()]  # (N, F, 3, 4)
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]

    def xyw(p):
        return torch.stack([p[..., 0], p[..., 1], p[..., 3]], dim=-1)

    # cross((qx,qy,qw),(rx,ry,rw)) is exactly (c_fx, c_fy, c_1) of the edge
    # function a(fx,fy) = (qx - fx*qw)(ry - fy*rw) - (qy - fy*qw)(rx - fx*rw)
    c_a0 = torch.linalg.cross(xyw(p1), xyw(p2))
    c_a1 = torch.linalg.cross(xyw(p2), xyw(p0))
    c_a2 = torch.linalg.cross(xyw(p0), xyw(p1))
    c_z = p0[..., 2:3] * c_a0 + p1[..., 2:3] * c_a1 + p2[..., 2:3] * c_a2
    c_w = p0[..., 3:4] * c_a0 + p1[..., 3:4] * c_a1 + p2[..., 3:4] * c_a2
    coeffs = torch.stack([c_a0, c_a1, c_a2, c_z, c_w], dim=2)

    w_pos = torch.all(tri[..., 3] > 0.0, dim=-1)
    edges = torch.stack([c_a0, c_a1, c_a2], dim=2)
    nondegenerate = torch.amax(torch.abs(edges), dim=(2, 3)) > 0.0
    return coeffs, w_pos & nondegenerate


def pixel_basis(h: int, w: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """NDC pixel-center coordinates fx (w,), fy (h,).

    Computed on the CPU and then moved: on the card, PyTorch divides a
    tensor by a scalar as a multiply by its rounded reciprocal, one ulp off
    the true quotient that the CPU (and the kernels) take.
    """
    fx = (2.0 * torch.arange(w, dtype=torch.float32) + 1.0) / w - 1.0
    fy = (2.0 * torch.arange(h, dtype=torch.float32) + 1.0) / h - 1.0
    return fx.to(device), fy.to(device)


def _plane(c: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """c (..., 3) coefficients at flat pixels fx, fy (P,) -> (..., P)."""
    return c[..., 0:1] * fx + c[..., 1:2] * fy + c[..., 2:3]


def rasterize(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Rasterize N instance batches -> (N, h, w, 4) of (b0, b1, z/w, id+1).

    Scans face chunks with a running nearest-depth reduction per pixel; a
    chunk's argmin picks the lowest face on ties and a later chunk must be
    strictly nearer, so ties go to the lowest face id overall. A final pass
    re-evaluates the barycentrics of the winning face only.
    """
    n = clip.shape[0]
    f = faces.shape[0]
    coeffs, valid = edge_coefficients(clip, faces)
    fxs, fys = pixel_basis(h, w, clip.device)
    fx = fxs.repeat(h)  # (hw,) row-major
    fy = fys.repeat_interleave(w)
    hw = h * w

    best_zw = torch.full((n, hw), float("inf"), device=clip.device)
    best_id = torch.zeros((n, hw), dtype=torch.int64, device=clip.device)
    chunk = max(1, min(f, _PLANE_BUDGET // max(1, n * hw)))
    for start in range(0, f, chunk):
        cf = coeffs[:, start : start + chunk]  # (N, C, 5, 3)
        a0 = _plane(cf[:, :, 0], fx, fy)  # (N, C, hw)
        a1 = _plane(cf[:, :, 1], fx, fy)
        a2 = _plane(cf[:, :, 2], fx, fy)
        covered = ((a0 >= 0) & (a1 >= 0) & (a2 >= 0)) | ((a0 <= 0) & (a1 <= 0) & (a2 <= 0))
        covered &= (a0 + a1 + a2) != 0.0
        del a0, a1, a2
        covered &= valid[:, start : start + chunk, None]
        zw = _plane(cf[:, :, 3], fx, fy) / _plane(cf[:, :, 4], fx, fy)
        covered &= (zw >= -1.0) & (zw <= 1.0)
        zw = torch.where(covered, zw, torch.full_like(zw, float("inf")))
        local_zw, local_best = torch.min(zw, dim=1)
        take = local_zw < best_zw
        best_zw = torch.where(take, local_zw, best_zw)
        best_id = torch.where(take, local_best + (start + 1), best_id)

    fg = best_id > 0
    face_idx = torch.clamp(best_id - 1, min=0)  # (N, hw)
    win = torch.gather(
        coeffs.reshape(n, f, 15), 1, face_idx[..., None].expand(n, hw, 15)
    ).reshape(n, hw, 5, 3)
    a0 = win[:, :, 0, 0] * fx + win[:, :, 0, 1] * fy + win[:, :, 0, 2]
    a1 = win[:, :, 1, 0] * fx + win[:, :, 1, 1] * fy + win[:, :, 1, 2]
    a2 = win[:, :, 2, 0] * fx + win[:, :, 2, 1] * fy + win[:, :, 2, 2]
    iw = 1.0 / (a0 + a1 + a2)
    b0 = torch.clamp(a0 * iw, 0.0, 1.0)
    b1 = torch.clamp(a1 * iw, 0.0, 1.0)
    zw = torch.clamp(best_zw, -1.0, 1.0)
    out = torch.stack([b0, b1, zw, best_id.to(torch.float32)], dim=-1)
    out = torch.where(fg[..., None], out, torch.zeros_like(out))
    return out.reshape(n, h, w, 4)


def interpolate_attributes(
    attr: torch.Tensor, rast: torch.Tensor, faces: torch.Tensor
) -> torch.Tensor:
    """Barycentric vertex-attribute interpolation (interpolate.cu:15-85).

    attr (N, V, C) per instance or (V, C) shared; rast (N, H, W, 4);
    faces (F, 3) -> (N, H, W, C), zero on background.
    """
    n, h, w, _ = rast.shape
    tri_id = rast[..., 3].to(torch.int64) - 1
    fg = tri_id >= 0
    face_idx = torch.clamp(tri_id, min=0).reshape(n, h * w)
    b = (rast[..., 0], rast[..., 1], 1.0 - rast[..., 0] - rast[..., 1])
    if attr.dim() == 2:
        attr = attr[None].expand(n, *attr.shape)
    c = attr.shape[-1]
    acc = None
    for k in range(3):
        vidx = faces[:, k].long()[face_idx]  # (N, hw)
        vals = torch.gather(attr, 1, vidx[..., None].expand(n, h * w, c))
        term = b[k][..., None] * vals.reshape(n, h, w, c)
        acc = term if acc is None else acc + term
    return torch.where(fg[..., None], acc, torch.zeros_like(acc))


def texture_bilinear_wrap(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture fetch with wrap boundary (texture.cu:131-179).

    tex (Th, Tw, C), uv (N, H, W, 2) -> (N, H, W, C).
    """
    th, tw, c = tex.shape
    mu = uv[..., 0] * tw - 0.5
    mv = uv[..., 1] * th - 0.5
    iu0 = torch.floor(mu)
    iv0 = torch.floor(mv)
    fu = mu - iu0
    fv = mv - iv0
    iu0 = iu0.to(torch.int64)
    iv0 = iv0.to(torch.int64)
    u0 = torch.remainder(iu0, tw)
    u1 = torch.remainder(iu0 + 1, tw)
    v0 = torch.remainder(iv0, th)
    v1 = torch.remainder(iv0 + 1, th)
    w00 = ((1 - fu) * (1 - fv))[..., None]
    w10 = (fu * (1 - fv))[..., None]
    w01 = ((1 - fu) * fv)[..., None]
    w11 = (fu * fv)[..., None]
    flat = tex.reshape(th * tw, c)
    return (
        flat[v0 * tw + u0] * w00
        + flat[v0 * tw + u1] * w10
        + flat[v1 * tw + u0] * w01
        + flat[v1 * tw + u1] * w11
    )


def shade_color(
    color: torch.Tensor,
    diffuse_map: torch.Tensor,
    rast: torch.Tensor,
    w_ambient: float = 0.8,
    w_diffuse: float = 0.5,
) -> torch.Tensor:
    """Lambert shading + clamp (render.cu:459-520 and :30-39)."""
    is_foreground = torch.clamp(rast[..., 3:4], 0.0, 1.0)
    out = color * (w_ambient + diffuse_map * w_diffuse) * is_foreground
    return torch.clamp(out, 0.0, 1.0)


def flip_vertical(img: torch.Tensor) -> torch.Tensor:
    """GL y-up -> image y-down vertical flip (render.cpp:676-681)."""
    return torch.flip(img, dims=(1,))
