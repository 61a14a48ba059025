"""Rendering: the hypotheses' crops (the render branch of the reference
deployment's NvdiffrastRender + RenderProcess) and whole camera frames
(the benchmark's input images), on the plain rasterizer."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry, raster
from benchmark.reference.assets import Mesh


def threshold_xyz(xyz, poses, downscale: float, min_depth: float, max_depth: float):
    """Centre xyz crops on their pose's translation and divide by
    diameter / 2; zero a coordinate beyond max_depth, and every coordinate
    of a point whose z (before centring) is below min_depth."""
    t = poses[:, :3, 3][:, None, None, :]
    invalid = xyz[..., 2:3] < min_depth
    scaled = (xyz - t) / downscale
    drop = (torch.abs(scaled) > max_depth) | invalid
    return torch.where(drop, torch.zeros_like(scaled), scaled)


def render_crops(mesh: Mesh, poses, clip_mat, crop: int, cfg: dict) -> torch.Tensor:
    """(N, crop, crop, 6): shaded texture | centred, scaled xyz, flipped to
    image rows."""
    n = poses.shape[0]
    clip = geometry.transform_h(clip_mat, mesh.vertices)
    rast = raster.rasterize(clip, mesh.faces, crop, crop)
    attrs = torch.cat([geometry.transform(poses, mesh.vertices),
                       geometry.lambert(poses, mesh.normals)[..., None],
                       mesh.uvs[None].expand(n, *mesh.uvs.shape)], dim=-1)
    interp = raster.interpolate(attrs, rast, mesh.faces)
    color = raster.texture_wrap(mesh.texture, interp[..., 4:6])
    color = raster.shade(color, interp[..., 3:4], rast, cfg["w_ambient"], cfg["w_diffuse"])
    color = torch.flip(color, dims=(1,))
    xyz = torch.flip(interp[..., 0:3], dims=(1,))
    xyz = threshold_xyz(xyz, poses, mesh.diameter / 2.0, cfg["min_depth"], cfg["max_depth"])
    return torch.cat([color, xyz], dim=-1)


@torch.no_grad()
def render_frame(mesh: Mesh, poses: np.ndarray, K: np.ndarray, h: int, w: int, cfg: dict):
    """One camera frame of one or more instances of ``mesh`` at ``poses``
    ((4, 4) or (N, 4, 4)), nearest surface first -> (rgb uint8 (h, w, 3),
    depth f32 metres (h, w), 0 off the objects; mask uint8 (h, w), 255 on
    them)."""
    dev = mesh.vertices.device
    p = torch.as_tensor(np.asarray(poses, np.float32).reshape(-1, 4, 4), device=dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    bbox = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=dev).expand(p.shape[0], 4)
    clip_mat = geometry.clip_matrix(p, bbox, Kt, h, w, cfg["znear"], cfg["zfar"])
    rast = raster.rasterize(geometry.transform_h(clip_mat, mesh.vertices), mesh.faces, h, w)
    xyz = raster.interpolate(geometry.transform(p, mesh.vertices), rast, mesh.faces)
    color = raster.texture_wrap(mesh.texture, raster.interpolate(mesh.uvs, rast, mesh.faces))
    diffuse = raster.interpolate(geometry.lambert(p, mesh.normals)[..., None], rast, mesh.faces)
    color = torch.flip(raster.shade(color, diffuse, rast, cfg["w_ambient"], cfg["w_diffuse"]),
                       dims=(1,))
    depth = torch.flip(xyz[..., 2], dims=(1,))
    fg = torch.flip(rast[..., 3], dims=(1,)) > 0
    depth = torch.where(fg, depth, torch.full_like(depth, float("inf")))
    nearest = depth.argmin(dim=0, keepdim=True)  # the instance in front
    fg_any = fg.any(dim=0)
    rgb = torch.gather(color, 0, nearest[..., None].expand(1, h, w, 3))[0]
    z = torch.gather(depth, 0, nearest)[0]
    rgb = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    z = torch.where(fg_any, z, torch.zeros_like(z))
    return (rgb.cpu().numpy(), z.cpu().numpy().astype(np.float32),
            (fg_any.to(torch.uint8) * 255).cpu().numpy())
