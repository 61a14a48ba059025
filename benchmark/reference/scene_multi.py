"""Frames of several distinct objects, and Track of each of them, in plain
float32 PyTorch with TF32 off.

The semantics held to: distinct objects are independent in FoundationPose's
Track (zz990099/foundationpose_cpp, src/foundationpose.cpp:230-265 tracks
one object a call, on that object's mesh and diameter), so the reference of
one call that tracks several distinct objects in a frame is each object's
own single-mesh refinement in that frame, from its hypothesis: every
quantity of object i comes from its pose, its mesh and its diameter alone,
with the arithmetic of ``pipeline.Reference``, whose pieces it calls. The
nets' parameters are read once and shared. A frame shows every object, the
nearest surface of any of them winning.

The geometry runs over the whole batch of poses, as one call of the
program runs it: object i's crop window, clip matrix and pose update are
row i of ``geometry``'s functions on all N poses with object i's diameter.
A crop window's bounds are rounded to whole pixels, and a matrix product
over N rows may round in another way than one over a single row: computed
one object at a time, the eggbox's window at one hypothesis of one seed
fell a pixel from the batched one and its pose 0.6 deg from the program's.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import depth as depth_ops
from benchmark.reference import geometry, nets, pipeline, raster, render
from benchmark.reference.assets import Mesh
from benchmark.reference.pipeline import CFG


def _layers(mesh: Mesh, poses: torch.Tensor, K: torch.Tensor, h: int, w: int, cfg: dict):
    """(color (N, h, w, 3), depth (N, h, w), foreground (N, h, w)) of the
    instances of one mesh, each alone, in image rows; depth inf off it."""
    bbox = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=poses.device) \
        .expand(poses.shape[0], 4)
    clip_mat = geometry.clip_matrix(poses, bbox, K, h, w, cfg["znear"], cfg["zfar"])
    rast = raster.rasterize(geometry.transform_h(clip_mat, mesh.vertices), mesh.faces, h, w)
    xyz = raster.interpolate(geometry.transform(poses, mesh.vertices), rast, mesh.faces)
    color = raster.texture_wrap(mesh.texture, raster.interpolate(mesh.uvs, rast, mesh.faces))
    diffuse = raster.interpolate(geometry.lambert(poses, mesh.normals)[..., None], rast,
                                 mesh.faces)
    color = torch.flip(raster.shade(color, diffuse, rast, cfg["w_ambient"], cfg["w_diffuse"]),
                       dims=(1,))
    depth = torch.flip(xyz[..., 2], dims=(1,))
    fg = torch.flip(rast[..., 3], dims=(1,)) > 0
    return color, torch.where(fg, depth, torch.full_like(depth, float("inf"))), fg


@torch.no_grad()
def render_frames(meshes: list[Mesh], poses: np.ndarray, K: np.ndarray, h: int, w: int,
                  cfg: dict) -> list[tuple]:
    """T camera frames of objects ``meshes[i]`` at ``poses[:, i]`` ((T, N, 4,
    4)), in each the nearest surface of any object first -> a list of T
    (rgb uint8 (h, w, 3), depth f32 metres (h, w), 0 off the objects; mask
    uint8 (h, w), 255 on them). Each object's T views are rendered in one
    batch; where two objects' depths tie, the first object shows."""
    dev = meshes[0].vertices.device
    p = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    for i, mesh in enumerate(meshes):
        color, depth, fg = _layers(mesh, p[:, i], Kt, h, w, cfg)
        if i == 0:
            rgb, z, fg_any = color, depth, fg
            continue
        nearer = depth < z
        rgb = torch.where(nearer[..., None], color, rgb)
        z = torch.where(nearer, depth, z)
        fg_any = fg_any | fg
    rgb = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    z = torch.where(fg_any, z, torch.zeros_like(z)).cpu().numpy().astype(np.float32)
    mask = (fg_any.to(torch.uint8) * 255).cpu().numpy()
    return [(rgb[k], z[k], mask[k]) for k in range(p.shape[0])]


def render_frame(meshes: list[Mesh], poses: np.ndarray, K: np.ndarray, h: int, w: int,
                 cfg: dict):
    """One camera frame of objects ``meshes[i]`` at ``poses[i]`` ((N, 4, 4)),
    the nearest surface of any of them first -> (rgb uint8 (h, w, 3), depth
    f32 metres (h, w), 0 off the objects; mask uint8 (h, w), 255 on them)."""
    return render_frames(meshes, np.asarray(poses, np.float32).reshape(1, -1, 4, 4), K, h, w,
                         cfg)[0]


@dataclasses.dataclass
class MultiReference:
    """Track of distinct objects, one ``pipeline.Reference`` an object (its
    mesh; the nets' parameters, K, the crop and the controls shared)."""

    objects: list[pipeline.Reference]

    @property
    def device(self):
        return self.objects[0].device

    def _rows(self, fn) -> torch.Tensor:
        """Row i of ``fn(object i)`` for each object i."""
        return torch.stack([fn(ref)[i] for i, ref in enumerate(self.objects)])

    def _refine_once(self, p, rgb_t, xyz, h: int, w: int) -> torch.Tensor:
        lead = self.objects[0]
        g, crop = lead._g, lead.crop
        tfs = g(self._rows(lambda ref: geometry.crop_window_tf(
            p, ref.K, crop, CFG["refine_crop_ratio"], ref.mesh.diameter)))
        bbox = g(geometry.crop_bbox(tfs, crop))
        clip = g(geometry.clip_matrix(p, bbox, lead.K, h, w, CFG["znear"], CFG["zfar"]))
        rend = torch.cat([render.render_crops(ref.mesh, p[i:i + 1], clip[i:i + 1], crop, CFG)
                          for i, ref in enumerate(self.objects)])
        obs = g(depth_ops.warp_xyz(xyz, tfs, crop))
        obs = torch.cat([render.threshold_xyz(obs[i:i + 1], p[i:i + 1], ref.mesh.diameter / 2.0,
                                              CFG["min_depth"], CFG["max_depth"])
                         for i, ref in enumerate(self.objects)])
        observed = torch.cat([depth_ops.warp_rgb(rgb_t, tfs, crop), obs], dim=-1)
        trans, rot = nets.refine(lead.refiner, rend, observed, lead.block, lead.heads, lead.quant)
        return g(self._rows(lambda ref: geometry.apply_delta(
            p, trans, rot, ref.mesh.diameter, CFG["rot_normalizer"])))

    @torch.no_grad()
    def track(self, rgb, depth, poses: np.ndarray, refine_itr: int = 1) -> np.ndarray:
        """(N, 4, 4) hypotheses, pose i of object i -> (N, 4, 4) refined
        poses, numpy: each object refined on its own mesh."""
        p = torch.as_tensor(np.asarray(poses, np.float32).reshape(-1, 4, 4), device=self.device)
        if p.shape[0] != len(self.objects):
            raise ValueError(f"{p.shape[0]} poses for {len(self.objects)} objects")
        rgb_t, _, xyz = self.objects[0]._frame(rgb, depth)
        h, w = depth.shape
        for _ in range(refine_itr):
            p = self._refine_once(p, rgb_t, xyz, h, w)
        return p.cpu().numpy()


def build(meshes: list[Mesh], refiner: dict, scorer: dict, K: torch.Tensor, crop: int,
          **kwargs) -> MultiReference:
    """A ``MultiReference`` of ``meshes`` (one an object); ``kwargs`` go to
    every ``pipeline.Reference`` (heads, quant, geom, n_views, ...)."""
    return MultiReference([pipeline.Reference(m, refiner, scorer, K, crop, **kwargs)
                           for m in meshes])
