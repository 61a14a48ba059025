"""Render-and-compare front end: the reference FoundationPoseRenderer as two
tensor functions.

Counterpart of ``foundationpose_cpp_tpu.pipeline.renderer``. Pipeline order
matches the reference's NvdiffrastRender (foundationpose_render.cpp:611-683)
+ RenderProcess (:685-729) + TransfProcess (:731-812): the render branch is
the CUDA render kernel (``ops/render.py``); the observed branch is the crop
kernel (``ops/crop.py``): the two crop warps, the pointcloud threshold and
the concat in one pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset
from foundationpose_cpp_tpu_torch.ops import crop, render
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshConstants:
    """Device-resident mesh tensors, preprocessed once per mesh.

    Mirrors FoundationPoseRenderer::LoadTexturedMesh (:381-509): vertices are
    centered on the model center, the V texture coordinate is flipped, and the
    texture is float [0,1]. The faces are the asset's own, unpadded.
    """

    vertices: torch.Tensor  # (V, 3) centered
    normals: torch.Tensor  # (V, 3)
    texcoords: torch.Tensor  # (V, 2) v-flipped
    faces: torch.Tensor  # (F, 3) int32
    texture: torch.Tensor  # (Th, Tw, 3) f32
    diameter: float
    model_center: torch.Tensor  # (3,)
    orient_bounds: torch.Tensor  # (4, 4)

    @staticmethod
    def from_asset(asset: MeshAsset, device=None) -> "MeshConstants":
        """``device`` None means the card (``utils.device.resolve_device``)."""
        device = resolve_device(device)
        verts = asset.vertices - asset.model_center[None, :]
        uv = np.stack([asset.texcoords[:, 0], 1.0 - asset.texcoords[:, 1]], axis=-1)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return MeshConstants(
            vertices=t(verts),
            normals=t(asset.vertex_normals),
            texcoords=t(uv),
            faces=t(asset.faces, torch.int32),
            texture=t(asset.texture),
            diameter=float(asset.diameter),
            model_center=t(asset.model_center),
            orient_bounds=t(asset.orient_bounds),
        )


@dataclasses.dataclass(frozen=True)
class MeshSet:
    """A model's catalog: every registered ``MeshConstants`` concatenated
    once, in registration order, as one launch of the render kernel takes
    them (faces index their own mesh's vertices, texels are flattened to
    (texels, 3)); ``rows`` the (M, 8) int32 ``ops.render.ViewTable`` row of
    each mesh (its scratch column 0), ``diameters`` the (M,) f32 diameters,
    on the device, and ``vertex_max`` the largest vertex count. Built once
    a model (``FoundationPose``); ``views`` picks each view's mesh out of it
    on the device, so one program serves any names. The graphs read it by
    address.
    """

    names: tuple
    vertices: torch.Tensor  # (sum V, 3)
    normals: torch.Tensor  # (sum V, 3)
    texcoords: torch.Tensor  # (sum V, 2)
    faces: torch.Tensor  # (sum F, 3) int32, local to each mesh
    texture: torch.Tensor  # (sum Th * Tw, 3) f32
    rows: torch.Tensor  # (M, 8) int32
    diameters: torch.Tensor  # (M,) f32
    vertex_max: int

    @staticmethod
    def build(meshes: dict[str, MeshConstants]) -> "MeshSet":
        """The catalog of ``meshes``, in their order."""
        rows, v, f, t = [], 0, 0, 0
        for m in meshes.values():
            th, tw = m.texture.shape[:2]
            rows.append([v, m.vertices.shape[0], f, m.faces.shape[0], t, th, tw, 0])
            v, f, t = v + m.vertices.shape[0], f + m.faces.shape[0], t + th * tw
        device = next(iter(meshes.values())).vertices.device

        def cat(field, shape=None):
            parts = [getattr(m, field) for m in meshes.values()]
            return torch.cat([p.reshape(shape) if shape else p for p in parts]).contiguous()

        return MeshSet(
            names=tuple(meshes),
            vertices=cat("vertices"),
            normals=cat("normals"),
            texcoords=cat("texcoords"),
            faces=cat("faces"),
            texture=cat("texture", (-1, 3)),
            rows=torch.tensor(rows, dtype=torch.int32, device=device),
            diameters=torch.tensor([m.diameter for m in meshes.values()], dtype=torch.float32,
                                   device=device),
            vertex_max=max(m.vertices.shape[0] for m in meshes.values()),
        )

    def indices(self, names) -> np.ndarray:
        """(N,) int32 catalog index of each of ``names`` (host memory)."""
        return np.array([self.names.index(name) for name in names], np.int32)

    def views(self, idx: torch.Tensor) -> "MeshViews":
        """View n on mesh ``idx[n]`` ((N,) int32 on the device): its table
        row and diameter gathered on the device, no host synchronization."""
        return MeshViews(self, render.ViewTable.gather(self.rows, idx, self.vertex_max),
                         self.diameters.index_select(0, idx))

    def select(self, names) -> "MeshViews":
        """``views`` of the indices of ``names``, uploaded (outside a program)."""
        return self.views(torch.as_tensor(self.indices(names), device=self.rows.device))


@dataclasses.dataclass(frozen=True)
class MeshViews:
    """N views' meshes out of a ``MeshSet``, one a view: ``table`` the
    view's rows (``ops.render.ViewTable``) and ``diameter`` the (N,) f32
    diameters, which ``render_and_transform`` and
    ``transforms.apply_refine_delta`` take where a mesh has a number; the
    mesh tensors are the catalog's."""

    catalog: MeshSet
    table: render.ViewTable
    diameter: torch.Tensor

    @property
    def vertices(self) -> torch.Tensor:
        return self.catalog.vertices

    @property
    def normals(self) -> torch.Tensor:
        return self.catalog.normals

    @property
    def texcoords(self) -> torch.Tensor:
        return self.catalog.texcoords

    @property
    def faces(self) -> torch.Tensor:
        return self.catalog.faces

    @property
    def texture(self) -> torch.Tensor:
        return self.catalog.texture


def render_branch(
    mesh: MeshConstants | MeshViews,
    poses: torch.Tensor,
    clip_mat: torch.Tensor,
    ch: int,
    cw: int,
    cfg: FoundationPoseConfig,
) -> torch.Tensor:
    """Render branch only: N poses through clip matrices -> (N, ch, cw, 6):
    raster, barycentric attributes, texture, Lambert shade, v-flip, xyz
    threshold/diameter-downscale. ``MeshViews`` render each pose on its own
    mesh, in one launch."""
    return render.render_views(
        mesh.vertices, mesh.normals, mesh.texcoords, mesh.faces, mesh.texture, poses, clip_mat,
        ch, cw, mesh.diameter, cfg.min_depth, cfg.max_depth, cfg.w_ambient, cfg.w_diffuse,
        table=mesh.table if isinstance(mesh, MeshViews) else None,
    )


def render_and_transform(
    mesh: MeshConstants | MeshViews,
    poses: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    K: torch.Tensor,
    crop_ratio: float,
    cfg: FoundationPoseConfig,
    image_hw: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two 6-channel model input crops for N poses.

    poses (N, 4, 4); rgb (H, W, 3) uint8; xyz_map (H, W, 3) f32 from the RAW
    depth (foundationpose.cpp:297-301); crop_ratio 1.2 refine / 1.1 score;
    image_hw the real (h, w) when rgb and xyz_map are zero-padded to a size
    bucket (None: their shape), as numbers or as 0-d f32 tensors on the
    device. The zero padding reads as the warps' zero border, so only the
    clip matrix needs the real extent.
    ``MeshViews`` give each pose its own mesh and diameter.
    Returns (render_input, transf_input), each (N, crop_h, crop_w, 6) f32.
    """
    ch, cw = cfg.crop_window_h, cfg.crop_window_w
    h, w = image_hw if image_hw is not None else rgb.shape[:2]
    tfs = transforms.compute_crop_window_tf(poses, K, (ch, cw), crop_ratio, mesh.diameter)
    bbox2d = transforms.construct_bbox2d(tfs, ch, cw)
    clip_mat = transforms.pose_clip_matrix(poses, bbox2d, K, h, w, cfg.znear, cfg.zfar)
    render_input = render_branch(mesh, poses, clip_mat, ch, cw, cfg)

    transf_input = crop.crop_observed(
        rgb, xyz_map, tfs, poses, mesh.diameter / 2.0, ch, cw, cfg.min_depth, cfg.max_depth
    )
    return render_input, transf_input
