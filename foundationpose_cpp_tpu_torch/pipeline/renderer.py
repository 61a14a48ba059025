"""Render-and-compare front end: the reference FoundationPoseRenderer as two
tensor functions.

Counterpart of ``foundationpose_cpp_tpu.pipeline.renderer``. Pipeline order
matches the reference's NvdiffrastRender (foundationpose_render.cpp:611-683)
+ RenderProcess (:685-729) + TransfProcess (:731-812): the render branch is
the CUDA render kernel (``ops/render.py``); the observed branch is the two
crop warps and the pointcloud threshold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset
from foundationpose_cpp_tpu_torch.ops import pointcloud, render, warp
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


FACE_PAD = 128


@dataclasses.dataclass(frozen=True)
class MeshConstants:
    """Device-resident mesh tensors, preprocessed once per mesh.

    Mirrors FoundationPoseRenderer::LoadTexturedMesh (:381-509): vertices are
    centered on the model center, the V texture coordinate is flipped, and the
    texture is float [0,1]. Faces are padded to a multiple of FACE_PAD with
    a validity mask, as in the JAX package.
    """

    vertices: torch.Tensor  # (V, 3) centered
    normals: torch.Tensor  # (V, 3)
    texcoords: torch.Tensor  # (V, 2) v-flipped
    faces: torch.Tensor  # (Fp, 3) int32, padded
    face_valid: torch.Tensor  # (Fp,) bool
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
        f = asset.faces
        pad = (-f.shape[0]) % FACE_PAD
        valid = np.ones((f.shape[0],), dtype=bool)
        if pad:
            f = np.concatenate([f, np.zeros((pad, 3), dtype=np.int32)], axis=0)
            valid = np.concatenate([valid, np.zeros((pad,), dtype=bool)])

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return MeshConstants(
            vertices=t(verts),
            normals=t(asset.vertex_normals),
            texcoords=t(uv),
            faces=t(f, torch.int32),
            face_valid=t(valid, torch.bool),
            texture=t(asset.texture),
            diameter=float(asset.diameter),
            model_center=t(asset.model_center),
            orient_bounds=t(asset.orient_bounds),
        )


def render_branch(
    mesh: MeshConstants,
    poses: torch.Tensor,
    clip_mat: torch.Tensor,
    ch: int,
    cw: int,
    cfg: FoundationPoseConfig,
) -> torch.Tensor:
    """Render branch only: N poses through clip matrices -> (N, ch, cw, 6):
    raster, barycentric attributes, texture, Lambert shade, v-flip, xyz
    threshold/diameter-downscale."""
    return render.render_views(
        mesh.vertices, mesh.normals, mesh.texcoords, mesh.faces, mesh.face_valid,
        mesh.texture, poses, clip_mat, ch, cw, mesh.diameter, cfg.min_depth,
        cfg.max_depth, cfg.w_ambient, cfg.w_diffuse,
    )


def render_and_transform(
    mesh: MeshConstants,
    poses: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    K: torch.Tensor,
    crop_ratio: float,
    cfg: FoundationPoseConfig,
    image_hw: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two 6-channel model input crops for N poses.

    poses (N, 4, 4); rgb (H, W, 3) uint8; xyz_map (H, W, 3) f32 from the RAW
    depth (foundationpose.cpp:297-301); crop_ratio 1.2 refine / 1.1 score;
    image_hw the real (h, w) when rgb and xyz_map are zero-padded to a size
    bucket (None: their shape). The zero padding reads as the warps' zero
    border, so only the clip matrix needs the real extent.
    Returns (render_input, transf_input), each (N, crop_h, crop_w, 6) f32.
    """
    ch, cw = cfg.crop_window_h, cfg.crop_window_w
    h, w = image_hw if image_hw is not None else rgb.shape[:2]
    tfs = transforms.compute_crop_window_tf(poses, K, (ch, cw), crop_ratio, mesh.diameter)
    bbox2d = transforms.construct_bbox2d(tfs, ch, cw)
    clip_mat = transforms.pose_clip_matrix(poses, bbox2d, K, h, w, cfg.znear, cfg.zfar)
    render_input = render_branch(mesh, poses, clip_mat, ch, cw, cfg)

    rgb_crop = warp.warp_crop_linear_u8(rgb, tfs, ch, cw)
    xyz_crop = warp.warp_crop_nearest_f32(xyz_map, tfs, ch, cw)
    xyz_crop = pointcloud.threshold_and_downscale_pointcloud(
        xyz_crop, poses, mesh.diameter / 2.0, cfg.min_depth, cfg.max_depth
    )
    return render_input, pointcloud.concat_channels(rgb_crop, xyz_crop)
