"""Synthetic RGB-D scenes and datasets for tests, the demo and the smoke run.

Counterpart of ``foundationpose_cpp_tpu.utils.synthetic``: ``render_scene``
renders a mesh at a known pose into a full-frame RGB, metric depth and mask,
and ``write_mini_dataset`` writes a short sequence in the reference's
mustard0 layout (test_data/download.md), the stand-in for a recorded
dataset. A mesh on the card rasterizes through the full-frame kernel
(``ops/rasterize_tiled.py``), a CPU mesh through its plain version; images
are written through ``utils/png.py``.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset
from foundationpose_cpp_tpu_torch.ops import rasterize as ras
from foundationpose_cpp_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import png
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


@torch.inference_mode()
def render_scene(
    mesh: MeshConstants,
    pose: np.ndarray,
    K: np.ndarray,
    h: int,
    w: int,
    cfg: FoundationPoseConfig = FoundationPoseConfig(),
    background_depth: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render (rgb u8, depth f32, mask u8) of ``mesh`` at ``pose``; the full
    frame is the crop window (bbox = whole image). Runs on mesh's device."""
    dev = mesh.vertices.device
    poses = torch.as_tensor(pose[None].astype(np.float32), device=dev)
    Kt = torch.as_tensor(K.astype(np.float32), device=dev)
    bbox2d = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=dev)
    clip_mat = transforms.pose_clip_matrix(poses, bbox2d, Kt, h, w, cfg.znear, cfg.zfar)
    clip = transforms.transform_points_homogeneous(clip_mat, mesh.vertices)
    rast = rasterize_tiled(clip, mesh.faces, h, w)

    pts_cam = transforms.transform_points(poses, mesh.vertices)
    xyz = ras.interpolate_attributes(pts_cam, rast, mesh.faces)
    uv = ras.interpolate_attributes(mesh.texcoords, rast, mesh.faces)
    color = ras.texture_bilinear_wrap(mesh.texture, uv)
    diffuse = transforms.diffuse_intensity(poses, mesh.normals)
    dmap = ras.interpolate_attributes(diffuse[..., None], rast, mesh.faces)
    color = ras.shade_color(color, dmap, rast, cfg.w_ambient, cfg.w_diffuse)

    color = ras.flip_vertical(color)[0].cpu().numpy()
    xyz = ras.flip_vertical(xyz)[0].cpu().numpy()
    fg = ras.flip_vertical(rast[..., 3:4])[0, ..., 0].cpu().numpy() > 0

    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    depth = np.where(fg, xyz[..., 2], background_depth).astype(np.float32)
    mask = fg.astype(np.uint8) * 255
    return rgb, depth, mask


def euler_xyz_deg(angles) -> np.ndarray:
    """Extrinsic x-y-z Euler angles (degrees) -> 3x3, as scipy's
    ``Rotation.from_euler("xyz", angles, degrees=True)``."""
    ax, ay, az = (math.radians(a) for a in angles)
    rx = np.array([[1, 0, 0], [0, math.cos(ax), -math.sin(ax)], [0, math.sin(ax), math.cos(ax)]])
    ry = np.array([[math.cos(ay), 0, math.sin(ay)], [0, 1, 0], [-math.sin(ay), 0, math.cos(ay)]])
    rz = np.array([[math.cos(az), -math.sin(az), 0], [math.sin(az), math.cos(az), 0], [0, 0, 1]])
    return rz @ ry @ rx


def default_pose(tz: float = 0.6) -> np.ndarray:
    """A mildly rotated pose in front of the camera."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = euler_xyz_deg([25, -15, 40])
    pose[:3, 3] = [0.02, -0.01, tz]
    return pose


def write_sequence(
    root: str,
    asset: MeshAsset,
    poses: list[np.ndarray],
    K: np.ndarray,
    h: int,
    w: int,
    cfg: FoundationPoseConfig | None = None,
    texture: bool = True,
    device=None,
) -> None:
    """Write ``asset`` rendered at each pose as a mustard0-layout dataset:
    rgb/, depth/ (16-bit mm), masks/, mesh/<name>.obj (with an MTL file and
    a PNG texture when ``texture``), cam_K.txt and annotated_poses/.
    Renders on ``device`` (None: the card)."""
    cfg = cfg or FoundationPoseConfig()
    root_p = pathlib.Path(root)
    for sub in ("rgb", "depth", "masks", "mesh", "annotated_poses"):
        (root_p / sub).mkdir(parents=True, exist_ok=True)
    np.savetxt(root_p / "cam_K.txt", K, fmt="%.6f")
    obj = root_p / "mesh" / f"{asset.name}.obj"
    procedural.write_obj(asset, str(obj), str(obj.with_suffix(".png")) if texture else None)
    mesh = MeshConstants.from_asset(asset, resolve_device(device))
    for i, pose in enumerate(poses):
        fid = f"{i:06d}"
        rgb, depth, mask = render_scene(mesh, pose, K, h, w, cfg)
        png.write_png(str(root_p / "rgb" / f"{fid}.png"), rgb)
        png.write_png(str(root_p / "depth" / f"{fid}.png"),
                      np.round(depth * 1000.0).astype(np.uint16))
        png.write_png(str(root_p / "masks" / f"{fid}.png"), mask)
        np.savetxt(root_p / "annotated_poses" / f"{fid}.txt", pose, fmt="%.8f")


def write_mini_dataset(
    root: str,
    n_frames: int = 3,
    h: int = 120,
    w: int = 160,
    cfg: FoundationPoseConfig | None = None,
    device=None,
) -> np.ndarray:
    """Write a tiny mustard0-layout dataset of a moving textured cube, as the
    JAX package's ``write_mini_dataset`` does (its OBJ carries no texture).
    Returns the (3, 3) intrinsics."""
    cfg = cfg or FoundationPoseConfig(crop_window_h=32, crop_window_w=32)
    K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], np.float32)
    poses = []
    for i in range(n_frames):
        pose = default_pose(tz=0.5 + 0.004 * i)
        pose[0, 3] += 0.003 * i
        poses.append(pose)
    write_sequence(root, procedural.textured_cube(size=0.1), poses, K, h, w, cfg,
                   texture=False, device=device)
    return K
