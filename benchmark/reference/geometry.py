"""Pose, projection and crop-window arithmetic, and the 252-pose grid.

A frozen copy of the plain f32 arithmetic of FoundationPose's reference C++
deployment (zz990099/foundationpose_cpp: ComputeCropWindowTF,
ConstructBBox2D, ProjectMatrixFromIntrinsics, generate_pose_clip,
RefinePostProcess, the icosphere sampler), in plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, returned in float32 (a control's geometry)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """std::round: halves away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def crop_window_tf(poses, K, crop: int, crop_ratio: float, diameter: float) -> torch.Tensor:
    """(N, 3, 3) affine from image pixels to crop pixels (ComputeCropWindowTF:
    the window's radius is the largest v offset of the four probes, and its
    bounds are rounded to whole pixels)."""
    r = diameter * crop_ratio / 2.0
    offsets = torch.tensor([[0.0, 0.0, 0.0], [r, 0.0, 0.0], [-r, 0.0, 0.0], [0.0, r, 0.0],
                            [0.0, -r, 0.0]], dtype=torch.float32, device=poses.device)
    pts = poses[:, :3, 3][:, None, :] + offsets[None]
    proj = torch.einsum("ij,npj->npi", K, pts)
    uv = proj[..., :2] / proj[..., 2:3]
    center = uv[:, 0, :]
    radius = torch.abs(torch.max(uv[..., 1] - center[:, None, 1], dim=1).values)
    left = _round_away(center[:, 0] - radius)
    right = _round_away(center[:, 0] + radius)
    top = _round_away(center[:, 1] - radius)
    bottom = _round_away(center[:, 1] + radius)
    sx = crop / (right - left)
    sy = crop / (bottom - top)
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, -sx * left], -1), torch.stack([z, sy, -sy * top], -1),
                        torch.stack([z, z, o], -1)], -2)


def invert_affine(tfs: torch.Tensor) -> torch.Tensor:
    a, b, c = tfs[:, 0, 0], tfs[:, 0, 1], tfs[:, 0, 2]
    d, e, f = tfs[:, 1, 0], tfs[:, 1, 1], tfs[:, 1, 2]
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([ia, ib, ic], -1), torch.stack([id_, ie, if_], -1),
                        torch.stack([z, z, o], -1)], -2)


def crop_bbox(tfs: torch.Tensor, crop: int) -> torch.Tensor:
    """(N, 4) [left, top, right, bottom] of the crop window in the image."""
    inv = invert_affine(tfs)
    corners = torch.tensor([[0.0, 0.0, 1.0], [crop - 1.0, crop - 1.0, 1.0]],
                           dtype=torch.float32, device=tfs.device)
    m = torch.einsum("nij,cj->nci", inv, corners)
    return torch.cat([m[:, 0, :2], m[:, 1, :2]], dim=-1)


def projection(K, h: float, w: float, znear: float, zfar: float) -> torch.Tensor:
    """OpenGL projection of a pinhole K with y down (ProjectMatrixFromIntrinsics)."""
    q = -(zfar + znear) / (zfar - znear)
    qn = -2.0 * zfar * znear / (zfar - znear)
    z = torch.zeros((), dtype=torch.float32, device=K.device)
    w_t = torch.tensor(float(w), device=K.device)
    h_t = torch.tensor(float(h), device=K.device)
    row0 = torch.stack([2 * K[0, 0] / w_t, -2 * K[0, 1] / w_t, (-2 * K[0, 2] + w_t) / w_t, z])
    row1 = torch.stack([z, 2 * K[1, 1] / h_t, (2 * K[1, 2] - h_t) / h_t, z])
    rows23 = torch.tensor([[0.0, 0.0, q, qn], [0.0, 0.0, -1.0, 0.0]], device=K.device)
    return torch.cat([torch.stack([row0, row1]), rows23])


GL_FROM_CV = ((1.0, 0.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, 0.0),
              (0.0, 0.0, 0.0, 1.0))


def clip_matrix(poses, bbox, K, h: int, w: int, znear: float, zfar: float) -> torch.Tensor:
    """(N, 4, 4) mesh frame -> clip space of the crop window (the host's
    proj @ glcam @ pose, then generate_pose_clip's remap of the bbox)."""
    gl = torch.tensor(GL_FROM_CV, dtype=torch.float32, device=poses.device)
    mvp = torch.einsum("ij,jk,nkl->nil", projection(K, h, w, znear, zfar), gl, poses)
    hh = torch.tensor(float(h), device=poses.device)
    ww = torch.tensor(float(w), device=poses.device)
    l, t, r, b = bbox[:, 0], hh - bbox[:, 1], bbox[:, 2], hh - bbox[:, 3]
    a00 = torch.reciprocal(r - l) * ww
    a11 = torch.reciprocal(t - b) * hh
    a30 = (ww - r - l) / (r - l)
    a31 = (hh - t - b) / (t - b)
    row0 = a00[:, None] * mvp[:, 0, :] + a30[:, None] * mvp[:, 3, :]
    row1 = a11[:, None] * mvp[:, 1, :] + a31[:, None] * mvp[:, 3, :]
    return torch.stack([row0, row1, mvp[:, 2, :], mvp[:, 3, :]], dim=1)


def transform(poses, pts) -> torch.Tensor:
    """(N, 4, 4) x (V, 3) -> (N, V, 3)."""
    return torch.einsum("nij,vj->nvi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]


def transform_h(mats, pts) -> torch.Tensor:
    """(N, 4, 4) x (V, 3) -> (N, V, 4) homogeneous."""
    return torch.einsum("nij,vj->nvi", mats[:, :, :3], pts) + mats[:, None, :, 3]


def lambert(poses, normals) -> torch.Tensor:
    """(N, V): clamp(-z / |n|, 0, 1) of the normal rotated into the camera."""
    tn = torch.einsum("nij,vj->nvi", poses[:, :3, :3], normals)
    norm = torch.linalg.norm(tn, dim=-1)
    value = torch.where(norm == 0.0, torch.zeros_like(norm),
                        -tn[..., 2] / torch.clamp(norm, min=1e-30))
    return torch.clamp(value, 0.0, 1.0)


def rodrigues(rv: torch.Tensor) -> torch.Tensor:
    """(N, 3) rotation vectors -> (N, 3, 3)."""
    angle = torch.linalg.norm(rv, dim=-1, keepdim=True)
    axis = rv / torch.clamp(angle, min=1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = torch.cos(angle[..., 0]), torch.sin(angle[..., 0])
    C = 1.0 - c
    m = torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], -2)
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device).expand(m.shape)
    return torch.where(angle[..., None] < 1e-12, eye, m)


def apply_delta(poses, trans_out, rot_out, diameter: float, rot_normalizer: float):
    """RefinePostProcess: t += trans * diameter / 2; R = rodrigues(tanh(rot)
    * normalizer)^T @ R."""
    out = poses.clone()
    rot_t = rodrigues(torch.tanh(rot_out) * rot_normalizer).transpose(-1, -2)
    out[:, :3, :3] = torch.einsum("nij,njk->nik", rot_t, poses[:, :3, :3])
    out[:, :3, 3] = poses[:, :3, 3] + trans_out * (diameter / 2.0)
    return out


def rotation_grid(n_views: int = 40, inplane_step_deg: int = 60) -> np.ndarray:
    """(M, 4, 4) object-in-camera rotations: icosphere vertices (subdivided
    until there are n_views) as look-at cameras, each with in-plane turns."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    raw = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t), (0, -1, -t),
           (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in raw]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    cache: dict = {}

    def mid(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            p = (verts[i] + verts[j]) / 2.0
            verts.append(p / np.linalg.norm(p))
            cache[key] = len(verts) - 1
        return cache[key]

    while len(verts) < n_views:
        new = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    grid = []
    up = np.array([0.0, 0.0, 1.0], np.float32)
    for pos in np.stack(verts).astype(np.float32):
        cam = np.eye(4, dtype=np.float32)
        z_axis = -pos / np.linalg.norm(pos)
        x_axis = np.cross(up, z_axis)
        if np.allclose(x_axis, 0.0):
            x_axis = np.array([1.0, 0.0, 0.0], np.float32)
        x_axis = x_axis / np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = x_axis, y_axis / np.linalg.norm(y_axis), \
            z_axis, pos
        for deg in np.arange(0.0, 360.0, float(inplane_step_deg)):
            rz = np.eye(4, dtype=np.float32)
            c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
            rz[0, 0], rz[0, 1], rz[1, 0], rz[1, 1] = c, -s, s, c
            grid.append(np.linalg.inv(cam @ rz))
    return np.stack(grid).astype(np.float32)
