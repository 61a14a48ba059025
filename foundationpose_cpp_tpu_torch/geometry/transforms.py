"""Batched pose / projection / crop-window math on torch tensors.

The counterpart of ``foundationpose_cpp_tpu.geometry.transforms``, which
reimplements the reference's host-side Eigen geometry:

- GL<->CV camera flip: foundationpose_render.cpp:22-23
- ComputeTF / ComputeCropWindowTF: foundationpose_render.cpp:25-75
- ConstructBBox2D (crop bbox back-projection): foundationpose_render.cpp:123-149
- ProjectMatrixFromIntrinsics: foundationpose_render.cpp:151-186
- generate_pose_clip crop->NDC remap: foundationpose_render.cu:363-416
- refine-delta pose composition: foundationpose.cpp:360-406

Everything is batched over the leading hypothesis axis N and stays in f32 on
the caller's device. The package turns TF32 off (see ``__init__``): the crop
window rounding and the clip-space vertices move under TF32, which is why the
JAX package pins ``Precision.HIGHEST`` for the same products.

The constant tensors these functions combine with their inputs are built
from Python floats once per (values, device) by ``_constant`` and kept, so
a call only launches work on tensors already on the device: building one
from a Python list on the card is a blocking copy that drains the stream.
They are kept for the life of the process: a captured CUDA graph
(``pipeline/programs.py``) reads them by address, and none of them may be
freed while a graph that read it can still replay.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """f32 tensor of the nested tuple ``values`` on ``device``, built on the
    first call for these values and device and returned from then on. Built
    outside inference mode, so it serves autograd-recording callers too;
    callers never write to it. The cache is unbounded on purpose: an entry
    is at most 16 floats, and evicting one would leave a live graph reading
    freed memory."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def _gl_cam_in_cv_cam(device) -> torch.Tensor:
    """CV camera -> GL camera: flips y and z (foundationpose_render.cpp:22-23)."""
    return _constant(((1.0, 0.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, 0.0),
                      (0.0, 0.0, 0.0, 1.0)), torch.device(device))


def _extent(x, device: torch.device) -> torch.Tensor:
    """A frame extent as a 0-d f32 tensor on ``device``: a tensor is taken as
    it is (a size bucket's real h or w, read on the device), a number is
    made one once (``_constant``), so the arithmetic is the same f32
    arithmetic either way."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return _constant(float(x), torch.device(device))


def projection_from_intrinsics(
    K: torch.Tensor,
    height,
    width,
    znear: float = 0.1,
    zfar: float = 100.0,
) -> torch.Tensor:
    """OpenGL projection matrix from a pinhole K, y_down window coords.

    Mirrors ProjectMatrixFromIntrinsics (foundationpose_render.cpp:151-186).
    height, width: numbers or 0-d tensors on K's device.
    """
    w = _extent(width, K.device)
    h = _extent(height, K.device)
    depth = zfar - znear
    q = -(zfar + znear) / depth
    qn = -2.0 * zfar * znear / depth
    z = torch.zeros((), dtype=torch.float32, device=K.device)
    row0 = torch.stack([2 * K[0, 0] / w, -2 * K[0, 1] / w, (-2 * K[0, 2] + w) / w, z])
    row1 = torch.stack([z, 2 * K[1, 1] / h, (2 * K[1, 2] - h) / h, z])
    rows23 = _constant(((0.0, 0.0, q, qn), (0.0, 0.0, -1.0, 0.0)), K.device)
    return torch.cat([torch.stack([row0, row1]), rows23])


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """std::round: halfway cases away from zero (torch.round is half-to-even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def compute_crop_window_tf(
    poses: torch.Tensor,
    K: torch.Tensor,
    out_hw: tuple[int, int],
    crop_ratio: float,
    mesh_diameter: float | torch.Tensor,
) -> torch.Tensor:
    """Per-pose 3x3 affine mapping original-image pixels -> crop-window pixels.

    Mirrors ComputeCropWindowTF + ComputeTF (foundationpose_render.cpp:25-75),
    including its quirks: the window radius is the |max signed delta| of the
    *v* coordinate only across the five probe points, and the window bounds
    are rounded (std::round) to integer pixels before the scale is computed.

    poses (N, 4, 4), K (3, 3) -> (N, 3, 3) with last row [0, 0, 1].
    mesh_diameter: a number, or an (N,) f32 tensor of each pose's mesh's.
    The tensor's window radius is an f32 product, which may lie an ulp or
    two from the number's (a product in double, rounded once); the bounds
    are rounded to whole pixels, so the windows differ only where a bound
    lies that close to a half pixel.
    """
    out_h, out_w = out_hw
    if isinstance(mesh_diameter, torch.Tensor):
        r = mesh_diameter * (crop_ratio / 2.0)
        probes = _constant(
            ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
             (0.0, -1.0, 0.0)), poses.device,
        )
        offsets = r[:, None, None] * probes  # (N, 5, 3): 0, r or -r exactly
    else:
        r = mesh_diameter * crop_ratio / 2.0
        offsets = _constant(
            ((0.0, 0.0, 0.0), (r, 0.0, 0.0), (-r, 0.0, 0.0), (0.0, r, 0.0), (0.0, -r, 0.0)),
            poses.device,
        )[None]  # (1, 5, 3)
    centers = poses[:, :3, 3]  # (N, 3)
    pts = centers[:, None, :] + offsets  # (N, 5, 3)
    projected = torch.einsum("ij,npj->npi", K, pts)  # (N, 5, 3)
    uvs = projected[..., :2] / projected[..., 2:3]  # (N, 5, 2)
    center_uv = uvs[:, 0, :]
    dv = uvs[..., 1] - center_uv[:, None, 1]  # (N, 5)
    radius = torch.abs(torch.max(dv, dim=1).values)  # (N,)

    left = _round_away(center_uv[:, 0] - radius)
    right = _round_away(center_uv[:, 0] + radius)
    top = _round_away(center_uv[:, 1] - radius)
    bottom = _round_away(center_uv[:, 1] + radius)

    # ComputeTF: scale(out/(r-l), out/(b-t)) @ translate(-l, -t); the reference
    # indexes crop_H for the x scale and crop_W for y (render.cpp:37-39)
    sx = out_h / (right - left)
    sy = out_w / (bottom - top)
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)
    return torch.stack(
        [
            torch.stack([sx, zeros, -sx * left], dim=-1),
            torch.stack([zeros, sy, -sy * top], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


def invert_affine3(tfs: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (N, 3, 3) affines with last row [0,0,1]."""
    a, b, c = tfs[:, 0, 0], tfs[:, 0, 1], tfs[:, 0, 2]
    d, e, f = tfs[:, 1, 0], tfs[:, 1, 1], tfs[:, 1, 2]
    det = a * e - b * d
    ia = e / det
    ib = -b / det
    id_ = -d / det
    ie = a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    zeros = torch.zeros_like(a)
    ones = torch.ones_like(a)
    return torch.stack(
        [
            torch.stack([ia, ib, ic], dim=-1),
            torch.stack([id_, ie, if_], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


def construct_bbox2d(tfs: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Crop-window corners back in original-image coords (render.cpp:123-149).

    Rows are [left, top, right, bottom] per pose, from corners (0,0) and
    (W-1,H-1).
    """
    inv = invert_affine3(tfs)
    corners = _constant(((0.0, 0.0, 1.0), (crop_w - 1.0, crop_h - 1.0, 1.0)), tfs.device)
    mapped = torch.einsum("nij,cj->nci", inv, corners)  # (N, 2, 3)
    return torch.cat([mapped[:, 0, :2], mapped[:, 1, :2]], dim=-1)


def pose_clip_matrix(
    poses: torch.Tensor,
    bbox2d: torch.Tensor,
    K: torch.Tensor,
    rgb_h,
    rgb_w,
    znear: float = 0.1,
    zfar: float = 100.0,
) -> torch.Tensor:
    """Per-pose 4x4 matrix taking mesh-frame points to crop-NDC clip space.

    Fuses the host mvp (proj @ glcam @ pose, foundationpose_render.cpp:570-609)
    with generate_pose_clip_kernel's crop-bbox remap (render.cu:363-416).
    rgb_h, rgb_w: the frame's real extent, numbers or 0-d tensors on the
    device (a size bucket's, so that one captured program serves every size
    in the bucket).
    """
    proj = projection_from_intrinsics(K, rgb_h, rgb_w, znear, zfar)
    mvp = torch.einsum(
        "ij,jk,nkl->nil", proj, _gl_cam_in_cv_cam(poses.device), poses
    )
    rgb_h = _extent(rgb_h, poses.device)
    rgb_w = _extent(rgb_w, poses.device)
    l = bbox2d[:, 0]
    t = rgb_h - bbox2d[:, 1]
    r = bbox2d[:, 2]
    b = rgb_h - bbox2d[:, 3]
    # the reciprocal's product: what a number over a tensor computes
    a00 = torch.reciprocal(r - l) * rgb_w
    a11 = torch.reciprocal(t - b) * rgb_h
    a30 = (rgb_w - r - l) / (r - l)
    a31 = (rgb_h - t - b) / (t - b)
    row0 = a00[:, None] * mvp[:, 0, :] + a30[:, None] * mvp[:, 3, :]
    row1 = a11[:, None] * mvp[:, 1, :] + a31[:, None] * mvp[:, 3, :]
    return torch.stack([row0, row1, mvp[:, 2, :], mvp[:, 3, :]], dim=1)


def transform_points(poses: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(N,4,4) poses x (V,3) points -> (N,V,3) (transform_points_kernel)."""
    return torch.einsum("nij,vj->nvi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]


def transform_points_homogeneous(mats: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(N,4,4) x (V,3) -> (N,V,4) full homogeneous transform."""
    return torch.einsum("nij,vj->nvi", mats[:, :, :3], pts) + mats[:, None, :, 3]


def diffuse_intensity(poses: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Per-pose, per-vertex Lambert term (transform_normals_kernel,
    render.cu:418-457): rotate the normal into camera frame, clamp(-z/|n|, 0, 1)."""
    tn = torch.einsum("nij,vj->nvi", poses[:, :3, :3], normals)
    norm = torch.linalg.norm(tn, dim=-1)
    value = torch.where(
        norm == 0.0, torch.zeros_like(norm), -tn[..., 2] / torch.clamp(norm, min=1e-30)
    )
    return torch.clamp(value, 0.0, 1.0)


def axis_angle_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Batched Rodrigues: (N,3) rotation vectors -> (N,3,3); identity at 0."""
    angle = torch.linalg.norm(rotvec, dim=-1, keepdim=True)
    axis = rotvec / torch.clamp(angle, min=1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(angle[..., 0])
    s = torch.sin(angle[..., 0])
    C = 1.0 - c
    mat = torch.stack(
        [
            torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], dim=-1),
            torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], dim=-1),
            torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(mat.shape)
    return torch.where(angle[..., None] < 1e-12, eye, mat)


def matrix_to_axis_angle(mat: torch.Tensor) -> torch.Tensor:
    """Batched rotation log map: (N,3,3) -> (N,3); inverse of
    axis_angle_to_matrix on [0, pi), with the sinc series near 0 and
    Shepperd's largest-diagonal pivot near pi."""
    trace = mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]
    cos_a = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_a)
    sx = (mat[..., 2, 1] - mat[..., 1, 2]) * 0.5
    sy = (mat[..., 0, 2] - mat[..., 2, 0]) * 0.5
    sz = (mat[..., 1, 0] - mat[..., 0, 1]) * 0.5
    s = torch.stack([sx, sy, sz], dim=-1)  # sin(angle) * axis
    factor = torch.where(
        angle < 1e-4,
        1.0 + angle**2 / 6.0,
        angle / torch.clamp(torch.sin(angle), min=1e-12),
    )
    rv = s * factor[..., None]
    one_minus_c = torch.clamp(1.0 - cos_a[..., None], min=1e-12)
    sym = (mat + mat.transpose(-1, -2)) * 0.5
    diag = torch.stack([mat[..., 0, 0], mat[..., 1, 1], mat[..., 2, 2]], dim=-1)
    onehot = torch.nn.functional.one_hot(torch.argmax(diag, dim=-1), 3).to(mat.dtype)
    pivot_row = torch.einsum("...k,...kj->...j", onehot, sym)
    a_k2 = torch.clamp(
        (torch.sum(onehot * diag, dim=-1, keepdim=True) - cos_a[..., None])
        / one_minus_c,
        0.0,
        1.0,
    )
    a_k = torch.sqrt(a_k2)
    axis_pi = pivot_row / torch.clamp(a_k * one_minus_c, min=1e-12)
    axis_pi = torch.where(onehot > 0, a_k, axis_pi)
    axis_pi = axis_pi / torch.clamp(
        torch.linalg.norm(axis_pi, dim=-1, keepdim=True), min=1e-12
    )
    flip = torch.where(torch.sum(s * axis_pi, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    rv_pi = axis_pi * flip * angle[..., None]
    return torch.where((torch.pi - angle[..., None]) < 1e-3, rv_pi, rv)


def apply_refine_delta(
    poses: torch.Tensor,
    trans_out: torch.Tensor,
    rot_out: torch.Tensor,
    mesh_diameter: float | torch.Tensor,
    rot_normalizer: float = 0.349065850398865,
) -> torch.Tensor:
    """Compose refiner deltas onto hypothesis poses (RefinePostProcess,
    foundationpose.cpp:360-406):
      t' = t + trans_out * diameter/2
      rv = tanh(rot_out) * rot_normalizer
      R' = axis_angle(rv).T @ R
    mesh_diameter: a number, or an (N,) f32 tensor of each pose's mesh's
    (whose halves are exactly the f32 a number's half rounds to).
    """
    half = mesh_diameter / 2.0
    trans_delta = trans_out * (half[:, None] if isinstance(half, torch.Tensor) else half)
    rv = torch.tanh(rot_out) * rot_normalizer
    rot_delta_t = axis_angle_to_matrix(rv).transpose(-1, -2)
    out = poses.clone()
    out[:, :3, :3] = torch.einsum("nij,njk->nik", rot_delta_t, poses[:, :3, :3])
    out[:, :3, 3] = poses[:, :3, 3] + trans_delta
    return out


def convert_pose_mesh2bbox(
    pose_in_mesh: torch.Tensor, model_center: torch.Tensor, orient_bounds: torch.Tensor
) -> torch.Tensor:
    """Pose frame change mesh -> oriented bbox (mesh_loader.hpp:75-81)."""
    tf_to_center = torch.eye(4, dtype=pose_in_mesh.dtype, device=pose_in_mesh.device)
    tf_to_center[:3, 3] = -model_center
    return pose_in_mesh @ tf_to_center @ orient_bounds
