"""The full-frame rasterizer: per-pixel nearest face for N views, one CUDA
kernel on the card.

Replaces the Pallas kernel ``_raster_kernel`` / ``rasterize_tpu`` of
``foundationpose_cpp_tpu/ops/rasterize_pallas.py`` with ``csrc/rasterize.cu``.
It is a drop-in for ``ops.rasterize.rasterize`` and computes exactly its
contract: (N, h, w, 4) of (b0, b1, z/w, id + 1) in raster rows, nearest z/w
wins, the lowest face id on ties, 0 for background. The TPU kernel's
bbox-centre sort, 64-face chunks and sorted-position tie break are not
carried over. ``rasterize_tiled_plain`` is the plain version; the wrapper
runs it for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.ops import rasterize as ras
from foundationpose_cpp_tpu_torch.ops.render import face_pixel_bbox

TILE = 32  # the kernel's pixel tile (csrc/rasterize.cu)

rasterize_tiled_plain = ras.rasterize


def rasterize_prepass(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int,
                      face_valid: torch.Tensor | None = None):
    """The kernel's inputs, computed with plain tensor ops: (N, F, 15) plane
    coefficients and (N, F, 4) int32 pixel bboxes, empty for faces that are
    invalid or behind the camera."""
    coeffs, valid = ras.edge_coefficients(clip, faces)
    if face_valid is not None:
        valid = valid & face_valid[None, :]
    n, f = valid.shape
    bbox = face_pixel_bbox(clip, faces, valid, h, w)
    return coeffs.reshape(n, f, 15).contiguous(), bbox


def rasterize_tiled(
    clip: torch.Tensor,
    faces: torch.Tensor,
    h: int,
    w: int,
    face_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rasterize N views of clip-space vertices (N, V, 4) with faces (F, 3)
    into (N, h, w, 4) f32.

    CPU tensors go through the plain version. CUDA tensors launch the
    kernel, which takes f32 clip, int32 faces and a bool face_valid on one
    device, and raises on anything else.
    """
    if clip.device.type == "cpu":
        return rasterize_tiled_plain(clip, faces, h, w, face_valid=face_valid)
    if clip.device.type != "cuda":
        raise ValueError(f"unsupported device {clip.device}")
    if clip.dtype != torch.float32 or clip.dim() != 3 or clip.shape[-1] != 4:
        raise ValueError(f"rasterize kernel: clip must be (N, V, 4) f32, got "
                         f"{tuple(clip.shape)} {clip.dtype}")
    if faces.dtype != torch.int32 or faces.device != clip.device or faces.dim() != 2:
        raise ValueError("rasterize kernel: faces must be (F, 3) int32 on clip's device")
    if face_valid is not None and (face_valid.dtype != torch.bool
                                   or face_valid.device != clip.device):
        raise ValueError("rasterize kernel: face_valid must be bool on clip's device")
    n = clip.shape[0]
    if not (1 <= n <= 65535 and 1 <= h <= 65535 * TILE and w >= 1):
        raise ValueError(f"rasterize kernel: bad shape n={n} h={h} w={w}")
    coeffs, bbox = rasterize_prepass(clip, faces, h, w, face_valid)
    out = launch_rasterize(coeffs, bbox, h, w)
    rasterize_tiled.launches += 1
    return out


rasterize_tiled.launches = 0


def launch_rasterize(coeffs: torch.Tensor, bbox: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Launch csrc/rasterize.cu on the prepass's outputs and return its
    (N, h, w, 4) raster. ``rasterize_tiled`` checks the inputs and counts
    its launches; this is the launch alone."""
    n, f = bbox.shape[:2]
    out = torch.empty((n, h, w, 4), dtype=torch.float32, device=coeffs.device)
    lib = cuda_build.load("rasterize")
    fn = lib.fp_rasterize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(coeffs.data_ptr(), bbox.data_ptr(), out.data_ptr(), n, f, h, w, stream)
    cuda_build.check(err, "rasterize_tiled")
    return out
