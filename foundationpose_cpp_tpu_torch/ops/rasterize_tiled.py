"""The full-frame rasterizer: per-pixel nearest face for N views, one CUDA
kernel on the card.

Replaces the Pallas kernel ``_raster_kernel`` / ``rasterize_tpu`` of
``foundationpose_cpp_tpu/ops/rasterize_pallas.py`` with ``csrc/rasterize.cu``.
It is a drop-in for ``ops.rasterize.rasterize`` and computes exactly its
contract: (N, h, w, 4) of (b0, b1, z/w, id + 1) in raster rows, nearest z/w
wins, the lowest face id on ties, 0 for background. The TPU kernel's
bbox-centre sort, 64-face chunks and sorted-position tie break are not
carried over: the CUDA kernel scatters each face over the pixel centers of
its own bbox into a depth buffer of 64-bit keys, one region of the image a
block (``csrc/raster_tile.cuh``). ``rasterize_tiled_plain`` is the plain
version, which the wrapper runs for CPU tensors only;
``rasterize_scatter_plain`` walks the kernel's algorithm in PyTorch, with its
key mapping and its order of operations, and runs in the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.ops import rasterize as ras
from foundationpose_cpp_tpu_torch.ops.render import face_pixel_bbox

REGION = (64, 64)  # rows, columns of the region a block owns (csrc/rasterize.cu)
EMPTY_KEY = (1 << 63) - 1  # the depth buffer's value where no face covers the pixel

rasterize_tiled_plain = ras.rasterize


def rasterize_prepass(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int):
    """What the kernel builds per (view, face), computed with plain tensor
    ops: (N, F, 15) plane coefficients and (N, F, 4) int32 pixel bboxes,
    empty for faces that are degenerate or behind the camera."""
    coeffs, valid = ras.edge_coefficients(clip, faces)
    n, f = valid.shape
    bbox = face_pixel_bbox(clip, faces, valid, h, w)
    return coeffs.reshape(n, f, 15).contiguous(), bbox


def _fused_multiply_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round(a * b + c) with one rounding, for f32 tensors: the product of two
    f32 values is exact in f64, and the f64 sum rounds once more only on a
    tie of measure zero."""
    return (a.double() * b.double() + c.double()).float()


def edge_coefficients_kernel_order(clip: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(N, F, 15) plane coefficients in the kernel's order of operations
    (``csrc/raster_tile.cuh`` edge_cross, depth_coefficients): each cross
    product component is one rounded product and one fused multiply-add, as
    ``torch.linalg.cross`` contracts it; the z and w planes are rounded
    products summed left to right."""
    tri = clip[:, faces.long()]  # (N, F, 3, 4)
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]

    def cross(q, r):  # of (qx, qy, qw) and (rx, ry, rw)
        qx, qy, qw, rx, ry, rw = q[..., 0], q[..., 1], q[..., 3], r[..., 0], r[..., 1], r[..., 3]
        return torch.stack([
            _fused_multiply_add(qy, rw, -(qw * ry)),
            _fused_multiply_add(qw, rx, -(qx * rw)),
            _fused_multiply_add(qx, ry, -(qy * rx)),
        ], dim=-1)

    c_a0, c_a1, c_a2 = cross(p1, p2), cross(p2, p0), cross(p0, p1)
    c_z = p0[..., 2:3] * c_a0 + p1[..., 2:3] * c_a1 + p2[..., 2:3] * c_a2
    c_w = p0[..., 3:4] * c_a0 + p1[..., 3:4] * c_a1 + p2[..., 3:4] * c_a2
    return torch.cat([c_a0, c_a1, c_a2, c_z, c_w], dim=-1)


def depth_keys(zw: torch.Tensor, face_id: torch.Tensor) -> torch.Tensor:
    """int64 keys that order by z/w, then by face id: the high word is the
    f32 z/w mapped to a signed integer that orders as the float does (-0.0
    brought to +0.0 first), the low word the id."""
    s = (zw + 0.0).contiguous().view(torch.int32).to(torch.int64)
    s = s ^ ((s >> 31) & 0x7FFFFFFF)
    return (s << 32) | face_id.to(torch.int64)


def key_depth(keys: torch.Tensor) -> torch.Tensor:
    """The f32 z/w of ``depth_keys``' keys."""
    s = keys >> 32
    s = s ^ ((s >> 31) & 0x7FFFFFFF)
    return s.to(torch.int32).view(torch.float32)


def rasterize_scatter_plain(
    clip: torch.Tensor,
    faces: torch.Tensor,
    h: int,
    w: int,
    region: tuple[int, int] = REGION,
    coeffs: torch.Tensor | None = None,
) -> torch.Tensor:
    """``rasterize`` computed the way the kernel walks it: per region of
    ``region`` (rows, columns) pixels, every face that survives culling is
    tested at the pixel centers of its bbox inside the region, the covered
    ones reduce ``depth_keys`` with a scatter-min into the region's depth
    buffer, and a resolve pass re-evaluates each winner's edge values.
    ``coeffs`` (N, F, 15) takes the place of the coefficients built in the
    kernel's order. Same contract and output as ``ops.rasterize.rasterize``."""
    n, f = clip.shape[0], faces.shape[0]
    dev = clip.device
    if coeffs is None:
        coeffs = edge_coefficients_kernel_order(clip, faces)
    coeffs = coeffs.reshape(n, f, 15)
    valid = torch.all(clip[:, faces.long(), 3] > 0.0, dim=-1)
    valid &= torch.amax(torch.abs(coeffs[..., :9]), dim=-1) > 0.0
    bbox = face_pixel_bbox(clip, faces, valid, h, w).long()
    fxs, fys = ras.pixel_basis(h, w, dev)
    rh, rw = region
    out = torch.zeros((n, h, w, 4), dtype=torch.float32, device=dev)
    for ry0 in range(0, h, rh):
        for rx0 in range(0, w, rw):
            ry1, rx1 = min(ry0 + rh, h) - 1, min(rx0 + rw, w) - 1
            x0, x1 = bbox[..., 0].clamp(min=rx0), bbox[..., 1].clamp(max=rx1)
            y0, y1 = bbox[..., 2].clamp(min=ry0), bbox[..., 3].clamp(max=ry1)
            live = valid & (x0 <= x1) & (y0 <= y1)
            view, face = torch.nonzero(live, as_tuple=True)
            x0, y0 = x0[live], y0[live]
            bw = x1[live] - x0 + 1
            area = bw * (y1[live] - y0 + 1)
            # one row per face-pixel test: face `of` at the k-th pixel of its bbox
            of = torch.repeat_interleave(torch.arange(area.numel(), device=dev), area)
            k = torch.arange(of.numel(), device=dev) - (torch.cumsum(area, 0) - area)[of]
            px, py = x0[of] + k % bw[of], y0[of] + k // bw[of]
            c = coeffs[view[of], face[of]]  # (tests, 15)
            fx, fy = fxs[px], fys[py]
            a0 = c[:, 0] * fx + c[:, 1] * fy + c[:, 2]
            a1 = c[:, 3] * fx + c[:, 4] * fy + c[:, 5]
            a2 = c[:, 6] * fx + c[:, 7] * fy + c[:, 8]
            covered = ((a0 >= 0) & (a1 >= 0) & (a2 >= 0)) | ((a0 <= 0) & (a1 <= 0) & (a2 <= 0))
            covered &= (a0 + a1 + a2) != 0.0
            zw = (c[:, 9] * fx + c[:, 10] * fy + c[:, 11]) / (c[:, 12] * fx + c[:, 13] * fy + c[:, 14])
            covered &= (zw >= -1.0) & (zw <= 1.0)
            slot = (view[of] * rh + (py - ry0)) * rw + (px - rx0)
            keys = torch.full((n * rh * rw,), EMPTY_KEY, dtype=torch.int64, device=dev)
            keys.scatter_reduce_(0, slot[covered], depth_keys(zw, face[of])[covered], "amin")

            # resolve: the pixels of the region that lie in the image
            nh, nw = ry1 - ry0 + 1, rx1 - rx0 + 1
            keys = keys.reshape(n, rh, rw)[:, :nh, :nw]
            fg = keys != EMPTY_KEY
            fid = torch.where(fg, keys & 0xFFFFFFFF, torch.zeros_like(keys))
            c = torch.gather(coeffs, 1, fid.reshape(n, nh * nw, 1).expand(n, nh * nw, 15))
            c = c.reshape(n, nh, nw, 15)
            fx, fy = fxs[rx0 : rx1 + 1], fys[ry0 : ry1 + 1, None]
            a0 = c[..., 0] * fx + c[..., 1] * fy + c[..., 2]
            a1 = c[..., 3] * fx + c[..., 4] * fy + c[..., 5]
            a2 = c[..., 6] * fx + c[..., 7] * fy + c[..., 8]
            iw = 1.0 / (a0 + a1 + a2)
            px = torch.stack([torch.clamp(a0 * iw, 0.0, 1.0), torch.clamp(a1 * iw, 0.0, 1.0),
                              key_depth(keys), (fid + 1).to(torch.float32)], dim=-1)
            out[:, ry0 : ry1 + 1, rx0 : rx1 + 1] = torch.where(fg[..., None], px, torch.zeros_like(px))
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry point's signature on a build of csrc/rasterize.cu."""
    lib.fp_rasterize.restype = ctypes.c_int
    lib.fp_rasterize.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fp_rasterize_config.restype = None
    lib.fp_rasterize_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, its signature set once."""
    return bind(cuda_build.load("rasterize"))


def kernel_config() -> dict:
    """The region, block size, small-face threshold and shared memory of the
    loaded build of csrc/rasterize.cu."""
    cfg = (ctypes.c_int * 5)()
    _library().fp_rasterize_config(cfg)
    return dict(zip(("region_w", "region_h", "threads", "small_face", "shared_bytes"), cfg))


def _check_inputs(clip, faces, h, w, coeffs) -> None:
    """Raise on what the kernel does not take."""
    if clip.dtype != torch.float32 or clip.dim() != 3 or clip.shape[-1] != 4:
        raise ValueError(f"rasterize kernel: clip must be (N, V, 4) f32, got "
                         f"{tuple(clip.shape)} {clip.dtype}")
    if (faces.dtype != torch.int32 or faces.device != clip.device or faces.dim() != 2
            or faces.shape[1] != 3):
        raise ValueError("rasterize kernel: faces must be (F, 3) int32 on clip's device")
    n = clip.shape[0]
    if not (1 <= n <= 65535 and 1 <= h <= 65535 * REGION[0] and w >= 1):
        raise ValueError(f"rasterize kernel: bad shape n={n} h={h} w={w}")
    want = (n, faces.shape[0], 15)
    if coeffs is not None and (coeffs.dtype != torch.float32 or coeffs.device != clip.device
                               or tuple(coeffs.shape) != want or not coeffs.is_contiguous()):
        raise ValueError(f"rasterize kernel: coeffs must be contiguous f32 {want} on clip's device")


@cuda_build.counted
def rasterize_tiled(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Rasterize N views of clip-space vertices (N, V, 4) with faces (F, 3)
    into (N, h, w, 4) f32.

    CPU tensors go through the plain version. CUDA tensors launch the
    kernel (these checks, one allocation, one launch, no other tensor op),
    which takes f32 clip and int32 faces on one device, and raises on
    anything else.
    """
    if clip.device.type == "cpu":
        return rasterize_tiled_plain(clip, faces, h, w)
    out = launch_rasterize(clip, faces, h, w)
    rasterize_tiled.launches += 1
    return out


def launch_rasterize(clip, faces, h: int, w: int,
                     coeffs: torch.Tensor | None = None) -> torch.Tensor:
    """Check the inputs, launch csrc/rasterize.cu and return its (N, h, w, 4)
    raster, without counting: ``rasterize_tiled`` is the entry point. With
    ``coeffs`` (N, F, 15), as ``rasterize_prepass`` gives them, the kernel
    reads these plane coefficients and builds none: the scatter and the
    resolve alone, which must agree with the plain version exactly."""
    if clip.device.type != "cuda":
        raise ValueError(f"unsupported device {clip.device}")
    _check_inputs(clip, faces, h, w, coeffs)
    clip, faces = clip.contiguous(), faces.contiguous()
    if clip.data_ptr() % 16:
        raise ValueError("rasterize kernel: clip must be 16-byte aligned")
    n, v = clip.shape[:2]
    out = torch.empty((n, h, w, 4), dtype=torch.float32, device=clip.device)
    fn = _library().fp_rasterize
    with torch.cuda.device(clip.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(clip.data_ptr(), faces.data_ptr(),
                 None if coeffs is None else coeffs.data_ptr(), out.data_ptr(),
                 n, v, faces.shape[0], h, w, stream)
    cuda_build.check(err, "rasterize_tiled")
    return out
