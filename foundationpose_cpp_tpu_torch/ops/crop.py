"""The observed crops of N poses: the RGB and xyz warps, the pointcloud
threshold and the channel concat as one pass.

``crop_observed`` launches ``csrc/crop.cu`` on the card, one kernel a pass,
and runs ``crop_observed_plain`` for the CPU: the composition of
``ops/warp.py`` (``warp_crop_linear_u8``, ``warp_crop_nearest_f32``) and
``ops/pointcloud.py`` (``threshold_and_downscale_pointcloud``,
``concat_channels``), which is bit-exact with the JAX package. The kernel
repeats that composition's operations in its order and equals it on the card
bit for bit, NaN included. It replaces no Pallas kernel: it is the
counterpart of the reference's cvcuda warps and its threshold and concat
kernels (foundationpose_render.cpp:731-812, foundationpose_render.cu:61-140).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build, pointcloud, warp


def crop_observed_plain(
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    tfs: torch.Tensor,
    poses: torch.Tensor,
    downscale: float | torch.Tensor,
    ch: int,
    cw: int,
    min_depth: float,
    max_depth: float,
) -> torch.Tensor:
    """The plain PyTorch version, any device: (N, ch, cw, 6) f32."""
    rgb_crop = warp.warp_crop_linear_u8(rgb, tfs, ch, cw)
    xyz_crop = warp.warp_crop_nearest_f32(xyz_map, tfs, ch, cw)
    xyz_crop = pointcloud.threshold_and_downscale_pointcloud(
        xyz_crop, poses, downscale, min_depth, max_depth
    )
    return pointcloud.concat_channels(rgb_crop, xyz_crop)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, its signature set once."""
    lib = cuda_build.load("crop")
    lib.fp_crop_observed.restype = ctypes.c_int
    lib.fp_crop_observed.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    return lib


def _check(rgb, xyz_map, tfs, poses, downscale, ch: int, cw: int) -> None:
    """Raise on what the kernel does not take."""
    dev, n = tfs.device, tfs.shape[0]
    for name, t, dtype, shape in (
        ("rgb", rgb, torch.uint8, (*rgb.shape[:2], 3)),
        ("xyz_map", xyz_map, torch.float32, (*xyz_map.shape[:2], 3)),
        ("tfs", tfs, torch.float32, (n, 3, 3)),
        ("poses", poses, torch.float32, (n, 4, 4)),
        ("downscale", downscale if isinstance(downscale, torch.Tensor) else None,
         torch.float32, (n,)),
    ):
        if t is None:
            continue
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"crop_observed: {name} must be contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if ch < 1 or cw < 1:
        raise ValueError(f"crop_observed: bad crop {ch}x{cw}")


@cuda_build.counted
def crop_observed(
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    tfs: torch.Tensor,
    poses: torch.Tensor,
    downscale: float | torch.Tensor,
    ch: int,
    cw: int,
    min_depth: float,
    max_depth: float,
) -> torch.Tensor:
    """The observed model input crops, (N, ch, cw, 6) f32: the bilinear RGB
    crop in [0, 1] in channels 0-2, the nearest xyz centred on each pose's
    translation, divided by ``downscale`` and thresholded in channels 3-5.

    rgb (H, W, 3) u8 and xyz_map (H', W', 3) f32, one frame for all poses;
    tfs (N, 3, 3) f32 crop affines; poses (N, 4, 4) f32; downscale a number
    or an (N,) f32 tensor, a view each. Every tensor contiguous on one
    device: the wrapper raises otherwise. CPU tensors go through the plain
    version. CUDA tensors go through the kernel (one allocation and one
    launch), which raises on a view count outside 1..65535 and on an input
    that requires a gradient under grad mode (the kernel is forward-only).
    """
    _check(rgb, xyz_map, tfs, poses, downscale, ch, cw)
    args = (rgb, xyz_map, tfs, poses, downscale, ch, cw, min_depth, max_depth)
    if tfs.device.type == "cpu":
        return crop_observed_plain(*args)
    if tfs.device.type != "cuda":
        raise ValueError(f"unsupported device {tfs.device}")
    per_view = isinstance(downscale, torch.Tensor)
    cuda_build.refuse_grad(rgb, xyz_map, tfs, poses, downscale if per_view else None,
                           what="crop_observed")
    n = tfs.shape[0]
    if not 1 <= n <= 65535:
        raise ValueError(f"crop_observed: bad view count {n}")
    out = torch.empty((n, ch, cw, 6), dtype=torch.float32, device=tfs.device)
    fn = _library().fp_crop_observed
    with torch.cuda.device(tfs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            rgb.data_ptr(), xyz_map.data_ptr(), tfs.data_ptr(), poses.data_ptr(),
            downscale.data_ptr() if per_view else None,
            # PyTorch on the card divides by a number as a product with its
            # reciprocal, taken in double and rounded to f32 (ctypes rounds)
            0.0 if per_view else 1.0 / float(downscale),
            out.data_ptr(), n, rgb.shape[0], rgb.shape[1], xyz_map.shape[0], xyz_map.shape[1],
            ch, cw, min_depth, max_depth, stream,
        )
    cuda_build.check(err, "crop_observed")
    crop_observed.launches += 1
    return out
