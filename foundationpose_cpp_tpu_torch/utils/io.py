"""Dataset IO for reference-format RGB-D sequences.

Counterpart of ``foundationpose_cpp_tpu.utils.io``. The mustard0 layout the
reference tests against (test_data/download.md:5-16):

    <root>/cam_K.txt     3x3 intrinsics, whitespace separated
    <root>/rgb/*.png     8-bit color
    <root>/depth/*.png   16-bit depth in millimeters
    <root>/masks/*.png   binary mask (first channel)
    <root>/mesh/*.obj    textured mesh

Conversions mirror the reference test helpers (simple_tests/include/tests/
help_func.hpp:10-52): color as RGB, u16 depth / 1000 -> float32 meters,
mask = first channel, nonzero -> 255. Images decode through ``utils/png.py``
(a PNG stores RGB, which is what cv2's BGR read flipped back gives).
"""

from __future__ import annotations

import pathlib

import numpy as np

from foundationpose_cpp_tpu_torch.utils import png


def read_cam_k(path: str) -> np.ndarray:
    """3x3 intrinsics from a whitespace-separated text file (ReadCamK)."""
    vals = np.loadtxt(path, dtype=np.float64).reshape(3, 3)
    return vals.astype(np.float32)


def _imread(path: str) -> np.ndarray:
    """(H, W) or (H, W, 3) samples; alpha is dropped, gray + alpha is gray."""
    img = png.read_png(str(path))
    if img.ndim == 3:
        img = img[..., 0] if img.shape[2] == 2 else img[..., :3]
    return img


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    img = _imread(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3], dtype=np.uint8)


def read_depth(path: str, scale_to_meters: float = 1e-3) -> np.ndarray:
    """(H, W) float32 meters from a 16-bit millimeter PNG."""
    img = _imread(path)
    if img.ndim == 3:
        img = img[..., 0]
    return (img.astype(np.float32) * scale_to_meters).astype(np.float32)


def read_mask(path: str) -> np.ndarray:
    """(H, W) uint8 binary mask (first channel, nonzero = object -> 255)."""
    img = _imread(path)
    if img.ndim == 3:
        img = img[..., 0]
    return (img > 0).astype(np.uint8) * 255


def read_frame(root: str, frame_id: str, with_mask: bool = False):
    """(rgb, depth[, mask]) for one frame of a reference-layout dataset."""
    root_p = pathlib.Path(root)
    rgb = read_rgb(str(root_p / "rgb" / f"{frame_id}.png"))
    depth = read_depth(str(root_p / "depth" / f"{frame_id}.png"))
    if not with_mask:
        return rgb, depth
    mask = read_mask(str(root_p / "masks" / f"{frame_id}.png"))
    return rgb, depth, mask


def list_frame_ids(root: str) -> list[str]:
    """Sorted frame ids from <root>/rgb (get_files_in_directory + sort)."""
    rgb_dir = pathlib.Path(root) / "rgb"
    return sorted(p.stem for p in rgb_dir.glob("*.png"))
