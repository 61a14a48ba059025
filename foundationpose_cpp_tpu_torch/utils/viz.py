"""3-D bounding-box overlay.

Counterpart of ``foundationpose_cpp_tpu.utils.viz`` (the reference test
helper draw3DBoundingBox, simple_tests/include/tests/help_func.hpp:54-106):
project the 8 corners of the oriented bounding box through K and draw the
12 edges, always with the small numpy line drawer (the JAX package's no-cv2
path), so the port needs no cv2.
"""

from __future__ import annotations

import numpy as np

_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def project_bbox_corners(
    K: np.ndarray, pose_bbox: np.ndarray, dimension: np.ndarray
) -> np.ndarray:
    """(8, 2) pixel coordinates of the OBB corners under pose_bbox."""
    half = np.asarray(dimension, dtype=np.float64) / 2.0
    corners = np.array(
        [[sx * half[0], sy * half[1], sz * half[2], 1.0]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    cam = (np.asarray(pose_bbox, np.float64) @ corners.T).T[:, :3]
    uv = (np.asarray(K, np.float64) @ cam.T).T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)


def _draw_line(img: np.ndarray, p0, p1, color, thickness=2) -> None:
    """Sample the segment at one point per pixel of its longer extent and
    paint a (2r+1)^2 square at each, clipped to the image."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    r = max(1, thickness // 2)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, w - 1)
            yi = np.clip(ys + dy, 0, h - 1)
            img[yi, xi] = color


def draw_3d_bbox(
    rgb: np.ndarray,
    K: np.ndarray,
    pose_bbox: np.ndarray,
    dimension: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Overlay the projected OBB wireframe on a copy of rgb."""
    uv = project_bbox_corners(K, pose_bbox, dimension).astype(int)
    img = np.ascontiguousarray(rgb).copy()
    for a, b in _EDGES:
        _draw_line(img, uv[a], uv[b], np.asarray(color, img.dtype), thickness)
    return img
