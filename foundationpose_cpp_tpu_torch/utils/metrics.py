"""Pose-quality metrics: ADD, ADD-S, rotation and translation errors.

Counterpart of ``foundationpose_cpp_tpu.utils.metrics``: ADD / ADD-S
(Hinterstoisser et al.), the 6-DoF metrics FoundationPose reports, against a
ground-truth pose over the mesh vertices, on the host in numpy.
"""

from __future__ import annotations

import numpy as np


def transform_pts(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ pose[:3, :3].T + pose[:3, 3]


def add_error(pose_est: np.ndarray, pose_gt: np.ndarray, pts: np.ndarray) -> float:
    """ADD: mean distance between correspondingly transformed model points."""
    a = transform_pts(pose_est, pts)
    b = transform_pts(pose_gt, pts)
    return float(np.linalg.norm(a - b, axis=1).mean())


def adds_error(
    pose_est: np.ndarray, pose_gt: np.ndarray, pts: np.ndarray,
    max_points: int = 2048, seed: int = 0,
) -> float:
    """ADD-S: mean closest-point distance (symmetric-object metric), over a
    ``max_points`` subsample drawn by ``default_rng(seed)`` when larger."""
    if pts.shape[0] > max_points:
        idx = np.random.default_rng(seed).choice(pts.shape[0], max_points, replace=False)
        pts = pts[idx]
    a = transform_pts(pose_est, pts)
    b = transform_pts(pose_gt, pts)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(axis=1)).mean())


def rotation_error_deg(pose_est: np.ndarray, pose_gt: np.ndarray) -> float:
    r = pose_est[:3, :3] @ pose_gt[:3, :3].T
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def rotation_error_deg_sym(
    pose_est: np.ndarray,
    pose_gt: np.ndarray,
    symmetries: np.ndarray | None,
) -> float:
    """Geodesic rotation error modulo an object's declared symmetry set.

    symmetries: (S, 4, 4) object-frame transforms (MeshAsset.symmetries /
    geometry.symmetry); a pose and pose @ S are equivalent, matching the
    reference's ClusterPoses right-multiplication
    (foundationpose_sampling.cpp:152-162: ``cur_pose * tf``). None or an
    identity-only set reduces to rotation_error_deg.
    """
    if symmetries is None:
        return rotation_error_deg(pose_est, pose_gt)
    best = np.inf
    for s in np.asarray(symmetries):
        equiv = pose_gt[:3, :3] @ s[:3, :3]
        r = pose_est[:3, :3] @ equiv.T
        cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
        best = min(best, float(np.degrees(np.arccos(cos))))
    return best


def translation_error(pose_est: np.ndarray, pose_gt: np.ndarray) -> float:
    return float(np.linalg.norm(pose_est[:3, 3] - pose_gt[:3, 3]))


def add_auc(errors: np.ndarray, max_threshold: float = 0.1, steps: int = 100) -> float:
    """Area under the ADD(-S) accuracy-threshold curve (FoundationPose's
    headline number)."""
    errors = np.asarray(errors)
    thresholds = np.linspace(0, max_threshold, steps + 1)[1:]
    acc = [(errors < t).mean() for t in thresholds]
    return float(np.mean(acc))
