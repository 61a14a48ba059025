"""Rotational-symmetry sets for meshes (object-frame 4x4 transforms).

A copy of ``foundationpose_cpp_tpu.geometry.symmetry``. The reference carries
symmetry transforms through its pose clustering: ``ClusterPoses(angle,
dist, poses, symmetry_tfs)`` right-multiplies each candidate pose by every
symmetry tf before the geodesic comparison (foundationpose_sampling.cpp:
130-176 -- ``cur_pose * tf``). The same convention applies here: a pose
``P`` and ``P @ S`` are equivalent views of an object whose symmetry set
contains ``S``.

These sets serve two consumers:

  * evaluation: ``utils.metrics.rotation_error_deg_sym`` reports the
    geodesic error modulo the declared symmetries, so a 90-degree flip of
    a textureless cube is not scored as a 90-degree error;
  * ``MeshAsset.symmetries`` declares an object's set (None = asymmetric).

All transforms are exact rotations (orthonormal, det +1) about the object
frame's principal axes, as 4x4 matrices matching the reference's
``symmetry_tfs`` type.
"""

from __future__ import annotations

import itertools

import numpy as np


def identity() -> np.ndarray:
    """The trivial set (asymmetric object): just the identity."""
    return np.eye(4, dtype=np.float32)[None]


def _rot4(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    r = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    r[i, i] = c
    r[j, j] = c
    r[i, j] = -s if axis != 1 else s
    r[j, i] = s if axis != 1 else -s
    out = np.eye(4)
    out[:3, :3] = r
    return out


def axis_cyclic(axis: int, n: int) -> np.ndarray:
    """n-fold rotational symmetry about one principal axis (prisms, gears).

    axis: 0=x, 1=y, 2=z. Returns (n, 4, 4) including the identity.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return np.stack([_rot4(axis, 2.0 * np.pi * k / n) for k in range(n)]).astype(np.float32)


def axis_continuous(axis: int, steps: int = 36) -> np.ndarray:
    """Continuous rotational symmetry (cylinders, bottles) discretized to
    `steps` samples -- metrics taking a min over the set approximate the
    continuous minimum to within pi/steps."""
    return axis_cyclic(axis, steps)


def box(dims: tuple[float, float, float] | None = None, tol: float = 1e-6) -> np.ndarray:
    """Rotational symmetries of a (textureless) box with the given extents.

    A cube (all extents equal) has the full 24-element rotation group; a
    square cuboid keeps the 8 rotations fixing its long axis plus the
    flips that swap the equal faces; a generic box keeps the 4
    180-degree rotations (identity + 3 axis flips). dims=None means cube.
    """
    dims = (1.0, 1.0, 1.0) if dims is None else tuple(float(d) for d in dims)
    # enumerate the full cube group, keep the elements that permute the
    # extents onto themselves
    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            r = np.zeros((3, 3))
            for row, (col, s) in enumerate(zip(perm, signs)):
                r[row, col] = s
            if np.linalg.det(r) < 0:
                continue
            new_dims = tuple(dims[c] for c in perm)
            if all(abs(a - b) <= tol * max(dims) for a, b in zip(new_dims, dims)):
                m = np.eye(4)
                m[:3, :3] = r
                out.append(m)
    return np.stack(out).astype(np.float32)
