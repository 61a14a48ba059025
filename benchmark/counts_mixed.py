"""K2's bound on a launch that renders each view of its own mesh.

Counted from shapes and data as ``counts.py`` counts them, never from what
the kernel does: every distinct mesh's bytes (positions, normals, uvs,
faces, face flags, texture) read once, each view's pose and clip matrix,
the (n, crop, crop, 6) f32 image written once; and the face-pixel tests
each view needs against its own mesh (``counts.render_tests_needed``), at
``counts.RENDER_TEST_FLOPS`` a test on the f32 peak.
"""

from __future__ import annotations

import torch

from benchmark import counts


def mesh_bytes(vertices: int, faces: int, texture_texels: int) -> int:
    """One mesh as ``counts.render_bound_s`` counts it."""
    return vertices * (3 + 3 + 2) * 4 + faces * (3 * 4 + 1) + texture_texels * 3 * 4


def tests_needed(clips: list[torch.Tensor], faces: list[torch.Tensor], crop: int) -> int:
    """Face-pixel tests of every view against its own mesh: ``clips[k]``
    (n_k, V_k, 4) the clip coordinates of the views of mesh k, whose faces
    are ``faces[k]``."""
    return sum(counts.render_tests_needed(c, f, crop, crop) for c, f in zip(clips, faces))


def render_bound_s(n: int, crop: int, meshes: list[tuple[int, int, int]], tests: int) -> float:
    """K2 rendering n views of crop x crop, each on one of ``meshes``
    ((vertices, faces, texture texels) of each distinct mesh)."""
    bytes_moved = sum(mesh_bytes(*m) for m in meshes) + 2 * n * 16 * 4 + n * crop * crop * 6 * 4
    return counts.bound_s(bytes_moved, float(tests) * counts.RENDER_TEST_FLOPS,
                          counts.PEAK_F32_FLOPS)
