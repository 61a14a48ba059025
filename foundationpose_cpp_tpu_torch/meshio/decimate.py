"""Mesh decimation by vertex clustering.

A copy of ``foundationpose_cpp_tpu.meshio.decimate``.

Scanned/reconstructed meshes (the BundleSDF-generated-mesh configuration in
BASELINE.json) arrive with 10^5..10^6 faces. The reference renders whatever it
is given -- CudaRaster absorbs the load on GPU -- and leaves simplification to
the user's asset pipeline. Here decimation is a first-class preprocessing
step: render cost scales with face count, and pose estimation needs geometry
at roughly crop-pixel resolution (160x160), so a ~5-20k-face proxy is
lossless for the estimator.

Vertex clustering: snap vertices to a uniform grid (cell size derived from
the target face budget), merge vertices per cell (averaging positions,
renormalizing averaged normals, averaging UVs), drop collapsed faces, and
deduplicate. Runs in O(V + F) numpy; preserves the MeshAsset contract.
"""

from __future__ import annotations

import numpy as np

from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset, make_mesh_asset


def decimate_vertex_clustering(
    asset: MeshAsset,
    target_faces: int,
    max_iters: int = 8,
) -> MeshAsset:
    """Decimate to approximately <= target_faces faces.

    Iteratively coarsens the clustering grid until the face budget is met.
    Returns the input unchanged when it is already within budget.
    """
    if asset.num_faces <= target_faces:
        return asset

    verts = asset.vertices
    extent = float(np.max(verts.max(axis=0) - verts.min(axis=0)))
    # initial guess: faces scale ~ (extent/cell)^2 for surface meshes
    cell = extent / max(np.sqrt(target_faces / 2.0), 1.0)

    out = asset
    for _ in range(max_iters):
        out = _cluster_once(asset, cell)
        if out.num_faces <= target_faces:
            break
        cell *= 1.3
    return out


def _cluster_once(asset: MeshAsset, cell: float) -> MeshAsset:
    verts = asset.vertices.astype(np.float64)
    lo = verts.min(axis=0)
    keys = np.floor((verts - lo) / max(cell, 1e-12)).astype(np.int64)
    # unique cell per vertex
    _, cluster_id, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    n_clusters = counts.shape[0]

    def mean_per_cluster(values: np.ndarray) -> np.ndarray:
        acc = np.zeros((n_clusters, values.shape[1]), dtype=np.float64)
        np.add.at(acc, cluster_id, values)
        return acc / counts[:, None]

    new_verts = mean_per_cluster(verts).astype(np.float32)
    new_normals = mean_per_cluster(asset.vertex_normals.astype(np.float64))
    norms = np.linalg.norm(new_normals, axis=1, keepdims=True)
    new_normals = np.where(
        norms > 1e-12, new_normals / np.maximum(norms, 1e-12), 0.0
    ).astype(np.float32)
    new_uvs = mean_per_cluster(asset.texcoords.astype(np.float64)).astype(
        np.float32
    )

    faces = cluster_id[asset.faces]  # (F, 3) in cluster space
    # drop collapsed faces (two corners in the same cluster)
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[keep]
    # deduplicate faces regardless of corner rotation (same cyclic order)
    rolled = np.sort(faces, axis=1)
    _, first = np.unique(rolled, axis=0, return_index=True)
    faces = faces[np.sort(first)].astype(np.int32)

    return make_mesh_asset(
        asset.name,
        new_verts,
        faces,
        texcoords=new_uvs,
        vertex_normals=new_normals,
        texture=asset.texture,
    )
