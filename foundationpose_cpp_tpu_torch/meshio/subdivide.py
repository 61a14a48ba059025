"""Texture-driven face subdivision: per-pixel texturing as a mesh preprocess.

A copy of ``foundationpose_cpp_tpu.meshio.subdivide``, with its error
metrics from ``meshio/texture_error.py``. The port renders exactly per pixel,
so it needs no subdivision for its own render; ``subdivide_adaptive`` is
the scanned-mesh chain of the reference configuration (decimate, then
subdivide where the texel-patch metric asks for it), and its output is the
mesh the port then renders.

What follows is the JAX package's account of why the preprocess exists.

The JAX package's fused TPU render kernel (its ops/render_fused.py) samples
the texture at face corners and interpolates barycentrically -- zero
per-pixel gathers. The reference instead does a true bilinear texel fetch
per pixel (nvdiffrast common/texture.cu:131-179). The two agree
when every face spans at most ~a texel; on a mesh whose faces cover many
texels of a high-frequency texture, vertex sampling low-passes the texture
and the scorer loses discrimination.

The TPU-native fix is geometric, not a gather: midpoint-subdivide exactly
those faces whose UV extent exceeds a texel budget until corner sampling IS
texel sampling. This trades a one-time mesh-build cost + a larger face table
(the megakernel scales with F) for reference-grade texture fidelity with
unchanged kernel structure. tests/test_texture_fidelity.py pins the
resulting error against the reference-semantics per-pixel texture path.
"""

from __future__ import annotations

import logging

import numpy as np

from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset, make_mesh_asset
from foundationpose_cpp_tpu_torch.meshio.texture_error import (
    face_corner_colors,
    face_patch_error,
    vertex_colors_seam_robust,
)

logger = logging.getLogger(__name__)


def _face_uv_texels(uvs: np.ndarray, faces: np.ndarray, th: int, tw: int) -> np.ndarray:
    """(F,) max UV extent of each face in texels."""
    fuv = uvs[faces]  # (F, 3, 2)
    span = fuv.max(axis=1) - fuv.min(axis=1)  # (F, 2)
    return np.maximum(span[:, 0] * tw, span[:, 1] * th)


# probe barycentrics: face barycenter + the three edge midpoints -- the
# points farthest (in the subdivision metric) from the corners
_PROBES = np.array(
    [
        [1 / 3, 1 / 3, 1 / 3],
        [0.5, 0.5, 0.0],
        [0.0, 0.5, 0.5],
        [0.5, 0.0, 0.5],
    ]
)


def face_sampling_error(
    asset_texture: np.ndarray, uvs: np.ndarray, faces: np.ndarray
) -> np.ndarray:
    """(F,) worst-case color error of corner sampling vs per-pixel texturing.

    For each face, evaluates the texture bilinearly at interior probe points
    (barycenter + edge midpoints) and compares with the barycentric
    interpolation of the corner-sampled colors -- exactly the quantity the
    fused renderer's vertex sampling gets wrong vs the reference's per-pixel
    fetch (texture.cu:131-179). Smooth textures yield ~0 regardless of face
    size; only faces spanning real texture detail score high. Corners are
    sampled with the renderer's own seam-robust nudge (face_corner_colors)
    so wrap-seam faces are not flagged for an error subdivision cannot fix.
    """
    fuv = uvs[faces]  # (F, 3, 2)
    corner_col = face_corner_colors(asset_texture, uvs, faces)  # (F, 3, C)
    err = np.zeros(fuv.shape[0], np.float32)
    for w in _PROBES:
        uv_p = np.einsum("j,fjc->fc", w, fuv)  # (F, 2)
        # seam-robust like the corners: a probe on a wrap-boundary edge
        # would otherwise flag an error subdivision cannot remove (the
        # subdivided midpoint corner would be clamped the same way)
        tex_p = vertex_colors_seam_robust(asset_texture, uv_p)  # (F, C)
        interp_p = np.einsum("j,fjc->fc", w, corner_col)
        err = np.maximum(err, np.abs(tex_p - interp_p).max(axis=-1))
    return err


def _split_faces(
    verts: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    faces: np.ndarray,
    split: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One midpoint-subdivision round of the faces selected by `split`.

    Edge midpoints are shared between neighbor faces via an edge cache, so
    edges where BOTH neighbors split stay watertight; a split/unsplit
    boundary leaves a T-vertex (midpoint exactly on the neighbor's edge) --
    geometrically coincident, but its color is a fresh texture sample while
    the unsplit side interpolates corners, so a shading seam of exactly the
    sampling error being corrected can appear across such edges. Normals
    are renormalized.
    """
    vlist = [verts]
    nlist = [normals]
    ulist = [uvs]
    next_idx = verts.shape[0]
    edge_mid: dict[tuple[int, int], int] = {}
    new_faces = []

    def midpoint(a: int, b: int) -> int:
        nonlocal next_idx
        key = (a, b) if a < b else (b, a)
        found = edge_mid.get(key)
        if found is not None:
            return found
        vlist.append((vlist[0][a] + vlist[0][b])[None] / 2.0)
        n = (nlist[0][a] + nlist[0][b]) / 2.0
        n /= max(np.linalg.norm(n), 1e-12)
        nlist.append(n[None])
        ulist.append((ulist[0][a] + ulist[0][b])[None] / 2.0)
        edge_mid[key] = next_idx
        next_idx += 1
        return next_idx - 1

    # midpoint() reads only vlist[0] (face corners index the CURRENT
    # round's mesh; midpoints are created, never re-read, in one round)
    for fi, f in enumerate(faces):
        if not split[fi]:
            new_faces.append(f)
            continue
        a, b, c = (int(x) for x in f)
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        new_faces += [
            np.array([a, ab, ca]),
            np.array([ab, b, bc]),
            np.array([ca, bc, c]),
            np.array([ab, bc, ca]),
        ]
    return (
        np.concatenate(vlist, axis=0),
        np.concatenate(nlist, axis=0),
        np.concatenate(ulist, axis=0),
        np.stack(new_faces).astype(np.int64),
    )


def subdivide_for_texture(
    asset: MeshAsset,
    max_texels_per_face: float = 2.0,
    max_rounds: int = 6,
    max_faces: int = 200_000,
) -> MeshAsset:
    """Midpoint-subdivide faces until each spans <= max_texels_per_face.

    Vertices/normals/UVs are midpoint-interpolated (normals renormalized);
    edge midpoints are shared between neighbor faces via an edge cache
    (watertight where both neighbors split; see _split_faces for the
    T-vertex caveat at split/unsplit boundaries). Faces already within
    budget are untouched.

    Note: midpoint UV interpolation assumes faces do not straddle a texture
    wrap seam internally (true for meshes with duplicated seam vertices,
    the standard layout).
    """
    verts = np.asarray(asset.vertices, np.float64)
    normals = np.asarray(asset.vertex_normals, np.float64)
    uvs = np.asarray(asset.texcoords, np.float64)
    faces = np.asarray(asset.faces, np.int64)
    th, tw = asset.texture.shape[:2]

    for _ in range(max_rounds):
        ext = _face_uv_texels(uvs, faces, th, tw)
        split = ext > max_texels_per_face
        if not split.any() or faces.shape[0] >= max_faces:
            break
        # respect the face cap WITHIN a round (each split adds 3 faces):
        # without this clamp one round on an all-flagged mesh overshoots
        # max_faces by up to 4x, defeating the VMEM/face-table bound the
        # cap exists for -- worst offenders first, same as subdivide_adaptive
        budget = (max_faces - faces.shape[0]) // 3
        if budget <= 0:
            break
        if int(split.sum()) > budget:
            elig = np.where(split)[0]
            keep = elig[np.argsort(-ext[elig])][:budget]
            split = np.zeros_like(split)
            split[keep] = True
        verts, normals, uvs, faces = _split_faces(
            verts, normals, uvs, faces, split
        )

    return make_mesh_asset(
        asset.name,
        verts.astype(np.float32),
        faces.astype(np.int32),
        uvs.astype(np.float32),
        normals.astype(np.float32),
        asset.texture,
    )


def subdivide_adaptive(
    asset: MeshAsset,
    tol: float = 0.05,
    max_rounds: int = 6,
    max_faces: int = 65_536,
    patch_k: int = 0,
) -> tuple[MeshAsset, dict]:
    """Content-aware subdivision: split only faces whose sampling
    measurably deviates from per-pixel texturing (error > tol on a [0,1]
    color scale).

    patch_k selects the error metric to match how the fused kernel will
    texture the mesh: 0 = corner sampling (face_sampling_error), else the
    per-face texel-patch blend (meshio.texture_error.face_patch_error) -- with
    patches most sharp-textured meshes need NO subdivision at all, so the
    policy usually reduces to a cheap measurement.

    In the JAX package this is the automatic policy its pipeline applies
    when loading meshes (its MeshConstants.from_asset auto_subdivide): a
    scanned mesh with a sharp high-frequency texture gets reference-grade fidelity, while a mesh whose
    faces span only smooth texture regions is left untouched no matter how
    large its faces are -- the trigger is the actual sampling error, not the
    texel footprint. Returns (asset, info) where info records what the
    policy did (faces before/after, rounds, worst residual error).
    """
    verts = np.asarray(asset.vertices, np.float64)
    normals = np.asarray(asset.vertex_normals, np.float64)
    uvs = np.asarray(asset.texcoords, np.float64)
    faces = np.asarray(asset.faces, np.int64)
    f0 = faces.shape[0]

    if patch_k:
        def _err(u, f):
            return face_patch_error(asset.texture, u, f, pk=patch_k)

        def _split_mask(u, f, err):
            # split-gain gate: only split faces a finer texture sampling
            # would actually improve. Per-texel speckle noise keeps
            # err > tol at ANY subdivision level (children are just as
            # noisy), so a plain threshold ratchets every speckled mesh to
            # max_faces for ~zero render-error gain (measured: 7.9k -> 32k
            # faces for 0.031 -> 0.025). A pk*2 patch of the SAME face
            # predicts the error after one split; requiring a 30%
            # improvement admits coherent detail (checker cells: gain
            # 0.6-0.75) and rejects noise.
            # the 2pk lookahead is the expensive half of scan-mesh load
            # time: evaluate it only on the err > tol candidates instead
            # of every face (identical mask, fraction of the cost)
            cand = np.where(err > tol)[0]
            out = np.zeros(err.shape[0], bool)
            if cand.size == 0:
                return out
            fine = face_patch_error(
                asset.texture, u, f[cand], pk=2 * patch_k
            )
            gain = fine < 0.7 * err[cand]
            # footprint clause: the one-level lookahead underestimates
            # multi-round gains on faces spanning MANY texels (a 64-texel
            # checker face needs 3 rounds of splits before pk doubling
            # fully bites). A big face qualifies when doubled resolution
            # would bring it UNDER tolerance -- true for coherent detail
            # (checker cells), never for per-texel noise, whose error
            # floor no resolution reaches.
            th, tw = asset.texture.shape[:2]
            big = _face_uv_texels(u, f[cand], th, tw) > 4.0 * patch_k
            out[cand] = gain | (big & (fine <= tol))
            return out
    else:
        def _err(u, f):
            return face_sampling_error(asset.texture, u, f)

        def _split_mask(u, f, err):
            return err > tol

    rounds = 0
    err = _err(uvs, faces)
    for _ in range(max_rounds):
        split = _split_mask(uvs, faces, err)
        if not split.any() or faces.shape[0] >= max_faces:
            break
        # respect the face cap: split the worst ELIGIBLE offenders first
        budget = (max_faces - faces.shape[0]) // 3
        if budget <= 0:
            break  # cap reached: a zero budget would spin no-op rounds
        if int(split.sum()) > budget:
            elig = np.where(split)[0]
            keep = elig[np.argsort(-err[elig])][:budget]
            split = np.zeros_like(split)
            split[keep] = True
        verts, normals, uvs, faces = _split_faces(
            verts, normals, uvs, faces, split
        )
        rounds += 1
        err = _err(uvs, faces)

    info = {
        "faces_before": int(f0),
        "faces_after": int(faces.shape[0]),
        "rounds": rounds,
        "max_residual_error": float(err.max()) if err.size else 0.0,
        "tol": float(tol),
    }
    if rounds == 0:
        return asset, info
    logger.info(
        "[subdivide_adaptive] mesh '%s': %d -> %d faces in %d round(s) "
        "(%s-sampling error tol %.3f, residual %.3f)",
        asset.name, f0, faces.shape[0], rounds,
        f"patch{patch_k}" if patch_k else "corner", tol,
        info["max_residual_error"],
    )
    return (
        make_mesh_asset(
            asset.name,
            verts.astype(np.float32),
            faces.astype(np.int32),
            uvs.astype(np.float32),
            normals.astype(np.float32),
            asset.texture,
        ),
        info,
    )
