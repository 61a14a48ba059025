"""Procedural test meshes (textured cube / house / UV-sphere / scanned
blob) and OBJ and PLY writers.

A copy of the generators, ``write_obj`` and ``write_ply`` of
``foundationpose_cpp_tpu.meshio.procedural`` that the port's tests, the
dataset writer, the bench and the smoke run need; texture PNGs go through
``utils/png.py``.

The reference validates against the mustard0 dataset, which is a gated
download (test_data/download.md); these procedural assets give the test suite
and benchmarks deterministic, self-contained geometry with the same structure
(triangulated, UV-mapped, textured).
"""

from __future__ import annotations

import math
import pathlib

import numpy as np

from foundationpose_cpp_tpu_torch.geometry import symmetry
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import (
    MeshAsset,
    compute_vertex_normals,
    make_mesh_asset,
)
from foundationpose_cpp_tpu_torch.utils import png


def checkerboard_texture(size: int = 64, squares: int = 8) -> np.ndarray:
    """(size, size, 3) f32 RGB checkerboard in [0, 1]."""
    ys, xs = np.mgrid[0:size, 0:size]
    cell = size // squares
    check = ((ys // cell + xs // cell) % 2).astype(np.float32)
    tex = np.stack(
        [0.2 + 0.7 * check, 0.5 - 0.3 * check, 0.3 + 0.4 * (1 - check)], axis=-1
    )
    return tex.astype(np.float32)


def textured_cube(name: str = "cube", size: float = 0.1) -> MeshAsset:
    """Axis-aligned cube with per-face UVs (24 verts, 12 tris).

    Every face carries the IDENTICAL checkerboard, so the object is
    visually indistinguishable under the full 24-element cube rotation
    group -- it declares that set (MeshAsset.symmetries), and
    symmetry-aware metrics (rotation_error_deg_sym) score it modulo the
    group. face_colored_cube is the pose-UNIQUE variant."""
    s = size / 2.0
    verts, uvs, normals, faces = [], [], [], []
    # (axis, sign) per face; build 4 corners each. The outward winding
    # depends on the handedness of (u_axis, v_axis, axis): for axis 1 the
    # ordered remaining axes (0, 2) form a LEFT-handed frame with +y, so
    # the triangle order flips (getting this wrong renders fine -- the
    # kernel is double-sided and shading uses the stored normals -- but
    # silently fails the winding proof and disables backface culling).
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_axis, v_axis = [a for a in range(3) if a != axis]
            base = len(verts)
            for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
                p = [0.0, 0.0, 0.0]
                p[axis] = sign * s
                p[u_axis] = du * s
                p[v_axis] = dv * s
                verts.append(p)
                uvs.append([(du + 1) / 2, (dv + 1) / 2])
                n = [0.0, 0.0, 0.0]
                n[axis] = sign
                normals.append(n)
            outward = (sign > 0) ^ (axis == 1)
            if outward:
                faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
            else:
                faces += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
    return make_mesh_asset(
        name,
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
        np.asarray(normals, np.float32),
        checkerboard_texture(),
        symmetries=symmetry.box(),
    )


def face_atlas_texture(size: int = 96) -> np.ndarray:
    """(size, size, 3) atlas: 3x2 grid of distinct colors with gradients.

    Each cell is one cube face; the within-cell brightness gradient breaks
    in-plane flip symmetry so a pose is visually unique."""
    colors = [
        (0.90, 0.15, 0.15), (0.15, 0.80, 0.20), (0.20, 0.30, 0.90),
        (0.95, 0.80, 0.10), (0.90, 0.20, 0.85), (0.10, 0.85, 0.85),
    ]
    tex = np.zeros((size, size, 3), np.float32)
    ch, cw = size // 2, size // 3
    gy = np.linspace(0.55, 1.0, ch)[:, None, None]
    gx = np.linspace(0.70, 1.0, cw)[None, :, None]
    for idx, c in enumerate(colors):
        y0, x0 = (idx // 3) * ch, (idx % 3) * cw
        tex[y0 : y0 + ch, x0 : x0 + cw] = np.clip(
            np.asarray(c, np.float32)[None, None] * gy * gx, 0.0, 1.0
        )
    return tex


def face_colored_cube(name: str = "cube6", size: float = 0.1) -> MeshAsset:
    """Cube with a DISTINCT color per face (atlas UVs) -- no symmetry.

    The checkerboard textured_cube looks identical under 90-degree
    rotations, which makes rotation-error metrics meaningless; this asset
    is the pose-unique variant used by the synthetic trainer and demos.
    """
    s = size / 2.0
    verts, uvs, normals, faces = [], [], [], []
    face_idx = 0
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_axis, v_axis = [a for a in range(3) if a != axis]
            base = len(verts)
            cx, cy = face_idx % 3, face_idx // 3
            for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
                p = [0.0, 0.0, 0.0]
                p[axis] = sign * s
                p[u_axis] = du * s
                p[v_axis] = dv * s
                verts.append(p)
                # inset 5% so bilinear-wrap sampling never bleeds across cells
                uvs.append([
                    (cx + 0.05 + 0.9 * (du + 1) / 2) / 3.0,
                    (cy + 0.05 + 0.9 * (dv + 1) / 2) / 2.0,
                ])
                n = [0.0, 0.0, 0.0]
                n[axis] = sign
                normals.append(n)
            outward = (sign > 0) ^ (axis == 1)  # see textured_cube
            if outward:
                faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
            else:
                faces += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
            face_idx += 1
    return make_mesh_asset(
        name,
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
        np.asarray(normals, np.float32),
        face_atlas_texture(),
    )


def textured_house(name: str = "house", size: float = 0.1) -> MeshAsset:
    """Box + roof prism, distinct color per face group -- fully asymmetric.

    Unlike the cube (geometric 90-degree symmetry) this shape has no
    rotational symmetry at all, so rotation-error metrics are meaningful
    end to end. 16 triangles, 6 atlas color groups (bottom, front, back,
    left pentagon, right pentagon, roof).
    """
    a, b, c = size / 2.0, size * 0.4, size * 0.3  # half extents x, y, z
    d = size * 0.7  # roof apex height
    verts, uvs, normals, faces = [], [], [], []

    def add_face(pts, normal, cell, uv01):
        """pts: list of 3-D points (fan-triangulated), uv01: matching 2-D."""
        base = len(verts)
        cx, cy = cell % 3, cell // 3
        for p, (u, v) in zip(pts, uv01):
            verts.append(list(p))
            uvs.append([
                (cx + 0.05 + 0.9 * u) / 3.0,
                (cy + 0.05 + 0.9 * v) / 2.0,
            ])
            normals.append(list(normal))
        for i in range(1, len(pts) - 1):
            faces.append([base, base + i, base + i + 1])

    sq = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    # bottom (z = -c), outward normal -z (wind so the normal faces out)
    add_face(
        [(-a, -b, -c), (-a, b, -c), (a, b, -c), (a, -b, -c)],
        (0, 0, -1), 0, sq,
    )
    # front wall (y = -b)
    add_face(
        [(-a, -b, -c), (a, -b, -c), (a, -b, c), (-a, -b, c)],
        (0, -1, 0), 1, sq,
    )
    # back wall (y = +b)
    add_face(
        [(a, b, -c), (-a, b, -c), (-a, b, c), (a, b, c)],
        (0, 1, 0), 2, sq,
    )
    # gable pentagons (x = +-a): rect + apex
    pent_uv = [(0, 0), (1, 0), (1, 0.6), (0.5, 1), (0, 0.6)]
    add_face(
        [(a, -b, -c), (a, b, -c), (a, b, c), (a, 0, d), (a, -b, c)],
        (1, 0, 0), 3, pent_uv,
    )
    add_face(
        [(-a, b, -c), (-a, -b, -c), (-a, -b, c), (-a, 0, d), (-a, b, c)],
        (-1, 0, 0), 4, pent_uv,
    )
    # roof slopes (share cell 5); normals from the slope geometry
    ny = d - c  # slope rise
    ln = math.sqrt(b * b + ny * ny)
    add_face(
        [(-a, -b, c), (a, -b, c), (a, 0, d), (-a, 0, d)],
        (0, -ny / ln, b / ln), 5,
        [(0, 0), (1, 0), (1, 0.5), (0, 0.5)],
    )
    add_face(
        [(a, b, c), (-a, b, c), (-a, 0, d), (a, 0, d)],
        (0, ny / ln, b / ln), 5,
        [(0, 0.5), (1, 0.5), (1, 1), (0, 1)],
    )
    return make_mesh_asset(
        name,
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
        np.asarray(normals, np.float32),
        face_atlas_texture(),
    )


def textured_uv_sphere(
    name: str = "sphere",
    radius: float = 0.05,
    n_lat: int = 16,
    n_lon: int = 24,
) -> MeshAsset:
    """UV-sphere with (n_lat+1) x (n_lon+1) vertex grid (seam duplicated)."""
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    verts, uvs, normals = [], [], []
    for i, la in enumerate(lats):
        for j, lo in enumerate(lons):
            n = [np.sin(la) * np.cos(lo), np.sin(la) * np.sin(lo), np.cos(la)]
            verts.append([radius * c for c in n])
            normals.append(n)
            uvs.append([j / n_lon, i / n_lat])
    faces = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                faces.append([a, c, b])
            if i < n_lat - 1:
                faces.append([b, c, d])
    return make_mesh_asset(
        name,
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
        np.asarray(normals, np.float32),
        checkerboard_texture(),
    )


def scanned_blob(
    name: str = "scan",
    seed: int = 0,
    radius: float = 0.05,
    n_lat: int = 230,
    n_lon: int = 230,
    tex_size: int = 512,
) -> MeshAsset:
    """Dense scanned-object stand-in: >=100k-face bumpy blob, 512^2 sharp
    texture (BundleSDF-style reconstruction output,
    reference docs/gen_3d_obj_with_bundlesdf.md). Fully vectorized -- a
    105k-face mesh builds in ~100 ms.

    The radial field mixes several spherical-harmonic-ish frequencies (the
    lumpy low-poly shape of a fused TSDF) and the texture combines smooth
    color patches with a fine checker + speckle layer (the baked-in camera
    texture detail that makes per-pixel texturing matter).
    """
    rng = np.random.default_rng(seed)
    la = np.linspace(0.0, np.pi, n_lat + 1)
    lo = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    LA, LO = np.meshgrid(la, lo, indexing="ij")  # (n_lat+1, n_lon+1)
    nx = np.sin(LA) * np.cos(LO)
    ny = np.sin(LA) * np.sin(LO)
    nz = np.cos(LA)
    # low-frequency lumps: random cosine bumps in direction space
    r = np.ones_like(LA)
    for _ in range(6):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        dot = nx * d[0] + ny * d[1] + nz * d[2]
        r += rng.uniform(0.05, 0.18) * np.cos(
            rng.uniform(2.0, 5.0) * np.arccos(np.clip(dot, -1, 1))
        )
    # seam consistency: duplicate column must carry identical radii
    r[:, -1] = r[:, 0]
    verts = (radius * r)[..., None] * np.stack([nx, ny, nz], axis=-1)
    uvs = np.stack(
        [LO / (2 * np.pi), LA / np.pi], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    verts = verts.reshape(-1, 3).astype(np.float32)

    stride = n_lon + 1
    i = np.arange(n_lat)[:, None]
    j = np.arange(n_lon)[None, :]
    a = i * stride + j
    b = a + 1
    c = a + stride
    d = c + 1
    up = np.stack([a, c, b], axis=-1)[1:]  # skip degenerate pole row
    dn = np.stack([b, c, d], axis=-1)[:-1]
    faces = np.concatenate([up.reshape(-1, 3), dn.reshape(-1, 3)]).astype(
        np.int32
    )

    normals = compute_vertex_normals(verts, faces)

    # texture: smooth blotches + fine checker + speckle
    ys, xs = np.mgrid[0:tex_size, 0:tex_size] / tex_size
    tex = np.stack(
        [
            0.45 + 0.25 * np.sin(2 * np.pi * (2 * xs + ys)),
            0.45 + 0.25 * np.sin(2 * np.pi * (xs - 2 * ys) + 1.3),
            0.5 + 0.2 * np.sin(2 * np.pi * (3 * xs * ys) + 2.1),
        ],
        axis=-1,
    )
    checker = ((xs * 64).astype(int) + (ys * 64).astype(int)) % 2
    tex *= 0.75 + 0.25 * checker[..., None]
    tex += rng.uniform(-0.06, 0.06, tex.shape)
    return make_mesh_asset(
        name, verts, faces, uvs, normals,
        np.clip(tex, 0.0, 1.0).astype(np.float32),
    )


def write_obj(asset: MeshAsset, path: str, texture_path: str | None = None) -> None:
    """Write an asset as OBJ, plus an MTL file and a PNG texture when
    ``texture_path`` is given (procedural.py:336-365)."""
    lines = []
    mtl_name = None
    if texture_path is not None:
        png.write_png(texture_path, (asset.texture * 255).astype(np.uint8))
        mtl_path = pathlib.Path(path).with_suffix(".mtl")
        tex_rel = pathlib.Path(texture_path).name
        mtl_path.write_text(f"newmtl material0\nKd 1 1 1\nmap_Kd {tex_rel}\n")
        lines.append(f"mtllib {mtl_path.name}")
        mtl_name = "material0"
    for v in asset.vertices:
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    for t in asset.texcoords:
        lines.append(f"vt {t[0]} {t[1]}")
    for n in asset.vertex_normals:
        lines.append(f"vn {n[0]} {n[1]} {n[2]}")
    if mtl_name:
        lines.append(f"usemtl {mtl_name}")
    for f in asset.faces:
        lines.append("f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in f))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_ply(
    asset: MeshAsset,
    path: str,
    texture_path: str | None = None,
    binary: bool = True,
    with_normals: bool = True,
    with_uvs: bool = True,
) -> None:
    """Write an asset as PLY (ascii or binary_little_endian), plus a PNG
    texture named in a ``comment TextureFile`` line when ``texture_path`` is
    given (procedural.py:368-426): BundleSDF reconstructions arrive as PLY
    (reference test_data/download.md mesh layout)."""
    v = np.asarray(asset.vertices, np.float32)
    n = np.asarray(asset.vertex_normals, np.float32)
    t = np.asarray(asset.texcoords, np.float32)
    f = np.asarray(asset.faces, np.int32)
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0"]
    if texture_path is not None:
        png.write_png(texture_path, (asset.texture * 255).astype(np.uint8))
        header.append(f"comment TextureFile {pathlib.Path(texture_path).name}")
    header.append(f"element vertex {v.shape[0]}")
    header += ["property float x", "property float y", "property float z"]
    if with_normals:
        header += ["property float nx", "property float ny", "property float nz"]
    if with_uvs:
        header += ["property float u", "property float v"]
    header.append(f"element face {f.shape[0]}")
    header.append("property list uchar int vertex_indices")
    header.append("end_header")
    cols = [v] + ([n] if with_normals else []) + ([t] if with_uvs else [])
    rec = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fh.write(rec.tobytes())
            # one record per face: a uint8 count of 3, then three int32 indices
            face_rec = np.empty(f.shape[0], dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            face_rec["n"] = 3
            face_rec["idx"] = f
            fh.write(face_rec.tobytes())
        else:
            for row in rec:
                fh.write((" ".join(repr(float(x)) for x in row) + "\n").encode())
            for face in f:
                fh.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())
