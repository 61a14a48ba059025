"""Randomized procedural object family for object-generalizable training.

The reference's pre-trained engines work on ANY mesh with zero per-object
training (reference README.md:72 distributes the checkpoints;
simple_tests/src/test_foundationpose.cpp:22-46 just loads the engines and
runs mustard). The published FoundationPose model earns that property by
training on a large randomized synthetic object corpus. This module is the
in-repo analogue: a deterministic, seeded generator of textured meshes with
randomized geometry (superquadrics, bump-deformed spheres, random convex
hulls, random boxes/prisms) and randomized pose-unique textures, used by
training.multi to train ONE refiner/scorer across the family and evaluated
on objects (seeds and generator types) the trainer never saw.

The port's own copy of ``foundationpose_cpp_tpu.meshio.family``: the same
draws in the same order, so every asset (vertices, faces, uvs, texture)
equals the JAX package's. scipy's ConvexHull (imported when the hull
generator runs) gives the hull's faces in the same order.

Design constraints that come from the JAX package's TPU training step
(its training/multi.py), kept so that the family stays the same:

- every object is rescaled to a COMMON diameter: the whole pipeline is
  diameter-normalized by construction (crops scale with diameter, xyz maps
  and translation targets divide by diameter/2 -- pointcloud.py,
  transforms.apply_refine_delta), so a fixed training diameter loses no
  generality while letting the fused render kernel keep its static
  inv_downscale scalar (ops/render_fused.py render_views_fused).
- textures are SMOOTH low-frequency color fields (no repeating checker
  cells): appearance must disambiguate pose (repeating patterns alias
  under translation) and survive the fused kernel's vertex-sampled
  texturing at a few hundred vertices.
- geometry is asymmetrized (per-axis scales + bump fields) so the refiner's
  pose-delta supervision is single-valued; near-symmetric draws would give
  one rendered appearance two different "correct" targets.
"""

from __future__ import annotations

import numpy as np

from foundationpose_cpp_tpu_torch.meshio.mesh_loader import (
    MeshAsset,
    compute_vertex_normals,
    make_mesh_asset,
    mesh_diameter,
)

#: generators used for TRAINING draws (training/multi.py). "wedge" is
#: deliberately excluded -- it is the held-out generator family for the
#: unseen-object eval (tools/train_multi.py, tests/test_multi_object.py).
TRAIN_GENERATORS = ("superquadric", "bumpy", "hull", "box", "prism")
HELDOUT_GENERATORS = ("wedge",)

FAMILY_DIAMETER = 0.12  # meters; common training diameter (see module doc)


# ---------------------------------------------------------------------------
# textures: smooth pose-unique random color fields


def random_smooth_texture(rng: np.random.Generator, size: int = 64) -> np.ndarray:
    """(size, size, 3) f32 RGB in [0,1]: random low-frequency color field.

    Sum of a random affine ramp and 2 random sinusoids per channel --
    smooth enough for vertex-sampled texturing, non-repeating enough that
    every UV region has a distinct color signature.
    """
    u, v = np.meshgrid(
        np.linspace(0.0, 1.0, size), np.linspace(0.0, 1.0, size), indexing="xy"
    )
    tex = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        base = rng.uniform(0.25, 0.75)
        gu, gv = rng.uniform(-0.5, 0.5, size=2)
        field = base + gu * (u - 0.5) + gv * (v - 0.5)
        for _ in range(2):
            fu, fv = rng.uniform(-2.5, 2.5, size=2)
            amp = rng.uniform(0.05, 0.25)
            phase = rng.uniform(0, 2 * np.pi)
            field = field + amp * np.sin(2 * np.pi * (fu * u + fv * v) + phase)
        tex[..., c] = field
    return np.clip(tex, 0.02, 0.98).astype(np.float32)


# ---------------------------------------------------------------------------
# geometry generators (all return verts, faces, uvs; verts unscaled)


def _sphere_grid(n_lat: int, n_lon: int):
    """UV-sphere topology: (lat, lon) grid, seam duplicated, poles welded
    by degenerate-face skipping (same scheme as procedural.textured_uv_sphere)."""
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    la, lo = np.meshgrid(lats, lons, indexing="ij")
    dirs = np.stack(
        [np.sin(la) * np.cos(lo), np.sin(la) * np.sin(lo), np.cos(la)], axis=-1
    ).reshape(-1, 3)
    uvs = np.stack(
        [
            (lo / (2 * np.pi)).reshape(-1),
            (la / np.pi).reshape(-1),
        ],
        axis=-1,
    )
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
    return dirs.astype(np.float64), np.asarray(faces, np.int32), uvs.astype(np.float32)


def _superquadric(rng: np.random.Generator, n_lat=16, n_lon=24):
    """Superquadric r(dir) with random exponents + per-axis scales."""
    dirs, faces, uvs = _sphere_grid(n_lat, n_lon)
    e1 = rng.uniform(0.6, 1.8)  # east-west squareness
    e2 = rng.uniform(0.6, 1.8)  # north-south squareness
    scales = rng.uniform(0.45, 1.0, size=3)
    # signed-power reshaping of the unit sphere directions
    sp = np.sign(dirs) * np.abs(dirs) ** np.array([e1, e1, e2])
    verts = sp * scales
    return verts, faces, uvs


def _bumpy_sphere(rng: np.random.Generator, n_lat=16, n_lon=24):
    """Unit sphere with a random low-frequency radial bump field."""
    dirs, faces, uvs = _sphere_grid(n_lat, n_lon)
    r = np.ones(dirs.shape[0])
    for _ in range(3):
        w = rng.normal(size=3)
        w /= np.linalg.norm(w)
        freq = rng.uniform(1.0, 3.0)
        amp = rng.uniform(0.05, 0.22)
        phase = rng.uniform(0, 2 * np.pi)
        r = r + amp * np.sin(freq * np.pi * (dirs @ w) + phase)
    scales = rng.uniform(0.55, 1.0, size=3)
    verts = dirs * r[:, None] * scales
    return verts, faces, uvs


def _convex_hull(rng: np.random.Generator, n_points: int = 40):
    """Convex hull of random anisotropic gaussian points; spherical UVs."""
    from scipy.spatial import ConvexHull

    pts = rng.normal(size=(n_points, 3)) * rng.uniform(0.4, 1.0, size=3)
    hull = ConvexHull(pts)
    verts = pts[hull.vertices]
    remap = {int(v): i for i, v in enumerate(hull.vertices)}
    faces = np.asarray(
        [[remap[int(i)] for i in simplex] for simplex in hull.simplices],
        np.int32,
    )
    # ConvexHull simplices are not consistently wound; orient each outward
    # (centroid test -- hull is star-shaped around its centroid)
    centroid = verts.mean(axis=0)
    fv = verts[faces]
    n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    inward = np.einsum("fi,fi->f", n, fv.mean(axis=1) - centroid) < 0
    faces[inward] = faces[inward][:, ::-1]
    d = verts - centroid
    u = (np.arctan2(d[:, 1], d[:, 0]) / (2 * np.pi) + 0.5).astype(np.float32)
    v = (
        np.arccos(np.clip(d[:, 2] / np.linalg.norm(d, axis=1), -1, 1)) / np.pi
    ).astype(np.float32)
    return verts, faces, np.stack([u, v], axis=-1)


def _box_faces(extents: np.ndarray):
    """Axis-aligned box with per-face UV cells (procedural.textured_cube
    construction, arbitrary half-extents)."""
    verts, uvs, faces = [], [], []
    face_idx = 0
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_axis, v_axis = [a for a in range(3) if a != axis]
            base = len(verts)
            cx, cy = face_idx % 3, face_idx // 3
            for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
                p = [0.0, 0.0, 0.0]
                p[axis] = sign * extents[axis]
                p[u_axis] = du * extents[u_axis]
                p[v_axis] = dv * extents[v_axis]
                verts.append(p)
                uvs.append([
                    (cx + 0.05 + 0.9 * (du + 1) / 2) / 3.0,
                    (cy + 0.05 + 0.9 * (dv + 1) / 2) / 2.0,
                ])
            outward = (sign > 0) ^ (axis == 1)
            if outward:
                faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
            else:
                faces += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
            face_idx += 1
    return (
        np.asarray(verts, np.float64),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
    )


def _random_box(rng: np.random.Generator):
    extents = rng.uniform(0.35, 1.0, size=3)
    return _box_faces(extents)


def _random_prism(rng: np.random.Generator):
    """Extruded random convex polygon (5-8 sides), fan-capped."""
    n_sides = int(rng.integers(5, 9))
    ang = np.sort(rng.uniform(0, 2 * np.pi, size=n_sides))
    # enforce minimum angular gaps so edges never degenerate
    ang = ang + np.linspace(0, 0.2, n_sides)
    rad = rng.uniform(0.5, 1.0, size=n_sides)
    half_h = rng.uniform(0.3, 0.8)
    ring = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    verts, uvs, faces = [], [], []
    for zsign in (-1.0, 1.0):
        for k in range(n_sides):
            verts.append([ring[k, 0], ring[k, 1], zsign * half_h])
            uvs.append([k / n_sides, 0.25 + 0.5 * (zsign > 0)])
    bot = list(range(n_sides))
    top = list(range(n_sides, 2 * n_sides))
    for k in range(n_sides):
        k2 = (k + 1) % n_sides
        # side quad wound outward (ring is CCW seen from +z)
        faces += [[bot[k], bot[k2], top[k2]], [bot[k], top[k2], top[k]]]
    for k in range(1, n_sides - 1):  # caps
        faces.append([bot[0], bot[k + 1], bot[k]])  # -z cap faces down
        faces.append([top[0], top[k], top[k + 1]])  # +z cap faces up
    return (
        np.asarray(verts, np.float64),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
    )


def _random_wedge(rng: np.random.Generator):
    """HELD-OUT generator: box sheared into a wedge + truncated top.

    Never drawn during training (TRAIN_GENERATORS); exists so the
    unseen-object eval covers a generator FAMILY the trainer never saw,
    not just unseen seeds of familiar families.
    """
    verts, faces, uvs = _box_faces(rng.uniform(0.4, 1.0, size=3))
    shear = rng.uniform(-0.5, 0.5, size=2)
    taper = rng.uniform(0.3, 0.8)
    v = np.asarray(verts)
    zn = (v[:, 2] - v[:, 2].min()) / max(float(np.ptp(v[:, 2])), 1e-9)
    v[:, 0] = v[:, 0] * (1 - (1 - taper) * zn) + shear[0] * zn
    v[:, 1] = v[:, 1] * (1 - (1 - taper) * zn) + shear[1] * zn
    return v, faces, uvs


_GENERATORS = {
    "superquadric": _superquadric,
    "bumpy": _bumpy_sphere,
    "hull": _convex_hull,
    "box": _random_box,
    "prism": _random_prism,
    "wedge": _random_wedge,
}


def random_family_asset(
    seed: int,
    generator: str | None = None,
    diameter: float = FAMILY_DIAMETER,
    tex_size: int = 64,
) -> MeshAsset:
    """Deterministic random textured mesh, rescaled to `diameter`.

    generator=None draws uniformly from TRAIN_GENERATORS (seed-determined);
    pass an explicit name (incl. held-out 'wedge') for eval sets.
    """
    rng = np.random.default_rng(np.uint64(0x5EED_FA11) + np.uint64(seed))
    if generator is None:
        generator = TRAIN_GENERATORS[int(rng.integers(len(TRAIN_GENERATORS)))]
    verts, faces, uvs = _GENERATORS[generator](rng)
    verts = np.asarray(verts, np.float64)
    # random rotation so generator-frame axes leak nothing
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    verts = verts @ rot.T
    d = mesh_diameter(verts.astype(np.float32))
    verts = verts * (diameter / max(float(d), 1e-9))
    verts32 = verts.astype(np.float32)
    return make_mesh_asset(
        f"{generator}_{seed}",
        verts32,
        faces,
        texcoords=uvs,
        vertex_normals=compute_vertex_normals(verts32, faces),
        texture=random_smooth_texture(rng, tex_size),
    )
