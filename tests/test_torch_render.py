"""The port's render branch (plain version, CPU) against the JAX package's
unfused ``render_branch`` (pipeline/renderer.py:227): cube, house and a small
UV sphere, 3 random poses each, crop 32.

Budget: under 1% of pixels off by more than 2e-3 -- the JAX suite's own
budget for pixels on a face edge, where the two sides evaluate the edge
functions in another order (tests/test_render_fused.py:73-88). Background is
exactly zero in both. The port's meshes keep only their real faces, the JAX
package's are padded to a multiple of 128 with a validity mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.config import FoundationPoseConfig
from foundationpose_cpp_tpu.geometry import transforms as jtf
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.ops import rasterize as jras
from foundationpose_cpp_tpu.pipeline import renderer as jren
from foundationpose_cpp_tpu_torch.geometry import transforms as ttf
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.ops import rasterize as tras
from foundationpose_cpp_tpu_torch.ops import render as trender
from foundationpose_cpp_tpu_torch.pipeline import renderer as tren

CFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32)
K = np.array([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]], dtype=np.float32)
IMG = 128
CROP = 32

MESHES = {
    "cube": lambda m: m.textured_cube(size=0.1),
    "house": lambda m: m.textured_house(size=0.1),
    "sphere": lambda m: m.textured_uv_sphere(radius=0.05, n_lat=10, n_lon=14),
}


def _poses(seed=0, n=3):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = [0.01, -0.005, 0.45]
    return poses.astype(np.float32)


def _setup(name):
    jasset = MESHES[name](jproc)
    tasset = MESHES[name](tproc)
    jmesh = jren.MeshConstants.from_asset(jasset)
    tmesh = tren.MeshConstants.from_asset(tasset, device="cpu")
    poses = _poses()
    jp, jK = jnp.asarray(poses), jnp.asarray(K)
    tfs = jtf.compute_crop_window_tf(jp, jK, (CROP, CROP), 1.2, jmesh.diameter)
    bbox = jtf.construct_bbox2d(tfs, CROP, CROP)
    clipm = np.array(jtf.pose_clip_matrix(jp, bbox, jK, IMG, IMG))
    return jmesh, tmesh, poses, clipm


@pytest.mark.parametrize("name", [*sorted(MESHES), "mesh_set"])
def test_render_branch_matches_jax(name):
    """Each mesh on its real faces against the JAX package on its padded
    faces; ``mesh_set``: pose i on mesh i of the three, out of one
    ``MeshSet`` whose face spans are the meshes' real face counts."""
    names = sorted(MESHES) if name == "mesh_set" else [name] * 3
    setups = {n: _setup(n) for n in names}
    for n, (jmesh, tmesh, _, _) in setups.items():
        f = MESHES[n](tproc).num_faces
        assert tmesh.faces.shape[0] == f == int(jmesh.face_valid.sum())
        assert np.array_equal(np.asarray(jmesh.faces)[:f], tmesh.faces.numpy())
    want = {n: np.asarray(jren.render_branch(jmesh, jnp.asarray(p), jnp.asarray(c), CROP, CROP,
                                             CFG))
            for n, (jmesh, _, p, c) in setups.items()}
    want = np.stack([want[n][i] for i, n in enumerate(names)])
    poses = np.stack([setups[n][2][i] for i, n in enumerate(names)])
    clipm = np.stack([setups[n][3][i] for i, n in enumerate(names)])
    meshes = {n: setup[1] for n, setup in setups.items()}
    mesh = meshes[name] if name in MESHES else tren.MeshSet.build(meshes).select(names)
    if name == "mesh_set":
        counts = [meshes[n].faces.shape[0] for n in names]
        assert mesh.table.rows[:, trender.TABLE_COLS.index("face_count")].tolist() == counts
        assert mesh.faces.shape[0] == sum(counts)
    got = tren.render_branch(
        mesh, torch.from_numpy(poses), torch.from_numpy(clipm), CROP, CROP, CFG
    ).numpy()
    assert got.shape == want.shape == (3, CROP, CROP, 6)
    frac_bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert frac_bad < 0.01, f"{frac_bad:.4f} of pixels differ"
    fg_t = np.abs(got).sum(-1) > 0
    fg_j = np.abs(want).sum(-1) > 0
    assert fg_t.mean() > 0.1  # a meaningful amount of object in every crop
    bg = ~(fg_t | fg_j)
    assert (got[bg] == 0).all() and (want[bg] == 0).all()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_kernel_bbox_holds_every_covered_pixel(name):
    """The kernel tests a face only at the pixel centers of its bbox
    (face_pixel_bbox is the plain version of the bbox it builds); every
    pixel a face wins in the plain rasterizer must lie in that face's bbox,
    or the kernel would miss it. The raster on the real faces agrees with
    the JAX package's on its padded faces."""
    jmesh, tmesh, poses, clipm = _setup(name)
    tp, tc = torch.from_numpy(poses), torch.from_numpy(clipm)
    _, bbox, _ = trender.render_prepass(
        tmesh.vertices, tmesh.normals, tmesh.texcoords, tmesh.faces, tp, tc, CROP, CROP,
    )
    clip = ttf.transform_points_homogeneous(tc, tmesh.vertices)
    rast = tras.rasterize(clip, tmesh.faces, CROP, CROP)
    jrast = np.asarray(jras.rasterize(jnp.asarray(clip.numpy()), jmesh.faces, CROP, CROP,
                                      face_valid=jmesh.face_valid))
    agree = rast[..., 3].numpy() == jrast[..., 3]
    assert agree.mean() > 0.995
    np.testing.assert_allclose(rast.numpy()[agree], jrast[agree], rtol=1e-4, atol=1e-4)
    n_idx, ys, xs = torch.nonzero(rast[..., 3] > 0, as_tuple=True)
    fid = rast[n_idx, ys, xs, 3].long() - 1
    b = bbox[n_idx, fid].long()
    assert len(fid) > 0
    assert ((b[:, 0] <= xs) & (xs <= b[:, 1]) & (b[:, 2] <= ys) & (ys <= b[:, 3])).all()
    assert trender.face_pixel_tests(bbox) >= len(fid)  # at least one test a covered pixel


def test_culled_faces_get_empty_bbox():
    """Faces behind the camera (w <= 0) are tested nowhere; the render is
    zero, as the JAX package's on its padded faces."""
    jmesh, tmesh, poses, clipm = _setup("cube")
    poses = poses.copy()
    poses[:, 2, 3] = -0.5  # the whole cube behind the camera
    tfs = ttf.compute_crop_window_tf(torch.from_numpy(poses), torch.from_numpy(K), (CROP, CROP), 1.2, 0.17)
    clip_mat = ttf.pose_clip_matrix(
        torch.from_numpy(poses), ttf.construct_bbox2d(tfs, CROP, CROP), torch.from_numpy(K), IMG, IMG
    )
    _, bbox, _ = trender.render_prepass(
        tmesh.vertices, tmesh.normals, tmesh.texcoords, tmesh.faces, torch.from_numpy(poses),
        clip_mat, CROP, CROP,
    )
    assert (bbox[..., 0] > bbox[..., 1]).all()
    assert trender.face_pixel_tests(bbox) == 0
    out = tren.render_branch(tmesh, torch.from_numpy(poses), clip_mat, CROP, CROP, CFG)
    assert (out == 0).all()
    want = jren.render_branch(jmesh, jnp.asarray(poses), jnp.asarray(clip_mat.numpy()), CROP,
                              CROP, CFG)
    assert not np.asarray(want).any()

