"""``rasterize_scatter_plain``, the CUDA raster kernels' algorithm walked in
PyTorch (faces scattered over their own bboxes into a depth buffer of 64-bit
keys, region by region), on the CPU.

Against the port's plain rasterizer ``ops.rasterize.rasterize`` the face ids
must be equal and the values within 1e-6: on the CPU both sides evaluate the
same operations in the same order (``edge_coefficients_kernel_order`` pins
that, bit for bit). Against the JAX package the tolerances are those of
tests/test_torch_rasterize_tiled.py (ids agree on more than 99.5% of pixels,
rtol = atol = 1e-4 where they agree) and of tests/test_torch_render.py
(under 1% of pixels off by more than 2e-3). The port's meshes keep only
their real faces; against the JAX package's rasterizer they go on its padded
faces with its validity mask.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.config import FoundationPoseConfig
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.ops import rasterize as jras
from foundationpose_cpp_tpu.ops.rasterize_pallas import rasterize_tpu
from foundationpose_cpp_tpu.pipeline import renderer as jren
from foundationpose_cpp_tpu_torch.geometry import transforms as ttf
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.ops import rasterize as tras
from foundationpose_cpp_tpu_torch.ops import rasterize_tiled as rt
from foundationpose_cpp_tpu_torch.ops import render as trender
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic as tsyn
from tests.test_rasterize import _random_scene
from tests.test_torch_render import CFG, CROP, _setup

MESHES = {
    "cube": lambda m: m.textured_cube(size=0.1),
    "house": lambda m: m.textured_house(),
    "sphere": lambda m: m.textured_uv_sphere(radius=0.05, n_lat=12, n_lon=16),
}


def _same_raster(got: torch.Tensor, want: torch.Tensor) -> None:
    """Ids equal, values within 1e-6."""
    assert got.shape == want.shape
    torch.testing.assert_close(got[..., 3], want[..., 3], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _mesh_clip(name, h, w):
    """Two views of a mesh, the second partly out of the frame."""
    mesh = MeshConstants.from_asset(MESHES[name](tproc), device="cpu")
    K = torch.tensor([[150.0 * w / 160, 0, w / 2], [0, 150.0 * h / 120, h / 2], [0, 0, 1]])
    poses = torch.from_numpy(np.stack([tsyn.default_pose(0.35), tsyn.default_pose(0.25)]))
    poses[1, 0, 3] += 0.05
    bbox2d = torch.tensor([[0.0, 0.0, float(w), float(h)]]).expand(2, 4)
    clip = ttf.transform_points_homogeneous(ttf.pose_clip_matrix(poses, bbox2d, K, h, w),
                                            mesh.vertices)
    return clip, mesh.faces


@pytest.mark.parametrize("name,h,w,region", [
    ("cube", 45, 61, (16, 24)), ("house", 120, 160, (64, 64)), ("sphere", 72, 96, (40, 40)),
    ("house", 37, 53, (64, 64)),
])
def test_scatter_matches_plain_rasterizer_on_meshes(name, h, w, region):
    """Large faces (cube, house) and small ones (sphere); h and w that are
    no multiple of the region, and a region larger than the image. The JAX
    package's rasterizer on its padded faces agrees."""
    clip, faces = _mesh_clip(name, h, w)
    want = tras.rasterize(clip, faces, h, w)
    got = rt.rasterize_scatter_plain(clip, faces, h, w, region=region)
    assert (want[..., 3] > 0).float().mean() > 0.05
    _same_raster(got, want)
    jmesh = jren.MeshConstants.from_asset(MESHES[name](jproc), texture_patch_k=0)
    valid = np.asarray(jmesh.face_valid)
    assert np.array_equal(np.asarray(jmesh.faces)[valid], faces.numpy())
    _agree_with_jax(got.numpy(), np.asarray(jras.rasterize(
        jnp.asarray(clip.numpy()), jmesh.faces, h, w, face_valid=jmesh.face_valid)))


@pytest.mark.parametrize("seed,h,w,region", [(0, 16, 16, (64, 64)), (1, 33, 47, (16, 16)),
                                             (2, 64, 64, (32, 32)), (3, 50, 20, (7, 11))])
def test_scatter_random_soup_with_planted_ties(seed, h, w, region):
    """Random triangles with every face of the first half planted again at
    the end (same corners, so the same z/w at every pixel): the copy must
    never win, and the raster must equal the plain rasterizer's."""
    clip, faces = _random_scene(n=2, v=20, f=30, seed=seed)
    faces = np.concatenate([faces, faces[:15]], axis=0)
    clip_t, faces_t = torch.from_numpy(clip), torch.from_numpy(faces)
    want = tras.rasterize(clip_t, faces_t, h, w)
    got = rt.rasterize_scatter_plain(clip_t, faces_t, h, w, region=region)
    _same_raster(got, want)
    assert (got[..., 3] > 0).float().mean() > 0.05
    assert not (got[..., 3] > 30).any()  # ids 31..45 are the planted copies


def test_scatter_culls_faces_behind_the_camera_and_masked_faces():
    """Faces with a corner behind the camera never win; the port on the first
    21 faces agrees with the JAX package on all 24 with the last three
    masked, as its padding masks them (unmasked, the last one wins pixels)."""
    clip, faces = _random_scene(n=1, v=16, f=24, seed=5)
    clip[0, faces[:6, 0], 3] = -0.5
    f = 21
    clip_t, faces_t = torch.from_numpy(clip), torch.from_numpy(faces[:f])
    want = tras.rasterize(clip_t, faces_t, 32, 40)
    got = rt.rasterize_scatter_plain(clip_t, faces_t, 32, 40, region=(16, 16))
    _same_raster(got, want)
    masked = jras.rasterize(jnp.asarray(clip), jnp.asarray(faces), 32, 40,
                            face_valid=jnp.asarray(np.arange(24) < f))
    _agree_with_jax(got.numpy(), np.asarray(masked))
    assert (tras.rasterize(clip_t, torch.from_numpy(faces), 32, 40)[..., 3] > f).any()
    behind = [k + 1 for k in range(f) if (clip[0, faces[k], 3] <= 0).any()]
    assert len(behind) >= 6 and not np.isin(got[..., 3].numpy(), behind).any()
    assert (got[..., 3] > 0).any()


def test_scatter_every_face_culled_gives_zeros():
    clip, faces = _random_scene(n=2, seed=6)
    clip[..., 3] = -np.abs(clip[..., 3])
    got = rt.rasterize_scatter_plain(torch.from_numpy(clip), torch.from_numpy(faces), 20, 30,
                                     region=(16, 16))
    assert got.shape == (2, 20, 30, 4) and (got == 0).all()
    # the JAX package with every face masked, and the port on its padding
    # rows (0, 0, 0) alone, unmasked: degenerate, they win no pixel
    clip2, _ = _random_scene(n=2, seed=6)
    none_valid = jnp.zeros((faces.shape[0],), dtype=bool)
    assert not np.asarray(jras.rasterize(jnp.asarray(clip2), jnp.asarray(faces), 20, 30,
                                         face_valid=none_valid)).any()
    pad_rows = torch.zeros((8, 3), dtype=torch.int32)
    got = rt.rasterize_scatter_plain(torch.from_numpy(clip2), pad_rows, 20, 30)
    assert (got == 0).all()


def test_negative_zero_depth_ties_with_positive_zero():
    """Two copies of one face whose z/w is +0.0 for the first and -0.0 for
    the second over part of the image: equal as floats, so the lower id
    wins everywhere; as raw bits -0.0 would sort below +0.0."""
    clip = torch.tensor([[[-2.0, -2.0, 0.0, 1.0], [2.0, -2.0, 0.0, 1.0], [0.0, 2.5, 0.0, 1.0]]])
    faces = torch.tensor([[0, 1, 2], [0, 1, 2]], dtype=torch.int32)
    coeffs = rt.edge_coefficients_kernel_order(clip, faces).clone()
    coeffs[0, 0, 9:12] = torch.tensor([0.0, 0.0, 0.0])
    coeffs[0, 1, 9:12] = torch.tensor([0.0, 0.0, -0.0])
    fx, fy = tras.pixel_basis(8, 8)
    zw1 = (coeffs[0, 1, 9] * fx[None, :] + coeffs[0, 1, 10] * fy[:, None] + coeffs[0, 1, 11])
    assert torch.signbit(zw1).any() and (zw1 == 0).all()  # the case is really there
    got = rt.rasterize_scatter_plain(clip, faces, 8, 8, coeffs=coeffs, region=(4, 4))
    assert (got[..., 3] == 1.0).sum() > 30 and not (got[..., 3] == 2.0).any()
    assert (got[..., 2] == 0).all()
    assert torch.equal(rt.depth_keys(torch.tensor([-0.0]), torch.tensor([7])),
                       rt.depth_keys(torch.tensor([0.0]), torch.tensor([7])))


def _depth_samples(kind):
    if kind == "grid":
        return torch.linspace(-1.0, 1.0, 20001)
    if kind == "near_zero":
        tiny = torch.tensor([1e-45, 1e-40, 1.1754944e-38, 1e-30, 1e-10])
        return torch.cat([-tiny, tiny, torch.tensor([0.0, -0.0, 1.0, -1.0])])
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 0x3F800000, size=20000, dtype=np.int64).astype(np.int32)
    mag = torch.from_numpy(bits).view(torch.float32)  # every f32 in [0, 1)
    return torch.cat([mag, -mag])


@pytest.mark.parametrize("kind", ["grid", "near_zero", "random_bits"])
def test_depth_keys_order_as_the_floats(kind):
    zw = _depth_samples(kind)
    order = torch.argsort(zw, stable=True)
    zw = zw[order]
    ids = torch.full_like(zw, 3, dtype=torch.int64)
    keys = rt.depth_keys(zw, ids)
    step_f, step_k = zw[1:] - zw[:-1], keys[1:] - keys[:-1]
    assert (step_k >= 0).all()
    assert ((step_f > 0) == (step_k > 0)).all()  # strictly where the floats differ
    assert (keys < rt.EMPTY_KEY).all()
    back = rt.key_depth(keys)
    assert torch.equal(back, zw + 0.0) and (keys & 0xFFFFFFFF == 3).all()
    # on equal depth the lower id has the lower key
    assert (rt.depth_keys(zw, ids - 1) < keys).all()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_kernel_order_coefficients_equal_edge_coefficients(name):
    """The kernel builds each cross product component as one rounded product
    and one fused multiply-add, which is what torch.linalg.cross computes:
    bit for bit the coefficients of edge_coefficients."""
    clip, faces = _mesh_clip(name, 60, 80)
    want, _ = tras.edge_coefficients(clip, faces)
    got = rt.edge_coefficients_kernel_order(clip, faces)
    assert torch.equal(got, want.reshape(got.shape))


def test_handed_in_coefficients_take_the_built_ones_place():
    clip, faces = _mesh_clip("house", 60, 80)
    coeffs, _ = rt.rasterize_prepass(clip, faces, 60, 80)
    want = tras.rasterize(clip, faces, 60, 80)
    got = rt.rasterize_scatter_plain(clip, faces, 60, 80, coeffs=coeffs)
    _same_raster(got, want)
    flipped = coeffs.clone()
    flipped[..., 9:12] = -flipped[..., 9:12]  # mirror every depth: another winner order
    other = rt.rasterize_scatter_plain(clip, faces, 60, 80, coeffs=flipped)
    assert (other[..., 3] != want[..., 3]).any()


def test_face_pixel_tests_counts_the_scatter_walk():
    """The count chip_smoke prints beside the tests the data needs: the sum
    of the live bboxes' areas."""
    clip, faces = _mesh_clip("sphere", 48, 64)
    _, bbox = rt.rasterize_prepass(clip, faces, 48, 64)
    want = 0
    for x0, x1, y0, y1 in bbox.reshape(-1, 4).tolist():
        if x0 <= x1 and y0 <= y1:
            want += (x1 - x0 + 1) * (y1 - y0 + 1)
    assert trender.face_pixel_tests(bbox) == want > 0


def _agree_with_jax(got, want):
    assert got.shape == want.shape
    agree = got[..., 3] == want[..., 3]
    assert agree.mean() > 0.995, f"id agreement {agree.mean()}"
    np.testing.assert_allclose(got[agree], want[agree], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,v,f,seed,h,w,kw", [
    (2, 12, 16, 0, 16, 128, dict(chunk=8, tile_rows=8)),
    (1, 32, 100, 1, 32, 128, dict(chunk=16, tile_rows=8)),
])
def test_scatter_matches_pallas_interpret(n, v, f, seed, h, w, kw):
    clip, faces = _random_scene(n=n, v=v, f=f, seed=seed)
    want = np.asarray(rasterize_tpu(jnp.asarray(clip), jnp.asarray(faces), h, w,
                                    interpret=True, **kw))
    got = rt.rasterize_scatter_plain(torch.from_numpy(clip), torch.from_numpy(faces), h, w,
                                     region=(16, 48)).numpy()
    _agree_with_jax(got, want)
    assert (want[..., 3] > 0).mean() > 0.05


@pytest.mark.parametrize("h,w", [(20, 33), (37, 128)])
def test_scatter_matches_jax_rasterizer(h, w):
    clip, faces = _random_scene(n=2, v=16, f=24, seed=4)
    want = np.asarray(jras.rasterize(jnp.asarray(clip), jnp.asarray(faces), h, w))
    got = rt.rasterize_scatter_plain(torch.from_numpy(clip), torch.from_numpy(faces), h, w,
                                     region=(16, 16)).numpy()
    _agree_with_jax(got, want)


@pytest.mark.parametrize("name", ["cube", "house", "sphere"])
def test_render_on_the_scatter_rasterizer_matches_jax(name):
    """render_views_plain built on the scatter version against the JAX
    package's unfused render_branch, the scenes of tests/test_torch_render.py."""
    jmesh, tmesh, poses, clipm = _setup(name)
    want = np.asarray(jren.render_branch(jmesh, jnp.asarray(poses), jnp.asarray(clipm),
                                         CROP, CROP, FoundationPoseConfig(
                                             crop_window_h=CROP, crop_window_w=CROP)))
    scatter = functools.partial(rt.rasterize_scatter_plain, region=(20, 12))
    got = trender.render_views_plain(
        tmesh.vertices, tmesh.normals, tmesh.texcoords, tmesh.faces, tmesh.texture,
        torch.from_numpy(poses), torch.from_numpy(clipm), CROP, CROP,
        tmesh.diameter, CFG.min_depth, CFG.max_depth, CFG.w_ambient, CFG.w_diffuse,
        rasterizer=scatter,
    ).numpy()
    assert got.shape == want.shape == (3, CROP, CROP, 6)
    frac_bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert frac_bad < 0.01, f"{frac_bad:.4f} of pixels differ"
    assert (np.abs(got).sum(-1) > 0).mean() > 0.1


def test_vertex_prepass_plain_holds_clip_xyz_and_lambert():
    _, tmesh, poses, clipm = _setup("house")
    tp, tc = torch.from_numpy(poses), torch.from_numpy(clipm)
    verts = trender.vertex_prepass_plain(tmesh.vertices, tmesh.normals, tp, tc)
    attrs = trender.vertex_attributes(tp, tmesh.vertices, tmesh.normals, tmesh.texcoords)
    assert verts.shape == (3, tmesh.vertices.shape[0], 8) and verts.is_contiguous()
    assert torch.equal(verts[..., :4], ttf.transform_points_homogeneous(tc, tmesh.vertices))
    assert torch.equal(verts[..., 4:8], attrs[..., :4])


def test_mesh_constants_default_to_the_card():
    """from_asset(asset) means the card, as every entry point of the port:
    without one it raises and never falls back to the CPU."""
    asset = tproc.textured_cube(size=0.1)
    if torch.cuda.is_available():
        assert MeshConstants.from_asset(asset).vertices.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshConstants.from_asset(asset)
    assert MeshConstants.from_asset(asset, device="cpu").vertices.device.type == "cpu"


def test_kernel_launchers_refuse_cpu_tensors():
    """The launch-alone entry points are for the card: a CPU tensor raises
    (only the wrappers route CPU tensors to the plain versions)."""
    clip, faces = _mesh_clip("cube", 16, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        rt.launch_rasterize(clip, faces, 16, 16)
    before = rt.rasterize_tiled.launches
    out = rt.rasterize_tiled(clip, faces, 16, 16)
    assert rt.rasterize_tiled.launches == before and out.shape == (2, 16, 16, 4)
