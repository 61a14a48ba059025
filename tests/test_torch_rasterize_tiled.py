"""The port's full-frame rasterizer (plain version, CPU) against the JAX
package's Pallas rasterizer in interpret mode and its XLA rasterizer.

Against ``rasterize_tpu(..., interpret=True)`` at the scenes of
tests/test_rasterize_pallas.py, with its tolerance: face ids agree on more
than 99.5% of pixels (the TPU kernel breaks depth ties by sorted position,
the port by the lowest face id) and rtol = atol = 1e-4 where they agree.
Heights that are not a multiple of 16, which the Pallas kernel refuses, go
against the JAX XLA rasterizer with the same tolerance. The CUDA kernel's
bbox rule (a face is tested only at the pixel centers inside its bbox, of
which face_pixel_bbox is the plain version) is checked by rasterizing with
that rule in plain tensor ops: the same raster, exactly. The port's meshes
keep only their real faces; the JAX package pads its faces to a multiple of
128 with a validity mask, and the port on the real faces must agree with it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.ops import rasterize as jras
from foundationpose_cpp_tpu.ops.rasterize_pallas import rasterize_tpu
from foundationpose_cpp_tpu.pipeline import renderer as jren
from foundationpose_cpp_tpu_torch.geometry import transforms as ttf
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.ops import rasterize as tras
from foundationpose_cpp_tpu_torch.ops import rasterize_tiled as rt
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic as tsyn
from tests.test_rasterize import _random_scene


def _port(clip, faces, h, w):
    before = rt.rasterize_tiled.launches
    out = rt.rasterize_tiled(torch.from_numpy(clip), torch.from_numpy(faces), h, w).numpy()
    assert rt.rasterize_tiled.launches == before  # no kernel on the CPU
    return out


def _agree(got, want):
    assert got.shape == want.shape
    agree = got[..., 3] == want[..., 3]
    assert agree.mean() > 0.995, f"id agreement {agree.mean()}"
    np.testing.assert_allclose(got[agree], want[agree], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,v,f,seed,h,w,kw", [
    (2, 12, 16, 0, 16, 128, dict(chunk=8, tile_rows=8)),
    (1, 32, 100, 1, 32, 128, dict(chunk=16, tile_rows=8)),
])
def test_matches_pallas_interpret(n, v, f, seed, h, w, kw):
    clip, faces = _random_scene(n=n, v=v, f=f, seed=seed)
    want = np.asarray(rasterize_tpu(jnp.asarray(clip), jnp.asarray(faces), h, w,
                                    interpret=True, **kw))
    _agree(_port(clip, faces, h, w), want)
    assert (want[..., 3] > 0).mean() > 0.05


def test_face_valid_mask_respected():
    """The JAX package with its last four faces masked, as its padding masks
    them, against the port on the faces before them; unmasked, some of the
    four win pixels."""
    clip, faces = _random_scene(n=1, seed=3)
    f = faces.shape[0] - 4
    valid = np.arange(faces.shape[0]) < f
    want = np.asarray(rasterize_tpu(jnp.asarray(clip), jnp.asarray(faces), 16, 128,
                                    face_valid=jnp.asarray(valid), interpret=True,
                                    chunk=8, tile_rows=8))
    _agree(_port(clip, faces[:f], 16, 128), want)
    assert not (want[..., 3] > f).any()
    assert (_port(clip, faces, 16, 128)[..., 3] > f).any()


def test_background_zero_and_behind_camera_cull():
    clip, faces = _random_scene(n=1, seed=2)
    clip[0, faces[0, 0], 3] = -0.5
    want = np.asarray(rasterize_tpu(jnp.asarray(clip), jnp.asarray(faces), 16, 128,
                                    interpret=True, chunk=8, tile_rows=8))
    got = _port(clip, faces, 16, 128)
    _agree(got, want)
    behind = {k + 1 for k in range(len(faces)) if (clip[0, faces[k], 3] <= 0).any()}
    assert behind and not np.isin(got[..., 3], list(behind)).any()
    bg = got[..., 3] == 0
    assert (got[bg] == 0).all()


def _jax_faces(asset):
    """The JAX package's faces of ``asset``, padded, and their validity."""
    jmesh = jren.MeshConstants.from_asset(asset, texture_patch_k=0)
    return np.asarray(jmesh.faces), np.asarray(jmesh.face_valid)


def test_realistic_object_matches_pallas_interpret():
    """A posed sphere through the clip-matrix path (the scene of
    tests/test_rasterize_pallas.py): the port on its real faces against
    the JAX package on its padded faces."""
    sphere = tproc.textured_uv_sphere(radius=0.05, n_lat=8, n_lon=12)
    mesh = MeshConstants.from_asset(sphere, device="cpu")
    K = torch.tensor([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]])
    poses = torch.from_numpy(tsyn.default_pose(0.4)[None])
    tfs = ttf.compute_crop_window_tf(poses, K, (32, 128), 1.2, mesh.diameter)
    clipm = ttf.pose_clip_matrix(poses, ttf.construct_bbox2d(tfs, 32, 128), K, 128, 128)
    clip = ttf.transform_points_homogeneous(clipm, mesh.vertices).numpy()
    faces = mesh.faces.numpy()
    jfaces, jvalid = _jax_faces(jproc.textured_uv_sphere(radius=0.05, n_lat=8, n_lon=12))
    assert not jvalid.all() and np.array_equal(jfaces[jvalid], faces)  # padding only in JAX
    want = np.asarray(rasterize_tpu(jnp.asarray(clip), jnp.asarray(jfaces), 32, 128,
                                    face_valid=jnp.asarray(jvalid), interpret=True,
                                    chunk=32, tile_rows=8))
    _agree(_port(clip, faces, 32, 128), want)
    assert (want[..., 3] > 0).mean() > 0.05


@pytest.mark.parametrize("h,w", [(20, 33), (37, 128)])
def test_height_not_a_multiple_of_16(h, w):
    clip, faces = _random_scene(n=2, v=16, f=24, seed=4)
    want = np.asarray(jras.rasterize(jnp.asarray(clip), jnp.asarray(faces), h, w))
    _agree(_port(clip, faces, h, w), want)


def _bbox_staged_raster(clip, faces, h, w):
    """The kernel's rule in plain ops: a face covers a pixel only inside its
    bbox (pixels outside it are never tested against the face)."""
    coeffs, bbox = rt.rasterize_prepass(clip, faces, h, w)
    n, f = bbox.shape[:2]
    fxs, fys = tras.pixel_basis(h, w)
    fx, fy = fxs.repeat(h), fys.repeat_interleave(w)
    px, py = torch.arange(w).repeat(h), torch.arange(h).repeat_interleave(w)
    c = coeffs.reshape(n, f, 5, 3)
    planes = [tras._plane(c[:, :, k], fx, fy) for k in range(5)]
    a0, a1, a2 = planes[:3]
    covered = ((a0 >= 0) & (a1 >= 0) & (a2 >= 0)) | ((a0 <= 0) & (a1 <= 0) & (a2 <= 0))
    covered &= (a0 + a1 + a2) != 0.0
    b = bbox.long()[..., None]
    covered &= (b[:, :, 0] <= px) & (px <= b[:, :, 1]) & (b[:, :, 2] <= py) & (py <= b[:, :, 3])
    zw = planes[3] / planes[4]
    covered &= (zw >= -1.0) & (zw <= 1.0)
    zw = torch.where(covered, zw, torch.full_like(zw, float("inf")))
    best_zw, best = torch.min(zw, dim=1)
    ids = torch.where(torch.isfinite(best_zw), best + 1, torch.zeros_like(best))
    return ids.reshape(n, h, w).float()


@pytest.mark.parametrize("name,h,w", [("house", 120, 160), ("sphere", 72, 96), ("cube", 45, 61)])
def test_kernel_staging_rule_gives_the_same_raster(name, h, w):
    """The staged raster equals the plain one exactly, and the plain one on
    the real faces agrees with the JAX package's on its padded faces."""
    make = {"house": lambda m: m.textured_house(),
            "sphere": lambda m: m.textured_uv_sphere(radius=0.05, n_lat=12, n_lon=16),
            "cube": lambda m: m.textured_cube(size=0.1)}[name]
    mesh = MeshConstants.from_asset(make(tproc), device="cpu")
    K = torch.tensor([[150.0 * w / 160, 0, w / 2], [0, 150.0 * h / 120, h / 2], [0, 0, 1]])
    poses = torch.from_numpy(np.stack([tsyn.default_pose(0.35), tsyn.default_pose(0.25)]))
    poses[1, 0, 3] += 0.05  # partly out of the frame
    bbox2d = torch.tensor([[0.0, 0.0, float(w), float(h)]]).expand(2, 4)
    clip = ttf.transform_points_homogeneous(ttf.pose_clip_matrix(poses, bbox2d, K, h, w),
                                            mesh.vertices)
    want = tras.rasterize(clip, mesh.faces, h, w)
    got = _bbox_staged_raster(clip, mesh.faces, h, w)
    assert (want[..., 3] > 0).float().mean() > 0.05
    torch.testing.assert_close(got, want[..., 3], rtol=0, atol=0)
    jfaces, jvalid = _jax_faces(make(jproc))
    assert np.array_equal(jfaces[jvalid], mesh.faces.numpy())
    _agree(want.numpy(), np.asarray(jras.rasterize(jnp.asarray(clip.numpy()), jnp.asarray(jfaces),
                                                   h, w, face_valid=jnp.asarray(jvalid))))


def test_kernel_library_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """rasterize.cu and render.cu include csrc/raster_tile.cuh: an edited
    header must give both libraries a new name, so no stale build loads."""
    import shutil

    from foundationpose_cpp_tpu_torch.ops import cuda_build

    assert "rasterize" in cuda_build.KERNEL_SOURCES
    for src in cuda_build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = {n: cuda_build.library_path(n) for n in ("rasterize", "render")}
    header = tmp_path / "raster_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in before}
    assert after["rasterize"] != before["rasterize"] and after["render"] != before["render"]
