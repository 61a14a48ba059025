"""The port's scanned-mesh ingest against the JAX package's.

Everything here is numpy or C++ on both sides, so the bar is equality:
``scanned_blob`` gives the same arrays, ``write_ply`` the same bytes and
texture pixels, decimation and adaptive subdivision the same assets and the
same ``info``; the texture error metrics agree within 1e-6 (numpy sums in
one order on both sides; the bound only leaves room for another BLAS). The
port's C++ parsers and diameters (``native/csrc/mesh.cpp``) are held on the
cases of ``tests/test_native.py`` against the port's Python parsers and the
JAX package's native library, and ``load_mesh`` through them against the
Python path.
"""

import numpy as np
import pytest
from PIL import Image

from foundationpose_cpp_tpu import native as jnative
from foundationpose_cpp_tpu.meshio import mesh_loader as jml
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.meshio.decimate import decimate_vertex_clustering as jdecimate
from foundationpose_cpp_tpu.meshio.subdivide import face_sampling_error as jface_sampling_error
from foundationpose_cpp_tpu.meshio.subdivide import subdivide_adaptive as jsubdivide_adaptive
from foundationpose_cpp_tpu.ops import render_fused as jrf
from foundationpose_cpp_tpu_torch import native as tnative
from foundationpose_cpp_tpu_torch.meshio import mesh_loader as tml
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.meshio import texture_error as tte
from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
from foundationpose_cpp_tpu_torch.meshio.subdivide import (
    face_sampling_error,
    subdivide_adaptive,
)
from foundationpose_cpp_tpu_torch.utils import png

SMALL = dict(n_lat=40, n_lon=40, tex_size=64)  # ~3k faces

FIELDS = ("vertices", "faces", "texcoords", "vertex_normals", "texture", "model_center",
          "orient_bounds", "dimensions")


def assert_assets_equal(got, want):
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.diameter == want.diameter


@pytest.fixture(scope="module")
def small_blobs():
    return tproc.scanned_blob(seed=5, **SMALL), jproc.scanned_blob(seed=5, **SMALL)


@pytest.mark.parametrize("kwargs", [dict(seed=3), dict(seed=5, **SMALL)], ids=["default", "small"])
def test_scanned_blob_equals_jax(kwargs):
    got, want = tproc.scanned_blob(**kwargs), jproc.scanned_blob(**kwargs)
    if "n_lat" not in kwargs:
        assert got.num_faces == 105_340 and got.texture.shape == (512, 512, 3)
    assert_assets_equal(got, want)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("normals, uvs", [(True, True), (False, False)], ids=["full", "bare"])
def test_write_ply_equals_jax(tmp_path, small_blobs, binary, normals, uvs):
    asset = small_blobs[0]
    paths = {}
    for side, write in (("t", tproc.write_ply), ("j", jproc.write_ply)):
        ply, tex = tmp_path / f"{side}.ply", tmp_path / f"{side}_tex.png"
        write(asset, str(ply), str(tex), binary=binary, with_normals=normals, with_uvs=uvs)
        paths[side] = ply, tex
    t_bytes, j_bytes = (paths[s][0].read_bytes() for s in "tj")
    # the headers name their own texture files; everything else is the same
    assert t_bytes.replace(b"t_tex.png", b"j_tex.png") == j_bytes
    np.testing.assert_array_equal(png.read_png(str(paths["t"][1])),
                                  np.asarray(Image.open(paths["j"][1])))


def test_texture_error_metrics_equal_jax(small_blobs):
    tblob, jblob = small_blobs
    tex, uvs, faces = tblob.texture, tblob.texcoords, tblob.faces
    np.testing.assert_allclose(face_sampling_error(tex, uvs, faces),
                               jface_sampling_error(tex, uvs, faces), atol=1e-6, rtol=0)
    for pk, reduce in ((4, "mean"), (4, "max"), (2, "mean")):
        np.testing.assert_allclose(tte.face_patch_error(tex, uvs, faces, pk, reduce=reduce),
                                   jrf.face_patch_error(tex, uvs, faces, pk, reduce=reduce),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(tte.vertex_colors_seam_robust(tex, uvs),
                               jrf.vertex_colors_seam_robust(tex, uvs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tte.face_corner_colors(tex, uvs, faces),
                               jrf.face_corner_colors(tex, uvs, faces), atol=1e-6, rtol=0)


@pytest.mark.parametrize("patch_k", [0, 4], ids=["corner_metric", "patch_metric"])
def test_decimate_and_subdivide_equal_jax(small_blobs, patch_k):
    tblob, jblob = small_blobs
    tdec, jdec = decimate_vertex_clustering(tblob, target_faces=1_500), jdecimate(
        jblob, target_faces=1_500)
    assert tdec.num_faces <= 1_500
    assert_assets_equal(tdec, jdec)
    got, tinfo = subdivide_adaptive(tdec, max_faces=4_096, patch_k=patch_k)
    want, jinfo = jsubdivide_adaptive(jdec, max_faces=4_096, patch_k=patch_k)
    assert tinfo == jinfo and tinfo["rounds"] >= 1
    assert_assets_equal(got, want)


# --- the native parsers and diameters, on tests/test_native.py's cases -----


@pytest.fixture(scope="module")
def jax_native():
    lib = jnative.load_library()
    assert lib is not None, "the JAX package's native library did not build"
    return jnative


def assert_parsed_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for a, b in zip(got[:4], want[:4]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


def _obj_cases(tmp_path):
    cube = tproc.textured_cube()
    obj = tmp_path / "cube.obj"
    tproc.write_obj(cube, str(obj), str(tmp_path / "cube_tex.png"))
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                    "f -4/-4 -3/-3 -2/-2 -1/-1\n")
    partial = tmp_path / "partial.obj"
    partial.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                       "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
                       "f 1//1 2//2 3//3\nf 1 2 4\n")
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd tex.png\n")
    tabbed = tmp_path / "tabbed.obj"
    tabbed.write_text("mtllib\tm.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    return {"cube": obj, "quad": quad, "partial_normals": partial, "tab_mtllib": tabbed}


def test_native_obj_cases(tmp_path, jax_native):
    cases = _obj_cases(tmp_path)
    for name, path in cases.items():
        got = tnative.parse_obj_native(str(path))
        assert got is not None, name
        assert_parsed_equal(got, jax_native.parse_obj_native(str(path)))
        pos, uv, nrm, faces, tex = tml._parse_obj(path)
        np.testing.assert_allclose(got[0], pos, atol=1e-6)
        np.testing.assert_array_equal(got[3], faces)
        assert (got[2] is None) == (nrm is None) and (got[1] is None) == (uv is None), name
        if name in ("cube", "tab_mtllib"):
            assert got[4] and got[4].endswith(("cube_tex.png", "tex.png"))
    quad = tnative.parse_obj_native(str(cases["quad"]))
    assert quad[3].shape == (2, 3) and quad[2] is None
    np.testing.assert_allclose(quad[1], [[0, 0], [1, 0], [1, 1], [0, 1]])
    assert tnative.parse_obj_native(str(cases["partial_normals"]))[2] is None
    d = tmp_path / "dir.obj"
    d.mkdir()
    assert tnative.parse_obj_native(str(d)) is None


def _ply_cases(tmp_path):
    cube = tproc.textured_cube(size=0.1)
    out = {}
    for binary in (True, False):
        p = tmp_path / f"cube_{'bin' if binary else 'ascii'}.ply"
        tproc.write_ply(cube, str(p), str(tmp_path / f"{p.stem}_tex.png"), binary=binary)
        out[p.stem] = p
    bare = tmp_path / "bare.ply"
    tproc.write_ply(cube, str(bare), binary=True, with_normals=False, with_uvs=False)
    out["bare"] = bare
    quad = tmp_path / "quad.ply"
    quad.write_text("ply\nformat ascii 1.0\nelement vertex 4\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "element face 1\nproperty list uchar int vertex_indices\n"
                    "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    out["quad"] = quad
    return out


def test_native_ply_cases(tmp_path, jax_native):
    cases = _ply_cases(tmp_path)
    for name, path in cases.items():
        got = tnative.parse_ply_native(str(path))
        assert got is not None, name
        assert_parsed_equal(got, jax_native.parse_ply_native(str(path)))
        pos, uv, nrm, faces, tex = tml._parse_ply(path)
        np.testing.assert_array_equal(got[0], pos)
        np.testing.assert_array_equal(got[3], faces)
        for a, b in ((got[1], uv), (got[2], nrm)):
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert got[4] == tex, name
    np.testing.assert_array_equal(tnative.parse_ply_native(str(cases["quad"]))[3],
                                  [[0, 1, 2], [0, 2, 3]])


def test_native_ply_rejects_big_endian(tmp_path, jax_native):
    ply = tmp_path / "be.ply"
    ply.write_text("ply\nformat binary_big_endian 1.0\nelement vertex 0\n"
                   "property float x\nproperty float y\nproperty float z\n"
                   "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    assert tnative.parse_ply_native(str(ply)) is None
    assert jax_native.parse_ply_native(str(ply)) is None
    listed = tmp_path / "list_vertex.ply"
    listed.write_text("ply\nformat ascii 1.0\nelement vertex 1\n"
                      "property list uchar float x\nelement face 0\n"
                      "property list uchar int vertex_indices\nend_header\n1 0.5\n")
    assert tnative.parse_ply_native(str(listed)) is None


@pytest.mark.parametrize("n, seed", [(500, 0), (700, 2), (50_000, 1)])
def test_native_diameters(jax_native, n, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [1.0, 0.3, 2.0]).astype(np.float32)
    exact = tnative.diameter_exact_native(pts)
    assert exact == pytest.approx(jax_native.diameter_exact_native(pts), rel=1e-12)
    assert tnative.mesh_diameter_native(pts) == pytest.approx(
        jax_native.mesh_diameter_native(pts), rel=1e-12)
    if n <= 1000:
        diff = pts[:, None, :].astype(np.float64) - pts[None, :, :]
        assert exact == pytest.approx(float(np.sqrt((diff**2).sum(-1).max())), rel=1e-12)
    # the loader's diameter: the hull through the native sweep, as JAX's
    assert tml.mesh_diameter(pts) == pytest.approx(jml.mesh_diameter(pts), rel=1e-12)
    assert tnative.diameter_exact_native(pts[:1]) == 0.0


def test_failed_mesh_library_build_raises_through_the_loader(tmp_path, monkeypatch):
    """A failed build of the mesh library raises with the compiler's output
    out of load_mesh; the loader does not fall back to its Python parsers."""
    from foundationpose_cpp_tpu_torch.ops import cuda_build

    obj = tmp_path / "cube.obj"
    tproc.write_obj(tproc.textured_cube(), str(obj))
    bad = tmp_path / "mesh.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "MESH_SOURCE", bad)
    monkeypatch.setattr(tnative, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for mesh.cpp"):
        tml.load_mesh("cube", str(obj))


@pytest.mark.parametrize("suffix", ["ply", "obj"])
def test_load_mesh_fast_path_equals_python_path(tmp_path, monkeypatch, small_blobs, suffix):
    asset = small_blobs[0]
    path = tmp_path / f"scan.{suffix}"
    if suffix == "ply":
        tproc.write_ply(asset, str(path), str(tmp_path / "scan_tex.png"), binary=True)
    else:
        tproc.write_obj(asset, str(path), str(tmp_path / "scan_tex.png"))
    fast = tml.load_mesh("scan", str(path))
    want = jml.load_mesh("scan", str(path))
    monkeypatch.setattr(tnative, f"parse_{suffix}_native", lambda p: None)
    slow = tml.load_mesh("scan", str(path))
    assert_assets_equal(fast, slow)
    assert_assets_equal(fast, want)
    assert fast.num_faces == asset.num_faces
