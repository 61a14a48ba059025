"""``track_batch`` over distinct meshes, one name a pose, on the CPU.

Three meshes of different face counts and diameters (the 12-face cube and
two ``meshio/family.py`` meshes) and seeded narrow f32 nets, at 120x160,
crop 32. The mixed call is held against per-mesh ``track_batch`` calls and
against the plain reference's per-object refinement
(``benchmark/reference/scene_multi.py``); its pieces (the plain render over
a mesh table, the geometry on per-pose diameters) against their one-mesh
versions; its program, catalog build and ``names`` span with the stand-in
of tests/graph_standin.py. No JAX is imported.
"""

import dataclasses

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import FoundationPoseConfig, create_foundationpose_model
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import family, procedural
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.ops import pointcloud, render
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import CATALOG, FoundationPose
from foundationpose_cpp_tpu_torch.pipeline.renderer import (
    MeshSet,
    render_and_transform,
    render_branch,
)
from foundationpose_cpp_tpu_torch.utils import profiling

from .graph_standin import FakeGraphs, graphs, one_thread  # noqa: F401  (a fixture)

H, W = 120, 160
K = np.array([[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]], np.float32)
CFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False,
                           n_views=12, inplane_step_deg=120)
NET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, ffn_dim=64,
                         crop_hw=32)
NAMES = ("cube", "bumpy", "quad")
ORDER = ("bumpy", "cube", "quad", "cube", "bumpy")  # pose i on mesh ORDER[i]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The three meshes written as binary PLY + PNG (read by the port's
    loader and by the reference's), and the nets as npz checkpoints."""
    d = tmp_path_factory.mktemp("mixed")
    meshes = {
        "cube": procedural.textured_cube("cube", size=0.08),
        "bumpy": family.random_family_asset(1, "bumpy", diameter=0.15),
        "quad": family.random_family_asset(2, "superquadric", diameter=0.09),
    }
    paths = {}
    for name, asset in meshes.items():
        paths[name] = str(d / f"{name}.ply")
        procedural.write_ply(asset, paths[name], str(d / f"{name}.png"), binary=True)
    scorer = dataclasses.replace(NET, cross_attention=True)
    convert_jax.save_npz(networks.init_net("refiner", NET, 0).state_dict(), str(d / "r.npz"))
    convert_jax.save_npz(networks.init_net("scorer", scorer, 1).state_dict(), str(d / "s.npz"))
    return paths, str(d / "r.npz"), str(d / "s.npz")


def _model(files) -> FoundationPose:
    paths, refiner, scorer = files
    assets = [load_mesh(name, paths[name]) for name in NAMES]
    return create_foundationpose_model(refiner, scorer, assets, K, H, W, config=CFG,
                                       device="cpu")


@pytest.fixture(scope="module")
def model(files):
    return _model(files)


def _poses(names=ORDER, seed=3) -> np.ndarray:
    """Poses on a row 1 m away, each seeded rotation of its own."""
    from benchmark import scene

    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(names), 1, 1))
    for i in range(len(names)):
        poses[i, :3, :3] = scene.random_rotation(rng)
        poses[i, :3, 3] = [(i - (len(names) - 1) / 2) * 0.17, 0.02 * (i % 2), 1.0]
    return poses


@pytest.fixture(scope="module")
def frame(files):
    """A frame of the objects of ORDER at _poses() (the reference's
    multi-object renderer), and hypotheses 4 mm and a little rotation off."""
    from benchmark.reference import assets, pipeline, scene_multi

    paths = files[0]
    gts = _poses()
    meshes = [assets.load_mesh(paths[n], "cpu") for n in ORDER]
    rgb, depth, _ = scene_multi.render_frame(meshes, gts, K, H, W, pipeline.CFG)
    hyp = gts.copy()
    hyp[:, :3, 3] += 0.004
    c, s = np.cos(0.03), np.sin(0.03)
    hyp[:, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) @ hyp[:, :3, :3]
    assert (depth > 0).mean() > 0.03
    return rgb, depth, hyp


def test_mixed_track_batch_equals_per_mesh_calls(model, frame):
    """The crops are those of each mesh's own call, bit for bit; the poses
    agree within rtol 1e-5, atol 1e-6, not bit for bit, because the CPU's
    convolutions and matrix products give results that depend on the batch
    (5 poses at once against 2, 2 and 1), by up to ~4e-7 in the refiner's
    outputs."""
    rgb, depth, hyp = frame
    got = model.track_batch(rgb, depth, hyp, list(ORDER))
    want = np.zeros_like(got)
    for name in NAMES:
        idx = [i for i, n in enumerate(ORDER) if n == name]
        want[idx] = model.track_batch(rgb, depth, hyp[idx], name)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got - hyp).max() > 1e-4  # the refiner moved them

    poses = torch.as_tensor(hyp)
    rgb_t, depth_t = torch.as_tensor(rgb), torch.as_tensor(depth)
    xyz = depth_ops.depth_to_xyz(depth_t, model._K, CFG.min_depth)
    mixed = render_and_transform(model._mesh_catalog().select(ORDER), poses, rgb_t, xyz, model._K,
                                 CFG.refine_crop_ratio, CFG)
    for name in NAMES:
        idx = [i for i, n in enumerate(ORDER) if n == name]
        alone = render_and_transform(model._meshes[name], poses[idx], rgb_t, xyz, model._K,
                                     CFG.refine_crop_ratio, CFG)
        for a, b in zip(mixed, alone):
            assert torch.equal(a[idx], b)


def test_mixed_track_batch_matches_the_plain_reference(files, model, frame):
    """Against each object refined alone on its own mesh by the plain float32
    reference, at the tolerance the reference's tests hold Track to."""
    from benchmark.reference import assets, scene_multi

    paths, refiner, scorer = files
    rgb, depth, hyp = frame
    ref = scene_multi.build([assets.load_mesh(paths[n], "cpu") for n in ORDER],
                            assets.read_params(refiner, "cpu"), assets.read_params(scorer, "cpu"),
                            torch.as_tensor(K), 32)
    got = model.track_batch(rgb, depth, hyp, ORDER)
    assert np.abs(got - ref.track(rgb, depth, hyp)).max() < 1e-5


def test_a_one_name_list_equals_the_one_name_call(model, frame):
    rgb, depth, hyp = frame
    one = model.track_batch(rgb, depth, hyp, "bumpy")
    assert np.array_equal(model.track_batch(rgb, depth, hyp, ["bumpy"] * len(hyp)), one)
    assert np.array_equal(model.track_batch(rgb, depth, hyp[:1], ["bumpy"]),
                          model.track_batch(rgb, depth, hyp[:1], "bumpy"))


def test_plain_render_over_a_mesh_table_equals_per_mesh_renders(model):
    poses = torch.as_tensor(_poses())
    mesh_set = MeshSet.build(model._meshes).select(ORDER)
    assert mesh_set.table.rows.shape == (len(ORDER), len(render.TABLE_COLS))
    assert mesh_set.diameter.dtype == torch.float32
    Kt = torch.as_tensor(K)
    tfs = transforms.compute_crop_window_tf(poses, Kt, (24, 28), 1.2, 0.2)
    clip = transforms.pose_clip_matrix(poses, transforms.construct_bbox2d(tfs, 24, 28), Kt, H, W,
                                       CFG.znear, CFG.zfar)
    got = render_branch(mesh_set, poses, clip, 24, 28, CFG)
    assert got.shape == (len(ORDER), 24, 28, 6)
    for name in NAMES:
        idx = [i for i, n in enumerate(ORDER) if n == name]
        want = render_branch(model._meshes[name], poses[idx], clip[idx], 24, 28, CFG)
        assert (want[..., 0] > 0).any()
        assert torch.equal(got[idx], want)


@pytest.mark.parametrize("fn", ["crop_window", "threshold", "refine_delta"])
def test_float_and_tensor_diameters_agree(fn):
    """An (N,) f32 diameter gives, bit for bit, what each pose's number
    gives: its halves (the threshold's scale, the update's) are the f32 a
    number's half rounds to, and the crop window's radius, an f32 product
    an ulp or two from the number's, moves no bound to another whole pixel
    here."""
    rng = np.random.default_rng(4)
    poses = torch.as_tensor(_poses(seed=5))
    n = poses.shape[0]
    diameters = [0.1021, 0.2014, 0.13856406150836198, 0.0899999997729, 0.15000000299906]
    trans = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    rot = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    xyz = torch.as_tensor(rng.uniform(-0.3, 1.3, size=(n, 6, 7, 3)), dtype=torch.float32)
    Kt = torch.as_tensor(K)

    def run(d, rows=slice(None)):
        if fn == "crop_window":
            return transforms.compute_crop_window_tf(poses[rows], Kt, (32, 32), 1.2, d)
        if fn == "threshold":
            half = d / 2.0
            return pointcloud.threshold_and_downscale_pointcloud(xyz[rows], poses[rows], half,
                                                                 0.001, 4.0)
        return transforms.apply_refine_delta(poses[rows], trans[rows], rot[rows], d)

    want = torch.cat([run(d, slice(i, i + 1)) for i, d in enumerate(diameters)])
    assert torch.equal(run(torch.tensor(diameters, dtype=torch.float32)), want)


def test_names_that_do_not_fit_raise_before_any_upload(model, frame, monkeypatch):
    rgb, depth, hyp = frame

    def no_upload(*args):
        raise AssertionError("uploaded")

    monkeypatch.setattr(FoundationPose, "_frame_args", no_upload)
    monkeypatch.setattr(FoundationPose, "_upload", no_upload)
    builds = model.meshset_builds
    for names, match in ((["cube", "bumpy", "mug", "quad", "cube"], "unknown"),
                         (["cube", "bumpy"], "2 target names for 5 poses"),
                         (list(ORDER) + ["cube"], "6 target names")):
        with pytest.raises(ValueError, match=match):
            model.track_batch(rgb, depth, hyp, names)
    assert model.meshset_builds == builds


def test_one_program_and_one_mesh_set_per_names_tuple(files, frame):
    """Every tuple of names of one length shares one program (keyed by N,
    not by the names) and the one catalog, built on the first call: a new
    tuple captures nothing and builds nothing, and each call returns its
    own tuple's poses."""
    rgb, depth, hyp = frame
    model = _model(files)
    recorded = profiling.RECORDER.meshset_builds
    with graphs(FakeGraphs()) as standin:
        first = model.track_batch(rgb, depth, hyp, ORDER)
        for _ in range(3):
            assert np.array_equal(model.track_batch(rgb, depth, hyp, list(ORDER)), first)
        model.track_batch(rgb, depth, hyp, "cube")
        other = ("cube", "quad", "bumpy", "quad", "cube")
        got = model.track_batch(rgb, depth, hyp, other)
        assert np.array_equal(model.track_batch(rgb, depth, hyp, other), got)
        assert np.array_equal(model.track_batch(rgb, depth, hyp, ORDER), first)
    with graphs(None):
        assert np.array_equal(_model(files).track_batch(rgb, depth, hyp, other), got)
    assert model.meshset_builds == 1 and profiling.RECORDER.meshset_builds == recorded + 2
    keys = [k for k in model._track_cache if not isinstance(k[1], str)]
    assert keys == [("track_batch", CATALOG, (H, W), 1, 5, False)]
    program = model._track_cache[keys[0]]
    assert (program.captures, program.replays) == (1, 6)
    assert model._catalog.names == NAMES
    assert standin.captures == 2


def test_a_recorded_mixed_call_has_the_meshset_span_and_its_launches(files, frame, monkeypatch):
    """A recorded call over names opens the ``names`` step (their catalog
    indices mapped and uploaded) after ``check``."""
    rgb, depth, hyp = frame
    model = _model(files)
    real = render.render_views

    def counted(*args, **kwargs):  # the card's wrapper counts its launch; the CPU's does not
        real.launches += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(render, "render_views", counted)
    with graphs(FakeGraphs()):
        model.track_batch(rgb, depth, hyp, ORDER)  # the capture
        with profiling.tracing() as rec:
            model.track_batch(rgb, depth, hyp, ORDER)
            model.track_batch(rgb, depth, hyp, ORDER[::-1])
            summary = rec.summary()
    names = [s[1] for s in rec.calls[0].spans]
    assert names[:3] == ["track_batch", "check", "names"] and "program" in names
    assert summary["spans"]["names"]["count"] == 2 and "meshset" not in summary["spans"]
    assert summary["launches"] == {"render_views": 1.0}
    assert summary["meshset_builds"] == profiling.RECORDER.meshset_builds
    program = model._track_cache[("track_batch", CATALOG, (H, W), 1, len(ORDER), False)]
    assert program.launches_per_call == {"render_views": 1}
