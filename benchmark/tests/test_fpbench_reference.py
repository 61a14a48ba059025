"""The plain reference against the program's eager CPU path at a small size:
its readers, its rasterizer, Register, Track and track_batch. The tests
import the program; the reference never does."""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference import assets, geometry, nets, pipeline, raster, render

ROOT = pathlib.Path(__file__).resolve().parents[2]
ASSETS = ROOT / "benchmark" / "assets"
K = np.array([[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]], np.float32)
H, W = 120, 160


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "foundationpose_cpp_tpu_torch", "foundationpose_cpp_tpu", "jax", "jaxlib"), \
                    f"{path.name} imports {name}"


@pytest.mark.parametrize("name", ["scan13k", "cube8cm"])
def test_mesh_reader_matches_the_programs_loader(name):
    from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants

    path = str(ASSETS / f"{name}.ply")
    asset = load_mesh(name, path)
    port = MeshConstants.from_asset(asset, "cpu")
    mine = assets.load_mesh(path, "cpu")
    f = asset.num_faces
    assert torch.equal(mine.vertices, port.vertices)
    assert torch.equal(mine.normals, port.normals)
    assert torch.equal(mine.uvs, port.texcoords)
    assert torch.equal(mine.faces, port.faces[:f].long())
    assert torch.equal(mine.texture, port.texture)
    assert mine.diameter == pytest.approx(asset.diameter, rel=1e-12)


def test_checkpoint_reader_matches_the_programs(tmp_path):
    from foundationpose_cpp_tpu_torch.models import convert_jax

    params = assets.read_params(str(ROOT / "weights" / "scorer_multi_full.npz"), "cpu")
    sd = convert_jax.load_npz(str(ROOT / "weights" / "scorer_multi_full.npz"))
    assert torch.equal(params["encodeA/conv0/w"].permute(3, 2, 0, 1),
                       sd["encodeA.conv0.weight"].float())
    assert torch.equal(params["att_cross/attn/qkv_w"].t(), sd["att_cross.attn.qkv.weight"].float())
    assert torch.equal(params["pos_embed"], sd["pos_embed"].float())
    assert params["encodeA/conv0/w"].dtype == torch.float32


def test_rotation_grid_matches_the_programs():
    from foundationpose_cpp_tpu_torch.geometry import icosphere

    for n_views, step in ((40, 60), (12, 120)):
        assert np.array_equal(geometry.rotation_grid(n_views, step),
                              icosphere.make_rotation_grid(n_views, step))


@pytest.mark.parametrize("mesh_name,n,crop", [("scan13k", 3, 40), ("cube8cm", 5, 32)])
def test_rasterizer_equals_the_programs_dense_one(mesh_name, n, crop):
    """The bounding-box rasterizer gives exactly what the program's plain
    rasterizer gives, on crops of seeded poses (ties and culling included)."""
    from foundationpose_cpp_tpu_torch.ops import rasterize as port_ras

    mesh = assets.load_mesh(str(ASSETS / f"{mesh_name}.ply"), "cpu")
    rng = np.random.default_rng(5)
    poses = torch.as_tensor(np.stack([_pose(rng) for _ in range(n)]))
    Kt = torch.as_tensor(K)
    tfs = geometry.crop_window_tf(poses, Kt, crop, 1.2, mesh.diameter)
    clip_mat = geometry.clip_matrix(poses, geometry.crop_bbox(tfs, crop), Kt, H, W, 0.1, 100.0)
    clip = geometry.transform_h(clip_mat, mesh.vertices)
    want = port_ras.rasterize(clip, mesh.faces.int(), crop, crop)
    got = raster.rasterize(clip, mesh.faces, crop, crop)
    assert (want[..., 3] > 0).float().mean() > 0.1
    assert torch.equal(got, want)


def test_rasterizer_lowest_face_wins_a_tie():
    """Two copies of a triangle at one depth: every pixel goes to the first."""
    verts = torch.tensor([[-0.5, -0.5, 0.5, 1.0], [0.6, -0.4, 0.5, 1.0], [0.0, 0.7, 0.5, 1.0]])
    clip = verts[None]
    faces = torch.tensor([[0, 1, 2], [0, 1, 2]])
    out = raster.rasterize(clip, faces, 16, 16)
    assert set(out[..., 3].unique().tolist()) == {0.0, 1.0}


def _pose(rng) -> np.ndarray:
    from benchmark import scene

    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = scene.random_rotation(rng)
    p[:3, 3] = [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02), rng.uniform(0.45, 0.6)]
    return p


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    from foundationpose_cpp_tpu_torch.models import convert_jax, networks

    d = tmp_path_factory.mktemp("nets")
    cfg = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, ffn_dim=64,
                             crop_hw=32)
    convert_jax.save_npz(networks.init_net("refiner", cfg, 1).state_dict(), str(d / "r.npz"))
    convert_jax.save_npz(networks.init_net(
        "scorer", networks.NetConfig(**{**cfg.__dict__, "cross_attention": True}), 2).state_dict(),
        str(d / "s.npz"))
    return str(d / "r.npz"), str(d / "s.npz")


def _pair(narrow, mesh_name, n_views=12, step=120):
    from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
    from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    path = str(ASSETS / f"{mesh_name}.ply")
    cfg = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False,
                               n_views=n_views, inplane_step_deg=step)
    port = FoundationPose(*narrow, [load_mesh("obj", path)], K, H, W, cfg, device="cpu")
    ref = pipeline.Reference(assets.load_mesh(path, "cpu"), assets.read_params(narrow[0], "cpu"),
                             assets.read_params(narrow[1], "cpu"), torch.as_tensor(K), 32,
                             n_views=n_views, inplane_step_deg=step)
    return port, ref


def test_register_matches_the_programs_cpu_path(narrow):
    port, ref = _pair(narrow, "cube8cm")
    rgb, depth, mask = render.render_frame(ref.mesh, _pose(np.random.default_rng(1)), K, H, W,
                                           pipeline.CFG)
    best, poses, scores = port.register_with_scores(rgb, depth, mask, "obj")
    ref_poses, ref_scores = ref.register(rgb, depth, mask)
    assert np.abs(poses - ref_poses).max() < 1e-5
    # scored on the program's own poses, the crops are the same to the pixel
    assert np.abs(ref.score_poses(poses, rgb, depth) - scores).max() < 1e-5
    assert np.array_equal(best, poses[np.argmax(scores)])


@pytest.mark.parametrize("mesh_name,n", [("scan13k", 1), ("cube8cm", 4)])
def test_track_matches_the_programs_cpu_path(narrow, mesh_name, n):
    port, ref = _pair(narrow, mesh_name)
    rng = np.random.default_rng(2)
    gts = np.stack([_pose(rng) for _ in range(n)])
    if n > 1:
        gts[:, :3, 3] = [[(i - 1.5) * 0.12, 0.0, 1.0] for i in range(n)]
    rgb, depth, _ = render.render_frame(ref.mesh, gts, K, H, W, pipeline.CFG)
    hyp = gts.copy()
    hyp[:, :3, 3] += 0.004
    got = port.track(rgb, depth, hyp[0], "obj")[None] if n == 1 else \
        port.track_batch(rgb, depth, hyp, "obj")
    assert np.abs(got - ref.track(rgb, depth, hyp)).max() < 1e-5


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0 + 1 / 16, 1.0 + 1 / 8, -3.0])
    q = nets.fp8_e4m3(x)
    assert q.tolist() == [448.0, 1.0, 1.0, 1.125, -3.0]
