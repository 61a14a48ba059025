"""``track_batch`` over distinct meshes on the card: K2 over a mesh table,
the mixed call's CUDA graph, and a changing set of names served by one
graph for each N.

These need a CUDA card and skip without one; no JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_track_mixed.py -q

Tolerances: K2 against its plain version under 1% of pixels off by more than
2e-3, as ``test_torch_cuda_kernels.py`` holds a render; against per-mesh
launches of K2 bit for bit (each view computes what its mesh's launch
computes for it); a replay against the eager function bit for bit.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import create_foundationpose_model
from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import family, procedural
from foundationpose_cpp_tpu_torch.ops import render
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import CATALOG
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants, MeshSet, render_branch
from foundationpose_cpp_tpu_torch.utils import profiling, synthetic

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights"
CFG = FoundationPoseConfig()
K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
ORDER = ("sphere", "house", "bumpy", "house", "sphere", "bumpy", "bumpy")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assets():
    return [procedural.textured_uv_sphere(name="sphere", radius=0.05, n_lat=24, n_lon=32),
            procedural.textured_house(name="house", size=0.1),
            dataclasses.replace(family.random_family_asset(1, "bumpy", diameter=0.15),
                                name="bumpy")]


def _poses(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        poses[i, :3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        poses[i, :3, 3] = [(i - (n - 1) / 2) * 0.12, 0.03 * (i % 2), 0.9]
    return poses


def _views(card, n_views, ch=160, cw=160):
    meshes = {a.name: MeshConstants.from_asset(a, card) for a in _assets()}
    names = tuple(ORDER[i % len(ORDER)] for i in range(n_views))
    poses = torch.as_tensor(_poses(n_views), device=card)
    Kt = torch.as_tensor(K, device=card)
    tfs = transforms.compute_crop_window_tf(poses, Kt, (ch, cw), 1.2, 0.15)
    clip = transforms.pose_clip_matrix(poses, transforms.construct_bbox2d(tfs, ch, cw), Kt,
                                       480, 640)
    return meshes, names, MeshSet.build(meshes).select(names), poses, clip


@pytest.mark.parametrize("n_views,ch,cw", [(7, 160, 160), (3, 48, 64), (140, 160, 160)])
def test_render_kernel_over_a_mesh_table_matches_plain(card, n_views, ch, cw):
    """Seven views (32x32 regions), a ragged small crop, and 140 views
    (whole-crop regions), each on its own mesh of three."""
    _, _, mesh_set, poses, clip = _views(card, n_views, ch, cw)
    before = render.render_views.launches
    got = render_branch(mesh_set, poses, clip, ch, cw, CFG)
    assert render.render_views.launches == before + 1
    want = render.render_views_plain(
        mesh_set.vertices, mesh_set.normals, mesh_set.texcoords, mesh_set.faces,
        mesh_set.texture, poses, clip, ch, cw, mesh_set.diameter,
        CFG.min_depth, CFG.max_depth, CFG.w_ambient, CFG.w_diffuse, table=mesh_set.table)
    assert (want.abs().sum(-1) > 0).float().mean().item() > 0.05
    assert ((got - want).abs().amax(dim=-1) > 2e-3).float().mean().item() < 0.01


@pytest.mark.parametrize("n_views", [7, 140])
def test_render_kernel_over_a_mesh_table_equals_per_mesh_launches(card, n_views):
    meshes, names, mesh_set, poses, clip = _views(card, n_views)
    got = render_branch(mesh_set, poses, clip, 160, 160, CFG)
    for name, mesh in meshes.items():
        idx = torch.tensor([i for i, n in enumerate(names) if n == name], device=card)
        want = render_branch(mesh, poses[idx], clip[idx], 160, 160, CFG)
        assert (want.abs().sum(-1) > 0).any()
        assert torch.equal(got[idx], want), name


def _scene():
    """The three meshes' model (the trained nets, 480x640) and a frame of
    ORDER's seven objects, each rendered alone and composited by nearest
    depth, with hypotheses 5 mm off."""
    model = create_foundationpose_model(
        str(WEIGHTS / "refiner_multi_full.npz"), str(WEIGHTS / "scorer_multi_full.npz"),
        _assets(), K, 480, 640)
    gts = _poses(len(ORDER), seed=1)
    frames = [synthetic.render_scene(model._meshes[n], gts[i], K, 480, 640)
              for i, n in enumerate(ORDER)]
    z = np.stack([np.where(f[1] > 0, f[1], np.inf) for f in frames])  # each object alone
    front = z.argmin(axis=0)  # the nearest object at each pixel
    rgb = np.take_along_axis(np.stack([f[0] for f in frames]), front[None, ..., None], 0)[0]
    depth = np.where(np.isfinite(z.min(axis=0)), z.min(axis=0), 0.0).astype(np.float32)
    hyp = gts.copy()
    hyp[:, :3, 3] += 0.005
    return model, rgb, depth, hyp


def test_mixed_track_batch_graph_equals_eager_with_one_render_launch(card):
    """The mixed track_batch program (a CUDA graph, the trained nets at
    480x640) replayed equals its function run eagerly, bit for bit; a
    replay launches K2 once (one launch pair over all views) and K1 once;
    each pose is the one its mesh's own call gives, but for the bf16 nets'
    dependence on the batch (2e-3 on a pose's entries: ~0.1 deg, 2 mm)."""
    model, rgb, depth, hyp = _scene()
    first = model.track_batch(rgb, depth, hyp, ORDER)  # the capture
    key = ("track_batch", CATALOG, (480, 640), 1, len(ORDER), False)
    program = model._track_cache[key]
    assert program.captured
    assert program.launches_per_call["render_views"] == 1
    assert program.launches_per_call["mha_packed_qkv"] == 1
    before = render.render_views.launches
    second = model.track_batch(rgb, depth, hyp, list(ORDER))
    assert render.render_views.launches == before + 1 and model.meshset_builds == 1
    frame = [torch.from_numpy(a).to(card) for a in (rgb, depth, hyp)]
    idx = torch.from_numpy(model._mesh_catalog().indices(ORDER)).to(card)
    with torch.inference_mode():
        want = program.fn(*frame, idx).cpu().numpy()
    assert np.array_equal(second, want) and np.array_equal(first, second)
    for name in set(ORDER):
        idx = [i for i, n in enumerate(ORDER) if n == name]
        alone = model.track_batch(rgb, depth, hyp[idx], name)
        assert np.abs(second[idx] - alone).max() < 2e-3, name


def test_changing_names_make_no_capture_and_equal_eager_calls(card):
    """One warm-up call at each N from 1 to 8 (ORDER's objects, the eighth
    a repeat of the first), then 300 calls, each a seeded random sequence
    of 1 to 8 of the frame's seven objects (repeats allowed), at least 200
    distinct: no capture and no catalog build after the warm-up; every
    call's poses bit for bit its program's function run eagerly on the same
    inputs; one K2 and one K1 launch a call; a replay of a new set under
    set_sync_debug_mode("error") makes no host synchronization."""
    model, rgb, depth, hyp = _scene()
    objects = list(range(len(ORDER))) + [0]
    for n in range(1, 9):
        model.track_batch(rgb, depth, hyp[objects[:n]], [ORDER[j] for j in objects[:n]])
    captures, builds = profiling.RECORDER.captures, model.meshset_builds
    rng = np.random.default_rng(7)
    sets = [tuple(rng.integers(0, len(ORDER), rng.integers(1, 9)).tolist()) for _ in range(300)]
    assert len(set(sets)) >= 200
    catalog = model._mesh_catalog()
    frame = [torch.from_numpy(a).to(card) for a in (rgb, depth)]

    def args(objects):
        names = [ORDER[j] for j in objects]
        return [*frame, torch.from_numpy(hyp[list(objects)]).to(card),
                torch.from_numpy(catalog.indices(names)).to(card)]

    for objects in sets:
        render.render_views.launches = 0
        got = model.track_batch(rgb, depth, hyp[list(objects)], [ORDER[j] for j in objects])
        assert render.render_views.launches == 1
        program = model._track_cache[("track_batch", CATALOG, (480, 640), 1, len(objects), False)]
        with torch.inference_mode():
            want = program.fn(*args(objects)).cpu().numpy()
        assert np.array_equal(got, want), objects
    assert (profiling.RECORDER.captures, model.meshset_builds) == (captures, builds)
    keys = sorted(k[4] for k in model._track_cache if k[1] == CATALOG)
    assert keys == list(range(1, 9))
    for k in model._track_cache:
        if k[1] == CATALOG:
            per_call = model._track_cache[k].launches_per_call
            assert per_call["render_views"] == 1 and per_call["mha_packed_qkv"] == 1
    program = model._track_cache[("track_batch", CATALOG, (480, 640), 1, 3, False)]
    a = args((6, 1, 1))
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            program(*a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert program.captures == 1
