"""The cell over distinct meshes (``track_batch_mixed``) on the CPU, at the
tiny size of conftest.py with three small meshes of different sizes in place
of LM-O's eight: the traffic end to end through the harness, two planted
faults that its check must catch, and ``counts_mixed`` against a hand count."""

from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from benchmark import counts, counts_mixed, harness

CELL = "track_batch_mixed.lmo8"


@pytest.fixture(scope="module")
def mixed(tiny, tmp_path_factory) -> pathlib.Path:
    """The tiny benchmark with the lmo8 configuration cut to three objects:
    the 8 cm cube and two family meshes (0.15 and 0.10 m) written as PLY."""
    from foundationpose_cpp_tpu_torch.meshio import family, procedural

    dst = tmp_path_factory.mktemp("mixed")
    root = dst / "benchmark"
    shutil.copytree(tiny, root)
    shutil.copy(tiny.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name in ("r.npz", "s.npz"):
        shutil.copy(tiny.parent / name, dst / name)
    meshes = [{"name": "cube", "file": "benchmark/assets/cube8cm.ply", "faces": 12,
               "diameter_mm": 138.6}]
    for name, seed, kind, d in (("bumpy", 1, "bumpy", 0.15), ("quad", 2, "superquadric", 0.10)):
        procedural.write_ply(family.random_family_asset(seed, kind, diameter=d),
                             str(root / "assets" / f"{name}.ply"),
                             str(root / "assets" / f"{name}.png"), binary=True)
        meshes.append({"name": name, "file": f"benchmark/assets/{name}.ply", "faces": 720,
                       "diameter_mm": d * 1e3})
    config = json.loads((root / "configs" / "lmo8.json").read_text())
    config.update(meshes=meshes, refiner=str(dst / "r.npz"), scorer=str(dst / "s.npz"))
    (root / "configs" / "lmo8.json").write_text(json.dumps(config))
    cell = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    cell["params"].update(objects=3, grid=3)
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    return root


def _run(root, seed=2**31 + 13, trace=False):
    return harness.run_cell(CELL, seed, 0.3, trace, "cpu", root=root, log=lambda m: None)


def test_the_mixed_cell_runs_end_to_end_and_is_correct(mixed):
    r = _run(mixed)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"track_ms", "track_p95_ms", "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    traced = _run(mixed, seed=5, trace=True)
    # no device operations on the CPU: only the host clock's metric reads
    assert set(traced["metrics"]) == {"mfu.track"}


def test_a_call_with_two_objects_names_swapped_is_not_correct(mixed, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    real = FoundationPose.track_batch

    def swapped(self, rgb, depth, hyp, names, itr=1):
        names = list(names)
        names[0], names[1] = names[1], names[0]
        return real(self, rgb, depth, hyp, names, itr)

    monkeypatch.setattr(FoundationPose, "track_batch", swapped)
    assert not _run(mixed)["correct"]


def test_one_object_returned_unrefined_is_not_correct(mixed, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    real = FoundationPose.track_batch

    def one_left(self, rgb, depth, hyp, names, itr=1):
        out = real(self, rgb, depth, hyp, names, itr)
        out[2] = np.asarray(hyp[2], np.float32)
        return out

    monkeypatch.setattr(FoundationPose, "track_batch", one_left)
    assert not _run(mixed)["correct"]


def test_the_render_bound_of_two_meshes_by_hand():
    """Two views of a one-face mesh A (3 vertices, 4x4 texture) and one view
    of a two-face mesh B (4 vertices, 2x2 texture), on 8x8 crops."""
    a_faces = torch.tensor([[0, 1, 2]])
    b_faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    # A's face spans NDC [-0.5, 0.5]^2: pixel centres i = 2..5 each way, 16
    # tests a view; its second view is behind the camera: none
    tri = torch.tensor([[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0], [0.5, 0.5, 0.0, 1.0]])
    behind = tri.clone()
    behind[0, 3] = -1.0
    a_clip = torch.stack([tri, behind])
    # B: a square over the whole crop as two faces, each box 8x8: 128 tests
    sq = torch.tensor([[-1.0, -1.0, 0.0, 1.0], [1.0, -1.0, 0.0, 1.0], [1.0, 1.0, 0.0, 1.0],
                       [-1.0, 1.0, 0.0, 1.0]])
    tests = counts_mixed.tests_needed([a_clip, sq[None]], [a_faces, b_faces], 8)
    assert tests == 16 + 0 + 128
    # bytes: A 3 x 32 + 1 x 13 + 16 x 12, B 4 x 32 + 2 x 13 + 4 x 12 (each once),
    # 3 poses and clip matrices, the 3 x 8 x 8 x 6 f32 image
    want_bytes = (3 * 32 + 13 + 16 * 12) + (4 * 32 + 2 * 13 + 4 * 12) + 3 * 2 * 64 + 3 * 64 * 24
    got = counts_mixed.render_bound_s(3, 8, [(3, 1, 16), (4, 2, 4)], tests)
    assert got == pytest.approx(want_bytes / counts.PEAK_HBM_BYTES_PER_S)
    many = 10 ** 12
    assert counts_mixed.render_bound_s(3, 8, [(3, 1, 16)], many) == pytest.approx(
        many * counts.RENDER_TEST_FLOPS / counts.PEAK_F32_FLOPS)
    # one mesh for every view: counts.render_bound_s's count
    assert counts_mixed.render_bound_s(5, 160, [(8062, 13277, 512 * 512)], 7) == \
        pytest.approx(counts.render_bound_s(5, 160, 8062, 13277, 512 * 512, 7))


def test_the_mixed_readers_read_nothing_without_their_sources(monkeypatch):
    from benchmark import program_trace, trace

    run = harness.Run(1.0, 1.0, [0.001], {"flops": 1.0},
                      trace.Slice(2, 0.1, [("render_kernel<32, 32, true>", "kernel", 0.0, 5.0)],
                                  []))
    roofline = harness.load_module(harness.HERE / "metrics" / "render_roofline.track_mixed.py",
                                   "fpbench_test_roofline")
    launches = harness.load_module(harness.HERE / "metrics" / "render_launches.track_mixed.py",
                                   "fpbench_test_launches")
    assert roofline.read(run) is None  # no bound in the work
    run.work["k2_mixed_bound_s"] = 1e-6
    assert roofline.read(run) == pytest.approx(100.0 * 1e-6 * 2 / 5e-6)
    # a program that keeps no launch counts (the parent's recorder) reads nothing
    monkeypatch.setattr(program_trace, "summary", lambda r: {"calls": 2, "bytes": {}})
    assert launches.read(run) is None
    monkeypatch.setattr(program_trace, "summary",
                        lambda r: {"calls": 2, "launches": {"render_views": 1.0}})
    assert launches.read(run) == 1.0
    monkeypatch.setattr(program_trace, "summary", lambda r: None)
    assert launches.read(run) is None


def test_frames_rendered_in_one_batch_equal_each_frame_alone(tmp_path):
    """``render_frames`` renders each object's views of every frame in one
    batch; each frame is the one ``render_frame`` makes of its poses alone,
    with objects overlapping so the nearest surface decides. Not bit for bit:
    the CPU's batched matrix products round a view's vertices by an ulp
    apart from a single view's (depth ~1e-7 m, a colour by one level)."""
    from foundationpose_cpp_tpu_torch.meshio import family, procedural

    from benchmark.reference import assets, scene_multi
    from benchmark.reference.pipeline import CFG

    meshes = []
    for i, asset in enumerate((procedural.textured_cube(size=0.08),
                               family.random_family_asset(1, "bumpy", diameter=0.15))):
        procedural.write_ply(asset, str(tmp_path / f"{i}.ply"), str(tmp_path / f"{i}.png"),
                             binary=True)
        meshes.append(assets.load_mesh(str(tmp_path / f"{i}.ply"), "cpu"))
    k = np.array([[120.0, 0, 40.0], [0, 120.0, 30.0], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 2, 1, 1))
    for t in range(3):
        poses[t, 0, :3, 3] = [0.01 * t - 0.02, 0.0, 0.5]
        poses[t, 1, :3, 3] = [0.03 - 0.01 * t, 0.01, 0.52]
    frames = scene_multi.render_frames(meshes, poses, k, 60, 80, CFG)
    assert len(frames) == 3
    for t, frame in enumerate(frames):
        rgb, depth, mask = scene_multi.render_frame(meshes, poses[t], k, 60, 80, CFG)
        assert (frame[2] != mask).mean() < 1e-3 and (mask > 0).mean() > 0.05
        both = (frame[2] > 0) & (mask > 0)
        assert np.abs(frame[0][both].astype(int) - rgb[both]).max() <= 1
        assert np.abs(frame[1][both] - depth[both]).max() < 1e-6
