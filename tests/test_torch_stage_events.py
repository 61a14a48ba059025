"""The stage events inside the port's CUDA graphs, on the card.

These need a CUDA card and skip without one. The file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_stage_events.py -q

At the benchmark's scan (13,277 faces, 480x640, the trained nets): every
stage of a replayed Register, Track and track_batch of 8 reads more than 0
ms, the stages sum to the replay's own device time, each graph holds one
event node a stage and one for the end, and a replay with the event nodes
equals the eager function bit for bit.
"""

import pathlib

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import create_foundationpose_model
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import profiling, synthetic

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
STAGES = {
    "register": ["front_end", "render_crop", "refiner", "pose_update", "render_crop", "scorer",
                 "select"],
    "track": ["xyz", "render_crop", "refiner", "pose_update"],
    "track_batch": ["xyz", "render_crop", "refiner", "pose_update"],
}

# ~25 ms of queued device work at the card's clock: longer than any launch
QUEUED_CYCLES = 50_000_000

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scan():
    """(model, the scan's asset, pose, rgb, depth, mask) at 480x640."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    asset = load_mesh("scan", str(ROOT / "benchmark" / "assets" / "scan13k.ply"))
    pose = synthetic.default_pose(0.6)
    frame = synthetic.render_scene(MeshConstants.from_asset(asset, "cuda"), pose, K, 480, 640)
    return (_model(asset), asset, pose, *frame)


def _model(asset):
    return create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), [asset], K, 480, 640)


def _calls(model, pose, rgb, depth, mask):
    """kind -> a call of that kind on the frame."""
    poses = np.stack([pose] * 8)
    return {
        "register": lambda: model.register(rgb, depth, mask, "scan"),
        "track": lambda: model.track(rgb, depth, pose, "scan"),
        "track_batch": lambda: model.track_batch(rgb, depth, poses, "scan"),
    }


def _program(model, kind):
    if kind == "register":
        return model._register_cache[("register", "scan", (480, 640), 1, False)]
    n = (8,) if kind == "track_batch" else ()
    return model._track_cache[(kind, "scan", (480, 640), 1, *n, False)]


@pytest.mark.parametrize("kind", ["register", "track", "track_batch"])
def test_every_stage_reads_a_time_and_the_stages_sum_to_the_replay(scan, kind):
    """Each recorded call reads every stage, in the graph's order, above 0
    ms; and the stages of a replay sum to within 3% of its own device time,
    which a pair of events on the current stream takes around the graph's
    launch. Queued work ahead of the pair keeps the host's launch time out
    of it (the test checks that the launch returned before the first event
    ran), so the pair times the graph's nodes alone: work outside every
    stage, or a mark in the wrong place, would show as a gap."""
    model, _, pose, rgb, depth, mask = scan
    call = _calls(model, pose, rgb, depth, mask)[kind]
    call()  # the capture
    program = _program(model, kind)
    assert program.stages == STAGES[kind]
    with profiling.tracing() as rec:
        for _ in range(4):
            call()
        summary = rec.summary()
    for c in rec.calls:
        assert [name for name, _ in c.stages] == STAGES[kind]
        assert all(ms > 0 for _, ms in c.stages), c.stages
    assert set(summary["stages"]) == set(STAGES[kind])
    assert summary["calls"] == 4 and summary["replays"] >= 4
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        torch.cuda._sleep(QUEUED_CYCLES)
        start.record()
        program._graph.replay()
        queued = not start.query()
        end.record()
        end.synchronize()
        stages, whole = sum(ms for _, ms in program.stage_ms()), start.elapsed_time(end)
        assert queued
        assert abs(stages - whole) <= 0.03 * whole, (stages, whole)


@pytest.mark.parametrize("kind", ["register", "track", "track_batch"])
def test_graph_holds_an_event_node_a_stage_and_replays_equal_eager(scan, kind, monkeypatch):
    """Against the same program captured with the marks patched out: one
    node more a stage and one for the end; the replay with the event nodes
    equals its function run eagerly, bit for bit."""
    _, asset, pose, rgb, depth, mask = scan
    model = _model(asset)
    _calls(model, pose, rgb, depth, mask)[kind]()
    program = _program(model, kind)
    with monkeypatch.context() as m:
        m.setattr(fpp, "stage", lambda name: None)
        bare = _model(asset)
        _calls(bare, pose, rgb, depth, mask)[kind]()
    plain = _program(bare, kind)
    assert plain.stages == [] and program.nodes - plain.nodes == len(STAGES[kind]) + 1
    frame = [torch.from_numpy(a).cuda() for a in (rgb, depth)]
    if kind == "register":
        args = [*frame, torch.from_numpy((mask > 0).astype(np.uint8)).cuda()]
    else:
        args = [*frame, torch.from_numpy(pose if kind == "track" else np.stack([pose] * 8)).cuda()]
    with torch.inference_mode():
        got = program(*args)
        want = program.fn(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
