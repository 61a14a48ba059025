"""The port's own tracing (``utils/profiling.py``'s recorder, the stage marks
of ``pipeline/programs.py``) on the CPU.

The recorder is off unless ``profiling.tracing()`` is active or a
``torch.profiler`` session runs; on, it keeps each public call's host spans
(nested, one call id a call), the device ms of the stages of the graph the
call replayed and the bytes the call copied, by kind. The graph's side runs
with the stand-in of tests/graph_standin.py, whose events are stamped on the
host clock at the capture. No JAX is imported.
"""

import dataclasses
import gc
import json

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import FoundationPoseConfig, create_foundationpose_model
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline import programs
from foundationpose_cpp_tpu_torch.utils import profiling

from .graph_standin import FakeGraphs, graphs, one_thread  # noqa: F401  (a fixture)

H, W = 480, 640  # the benchmark's frames, so the bytes are the ones it reads
K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
CFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False,
                           n_views=12, inplane_step_deg=120)
NET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
REGISTER_STAGES = ["front_end", "render_crop", "refiner", "pose_update", "render_crop", "scorer",
                   "select"]
TRACK_STAGES = ["xyz", "render_crop", "refiner", "pose_update"]
FRAME_BYTES = H * W * 3 + H * W * 4  # uint8 rgb, f32 depth
CALL, NAME, START, END, PARENT = range(5)  # the fields of a recorded span


@pytest.fixture(scope="module")
def nets():
    return (networks.init_net("refiner", NET, seed=0),
            networks.init_net("scorer", dataclasses.replace(NET, cross_attention=True), seed=1))


@pytest.fixture
def scene(nets):
    """A model of its own with narrow f32 nets (no program captured yet), a
    cube 0.5 m in front of the camera, and a frame of the benchmark's shape
    (its values matter to no test here)."""
    cube = tproc.textured_cube(size=0.1)
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    depth = np.full((H, W), 0.5, np.float32)
    mask = np.zeros((H, W), np.uint8)
    mask[200:280, 280:360] = 1
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.5
    model = create_foundationpose_model(*nets, [cube], K, H, W, config=CFG, device="cpu")
    return model, pose, rgb, depth, mask


def _track(model, scene_, n=None):
    _, pose, rgb, depth, _ = scene_
    if n is None:
        return model.track(rgb, depth, pose, "cube")
    return model.track_batch(rgb, depth, np.stack([pose] * n), "cube")


def test_recorder_is_off_by_default_and_records_nothing(scene):
    rec = profiling.RECORDER
    assert not rec.forced and not torch.autograd.profiler._is_profiler_enabled
    assert profiling.call("track") is profiling.OFF and profiling.span("load") is profiling.OFF
    before, copied = list(rec.calls), dict(rec.bytes)
    _track(scene[0], scene)
    assert list(rec.calls) == before and dict(rec.bytes) == copied
    assert not profiling.counting()


def test_recorder_is_on_inside_the_profiler_and_off_after(scene):
    model = scene[0]
    with profiling.tracing():
        _track(model, scene)  # a stretch before the profiler's
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _track(model, scene)
        _track(model, scene, 2)
    names = [e.name for e in prof.events()]
    assert {"fp.track", "fp.track_batch", "fp.check", "fp.upload", "fp.program",
            "fp.readback"} <= set(names)
    calls = list(profiling.RECORDER.calls)
    assert [c.spans[0][NAME] for c in calls] == ["track", "track_batch"]  # the profiler's stretch
    _track(model, scene)
    assert list(profiling.RECORDER.calls) == calls


def test_spans_nest_with_parents_and_share_a_call_id(scene):
    model = scene[0]
    with graphs(FakeGraphs()), profiling.tracing() as rec:
        _track(model, scene)  # the capture
        _track(model, scene)  # a replay
        summary = rec.summary()
    first, second = rec.calls
    assert first.id != second.id
    for call in (first, second):
        assert {s[CALL] for s in call.spans} == {call.id}
        assert all(s[START] <= s[END] for s in call.spans)
    names = [(s[NAME], second.spans[s[PARENT]][NAME] if s[PARENT] >= 0 else None)
             for s in second.spans]
    assert names == [("track", None), ("check", "track"), ("upload", "track"),
                     ("program", "track"), ("load", "program"), ("replay", "program"),
                     ("clone", "program"), ("readback", "track")]
    for call in (first, second):  # every child lies inside its parent
        for s in call.spans[1:]:
            parent = call.spans[s[PARENT]]
            assert parent[START] <= s[START] <= s[END] <= parent[END]

    def duration(s):
        return s[END] - s[START]

    # self time: the duration less the children's
    own = [duration(c.spans[3]) - sum(duration(s) for s in c.spans if s[PARENT] == 3)
           for c in (first, second)]
    got = summary["spans"]["program"]
    assert got["count"] == 2 and all(o > 0 for o in own)
    assert got["self_ms"] == pytest.approx(sum(own) * 1e-6 / 2)
    assert got["mean_ms"] == pytest.approx(sum(duration(c.spans[3]) for c in (first, second))
                                           * 1e-6 / 2)


def test_recorder_keeps_the_newest_calls_of_a_bounded_buffer(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_CALLS", 2)
    rec = profiling.Recorder()
    saved = profiling.RECORDER
    profiling.RECORDER = rec
    try:
        with profiling.tracing():
            for name in ("a", "b", "c"):
                with profiling.call(name):
                    with profiling.span("inner"):
                        profiling.count_bytes("load", 10)
    finally:
        profiling.RECORDER = saved
    assert [c.spans[0][NAME] for c in rec.calls] == ["b", "c"]
    assert rec.bytes["load"] == 30 and rec.summary()["bytes"] == {"load": 10.0}
    assert rec.summary()["spans"]["inner"]["count"] == 2


@pytest.mark.parametrize("kind", ["register", "track"])
def test_stand_in_capture_marks_the_stages_in_order(scene, kind):
    model, pose, rgb, depth, mask = scene
    with graphs(FakeGraphs()), profiling.tracing() as rec:
        for _ in range(3):
            if kind == "register":
                model.register(rgb, depth, mask, "cube")
            else:
                model.track(rgb, depth, pose, "cube")
        summary = rec.summary()
    cache = model._register_cache if kind == "register" else model._track_cache
    program = cache[(kind, "cube", (H, W), 1, False)]
    want = REGISTER_STAGES if kind == "register" else TRACK_STAGES
    assert program.stages == want and len(program._marks) == len(want) + 1
    assert program._marks[-1][0] is None  # the end of the last stage
    calls = list(rec.calls)
    assert calls[0].stages == ()  # the capture's call ran its function, not the graph
    for call in calls[1:]:
        assert [name for name, _ in call.stages] == want
        assert all(ms > 0 for _, ms in call.stages)
    assert set(summary["stages"]) == set(want)
    render_crop = [ms for c in calls for name, ms in c.stages if name == "render_crop"]
    assert summary["stages"]["render_crop"] == pytest.approx(sum(render_crop) / 2)


def test_stage_marks_do_nothing_outside_a_capture(scene):
    """Eager and the warm-up run record no event; the stand-in's replay of
    the staged graph equals the eager function bit for bit."""
    model, pose, rgb, depth, _ = scene
    with graphs(None):
        programs.stage("refiner")  # no capture: nothing to record, nothing raised
        want = model.track(rgb, depth, pose, "cube")
    standin = FakeGraphs()
    events = []
    standin.event = lambda: events.append(1) or FakeGraphs.event()
    with graphs(standin):
        first = model.track(rgb, depth, pose, "cube")
        second = model.track(rgb, depth, pose, "cube")
    assert len(events) == len(TRACK_STAGES) + 1  # the capture's marks alone
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)


def test_only_the_public_calls_programs_carry_stage_events(scene):
    """The packed step (the deployment path, which reads nothing back)
    captures Track's marked steps with no event: its graph carries no event
    node, and a Track call's program still carries its own."""
    model, pose, rgb, depth, _ = scene
    standin = FakeGraphs()
    events = []
    standin.event = lambda: events.append(1) or FakeGraphs.event()
    step = model.make_packed_tracker("cube", (H, W))
    packed = model.pack_frame(rgb, depth)
    with graphs(standin):
        step(packed, pose)
        step(packed, pose)
        assert step.program.captured and step.program.stages == [] and events == []
        model.track(rgb, depth, pose, "cube")
    assert len(events) == len(TRACK_STAGES) + 1
    assert model._track_cache[("track", "cube", (H, W), 1, False)].stages == TRACK_STAGES


def test_captures_and_replays_count_on_or_off(scene):
    model = scene[0]
    rec = profiling.RECORDER
    before = (rec.captures, rec.replays)
    with graphs(FakeGraphs()):
        _track(model, scene, 3)
        _track(model, scene, 3)
        with profiling.tracing():
            _track(model, scene, 3)
        _track(model, scene, 3)
    program = model._track_cache[("track_batch", "cube", (H, W), 1, 3, False)]
    assert (program.captures, program.replays) == (1, 3)
    assert (rec.captures - before[0], rec.replays - before[1]) == (1, 3)
    with graphs(None):
        _track(model, scene, 3)  # eager: neither
    assert (program.captures, program.replays) == (1, 3)


@pytest.mark.parametrize("n", [None, 8])
def test_copy_counters_give_the_bytes_of_a_call(scene, n):
    """A replayed call at 480x640: the frame and the pose loaded into the
    static buffers, the pose cloned; the uploads and the readback are no
    copies on the CPU and count 0."""
    model = scene[0]
    pose_bytes = 64 * (n or 1)
    with graphs(FakeGraphs()):
        _track(model, scene, n)  # the capture
        with profiling.tracing() as rec:
            _track(model, scene, n)
            _track(model, scene, n)
    assert rec.summary()["bytes"] == {"load": FRAME_BYTES + pose_bytes, "clone": pose_bytes}
    assert dict(rec.bytes) == {"load": 2 * (FRAME_BYTES + pose_bytes), "clone": 2 * pose_bytes}


def test_recorded_calls_keep_few_objects_for_the_collector(scene):
    """A full buffer must not slow the process's garbage collections: a
    recorded call keeps one tracked object (its ``Call``); its spans and
    stages are tuples of numbers and strings, which the collector drops."""
    model = scene[0]
    with graphs(FakeGraphs()):
        _track(model, scene)  # the capture
        with profiling.tracing() as rec:
            _track(model, scene)
            gc.collect()
            before = len(gc.get_objects())
            for _ in range(50):
                _track(model, scene)
            gc.collect()
            gc.collect()
            kept = (len(gc.get_objects()) - before) / 50
    assert len(rec.calls) == 51 and kept < 2, kept
    assert not gc.is_tracked(rec.calls[-1].spans) and not gc.is_tracked(rec.calls[-1].bytes)


def test_trace_exports_the_program_spans(scene, tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        _track(scene[0], scene)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"fp.track", "fp.check", "fp.upload", "fp.program", "fp.readback"} <= spans
