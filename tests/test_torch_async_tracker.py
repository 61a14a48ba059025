"""The port's frame ring, async tracker, track_dataset and stage timers.

The ring is the port's own C++ copy (``foundationpose_cpp_tpu_torch.native``),
built with g++ through a temporary file that is renamed into place; it is
held to the cases of tests/test_native.py. The async tracker runs the
packed-frame Track on frames popped from the ring: its poses must be the
step's and track()'s on the same quantized frames. ``track_dataset`` is held
against the JAX package's within 1e-4 (small f32 nets as in
tests/test_torch_pipeline.py).
"""

import dataclasses
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu import FoundationPoseConfig as JConfig
from foundationpose_cpp_tpu import create_foundationpose_model as j_create
from foundationpose_cpp_tpu import networks as jnet
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.pipeline import async_tracker as jasync
from foundationpose_cpp_tpu.pipeline.renderer import MeshConstants as JMesh
from foundationpose_cpp_tpu.utils import synthetic as jsyn
from foundationpose_cpp_tpu_torch import FoundationPoseConfig, native
from foundationpose_cpp_tpu_torch import create_foundationpose_model as t_create
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.pipeline import async_tracker as tasync
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose as TFP
from foundationpose_cpp_tpu_torch.utils import profiling

NET = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)
NET_S = dataclasses.replace(NET, cross_attention=True)
JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
H, W = 120, 160
TOL = 1e-4


def _quantize_mm(depth):
    return np.round(depth.astype(np.float64) * 1000).astype(np.uint16).astype(np.float32) * 1e-3


# --- the ring (tests/test_native.py:76-118, 162-170) -------------------------

def test_frame_ring_push_pop_latest():
    ring = native.FrameRing((4, 4, 3), np.uint8, capacity=3)
    assert ring.pop_latest() is None
    frames = [np.full((4, 4, 3), i, np.uint8) for i in range(5)]
    for f in frames:
        ring.push(f)
    out, skipped = ring.pop_latest()
    np.testing.assert_array_equal(out, frames[-1])
    assert skipped >= 1
    assert ring.dropped >= 1
    assert len(ring) == 0
    # into a caller's buffer
    ring.push(frames[2])
    buf = np.zeros((4, 4, 3), np.uint8)
    got, skipped = ring.pop_latest(out=buf)
    assert got is buf and skipped == 0
    np.testing.assert_array_equal(buf, frames[2])
    with pytest.raises(ValueError, match="C-contiguous"):
        ring.pop_latest(out=np.zeros((4, 4, 3), np.float32))
    ring.close()
    with pytest.raises(ValueError, match="closed"):
        ring.push(frames[0])


def test_frame_ring_threaded():
    ring = native.FrameRing((8, 8), np.float32, capacity=8)
    n = 200

    def producer():
        for i in range(n):
            ring.push(np.full((8, 8), float(i), np.float32))

    t = threading.Thread(target=producer)
    t.start()
    seen = []
    for _ in range(100000):
        got = ring.pop_latest()
        if got is not None:
            frame, _ = got
            assert (frame == frame[0, 0]).all(), "torn frame"
            seen.append(float(frame[0, 0]))
            if seen[-1] == float(n - 1):
                break
        elif not t.is_alive():
            got = ring.pop_latest()
            if got is not None:
                seen.append(float(got[0][0, 0]))
            break
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen and seen[-1] == float(n - 1)
    assert seen == sorted(seen), "frames came out of order"
    ring.close()


@pytest.mark.parametrize("capacity", [0, -1])
def test_frame_ring_rejects_capacity(capacity):
    with pytest.raises(ValueError, match="capacity"):
        native.FrameRing((16,), np.uint8, capacity=capacity)


def test_ring_builds_through_a_temporary_file(tmp_path, monkeypatch):
    """g++'s -o is never the library's final path (a concurrent reader would
    load a half-written file); the rename puts it there."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    calls = []
    real_run = subprocess.run

    def spy(cmd, *args, **kwargs):
        calls.append(list(cmd))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", spy)
    final = native.library_path()
    assert final.parent == tmp_path and not final.exists()
    assert native.build() == final and final.exists()
    (cmd,) = calls
    target = cmd[cmd.index("-o") + 1]
    assert target != str(final) and target.endswith(".tmp")
    assert not os.path.exists(target)
    assert native.build() == final and len(calls) == 1  # built once


def test_ring_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp") as err:
        native.build(bad)
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary left
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="could not build"):
        native.build(bad)


# --- the tracker ------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """Three frames of the cube drifting 3 mm a frame, and their poses."""
    mesh = JMesh.from_asset(jproc.textured_cube(size=0.1))
    poses, frames = [], []
    for i in range(3):
        pose = jsyn.default_pose(tz=0.5)
        pose[0, 3] += 0.003 * i
        rgb, depth, _ = jsyn.render_scene(mesh, pose, K, H, W, JCFG)
        poses.append(pose)
        frames.append((rgb, depth))
    return poses, frames


@pytest.fixture(scope="module")
def models():
    pr, ps = jnet.init_refiner(0, NET), jnet.init_scorer(1, NET_S)
    jm = j_create(pr, ps, [jproc.textured_cube(size=0.1)], K, H, W, config=JCFG, net_config=NET)
    sds = [convert_jax.params_from_jax(jax.tree.map(np.asarray, p)) for p in (pr, ps)]
    tm = t_create(convert_jax.build_net(sds[0], "refiner"), convert_jax.build_net(sds[1], "scorer"),
                  [tproc.textured_cube(size=0.1)], K, H, W, config=TCFG, device="cpu")
    return jm, tm


def test_track_dataset_matches_jax(scene, models):
    poses, frames = scene
    jm, tm = models
    want = jasync.track_dataset(jm, "cube", frames, poses[0])
    got = tasync.track_dataset(tm, "cube", frames, poses[0])
    assert len(got) == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def test_run_takes_the_newest_frame(scene, models):
    """Four pushes, then run(max_frames=1): the stale frames are skipped and
    the pose is the packed step's on the newest frame."""
    poses, frames = scene
    _, tm = models
    tracker = tasync.AsyncTracker(tm, "cube", (H, W), capacity=4)
    pushed = [(frames[i % 3][0], frames[i % 3][1] + np.float32(0.001 * i)) for i in range(4)]
    for rgb, depth in pushed:
        tracker.push_frame(rgb, depth)
    seen = []
    records = tracker.run(poses[0], on_pose=seen.append, max_frames=1)
    assert len(records) == 1 and seen == records
    rec = records[0]
    assert rec.frame_index == 0 and rec.skipped_frames >= 1 and rec.latency_s > 0
    assert tracker.pushed_frames == 4 and tracker.dropped_frames == 0
    step = tm.make_packed_tracker("cube", (H, W))
    want = step(TFP.pack_frame(*pushed[-1]), poses[0]).numpy()
    np.testing.assert_allclose(rec.pose, want, rtol=0, atol=1e-6)
    tracker.close()


@pytest.mark.parametrize("depth_format,pipeline_depth", [("u16mm", 3), ("f32", 0)])
def test_run_chain_equals_track_chain(scene, models, depth_format, pipeline_depth):
    """push, then run(max_frames=1), frame after frame (every run after the
    first reuses the tracker): the poses are the track() chain's on the same
    quantized frames. u16 sensor depth passes push_frame as it is."""
    poses, frames = scene
    _, tm = models
    tracker = tasync.AsyncTracker(tm, "cube", (H, W), depth_format=depth_format)
    pose, want = poses[0], poses[0]
    for rgb, depth in frames:
        if depth_format == "u16mm":
            tracker.push_frame(rgb, np.round(depth.astype(np.float64) * 1000).astype(np.uint16))
            depth = _quantize_mm(depth)
        else:
            tracker.push_frame(rgb, depth)
        (rec,) = tracker.run(pose, max_frames=1, pipeline_depth=pipeline_depth)
        assert rec.skipped_frames == 0
        pose, want = rec.pose, tm.track(rgb, depth, want, "cube")
        np.testing.assert_allclose(pose, want, rtol=0, atol=1e-6)
    tracker.close()


def test_run_streams_from_a_producer_thread(scene, models):
    """A producer pushes while run() consumes: max_frames records, in frame
    order, each a finite pose; stop() ends an unbounded run."""
    poses, frames = scene
    _, tm = models
    tracker = tasync.AsyncTracker(tm, "cube", (H, W), capacity=2)
    halt = threading.Event()

    def producer():
        i = 0
        while not halt.is_set():
            tracker.push_frame(*frames[i % 3])
            i += 1
            halt.wait(0.002)

    prod = threading.Thread(target=producer)
    prod.start()
    try:
        records = tracker.run(poses[0], max_frames=4, pipeline_depth=2)
        assert [r.frame_index for r in records] == [0, 1, 2, 3]
        assert all(np.isfinite(r.pose).all() and r.pose.shape == (4, 4) for r in records)
        # an unbounded run ends on stop(), here from its own callback
        more = tracker.run(records[-1].pose, pipeline_depth=0,
                           on_pose=lambda r: r.frame_index == 1 and tracker.stop())
        assert [r.frame_index for r in more] == [0, 1]
        assert all(np.isfinite(r.pose).all() for r in more)
    finally:
        halt.set()
        prod.join(timeout=10)
    assert not prod.is_alive()
    assert tracker.pushed_frames >= 5
    tracker.close()


def test_push_frame_validation(models):
    _, tm = models
    tracker = tasync.AsyncTracker(tm, "cube", (H, W), depth_format="f32")
    rgb = np.zeros((H, W, 3), np.uint8)
    with pytest.raises(ValueError, match="rgb must be u8"):
        tracker.push_frame(rgb[:-1], np.zeros((H, W), np.float32))
    with pytest.raises(ValueError, match="depth must be f32"):
        tracker.push_frame(rgb, np.zeros((H, W), np.uint16))  # u16 only for u16mm
    with pytest.raises(ValueError, match="depth must be f32"):
        tracker.push_frame(rgb, np.zeros((H, W - 1), np.float32))
    tracker.close()
    with pytest.raises(KeyError):
        tasync.AsyncTracker(tm, "cube", (H, W), depth_format="f16")
    with pytest.raises(ValueError, match="capacity"):
        tasync.AsyncTracker(tm, "cube", (H, W), capacity=0)


# --- tracing -----------------------------------------------------------------

def test_trace_writes_a_timeline(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
