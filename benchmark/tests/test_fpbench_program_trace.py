"""The readers of what the program recorded (``benchmark/program_trace.py``
and the metrics that use it) on a synthetic run and a filled recorder:
their values, and None where the recorder's calls are not the slice's, the
slice ran nothing on the device, or the program has no recorder."""

from __future__ import annotations

import pathlib

import pytest

from benchmark import counts, harness, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
BYTES = {"upload_pageable": 2_150_464, "load": 2_150_464, "clone": 64, "readback": 64}
REGISTER = [("front_end", 2.0), ("render_crop", 3.0), ("refiner", 16.0), ("pose_update", 0.5),
            ("render_crop", 4.0), ("scorer", 17.0), ("select", 0.25)]
TRACK = [("xyz", 0.01), ("render_crop", 0.25), ("refiner", 0.5), ("pose_update", 0.02)]


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               f"fpbench_metric_{name}").read


def _run(calls: int, flops: float, device_ops=True) -> harness.Run:
    ops = [("k", "kernel", 10.0 * i, 5.0) for i in range(calls)] if device_ops else []
    return harness.Run(1.0, 1.0, [0.01] * 100, {"flops": flops},
                       trace.Slice(calls, 0.1, ops, []))


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder, replaced by an empty one for the test."""
    from foundationpose_cpp_tpu_torch.utils import profiling

    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return profiling, rec


def _fill(profiling, stages, calls: int, name: str) -> None:
    with profiling.tracing():
        for _ in range(calls):
            with profiling.call(name):
                for kind, n in BYTES.items():
                    profiling.count_bytes(kind, n)
                profiling.RECORDER._call.stages.extend(stages)


def test_register_readers(recorder):
    profiling, _ = recorder
    _fill(profiling, REGISTER, 8, "register")
    run = _run(8, 6.51e12)
    assert _reader("render_crop_ms.register")(run) == pytest.approx(7.0)  # both passes
    want = 100.0 * 6.51e12 / 33e-3 / counts.PEAK_BF16_FLOPS
    assert _reader("nets_mfu.register")(run) == pytest.approx(want)


@pytest.mark.parametrize("batch", [1, 8])
def test_track_readers(recorder, batch):
    profiling, _ = recorder
    _fill(profiling, TRACK, 64, "track")
    flops = counts.track_flops(batch)
    run = _run(64, flops)
    assert _reader("nets_mfu.track")(run) == pytest.approx(
        100.0 * flops / 0.5e-3 / counts.PEAK_BF16_FLOPS)
    assert _reader("copy_mb.track")(run) == pytest.approx(4.301056)


NAMES = ["render_crop_ms.register", "nets_mfu.register", "nets_mfu.track", "copy_mb.track"]


@pytest.mark.parametrize("name", NAMES)
def test_readers_return_none_when_the_calls_differ(recorder, name):
    profiling, _ = recorder
    stages = REGISTER if name.endswith("register") else TRACK
    _fill(profiling, stages, 8, "call")
    assert _reader(name)(_run(8, 1e12)) is not None
    assert _reader(name)(_run(7, 1e12)) is None  # the recorder holds a call more
    assert _reader(name)(_run(8, 1e12, device_ops=False)) is None  # a CPU run
    assert _reader(name)(harness.Run(1.0, 1.0, [0.01], {"flops": 1e12})) is None  # untraced


@pytest.mark.parametrize("name", NAMES)
def test_readers_return_none_on_a_program_without_a_recorder(recorder, monkeypatch, name):
    profiling, _ = recorder
    _fill(profiling, TRACK + REGISTER, 8, "call")
    monkeypatch.delattr(profiling, "RECORDER")
    assert _reader(name)(_run(8, 1e12)) is None
