"""What the port's tracing costs, on the card.

    python -m foundationpose_cpp_tpu_torch.tools.trace_cost [--windows 8] [--calls 300 20]

At the benchmark's scan (``benchmark/assets/scan13k.ply``, 480x640, the
trained nets, a frame made by ``render_scene`` at ``default_pose(0.6)``):

- ``nodes``: each graph's node count (Register, Track, ``track_batch`` of
  8, the packed step), captured as the program is and with the stage
  marks patched out (``foundationpose.stage`` a no-op during the second
  model's captures); the packed step's program is unstaged, so its
  "with_events" graph is the same function captured by a staged Program;
- ``replay_us``: us a replay, with and without the event nodes, on inputs
  already on the card, the tracing off: windows of back-to-back replays
  (Track, ``track_batch`` and the packed step ``calls[0]``, Register
  ``calls[1]``), the two graphs in turns, each window's host time over its
  calls after a synchronize;
- ``recorder_us``: us a public ``track`` / ``register`` call with
  ``profiling.tracing()`` on and off, in turns, no profiler;
- ``coverage_us``: us of device time a replay (a pair of events around
  the graph's launch, behind ~25 ms of queued work, so that the host's
  launch time falls outside it) and the sum of its stages, the median of
  5 replays of each kind;
- ``off_path_us``: us of the recorder's off path of one Track call (the
  root, four steps, the Program's three spans and the checks), on the
  host;
- ``stages`` / ``spans`` (self ms) / ``bytes``: the recorder's summary of
  the last traced Track and Register windows.

Prints one JSON line with the medians and every window, the card's name
and power limit. Raises without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import time

import numpy as np
import torch

from foundationpose_cpp_tpu_torch import create_foundationpose_model
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline.programs import Program
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.tools.profile_nets import print_line
from foundationpose_cpp_tpu_torch.utils import profiling, synthetic
from foundationpose_cpp_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
KINDS = ("register", "track", "track_batch", "packed")


def _calls(model, pose, rgb, depth, mask) -> dict:
    poses = np.stack([pose] * 8)
    return {"register": lambda: model.register(rgb, depth, mask, "scan"),
            "track": lambda: model.track(rgb, depth, pose, "scan"),
            "track_batch": lambda: model.track_batch(rgb, depth, poses, "scan")}


def _programs(model) -> dict:
    return {"register": model._register_cache[("register", "scan", (480, 640), 1, False)],
            "track": model._track_cache[("track", "scan", (480, 640), 1, False)],
            "track_batch": model._track_cache[("track_batch", "scan", (480, 640), 1, 8, False)],
            "packed": model._packed_cache[("packed", "scan", (480, 640), 1, "u16mm", False)]}


def _window_us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def _turns(fns: dict, calls: int, windows: int) -> dict:
    """{name: [us a call of each window]}, the functions' windows in turns."""
    out = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            out[name].append(_window_us(fn, calls))
    return out


def _median(runs: dict) -> dict:
    return {name: statistics.median(us) for name, us in runs.items()}


def coverage_us(program, replays: int = 5) -> dict:
    """The median over ``replays`` of a replay's own device time and of its
    stages' sum, in us; raises where the launch outlasted the queued work."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    whole, stages = [], []
    for _ in range(replays):
        torch.cuda._sleep(50_000_000)
        start.record()
        program._graph.replay()
        if start.query():
            raise RuntimeError("the graph's launch outlasted the queued work")
        end.record()
        end.synchronize()
        whole.append(start.elapsed_time(end) * 1e3)
        stages.append(sum(ms for _, ms in program.stage_ms()) * 1e3)
    return {"replay": statistics.median(whole), "stages": statistics.median(stages)}


def off_path_us(reps: int = 100_000) -> float:
    """us of what a Track call runs of the recorder with it off: the root,
    four steps, the Program's three spans and four checks (the uploads',
    the Program's two, the readback's)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        with profiling.call("track"):
            for name in ("check", "upload", "program", "readback"):
                profiling.step(name)
                profiling.counting()
            for name in ("load", "replay", "clone"):
                with profiling.span(name):
                    pass
    return (time.perf_counter() - t0) * 1e6 / reps


@torch.inference_mode()
def run(windows: int = 8, calls: tuple[int, int] = (300, 20)) -> dict:
    resolve_device(None)
    asset = load_mesh("scan", str(ROOT / "benchmark" / "assets" / "scan13k.ply"))
    pose = synthetic.default_pose(0.6)
    rgb, depth, mask = synthetic.render_scene(MeshConstants.from_asset(asset, "cuda"), pose, K,
                                              480, 640)

    def model():
        return create_foundationpose_model(
            str(ROOT / "weights" / "refiner_multi_full.npz"),
            str(ROOT / "weights" / "scorer_multi_full.npz"), [asset], K, 480, 640)

    staged, bare = model(), model()
    packed = torch.from_numpy(fpp.FoundationPose.pack_frame(rgb, depth)).cuda()
    pose_dev = torch.from_numpy(pose).cuda()
    public = _calls(staged, pose, rgb, depth, mask)
    for call in public.values():
        call()  # the captures
    staged.make_packed_tracker("scan", (480, 640))(packed, pose_dev)
    saved = fpp.stage
    fpp.stage = lambda name: None
    try:
        for call in _calls(bare, pose, rgb, depth, mask).values():
            call()
        bare.make_packed_tracker("scan", (480, 640))(packed, pose_dev)
    finally:
        fpp.stage = saved
    with_events, without = _programs(staged), _programs(bare)
    # the packed step's program is unstaged: its graph with the event nodes
    # is the same function captured by a staged Program
    unstaged = with_events["packed"]
    with_events["packed"] = Program(unstaged.fn, ("packed", "staged"), "cuda", staged=True)
    with_events["packed"](packed, pose_dev)
    nodes = {k: {"with_events": with_events[k].nodes, "without": without[k].nodes} for k in KINDS}
    nodes["packed"]["as_served"] = unstaged.nodes

    frame = [torch.from_numpy(a).cuda() for a in (rgb, depth)]
    args = {"register": [*frame, torch.from_numpy((mask > 0).astype(np.uint8)).cuda()],
            "track": [*frame, pose_dev],
            "track_batch": [*frame, torch.from_numpy(np.stack([pose] * 8)).cuda()],
            "packed": [packed, pose_dev]}
    replay = {}
    for kind, n in (("track", calls[0]), ("track_batch", calls[0]), ("packed", calls[0]),
                    ("register", calls[1])):
        a = args[kind]
        replay[kind] = _turns({"with_events": lambda p=with_events[kind], a=a: p(*a),
                               "without": lambda p=without[kind], a=a: p(*a)}, n, windows)

    coverage = {k: coverage_us(with_events[k]) for k in ("register", "track", "track_batch")}
    recorder, summaries = {}, {}
    for kind, n in (("track", calls[0]), ("register", calls[1])):
        recorder[kind] = {"on": [], "off": []}
        for _ in range(windows):
            with profiling.tracing() as rec:
                recorder[kind]["on"].append(_window_us(public[kind], n))
                summaries[kind] = rec.summary()
            recorder[kind]["off"].append(_window_us(public[kind], n))
    return {
        "nodes": nodes,
        "replay_us": {k: _median(v) for k, v in replay.items()},
        "recorder_us": {k: _median(v) for k, v in recorder.items()},
        "coverage_us": coverage,
        "off_path_us": off_path_us(),
        "stages": {k: s["stages"] for k, s in summaries.items()},
        "spans": {k: {n: round(v["self_ms"], 4) for n, v in s["spans"].items()}
                  for k, s in summaries.items()},
        "bytes": {k: s["bytes"] for k, s in summaries.items()},
        "windows": {"replay_us": replay, "recorder_us": recorder},
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=8)
    parser.add_argument("--calls", type=int, nargs=2, default=(300, 20),
                        help="calls a window: Track, Register")
    args = parser.parse_args(argv)
    print_line("trace_cost", None, **run(args.windows, tuple(args.calls)))


if __name__ == "__main__":
    main()
