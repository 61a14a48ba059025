"""Runs one cell once: set-up, the timed window, the traced slice, the check
against the plain reference, and the metrics.

Everything that belongs to one cell, configuration, traffic kind or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

  workloads/<cell>.json     configuration, traffic kind, its parameters,
                            the profiled calls, the limits of the check
  configs/<config>.json     the deployment: mesh, checkpoints, camera, grid
  traffic/<kind>.py         one general generator of a kind of traffic
  metrics/<metric>.py       a reader: ``read(run) -> float | None``

The program under test is ``foundationpose_cpp_tpu_torch``, imported only
here and in the traffic generators; the reference under ``reference/`` never
imports it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "foundationpose_cpp_tpu")


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, name: str):
    """A module from a file path (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_spec(root: pathlib.Path) -> dict:
    """BENCHMARK.json beside the benchmark's directory."""
    return load_json(root.parent / "BENCHMARK.json")


def listing(root: pathlib.Path = HERE) -> dict:
    """The names the harness finds under ``root``, by kind."""
    return {
        "configs": sorted(p.stem for p in (root / "configs").glob("*.json")),
        "workloads": sorted(p.stem for p in (root / "workloads").glob("*.json")),
        "traffic": sorted(p.stem for p in (root / "traffic").glob("*.py") if p.stem != "__init__"),
        "metrics": sorted(p.stem for p in (root / "metrics").glob("*.py") if p.stem != "__init__"),
    }


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in spec[section] if "workloads" not in m or cell in m["workloads"]]


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    setup_s: float
    window_s: float
    latencies_s: list
    work: dict  # per-call counts of the traffic: flops, bounds (seconds)
    trace: object = None  # trace.Slice of the traced run

    @property
    def calls(self) -> int:
        return len(self.latencies_s)

    def p95_s(self) -> float:
        """95th percentile of every call's latency (linear between ranks)."""
        xs = sorted(self.latencies_s)
        if len(xs) == 1:
            return xs[0]
        return statistics.quantiles(xs, n=20, method="inclusive")[18]


def read_metrics(root: pathlib.Path, names: list[dict], run: Run) -> dict:
    out = {}
    for m in names:
        value = load_module(root / "metrics" / f"{m['name']}.py", f"fpbench_metric_{m['name']}") \
            .read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None, root: pathlib.Path = HERE, log=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``device``
    "cpu" runs the program's eager CPU path (tests at small sizes only)."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = benchmark_spec(root)
    wl = load_json(root / "workloads" / f"{cell}.json")
    config = load_json(root / "configs" / f"{wl['config']}.json")
    kind = load_module(root / "traffic" / f"{wl['traffic']}.py", f"fpbench_traffic_{wl['traffic']}")
    dev = torch.device(device)
    traffic = kind.Traffic(wl, config, seed, dev, root)

    traffic.make_inputs()  # frames from the reference renderer, freed after
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = traffic.build_model()
    traffic.warm_up(model)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[{cell}] set-up {setup_s:.3f} s; window {seconds} s")

    latencies, attempted, failed = [], 0, 0
    start = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        attempted += 1
        try:
            traffic.call(model, attempted - 1)
        except Exception as exc:  # a call that raises is a failed call
            failed += 1
            log(f"[{cell}] call {attempted - 1} failed: {exc!r}")
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        if c1 - start >= seconds:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[{cell}] {attempted} calls in {window_s:.3f} s, {failed} failed")

    slice_ = None
    if trace:
        from benchmark import trace as tr

        base = attempted
        slice_ = tr.profile_calls(torch, lambda i: traffic.call(model, base + i),
                                  int(wl["profiled_calls"]))
    c0 = time.perf_counter()
    outputs = traffic.program_outputs(model)  # replays the timed programs
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = traffic.reference()
    work = traffic.work(outputs, ref)
    checks = traffic.check(outputs, ref)
    del ref
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    log(f"[{cell}] check {time.perf_counter() - c0:.3f} s")

    run = Run(setup_s, window_s, latencies, work, slice_)
    section = "per_layer" if trace else "end_to_end"
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": read_metrics(root, cell_metrics(spec, cell, section), run),
        "device": device_info(torch, dev, peak, slice_),
    }
    if slice_ is not None:
        result["breakdown"] = {"device_ops": slice_.top_ops(), "idle_gaps": slice_.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return result


def device_info(torch, dev, peak: int, slice_) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if slice_ is not None:
        info["busy_s"] = slice_.busy_s()
        info["window_s"] = slice_.wall_s
    return info
