"""The harness: BENCHMARK.json against the contract it is written to, the
import guard, a cell added by files alone, and the check failing on the
faults a cell can have (on the CPU, at the tiny size of conftest.py)."""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import types

import numpy as np

from benchmark import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_meets_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    assert all(_line(w) for w in spec["command"]) and len(spec["command"]) <= 32
    found = harness.listing(ROOT / "benchmark")
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["name"] in found["workloads"] and w["traffic"] in found["traffic"]
        data = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert (data["config"], data["traffic"], data["why"]) == (w["config"], w["traffic"],
                                                                  w["why"])
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
            names.add(m["name"])
            assert m["better"] in ("lower", "higher") and m["name"] in found["metrics"]
            assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and "workloads" in m
        layers.add(m["layer"])
        for cell in m["workloads"]:
            assert any(e["name"] == m["moves"] for e in harness.cell_metrics(spec, cell,
                                                                               "end_to_end"))
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"| {layer} |" in perf for layer in layers), layers
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in spec["end_to_end"])
    for cell in cells:
        assert len(harness.cell_metrics(spec, cell, "end_to_end")) >= 2
        assert harness.cell_metrics(spec, cell, "per_layer")
    assert len(json.dumps(spec)) < 64 * 1024


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "foundationpose_cpp_tpu_torch_extra",
                        types.ModuleType("x"))
    assert harness.forbidden_loaded() == [] or all(
        n.split(".")[0] in harness.FORBIDDEN_MODULES for n in harness.forbidden_loaded())
    before = set(harness.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "foundationpose_cpp_tpu.fake", types.ModuleType("y"))
    assert set(harness.forbidden_loaded()) - before == {"foundationpose_cpp_tpu.fake"}


def test_a_cpu_cell_loads_no_jax_in_a_fresh_process(tiny):
    code = (
        "import json, sys, pathlib\n"
        "from benchmark import harness\n"
        f"r = harness.run_cell('track.scan13k', 2**31 + 11, 0.5, True, 'cpu', "
        f"root=pathlib.Path({str(tiny)!r}), log=lambda m: None)\n"
        "assert r['correct'], r\n"
        "print(json.dumps(harness.forbidden_loaded()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "benchmark", alone / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    for cwd in (ROOT, alone):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                              "track.scan13k", "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=600)
        assert out.returncode != 0 and not out.stdout.strip()


def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_a_traffic_kind_and_a_metric_are_added_by_files_alone(tiny, tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(tiny, root)
    shutil.copy(tiny.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(root)
    (root / "traffic" / "track_slow.py").write_text(
        '"""Track with two refinement iterations a call."""\n'
        "from benchmark.traffic import track\n\n\n"
        "class Traffic(track.Traffic):\n"
        "    def __init__(self, wl, config, seed, device, root):\n"
        "        super().__init__(wl, {**config, 'refine_itr': 2}, seed, device, root)\n")
    (root / "metrics" / "calls_in_window.py").write_text(
        '"""Calls completed in the window."""\n\n\ndef read(run):\n    return run.calls\n')
    cell = json.loads((root / "workloads" / "track.scan13k.json").read_text())
    cell.update(name="track_slow.scan13k", traffic="track_slow")
    (root / "workloads" / "track_slow.scan13k.json").write_text(json.dumps(cell))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "track_slow.scan13k", "config": "scan13k",
                              "traffic": "track_slow", "chips": 1, "why": "two iterations"})
    spec["end_to_end"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["track_slow.scan13k"]})
    for m in spec["end_to_end"]:
        if m["name"] == "track_ms":
            m["workloads"].append("track_slow.scan13k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    found = harness.listing(root)
    assert "track_slow" in found["traffic"] and "calls_in_window" in found["metrics"]
    assert "track_slow.scan13k" in found["workloads"]
    r = harness.run_cell("track_slow.scan13k", 3, 0.5, False, "cpu", root=root,
                         log=lambda m: None)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"track_ms", "setup_s", "calls_in_window"}
    assert r["metrics"]["calls_in_window"]["value"] >= 1


def test_sound_cells_come_out_correct(tiny):
    for cell in ("register.scan13k", "track.scan13k", "track_batch.scan13k_x8"):
        r = harness.run_cell(cell, 2**31 + 5, 0.3, False, "cpu", root=tiny, log=lambda m: None)
        assert r["correct"], (cell, r["checks"])
        assert list(r)[-1] == "checks"


def _run(tiny, cell):
    return harness.run_cell(cell, 2**31 + 7, 0.3, False, "cpu", root=tiny, log=lambda m: None)


def test_track_returning_its_hypothesis_is_not_correct(tiny, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    monkeypatch.setattr(FoundationPose, "track",
                        lambda self, rgb, depth, hyp, name, itr=1: np.asarray(hyp, np.float32))
    assert not _run(tiny, "track.scan13k")["correct"]


def test_track_batch_leaving_half_the_batch_out_is_not_correct(tiny, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    real = FoundationPose.track_batch

    def half(self, rgb, depth, hyp, name, itr=1):
        k = len(hyp) // 2
        return np.concatenate([real(self, rgb, depth, hyp[:k], name, itr),
                               np.asarray(hyp[k:], np.float32)])

    monkeypatch.setattr(FoundationPose, "track_batch", half)
    assert not _run(tiny, "track_batch.scan13k_x8")["correct"]


def test_register_answering_another_hypothesis_is_not_correct(tiny, monkeypatch):
    import torch

    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp

    real = fpp.register_step

    def altered(*args, **kwargs):
        best, poses, scores, ok = real(*args, **kwargs)
        return poses[torch.argsort(scores)[-2]], poses, scores, ok

    monkeypatch.setattr(fpp, "register_step", altered)
    assert not _run(tiny, "register.scan13k")["correct"]


def test_register_refining_half_the_hypotheses_is_not_correct(tiny, monkeypatch):
    import torch

    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp

    real = fpp.refine_loop

    def half(mesh, refiner, poses, *args, **kwargs):
        k = poses.shape[0] // 2
        return torch.cat([real(mesh, refiner, poses[:k], *args, **kwargs), poses[k:]])

    monkeypatch.setattr(fpp, "refine_loop", half)
    assert not _run(tiny, "register.scan13k")["correct"]


def test_traced_cpu_run_reports_what_it_can_read(tiny):
    r = harness.run_cell("track.scan13k", 9, 0.3, True, "cpu", root=tiny, log=lambda m: None)
    # no device operations on the CPU: the device readers return nothing
    assert set(r["metrics"]) == {"mfu.track"}
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0.0
