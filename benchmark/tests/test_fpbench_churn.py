"""The cell over a changing set of objects (``track_batch_churn``) on the
CPU, at the tiny size of conftest.py with the three small meshes of
``test_fpbench_mixed.py`` in place of LM-O's eight and a set that changes
at almost every call: the traffic end to end through the harness, three
planted faults that its check must catch, the churn process, the check's
sample and the captures reader."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.test_fpbench_mixed import mixed  # noqa: F401  (a fixture)

CELL = "track_batch_churn.lmo8"
# the window's first call tracks objects (1, 2), a set the warm-up (first N
# objects) never met, so each planted fault shows from the first call on: the
# CPU's plain render takes 0.1-1.5 s a call, and a 1 s window may hold one
SEED = 2**31 + 10


def _traffic_module():
    return harness.load_module(harness.HERE / "traffic" / "track_batch_churn.py",
                               "fpbench_test_churn")


@pytest.fixture(scope="module")
def churn(mixed):  # noqa: F811  (the fixture imported above)
    """The tiny benchmark with three objects, and the churn cell losing and
    returning objects at half the calls, so that sets other than the
    warm-up's come up in a short window. The cell's configuration takes
    the three objects of the mixed cell's."""
    lmo8 = json.loads((mixed / "configs" / "lmo8.json").read_text())
    config_path = mixed / "configs" / "lmo8_churn.json"
    config = json.loads(config_path.read_text())
    config.update({k: lmo8[k] for k in ("meshes", "refiner", "scorer")})
    config_path.write_text(json.dumps(config))
    path = mixed / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["params"].update(objects=3, grid=3, lose_p=0.5, return_p=0.5)
    path.write_text(json.dumps(cell))
    assert _traffic_module().Churn(3, 0.5, 0.5, SEED).step() == (1, 2)
    return mixed


def _run(root, seed=SEED, trace=False):
    return harness.run_cell(CELL, seed, 1.0, trace, "cpu", root=root, log=lambda m: None)


def test_the_churn_cell_runs_end_to_end_and_is_correct(churn):
    r = _run(churn)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"track_ms", "track_p95_ms", "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    traced = _run(churn, seed=6, trace=True)
    # no device operations on the CPU: the host clock's metric and the
    # program's capture count read (the CPU runs programs eagerly: none)
    assert set(traced["metrics"]) == {"mfu.track", "captures_per_kcall.track_churn"}
    assert traced["metrics"]["captures_per_kcall.track_churn"]["value"] == 0.0


def test_a_program_that_keeps_the_first_set_of_each_n_is_not_correct(churn, monkeypatch):
    """Each N renders the meshes of the first names it met (the warm-up's),
    as a graph that captured its names by value would."""
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshSet

    real, first = MeshSet.indices, {}

    def frozen(self, names):
        return first.setdefault(len(names), real(self, names))

    monkeypatch.setattr(MeshSet, "indices", frozen)
    assert not _run(churn)["correct"]


def test_two_objects_indices_swapped_is_not_correct(churn, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshSet

    real = MeshSet.indices

    def swapped(self, names):
        idx = real(self, names)
        idx[[0, -1]] = idx[[-1, 0]]
        return idx

    monkeypatch.setattr(MeshSet, "indices", swapped)
    assert not _run(churn)["correct"]


def test_one_object_returned_unrefined_is_not_correct(churn, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    real = FoundationPose.track_batch

    def one_left(self, rgb, depth, hyp, names, itr=1):
        out = real(self, rgb, depth, hyp, names, itr)
        out[-1] = np.asarray(hyp[-1], np.float32)
        return out

    monkeypatch.setattr(FoundationPose, "track_batch", one_left)
    assert not _run(churn)["correct"]


def test_the_churn_is_seeded_never_empty_and_near_its_mean():
    churn = _traffic_module().Churn
    cell = json.loads((harness.HERE / "workloads" / f"{CELL}.json").read_text())["params"]
    args = (cell["objects"], cell["lose_p"], cell["return_p"])
    seed = 2**31 + 101

    def run(c, calls):
        return [c.step() for _ in range(calls)]

    sets = run(churn(*args, seed), 10_000)
    assert sets == run(churn(*args, seed), 10_000)
    assert sets != run(churn(*args, seed + 1), 10_000)
    assert all(sets) and all(len(set(s)) == len(s) for s in sets)
    mean = np.mean([len(s) for s in sets])
    assert abs(mean - 6.4) < 0.05 * 6.4, mean
    changes = sum(a != b for a, b in zip(sets, sets[1:]))
    assert 2.0 < len(sets) / changes < 5.0  # a change about every 3 calls
    # an object that returns joins the end of the set; the rest keep their order
    for a, b in zip(sets, sets[1:]):
        kept = [j for j in a if j in b]
        assert list(b[:len(kept)]) == kept
    # objects lost at nearly every call: the one lost longest comes back
    rare = run(churn(cell["objects"], 0.95, 0.01, seed), 2_000)
    assert all(rare) and min(len(s) for s in rare) == 1


def test_the_check_sample_is_even_and_holds_every_n():
    traffic = _traffic_module().Traffic
    window = [(0, 0, (0,) * (1 + (i % 7 == 0)) if i != 3000 else (0, 1, 2), None)
              for i in range(5000)]
    picked = traffic.sample(window)
    assert len(picked) >= 256 and picked == sorted(set(picked))
    assert {len(window[i][2]) for i in picked} == {1, 2, 3} and 3000 in picked
    short = window[:40]
    assert traffic.sample(short) == list(range(40))
    assert traffic.sample([]) == []


def test_the_captures_reader_reads_the_programs_count_alone():
    from benchmark import trace

    reader = harness.load_module(harness.HERE / "metrics" / "captures_per_kcall.track_churn.py",
                                 "fpbench_test_captures")
    run = harness.Run(1.0, 1.0, [0.001] * 10, {"flops": 1.0}, trace.Slice(2, 0.1, [], []))
    assert reader.read(run) is None  # a program that counts no captures
    run.work.update(window_captures=3, window_calls=1500)
    assert reader.read(run) == pytest.approx(2.0)
    run.work.update(window_captures=0)
    assert reader.read(run) == 0.0
