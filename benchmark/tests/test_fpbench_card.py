"""On the card (marked ``cuda``; each skips where torch sees no card):
the reference renders on the card as on the CPU, a short cell comes out
correct at its full size, and a planted fault does not."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, scene
from benchmark.reference import assets, geometry, pipeline, render

ROOT = pathlib.Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


def test_reference_renders_on_the_card_as_on_the_cpu(cuda):
    out = {}
    for dev in ("cpu", cuda):
        mesh = assets.load_mesh(str(ROOT / "benchmark" / "assets" / "scan13k.ply"), dev)
        rng = np.random.default_rng(3)
        poses = np.stack([np.eye(4, dtype=np.float32)] * 8)
        for p in poses:
            p[:3, :3] = scene.random_rotation(rng)
            p[:3, 3] = [0.0, 0.0, 0.6]
        p_t = torch.as_tensor(poses, device=dev)
        K = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], device=dev)
        tfs = geometry.crop_window_tf(p_t, K, 160, 1.2, mesh.diameter)
        clip = geometry.clip_matrix(p_t, geometry.crop_bbox(tfs, 160), K, 480, 640, 0.1, 100.0)
        out[str(dev)] = render.render_crops(mesh, p_t, clip, 160, pipeline.CFG).cpu()
    diff = (out["cpu"] - out["cuda"]).abs().amax(dim=-1)
    assert (diff > 2e-3).float().mean() < 1e-3, diff.max()


def test_a_short_cell_is_correct_on_the_card(cuda):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "track_batch.scan13k_x8", "--seed", str(2**31 + 99), "--seconds", "2",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert {"idle_share.track", "mfu.track", "kernels_per_call.track"} <= set(result["metrics"])
    assert result["device"]["busy_s"] > 0


def test_track_returning_its_hypothesis_fails_on_the_card(cuda, monkeypatch):
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    monkeypatch.setattr(FoundationPose, "track",
                        lambda self, rgb, depth, hyp, name, itr=1: np.asarray(hyp, np.float32))
    r = harness.run_cell("track.scan13k", 2**31 + 98, 1.0, False, "cuda", log=lambda m: None)
    assert not r["correct"]
