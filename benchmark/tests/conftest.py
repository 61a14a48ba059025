"""A tiny copy of the benchmark for CPU tests: narrow seeded nets at crop 32,
120x160 frames, 36 hypotheses, short trajectories, and limits read at
that size (the program's eager CPU path against the reference, and the
control)."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"

# narrow nets: program 0.08-0.18 deg / 0.2-0.6 mm, control 1.7-2.4 deg /
# 6.9-11.9 mm at this size
TINY_LIMITS = {"pose_rot_deg": 0.6, "pose_trans_mm": 2.5, "score_gap": 0.05}


def make_tiny(dst: pathlib.Path) -> pathlib.Path:
    """Copy the benchmark to ``dst`` at a CPU test's size; returns the copy
    of the benchmark's directory."""
    from foundationpose_cpp_tpu_torch.models import convert_jax, networks

    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    narrow = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, ffn_dim=64,
                                crop_hw=32)
    scorer = networks.NetConfig(**{**narrow.__dict__, "cross_attention": True})
    convert_jax.save_npz(networks.init_net("refiner", narrow, 1).state_dict(), str(dst / "r.npz"))
    convert_jax.save_npz(networks.init_net("scorer", scorer, 2).state_dict(), str(dst / "s.npz"))
    configs = dst / "benchmark" / "configs"
    # the program's CPU path rasterizes densely: the cube keeps it short
    cube = json.loads((configs / "scan13k.json").read_text())
    cube.update(name="cube", mesh={"name": "cube", "file": "benchmark/assets/cube8cm.ply",
                                   "faces": 12})
    (configs / "cube.json").write_text(json.dumps(cube))
    for path in configs.glob("*.json"):
        c = json.loads(path.read_text())
        c.update(refiner=str(dst / "r.npz"), scorer=str(dst / "s.npz"), frame_hw=[120, 160],
                 K=[[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]], n_views=12,
                 inplane_step_deg=120,
                 nets={**c["nets"], "width1": 8, "width2": 16, "embed_dim": 64, "ffn_dim": 64,
                       "crop_hw": 32})
        path.write_text(json.dumps(c))
    for path in (dst / "benchmark" / "workloads").glob("*.json"):
        w = json.loads(path.read_text())
        w["params"]["frames"] = 2 if w["traffic"] == "register" else 4
        w["profiled_calls"] = 2
        w["limits"] = {k: TINY_LIMITS[k] for k in w["limits"]}
        if w["traffic"] in ("register", "track_batch"):
            w["config"] = "cube"
        if w["traffic"] == "track_batch":
            w["params"]["distance_m"] = 1.2
        path.write_text(json.dumps(w))
    return dst / "benchmark"


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> pathlib.Path:
    return make_tiny(tmp_path_factory.mktemp("fpbench"))


@pytest.fixture
def cuda():
    """Skips a test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
