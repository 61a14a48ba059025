"""The hypothesis split's Register on 8 ranks against one process.

    python -m foundationpose_cpp_tpu_torch.tools.bench_sharded
    python -m foundationpose_cpp_tpu_torch.tools.bench_sharded --device cpu

Counterpart of the JAX package's ``tools/bench_sharded.py``, with its
configuration: the 0.1 m textured cube at ``default_pose(tz=0.5)`` in a
120x160 frame, crop 32, seeded nets of embed 64 and 4 heads (refiner seed 0,
scorer seed 1), the 252-pose grid padded to 256. It builds the kernels once,
then starts ``N_DEV`` ranks (``parallel.ranks``; rank ``r`` on
``cuda:{r % device_count}``), which time ``make_sharded_register``; rank 0
also times ``register_step`` alone on the same padded grid. Prints one JSON
line with the JAX tool's keys:

- ``platform``: "gpu" when every rank has a card of its own, "gpu-shared"
  when ranks share one (gloo between them), "cpu" under ``--device cpu``;
- ``register_ms_single`` / ``register_ms_sharded``: mean host-clock ms of a
  Register over 5 after a warm-up on the card (1 on the CPU), the card
  synchronised at the ends; ``speedup`` their ratio;
- ``collectives_fused``: the ``torch.distributed`` collectives that rank 0
  issued in one sharded Register, by name; ``collectives_unfused`` is null,
  since the port has one split, the ``shard_map`` design.

``foundationpose_cpp_tpu_torch.bench`` runs this as a subprocess for its
``details.sharded`` block.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import icosphere
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.parallel import ranks, sharding
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic
from foundationpose_cpp_tpu_torch.utils.device import resolve_device

N_DEV = 8
NET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
H, W = 120, 160


def run(device=None) -> dict:
    """Every measurement of the tool; returns its JSON object."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        cuda_build.build()  # once, before eight ranks would each start nvcc
    reps = 5 if on_card else 1  # a Register takes seconds on one CPU thread
    cfg = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=on_card)
    mesh = MeshConstants.from_asset(procedural.textured_cube(size=0.1), "cpu")
    rgb, depth, mask = synthetic.render_scene(mesh, synthetic.default_pose(tz=0.5), K, H, W, cfg)
    grid, valid = sharding.pad_grid(icosphere.make_rotation_grid(), N_DEV)
    with tempfile.TemporaryDirectory() as tmp:
        convert_jax.save_npz(networks.init_net("refiner", NET, seed=0).state_dict(),
                             f"{tmp}/refiner.npz")
        convert_jax.save_npz(networks.init_net("scorer", NET, seed=1).state_dict(),
                             f"{tmp}/scorer.npz")
        job = dict(
            device=None if on_card else "cpu",
            threads=None if on_card else 1,
            mesh=["textured_cube", {"size": 0.1}], K=K.tolist(),
            cfg=dict(crop_window_h=32, crop_window_w=32, use_bf16_models=on_card),
            refiner=f"{tmp}/refiner.npz", scorers={"scorer": f"{tmp}/scorer.npz"},
            tasks=[{"kind": "register", "scorer": "scorer", "reps": reps}],
        )
        out = ranks.run(job, dict(rgb=rgb, depth=depth, mask=mask, rot_grid=grid,
                                  hyp_valid=valid), N_DEV, tmp)
    (task,) = out[0]["meta"]["tasks"]
    if not on_card:
        platform = "cpu"
    else:
        platform = "gpu" if torch.cuda.device_count() >= N_DEV else "gpu-shared"
    print(f"[bench_sharded] {platform}, {N_DEV} ranks over {out[0]['meta']['backend']}: rank 0 "
          f"launched {task['launches']} in one sharded Register", file=sys.stderr, flush=True)
    return {
        "n_devices": N_DEV,
        "platform": platform,
        "register_ms_single": task["ref_ms"],
        "register_ms_sharded": task["ms"],
        "speedup": task["ref_ms"] / task["ms"],
        "collectives_unfused": None,
        "collectives_fused": task["collectives"],
        # ranks that share one card (or the CPU's cores) take turns on it
        "note": "ranks sharing one card or the CPU measure correctness and the "
                "collective schedule, not scaling",
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
