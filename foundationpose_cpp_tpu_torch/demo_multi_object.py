"""Demo: track several instances of one mesh in one batch.

Counterpart of the JAX package's ``examples/demo_multi_object.py``. The
reference tracks one hypothesis per Track call; here N instances of a mesh
ride the leading batch axis that the 252-hypothesis Register uses
(``FoundationPose.track_batch``), so N objects cost one batch of launches a
frame. As in the JAX demo, the N poses are tracked on one synthetic frame
that shows only instance 0, with seeded random nets: it shows the batch's
cost per object, not its accuracy (``chip_smoke.py`` holds the accuracy on a
frame that shows all eight).

Usage:
    python -m foundationpose_cpp_tpu_torch.demo_multi_object [--instances N]
        [--frames M] [--hw H W] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import create_foundationpose_model
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic


def run_multi_object(
    instances: int = 8,
    frames: int = 5,
    hw: tuple[int, int] = (480, 640),
    device=None,
    config: FoundationPoseConfig | None = None,
    net_config: networks.NetConfig | None = None,
    refiner=None,
    scorer=None,
) -> dict:
    """Track ``instances`` cubes over ``frames`` calls of ``track_batch``.

    refiner / scorer: anything ``FoundationPose`` takes; None draws random
    nets of ``net_config`` from seeds 0 and 1. Returns the frame, the start
    poses, the poses after each frame ((frames, N, 4, 4)) and the ms per
    object of each call.
    """
    h, w = hw
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]], np.float32)
    cfg = config or FoundationPoseConfig()
    net_config = net_config or networks.NetConfig()
    cube = procedural.textured_cube(size=0.08)
    if refiner is None:
        refiner = networks.init_net("refiner", net_config, seed=0)
    if scorer is None:
        scorer = networks.init_net("scorer", net_config, seed=1)
    model = create_foundationpose_model(refiner, scorer, [cube], K, h, w, config=cfg,
                                        device=device)

    rng = np.random.default_rng(0)
    poses0 = np.tile(synthetic.default_pose(0.6)[None], (instances, 1, 1))
    poses0[:, :3, 3] += rng.uniform(-0.05, 0.05, (instances, 3)).astype(np.float32)
    # one shared synthetic frame (each instance would have its own crop)
    mesh = MeshConstants.from_asset(cube, model.device)
    rgb, depth, _ = synthetic.render_scene(mesh, poses0[0], K, h, w, cfg)

    print(f"tracking {instances} instances over {frames} frames...")
    t0 = time.perf_counter()
    out, ms_per_object, poses = [], [], poses0
    for i in range(frames):
        t1 = time.perf_counter()
        poses = model.track_batch(rgb, depth, poses, cube.name)
        dt = time.perf_counter() - t1
        out.append(poses)
        ms_per_object.append(dt / instances * 1e3)
        label = " (first call: kernel builds, cuDNN plans)" if i == 0 else ""
        print(f"  frame {i}: {dt * 1e3:8.1f} ms for {instances} instances"
              f" = {ms_per_object[-1]:6.2f} ms/object{label}")
    total = time.perf_counter() - t0
    print(f"done: {frames * instances / total:.1f} object-updates/s "
          f"(first call and per-call host round trips included)")
    return dict(rgb=rgb, depth=depth, poses0=poses0, poses=np.stack(out),
                ms_per_object=ms_per_object)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_multi_object(args.instances, args.frames, tuple(args.hw), args.device)


if __name__ == "__main__":
    main()
