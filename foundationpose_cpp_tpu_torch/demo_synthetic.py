"""Demo: Register + Track on a synthetic scene.

Counterpart of the JAX package's ``examples/demo_synthetic.py`` and of the
reference's foundationpose_test.test
(simple_tests/src/test_foundationpose.cpp:48-104): Register on a first
frame, draw the oriented 3-D bounding box, then Track across frames feeding
each output pose into the next. Frames come from ``render_scene``; overlays
are drawn by ``utils/viz.py`` and written by ``utils/png.py`` (no cv2).

Usage:
    python -m foundationpose_cpp_tpu_torch.demo_synthetic [--frames N]
        [--out DIR] [--mesh cube6|house|cube] [--weights DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import tempfile
import time

import numpy as np

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import create_foundationpose_model
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import metrics, png, synthetic, viz

WEIGHTS_DIR = pathlib.Path(__file__).resolve().parent.parent / "weights"
MESHES = {
    "cube6": lambda: procedural.face_colored_cube(name="cube"),
    "house": lambda: procedural.textured_house(name="cube"),
    "cube": lambda: procedural.textured_cube(size=0.1),
}


def _weights_or_init(weights_dir: str | None, kind: str, mesh_name: str, net_config, seed: int):
    """The first npz of ``weights_dir`` that fits (mesh-specific, then the
    object-generalizable family weights), else seeded random nets."""
    if weights_dir:
        for cand in (f"{kind}_{mesh_name}_full.npz", f"{kind}_cube_full.npz",
                     f"{kind}_multi_full.npz", f"{kind}.npz"):
            path = pathlib.Path(weights_dir) / cand
            if path.exists():
                print(f"  loading {kind} weights: {path}")
                return str(path)
        print(f"  (no {kind} weights under {weights_dir}; using random nets)")
    return networks.init_net(kind, net_config, seed=seed)


def gt_pose(i: int) -> np.ndarray:
    """The ground-truth trajectory: a slow rotation and drift."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = synthetic.euler_xyz_deg([25 + 3 * i, -15 + 2 * i, 40 + 5 * i])
    pose[:3, 3] = [0.02 + 0.002 * i, -0.01, 0.5 + 0.005 * i]
    return pose


def run_demo(
    frames: int = 8,
    out_dir: str | None = None,
    hw: tuple[int, int] = (480, 640),
    mesh_name: str = "cube6",
    weights_dir: str | None = str(WEIGHTS_DIR),
    device=None,
    config: FoundationPoseConfig | None = None,
    net_config: networks.NetConfig | None = None,
) -> dict:
    """Register on frame 0 and Track the rest; writes register_bbox.png and
    track_NNN.png to out_dir (default ``fp_demo`` in the temporary
    directory). Returns the poses, the ground truth and the errors."""
    out = pathlib.Path(out_dir or os.path.join(tempfile.gettempdir(), "fp_demo"))
    out.mkdir(parents=True, exist_ok=True)
    h, w = hw
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]], np.float32)
    cfg = config or FoundationPoseConfig()
    net_config = net_config or networks.NetConfig()
    asset = MESHES[mesh_name]()
    model = create_foundationpose_model(
        _weights_or_init(weights_dir, "refiner", mesh_name, net_config, 0),
        _weights_or_init(weights_dir, "scorer", mesh_name, net_config, 1),
        [asset], K, h, w, config=cfg, device=device,
    )
    mesh = MeshConstants.from_asset(asset, model.device)
    print("rendering synthetic frames...")
    scene = [synthetic.render_scene(mesh, gt_pose(i), K, h, w, cfg) for i in range(frames)]

    def overlay(name, rgb, pose):
        img = viz.draw_3d_bbox(rgb, K, model.convert_pose_mesh2bbox(pose, "cube"),
                               model.object_dimension("cube"))
        png.write_png(str(out / name), img)

    rgb, depth, mask = scene[0]
    print("Register on frame 0...")
    t0 = time.perf_counter()
    pose = model.register(rgb, depth, mask, "cube")
    print(f"  first call (kernel builds, cuDNN plans): {time.perf_counter() - t0:.1f}s")
    print("  pose:\n", np.round(pose, 4))
    overlay("register_bbox.png", rgb, pose)
    print(f"  wrote {out / 'register_bbox.png'}")
    gt0 = gt_pose(0)
    print(f"  register err: rot {metrics.rotation_error_deg(pose, gt0):.1f} deg, "
          f"t {metrics.translation_error(pose, gt0):.4f} m, "
          f"ADD-S {metrics.adds_error(pose, gt0, asset.vertices):.4f} m")

    print("Track over frames...")
    poses = [pose]
    for i, (rgb, depth, _) in enumerate(scene[1:], start=1):
        t0 = time.perf_counter()
        pose = model.track(rgb, depth, pose, "cube")
        dt = time.perf_counter() - t0
        gt_i = gt_pose(i)
        print(f"  frame {i}: {dt * 1e3:7.1f} ms  |t err| = "
              f"{metrics.translation_error(pose, gt_i):.4f} m  rot err = "
              f"{metrics.rotation_error_deg(pose, gt_i):5.1f} deg")
        overlay(f"track_{i:03d}.png", rgb, pose)
        poses.append(pose)
    print("done.")
    gts = [gt_pose(i) for i in range(frames)]
    return dict(poses=np.stack(poses), gt=np.stack(gts), out_dir=str(out),
                rot_err_deg=[metrics.rotation_error_deg(p, g) for p, g in zip(poses, gts)],
                t_err_m=[metrics.translation_error(p, g) for p, g in zip(poses, gts)])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=None, help="overlay directory (default: TMPDIR/fp_demo)")
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--mesh", default="cube6", choices=sorted(MESHES),
                    help="cube6 = face-coloured cube (committed trained weights); house = "
                         "asymmetric box and roof; cube = checkerboard texture")
    ap.add_argument("--weights", default=str(WEIGHTS_DIR),
                    help="directory of trained npz weights; '' runs with random nets")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_demo(args.frames, args.out, tuple(args.hw), args.mesh, args.weights, args.device)


if __name__ == "__main__":
    main()
