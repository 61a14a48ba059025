"""Register + Track an RGB-D sequence in the reference mustard0 layout.

Counterpart of the JAX package's ``examples/demo_dataset.py`` and of the
reference's flagship test (simple_tests/src/test_foundationpose.cpp:48-104):
load cam_K.txt and the textured mesh, Register on the first frame with its
mask, Track every following frame from the previous pose, write per-frame
poses and 3-D bbox overlays, and report ADD / ADD-S when ground-truth poses
are present. Runs on the card unless ``--device cpu``; reads and writes
images without PIL or cv2 (``utils/png.py``).

Expected layout (reference test_data/download.md:5-16):

    <root>/cam_K.txt      3x3 intrinsics, whitespace separated
    <root>/rgb/*.png      8-bit color
    <root>/depth/*.png    16-bit depth in millimeters
    <root>/masks/*.png    binary mask (only the first frame's is required)
    <root>/mesh/*.obj     textured mesh
    <root>/annotated_poses/*.txt   optional 4x4 GT poses (ADD/ADD-S report)

Usage:
    python -m foundationpose_cpp_tpu_torch.demo_dataset ROOT [--out DIR]
        [--max-frames N] [--refiner r.npz --scorer s.npz] [--video out.mp4]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

import numpy as np

from foundationpose_cpp_tpu_torch.meshio import mesh_loader
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import create_foundationpose_model
from foundationpose_cpp_tpu_torch.utils import io, metrics, png, viz


def _load_pose_dir(root: pathlib.Path, frame_ids: list[str]) -> dict[str, np.ndarray]:
    """Optional per-frame GT poses: <root>/annotated_poses/<frame_id>.txt."""
    gt = {}
    for sub in ("annotated_poses", "ob_in_cam", "gt_poses"):
        d = root / sub
        if d.is_dir():
            for fid in frame_ids:
                p = d / f"{fid}.txt"
                if p.exists():
                    gt[fid] = np.loadtxt(p, dtype=np.float64).reshape(4, 4)
            break
    return gt


def run_dataset(
    root: str,
    out_dir: str | None = None,
    max_frames: int | None = None,
    refiner=None,
    scorer=None,
    video_path: str | None = None,
    refine_itr: int = 1,
    write_overlays: bool = True,
    config=None,
    net_config: networks.NetConfig | None = None,
    device=None,
) -> dict:
    """Drive a mustard0-layout directory end to end; returns a summary dict.

    refiner / scorer: anything ``FoundationPose`` takes (a module, a
    converted state_dict or a ``weights/*_full.npz`` path); None draws
    random nets of ``net_config`` from seeds 0 and 1. out_dir defaults to
    ``fp_dataset`` in the temporary directory. device: None is the card.
    """
    root_p = pathlib.Path(root)
    out_p = pathlib.Path(out_dir or os.path.join(tempfile.gettempdir(), "fp_dataset"))
    out_p.mkdir(parents=True, exist_ok=True)

    K = io.read_cam_k(str(root_p / "cam_K.txt"))
    meshes = sorted((root_p / "mesh").glob("*.obj")) + sorted((root_p / "mesh").glob("*.ply"))
    if not meshes:
        raise FileNotFoundError(f"no mesh under {root_p / 'mesh'}")
    asset = mesh_loader.load_mesh("target", str(meshes[0]))

    frame_ids = io.list_frame_ids(str(root_p))
    if not frame_ids:
        raise FileNotFoundError(f"no frames under {root_p / 'rgb'}")
    if max_frames is not None:
        frame_ids = frame_ids[:max_frames]
    rgb0, depth0, mask0 = io.read_frame(str(root_p), frame_ids[0], with_mask=True)
    h, w = rgb0.shape[:2]

    net_config = net_config or networks.NetConfig()
    if refiner is None:
        print(
            "[demo_dataset] WARNING: no --refiner checkpoint; running with "
            "RANDOM weights -- poses will not be accurate."
        )
        refiner = networks.init_net("refiner", net_config, seed=0)
    if scorer is None:
        scorer = networks.init_net("scorer", net_config, seed=1)
    kwargs = {"device": device}
    if config is not None:
        kwargs["config"] = config
    model = create_foundationpose_model(refiner, scorer, [asset], K, h, w, **kwargs)

    gt_poses = _load_pose_dir(root_p, frame_ids)
    dim = model.object_dimension("target")
    poses: dict[str, np.ndarray] = {}
    overlays = []

    print(f"[demo_dataset] Register on frame {frame_ids[0]} ({h}x{w})...")
    t0 = time.perf_counter()
    pose = model.register(rgb0, depth0, mask0, "target", refine_itr=refine_itr)
    print(f"  register: {(time.perf_counter() - t0) * 1e3:.1f} ms (first call)")
    poses[frame_ids[0]] = pose

    def _emit(fid, rgb, pose):
        np.savetxt(out_p / f"pose_{fid}.txt", pose, fmt="%.8f")
        if write_overlays:
            img = viz.draw_3d_bbox(rgb, K, model.convert_pose_mesh2bbox(pose, "target"), dim)
            overlays.append(img)
            png.write_png(str(out_p / f"bbox_{fid}.png"), img)

    _emit(frame_ids[0], rgb0, pose)

    print(f"[demo_dataset] Track over {len(frame_ids) - 1} frames...")
    dts = []
    for fid in frame_ids[1:]:
        rgb, depth = io.read_frame(str(root_p), fid)
        t0 = time.perf_counter()
        pose = model.track(rgb, depth, pose, "target", refine_itr=refine_itr)
        dts.append(time.perf_counter() - t0)
        poses[fid] = pose
        _emit(fid, rgb, pose)

    if video_path and overlays:
        try:
            import cv2  # only for the optional video; nothing else needs it

            vw = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), 15, (w, h))
            for img in overlays:
                vw.write(img[..., ::-1])
            vw.release()
            print(f"[demo_dataset] wrote {video_path}")
        except ImportError:
            print("[demo_dataset] cv2 unavailable; skipping video")

    summary: dict = {
        "frames": len(frame_ids),
        "register_frame": frame_ids[0],
        "track_ms_mean": float(np.mean(dts) * 1e3) if dts else None,
        "out_dir": str(out_p),
    }
    if gt_poses:
        pts = asset.vertices
        add = [metrics.add_error(poses[f], gt_poses[f], pts) for f in frame_ids if f in gt_poses]
        adds = [metrics.adds_error(poses[f], gt_poses[f], pts) for f in frame_ids if f in gt_poses]
        summary.update(
            gt_frames=len(add),
            add_mean=float(np.mean(add)),
            adds_mean=float(np.mean(adds)),
            add_auc=metrics.add_auc(np.asarray(add)),
            adds_auc=metrics.add_auc(np.asarray(adds)),
        )
        print(
            f"[demo_dataset] ADD {summary['add_mean']:.4f} m | "
            f"ADD-S {summary['adds_mean']:.4f} m | "
            f"AUC(ADD-S) {summary['adds_auc']:.3f} over {len(add)} GT frames"
        )
    (out_p / "summary.json").write_text(json.dumps(summary, indent=2))
    print(f"[demo_dataset] summary -> {out_p / 'summary.json'}")
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="dataset root (mustard0 layout)")
    ap.add_argument("--out", default=None, help="output directory (default: TMPDIR/fp_dataset)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--refiner", help="refiner .npz (weights/refiner_multi_full.npz)")
    ap.add_argument("--scorer", help="scorer .npz (weights/scorer_multi_full.npz)")
    ap.add_argument("--video", help="write an overlay MP4 to this path (needs cv2)")
    ap.add_argument("--refine-itr", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run_dataset(args.root, args.out, args.max_frames, args.refiner, args.scorer, args.video,
                args.refine_itr, device=args.device)


if __name__ == "__main__":
    main()
