"""Train the refiner/scorer on synthetic render pairs and evaluate them.

The port's counterpart of ``tools/train_synthetic.py``, with its flags and
defaults: it trains the published topology with the port's renderer
(``foundationpose_cpp_tpu_torch.training``), saves bf16 npz checkpoints in
the JAX package's format and reports Register/Track accuracy on held-out
synthetic scenes as the same JSON. Runs on the card unless ``--device cpu``.

Usage:
  python -m foundationpose_cpp_tpu_torch.tools.train_synthetic --out weights/
  python -m foundationpose_cpp_tpu_torch.tools.train_synthetic --net small \\
      --refiner-steps 800 --scorer-steps 600 --eval-scenes 4      # quick run
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import icosphere
from foundationpose_cpp_tpu_torch.meshio import mesh_loader, procedural
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import register_step, track_step
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.training import synthetic as tr
from foundationpose_cpp_tpu_torch.utils import metrics
from foundationpose_cpp_tpu_torch.utils.device import resolve_device

SMALL_NET = networks.NetConfig(width1=32, width2=64, embed_dim=256, ffn_dim=256)


def build_mesh(name: str):
    if name == "cube":
        return procedural.textured_cube(size=0.1)
    if name == "cube6":
        # face-colored, pose-unique (the checkerboard cube is symmetric
        # under 90-degree rotations)
        return procedural.face_colored_cube(name="cube")
    if name == "house":
        # box + roof prism: no rotational symmetry
        return procedural.textured_house(name="house")
    if name == "sphere":
        return procedural.textured_uv_sphere(radius=0.05, n_lat=24, n_lon=32)
    return mesh_loader.load_mesh(name)


def inference_net(net, kind: str, device):
    """A module, a state_dict or an npz path -> a fresh bf16 inference module
    on ``device`` with the default attention (the kernel on the card); a
    module passed in is left as it is (``as_net`` casts a module in place)."""
    if isinstance(net, torch.nn.Module):
        net = {k: v.detach() for k, v in net.state_dict().items()}
    return convert_jax.as_net(net, kind, device, torch.bfloat16)


@torch.inference_mode()
def evaluate(asset, refiner, scorer, cfg: FoundationPoseConfig, tcfg: tr.SyntheticTrainConfig,
             n_scenes: int, seed: int, refine_itr: int = 1, device=None) -> dict:
    """Register + 3 Track iterations on ``n_scenes`` held-out scenes
    rendered by ``render_observed``; the JAX tool's metric dict.
    refiner / scorer: modules, state_dicts or npz paths, run in bf16."""
    device = resolve_device(device)
    mesh = MeshConstants.from_asset(asset, device)
    refiner = inference_net(refiner, "refiner", device)
    scorer = inference_net(scorer, "scorer", device)
    K = torch.as_tensor(tr.default_intrinsics(tcfg), device=device)
    rot_grid = torch.as_tensor(icosphere.make_rotation_grid(), device=device)
    gen = torch.Generator().manual_seed(seed + 777)
    pts = np.asarray(asset.vertices)
    rows, failures = [], 0
    for _ in range(n_scenes):
        gt = tr.sample_scene_poses(gen, 1, tcfg).to(device)
        rgb, depth = tr.render_observed(mesh, gt, K, tcfg.frame_hw, tcfg.frame_hw, cfg)
        rgb, depth = rgb[0], depth[0]
        mask = (depth > 0).to(torch.uint8) * 255
        best, _, _, ok = register_step(mesh, refiner, scorer, rgb, depth, mask, rot_grid, K,
                                       refine_itr, cfg)
        best_np = best.cpu().numpy()
        if not bool(ok) or not np.isfinite(best_np).all():
            # a failed translation guess poisons the pose with NaN
            failures += 1
            continue
        # track from the registered pose on the same frame (3 iterations
        # stand for 3 tracked frames of a static scene)
        tracked = track_step(mesh, refiner, rgb, depth, best[None], K, 3, cfg)[0].cpu().numpy()
        g = gt[0].cpu().numpy()
        row = {
            "register_rot_deg": metrics.rotation_error_deg(best_np, g),
            "register_t_err": metrics.translation_error(best_np, g),
            "register_adds": metrics.adds_error(best_np, g, pts),
            "tracked_rot_deg": metrics.rotation_error_deg(tracked, g),
            "tracked_t_err": metrics.translation_error(tracked, g),
            "tracked_adds": metrics.adds_error(tracked, g, pts),
        }
        if getattr(asset, "symmetries", None) is not None:
            # a declared-symmetry flip is not an error for this object
            row["register_rot_deg_sym"] = metrics.rotation_error_deg_sym(best_np, g, asset.symmetries)
            row["tracked_rot_deg_sym"] = metrics.rotation_error_deg_sym(tracked, g, asset.symmetries)
        rows.append(row)
    if not rows:
        return {"n_scenes": n_scenes, "register_failures": failures,
                "diameter": float(asset.diameter)}
    out = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    for k in ("register_rot_deg", "tracked_rot_deg"):
        out[k + "_median"] = float(np.median([r[k] for r in rows]))
    # flips the scorer failed to reject, on the symmetry-aware geodesic
    # where the asset declares symmetries
    out["register_flips"] = int(
        sum(r.get("register_rot_deg_sym", r["register_rot_deg"]) > 45.0 for r in rows)
    )
    out["n_scenes"] = n_scenes
    out["register_failures"] = failures
    out["diameter"] = float(asset.diameter)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="cube", help="cube | cube6 | house | sphere | path.obj")
    ap.add_argument("--net", default="full", choices=["full", "small"])
    ap.add_argument("--refiner-steps", type=int, default=4000)
    ap.add_argument("--scorer-steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--scorer-lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="weights")
    ap.add_argument("--eval-scenes", type=int, default=8)
    ap.add_argument("--eval-refine-itr", type=int, default=1)
    ap.add_argument("--skip-refiner", action="store_true")
    ap.add_argument("--skip-scorer", action="store_true")
    ap.add_argument("--cross-attention", action="store_true",
                    help="train the scorer as ScoreNetMultiPair")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FoundationPoseConfig()
    net_cfg = networks.NetConfig() if args.net == "full" else SMALL_NET
    tcfg = tr.SyntheticTrainConfig(batch=args.batch, lr=args.lr)
    asset = build_mesh(args.mesh)
    mesh = MeshConstants.from_asset(asset, device)
    os.makedirs(args.out, exist_ok=True)
    tag = f"{os.path.splitext(os.path.basename(args.mesh))[0]}_{args.net}"

    def log(msg):
        print(msg, flush=True)

    t0 = time.perf_counter()
    path_r = os.path.join(args.out, f"refiner_{tag}.npz")
    if not args.skip_refiner:
        log(f"training refiner ({args.refiner_steps} steps, batch {tcfg.batch}, "
            f"mesh {args.mesh}, net {args.net})...")
        net_r = tr.train_refiner(mesh, cfg, net_cfg, tcfg, steps=args.refiner_steps,
                                 seed=args.seed, log=log)
        tr.save_bf16(net_r, path_r)
        log(f"saved {path_r}")
        refiner = path_r
    elif os.path.exists(path_r):
        log(f"loading existing {path_r} for eval")
        refiner = path_r
    else:
        refiner = networks.init_net("refiner", net_cfg, args.seed)

    path_s = os.path.join(args.out, f"scorer_{tag}.npz")
    if not args.skip_scorer:
        log(f"training scorer ({args.scorer_steps} steps, lr {args.scorer_lr})...")
        tcfg_s = tr.SyntheticTrainConfig(batch=args.batch, lr=args.scorer_lr)
        net_cfg_s = dataclasses.replace(net_cfg, cross_attention=args.cross_attention)
        net_s = tr.train_scorer(mesh, cfg, net_cfg_s, tcfg_s, steps=args.scorer_steps,
                                seed=args.seed + 1, log=log)
        tr.save_bf16(net_s, path_s)
        log(f"saved {path_s}")
        scorer = path_s
    elif os.path.exists(path_s):
        log(f"loading existing {path_s} for eval")
        scorer = path_s
    else:
        scorer = networks.init_net("scorer", net_cfg, args.seed + 1)

    if args.eval_scenes <= 0:
        log(f"training done in {time.perf_counter() - t0:.0f}s (eval skipped)")
        return
    log(f"training done in {time.perf_counter() - t0:.0f}s; evaluating on "
        f"{args.eval_scenes} held-out scenes...")
    report = evaluate(asset, refiner, scorer, cfg, tcfg, args.eval_scenes, args.seed,
                      refine_itr=args.eval_refine_itr, device=device)
    report["net"] = args.net
    report["mesh"] = args.mesh
    report["refine_itr"] = args.eval_refine_itr
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
