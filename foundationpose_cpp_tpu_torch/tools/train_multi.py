"""Train ONE object-generalizable refiner/scorer across a randomized mesh
family and evaluate on objects the trainer never saw.

The port's counterpart of ``tools/train_multi.py``, with its flags and
defaults: one (refiner, scorer) pair over ``meshio.family``'s generators
(``training/multi.py``: one object drawn per optimizer step), saved as bf16
npz checkpoints in the JAX package's format, and Register accuracy on unseen
seeds of the training generators, the held-out "wedge" generator and the
fixed house / cube6 assets, written as ``eval_<tag>.json``. Runs on the card
unless ``--device cpu``.

Usage:
  python -m foundationpose_cpp_tpu_torch.tools.train_multi --out weights/
  python -m foundationpose_cpp_tpu_torch.tools.train_multi --objects 8 \\
      --refiner-steps 400 --scorer-steps 300 --eval-scenes 2        # quick run
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.meshio import family, procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.tools.train_synthetic import SMALL_NET, evaluate
from foundationpose_cpp_tpu_torch.training import multi
from foundationpose_cpp_tpu_torch.training import synthetic as tr
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


def eval_assets(n_unseen_seeds: int, n_wedge: int):
    """(label, asset) eval set; all objects unseen by the trainer."""
    out = []
    for i in range(n_unseen_seeds):
        # seeds far outside the training range; generator drawn as in training
        out.append(("unseen_seed", family.random_family_asset(20_000 + 17 * i)))
    for i in range(n_wedge):
        out.append(("heldout_wedge", family.random_family_asset(
            30_000 + 13 * i, generator="wedge", diameter=family.FAMILY_DIAMETER)))
    out.append(("fixed_house", procedural.textured_house(name="house")))
    out.append(("fixed_cube6", procedural.face_colored_cube(name="cube6")))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=32, help="training objects (family seeds 0..N-1)")
    ap.add_argument("--net", default="full", choices=["full", "small"])
    ap.add_argument("--refiner-steps", type=int, default=8000)
    ap.add_argument("--scorer-steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--scorer-lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="weights")
    ap.add_argument("--tag", default="multi")
    ap.add_argument("--eval-scenes", type=int, default=12)
    ap.add_argument("--eval-unseen", type=int, default=4)
    ap.add_argument("--eval-wedge", type=int, default=2)
    ap.add_argument("--eval-refine-itr", type=int, default=1)
    ap.add_argument("--skip-refiner", action="store_true")
    ap.add_argument("--skip-scorer", action="store_true")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--no-cross-attention", action="store_true",
                    help="train a plain ScoreNet instead of MultiPair")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FoundationPoseConfig()
    net_cfg = networks.NetConfig() if args.net == "full" else SMALL_NET
    tcfg = tr.SyntheticTrainConfig(batch=args.batch, lr=args.lr)

    def log(msg):
        print(msg, flush=True)

    log(f"building mesh bank: {args.objects} objects ...")
    bank = multi.build_mesh_bank([family.random_family_asset(s) for s in range(args.objects)],
                                 device=device)
    gens = sorted({n.split("_")[0] for n in bank.names})
    log(f"bank: {bank.n_objects} objects, "
        f"{sum(m.faces.shape[0] for m in bank.meshes)} faces, generators {gens}")

    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.tag}_{args.net}"
    t0 = time.perf_counter()
    path_r = os.path.join(args.out, f"refiner_{tag}.npz")
    if not args.skip_refiner:
        log(f"training refiner_{tag} ({args.refiner_steps} steps, batch {tcfg.batch})...")
        net_r = multi.train_refiner_multi(bank, cfg, net_cfg, tcfg, steps=args.refiner_steps,
                                          seed=args.seed, log=log)
        tr.save_bf16(net_r, path_r)
        log(f"saved {path_r}")
        refiner = path_r
    elif os.path.exists(path_r):
        log(f"loading existing {path_r}")
        refiner = path_r
    else:
        refiner = networks.init_net("refiner", net_cfg, args.seed)

    path_s = os.path.join(args.out, f"scorer_{tag}.npz")
    if not args.skip_scorer:
        tcfg_s = tr.SyntheticTrainConfig(batch=args.batch, lr=args.scorer_lr)
        net_cfg_s = dataclasses.replace(net_cfg, cross_attention=not args.no_cross_attention)
        log(f"training scorer_{tag} ({args.scorer_steps} steps, lr {args.scorer_lr}, "
            f"cross_attention={net_cfg_s.cross_attention})...")
        net_s = multi.train_scorer_multi(bank, cfg, net_cfg_s, tcfg_s, steps=args.scorer_steps,
                                         seed=args.seed + 1, log=log)
        tr.save_bf16(net_s, path_s)
        log(f"saved {path_s}")
        scorer = path_s
    elif os.path.exists(path_s):
        log(f"loading existing {path_s}")
        scorer = path_s
    else:
        scorer = networks.init_net("scorer", net_cfg, args.seed + 1)

    log(f"training done in {time.perf_counter() - t0:.0f}s")
    if args.skip_eval:
        return
    report = {}
    for label, asset in eval_assets(args.eval_unseen, args.eval_wedge):
        name = f"{label}:{asset.name}"
        log(f"evaluating {name} ({args.eval_scenes} scenes)...")
        r = evaluate(asset, refiner, scorer, cfg, tcfg, args.eval_scenes, args.seed,
                     refine_itr=args.eval_refine_itr, device=device)
        if "register_rot_deg" in r:
            log(f"  {name}: rot {r['register_rot_deg']:.2f} deg "
                f"(median {r['register_rot_deg_median']:.2f}), "
                f"ADD-S {r['register_adds'] * 1000:.2f} mm, "
                f"flips {r['register_flips']}/{r['n_scenes']}")
        else:
            log(f"  {name}: every scene failed to register")
        report[name] = r
    report["_meta"] = {
        "objects": args.objects, "refiner_steps": args.refiner_steps,
        "scorer_steps": args.scorer_steps, "net": args.net,
        "refine_itr": args.eval_refine_itr, "tag": tag,
    }
    out_json = os.path.join(args.out, f"eval_{tag}.json")
    with open(out_json, "w") as fh:
        json.dump(report, fh, indent=2)
    log(f"wrote {out_json}")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
