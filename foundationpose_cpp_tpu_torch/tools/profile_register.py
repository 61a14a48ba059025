"""Stage-level time of Register on the card (perf harness).

    python -m foundationpose_cpp_tpu_torch.tools.profile_register [--iters 8]
    python -m foundationpose_cpp_tpu_torch.tools.profile_register --device cpu --n 2 --crop 32 --hw 120 160 --iters 1

Counterpart of the JAX package's ``tools/profile_register.py``, with its
scene (the 6016-face UV sphere at ``default_pose(tz=0.6)`` in a 480x640
frame made by ``render_scene``, K = (600, 600, w/2, h/2), seeded nets at the
default ``NetConfig``: refiner seed 0, scorer seed 1 with ``att_cross``) and
its labels:

- ``pre (filters+guess+xyz)``: erode, bilateral filter, translation guess
  and xyz map (``ops/depth.py``);
- ``render_and_transform x252``: the crop and clip matrices, the render
  kernel, the two observed-crop warps and the pointcloud threshold;
- ``fused render (all)``: the crop and clip matrices and the render kernel
  (``render_branch``), and ``render kernel alone (K2)``: the kernel on
  clip matrices made before the timed calls;
- ``fused prepass+phase1`` and ``fused prepass only``: null, since the
  render kernel has no separate prepass (its vertex pass and its raster
  pass are one call of ``render_views``);
- ``observed warps x252``: the crop matrices and ``warp_crop_linear_u8`` /
  ``warp_crop_nearest_f32`` (the counterparts of the JAX ``_mxu`` warps);
- ``refiner fwd 252``, ``scorer fwd 252``: the nets on crops made on the
  device, and ``FULL register``: ``register_step`` at refine_itr 1.

Every stage runs on ``iters`` distinct stacked inputs (poses moved by 1e-6
x i, depths by 1e-7 x i, fresh crops), after a warm-up, timed by CUDA
events around the queued calls. ``FULL register`` is then run again
``iters`` times under ``torch.profiler``: ``FULL register kernel ms`` is
the card's kernel time a Register and ``FULL register busy share`` that
over ``FULL register`` (both null on the CPU). The nets compute in bf16 on
the card, in f32 on the CPU. Ends with one JSON line with the card's name
and power limit. Without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import icosphere, transforms
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.ops import warp
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import register_step
from foundationpose_cpp_tpu_torch.pipeline.renderer import (
    MeshConstants,
    render_and_transform,
    render_branch,
)
from foundationpose_cpp_tpu_torch.tools.profile_nets import print_line, seeded_net, timer, uniform
from foundationpose_cpp_tpu_torch.utils import synthetic
from foundationpose_cpp_tpu_torch.utils.device import resolve_device

NO_PREPASS = ("fused prepass+phase1", "fused prepass only")


def register_kernel_ms(fn, stacks, iters: int) -> float | None:
    """The card's kernel time per call of fn over the stacks, summed by
    ``torch.profiler`` (None when it saw no device activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(iters):
            fn(*(s[i] for s in stacks))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.self_device_time_total for e in kernels) / iters / 1e3


@torch.inference_mode()
def run(device=None, iters: int = 8, n: int | None = None, crop: int = 160, hw=(480, 640),
        net_cfg: networks.NetConfig | None = None) -> dict:
    """Every stage's ms a call, keyed by the JAX tool's labels (null for the
    two prepass stages), with the render kernel alone and, on the card, the
    full Register's kernel time and busy share. ``n``: the first n
    hypotheses of the rotation grid (None: all 252)."""
    dev = resolve_device(device)
    h, w = hw
    cfg = FoundationPoseConfig(crop_window_h=crop, crop_window_w=crop,
                               use_bf16_models=dev.type == "cuda")
    net_cfg = net_cfg or networks.NetConfig(crop_hw=crop)
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]], np.float32)
    Kt = torch.as_tensor(K, device=dev)
    sphere = procedural.textured_uv_sphere(radius=0.05, n_lat=48, n_lon=64)
    mesh = MeshConstants.from_asset(sphere, dev)
    gt = synthetic.default_pose(tz=0.6)
    rgb, depth, mask = (torch.from_numpy(a).to(dev)
                        for a in synthetic.render_scene(mesh, gt, K, h, w, cfg))
    rot_grid = torch.as_tensor(icosphere.make_rotation_grid(), device=dev)[:n]
    poses = rot_grid.clone()
    poses[:, :3, 3] = torch.as_tensor(gt[:3, 3], device=dev)
    m = poses.shape[0]
    refiner = seeded_net("refiner", dev, net_cfg, seed=0)
    scorer = seeded_net("scorer", dev, dataclasses.replace(net_cfg, cross_attention=True), seed=1)

    # stacked per-call variants, so that no call reuses another's input
    poses_stack = [poses + 1e-6 * i for i in range(iters)]
    depths = [depth + 1e-7 * i for i in range(iters)]
    xyz_map = depth_ops.depth_to_xyz(depth, Kt, cfg.min_depth)
    ch, cw = cfg.crop_window_h, cfg.crop_window_w
    out = {}
    timed = timer(dev, out)

    df = cfg.depth_filter

    def pre(depth_t):
        e = depth_ops.erode_depth(depth_t, df.erode_radius, df.erode_depth_diff_thres,
                                  df.erode_ratio_thres, df.zfar)
        f = depth_ops.bilateral_filter_depth(e, df.bilateral_radius, df.bilateral_sigma_d,
                                             df.bilateral_sigma_r, df.zfar, df.bilateral_mean_band)
        return (depth_ops.guess_translation(f, mask, Kt, cfg.min_depth),
                depth_ops.depth_to_xyz(depth_t, Kt, cfg.min_depth))

    timed("pre (filters+guess+xyz)", pre, depths)
    timed("render_and_transform x252",
          lambda p: render_and_transform(mesh, p, rgb, xyz_map, Kt, cfg.refine_crop_ratio, cfg),
          poses_stack)

    def crop_tfs(p):
        return transforms.compute_crop_window_tf(p, Kt, (ch, cw), cfg.refine_crop_ratio,
                                                 mesh.diameter)

    def clip_matrix(p):
        bbox = transforms.construct_bbox2d(crop_tfs(p), ch, cw)
        return transforms.pose_clip_matrix(p, bbox, Kt, h, w, cfg.znear, cfg.zfar)

    timed("fused render (all)", lambda p: render_branch(mesh, p, clip_matrix(p), ch, cw, cfg),
          poses_stack)
    for label in NO_PREPASS:
        out[label] = None
        print(f"{label:34s}     null (no separate prepass)")
    clips = [clip_matrix(p) for p in poses_stack]
    timed("render kernel alone (K2)", lambda p, c: render_branch(mesh, p, c, ch, cw, cfg),
          poses_stack, clips)
    del clips

    def warps(p):
        tfs = crop_tfs(p)
        return (warp.warp_crop_linear_u8(rgb, tfs, ch, cw),
                warp.warp_crop_nearest_f32(xyz_map, tfs, ch, cw))

    timed("observed warps x252", warps, poses_stack)

    gen = torch.Generator(device=dev).manual_seed(0)
    crops_a = uniform(gen, (iters, m, crop, crop, 6), torch.float32)
    crops_b = uniform(gen, (iters, m, crop, crop, 6), torch.float32)
    timed("refiner fwd 252", refiner, crops_a, crops_b)
    timed("scorer fwd 252", scorer, crops_a, crops_b)
    del crops_a, crops_b

    def full(rgb_t, depth_t, mask_t):
        return register_step(mesh, refiner, scorer, rgb_t, depth_t, mask_t, rot_grid, Kt, 1, cfg)

    stacks = ([rgb] * iters, depths, [mask] * iters)
    full_ms = timed("FULL register", full, *stacks)
    kernel_ms = register_kernel_ms(full, stacks, iters) if dev.type == "cuda" else None
    out["FULL register kernel ms"] = kernel_ms
    out["FULL register busy share"] = None if kernel_ms is None else kernel_ms / full_ms
    print("FULL register kernel time: " + (
        "not measured" if kernel_ms is None else
        f"{kernel_ms:.3f} ms a Register under torch.profiler, {kernel_ms / full_ms:.1%} of "
        f"{full_ms:.3f} ms"))
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=None,
                    help="the first n hypotheses of the rotation grid (default: all 252)")
    ap.add_argument("--crop", type=int, default=160, help="crop window and net crop size")
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640), help="frame height and width")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device, args.iters, args.n, args.crop, tuple(args.hw))
    print_line("profile_register", args.device, results=out, iters=args.iters,
               n=args.n or 252, crop=args.crop, hw=list(args.hw))
    return out


if __name__ == "__main__":
    main()
