"""The port's bench: Register and Track throughput on one card.

    python -m foundationpose_cpp_tpu_torch.bench
    python -m foundationpose_cpp_tpu_torch.bench --device cpu --crop 32 --hw 120 160 --iters 1

Counterpart of the JAX package's ``bench.py`` (repo root), with its input
and the keys of its one JSON line: the 6016-face UV sphere at
``default_pose(tz=0.6)`` in a 480x640 frame, K = (600, 600, 320, 240), and
seeded nets at the default ``NetConfig`` (refiner seed 0, scorer seed 1).
The JAX bench loops inside one compiled program (``lax.scan``); here every
loop is a Python loop of calls on tensors already on the card, ended by one
read:

- ``value`` / ``register_fps``: 32 ``register_step`` calls; ``register_fps_itr2``
  16 at refine_itr 2;
- ``track_fps``: 256 chained ``track_step`` calls, the pose left on the card;
- ``track_fps_percall``: 30 ``FoundationPose.track`` calls, numpy in and out;
- ``track_fps_dispatch``: 64 ``make_packed_tracker`` steps on a packed frame
  already on the card (the deployment's call: unpack, then Track);
- ``track_fps_pipelined``: ``AsyncTracker`` over the native ring while a
  producer pushes a frame every millisecond;
- ``h2d``: one u16mm packed frame uploaded from pageable and from pinned
  memory, by CUDA events;
- ``stage_ms``: ``render_and_transform``, refiner and scorer at 252 poses by
  CUDA events (``render_252_corner`` is null: the port renders exactly per
  pixel and has no corner-colour mode);
- ``scan``: the scanned-mesh chain (``scanned_blob`` -> binary PLY -> the
  native parser -> ``load_mesh`` -> decimation to 12,000 faces ->
  ``subdivide_adaptive``), then ``render_branch`` of the final mesh at 252
  poses by CUDA events; the host preprocess stays outside every timed window;
- ``memory``: ``torch.cuda.max_memory_allocated`` over the Register and the
  Track loops.

``sharded`` is the JSON line of ``tools/bench_sharded.py``, run as a
subprocess as ``bench.py`` runs the JAX tool: the hypothesis split's
Register on 8 ranks against one process (``{"error": ...}`` when it
fails). ``details.card``
names the card and its power limit as ``nvidia-smi`` reports them. Without a
card the bench raises; ``--device cpu`` runs it on the plain versions (times
by the host clock, ``platform`` "cpu", no h2d or memory block), which only
the tests do, with f32 nets there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from foundationpose_cpp_tpu_torch import native
from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import mesh_loader, procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline.async_tracker import AsyncTracker
from foundationpose_cpp_tpu_torch.pipeline.renderer import (
    MeshConstants,
    render_and_transform,
    render_branch,
)
from foundationpose_cpp_tpu_torch.utils import synthetic
from foundationpose_cpp_tpu_torch.utils.device import resolve_device
from foundationpose_cpp_tpu_torch.utils.profiling import stacked_ms

# the reference's RTX 4060 numbers (BASELINE.md, SURVEY.md section 6)
BASELINE_REGISTER_FPS, BASELINE_TRACK_FPS = 2.8, 220.0
ITERS = dict(track=256, percall=30, register=32, register_itr2=16, dispatch=64, pipelined=64,
             h2d=32, stage=8, scan=4)
# bench.py's scan chain: scanned_blob(seed=3), decimated to 12k faces, then
# subdivided where the texel-patch metric asks, up to 32,768 faces
SCAN = dict(blob=dict(seed=3), target_faces=12_000, max_faces=32_768, patch_k=4)


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, iters: int, device: torch.device) -> float:
    """Mean time of fn() over iters calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    return stacked_ms(lambda _: fn(), [range(iters)], device)


def setup(device, hw=(480, 640), crop: int = 160, net_cfg: networks.NetConfig | None = None) -> dict:
    """The bench's scene, model and resident tensors."""
    device = resolve_device(device)
    h, w = hw
    cfg = FoundationPoseConfig(crop_window_h=crop, crop_window_w=crop,
                               use_bf16_models=device.type == "cuda")
    net_cfg = net_cfg or networks.NetConfig(crop_hw=crop)
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]], np.float32)
    sphere = procedural.textured_uv_sphere(radius=0.05, n_lat=48, n_lon=64)
    gt = synthetic.default_pose(tz=0.6)
    rgb, depth, mask = synthetic.render_scene(MeshConstants.from_asset(sphere, device), gt, K,
                                              h, w, cfg)
    model = fpp.FoundationPose(
        networks.init_net("refiner", net_cfg, seed=0),
        networks.init_net("scorer", dataclasses.replace(net_cfg, cross_attention=True), seed=1),
        [sphere], K, h, w, config=cfg, device=device,
    )
    up = model._upload
    return dict(device=device, cfg=cfg, net_cfg=net_cfg, K=K, hw=(h, w), sphere=sphere, gt=gt,
                frame=(rgb, depth, mask), model=model, mesh=model._meshes[sphere.name],
                rgb=up(rgb), depth=up(depth), mask=up(mask))


@torch.inference_mode()
def track_chained(ctx: dict, iters: int) -> float:
    """Frames/s of ``iters`` chained ``track_step`` calls on resident
    tensors, the pose left on the card and read once at the end."""
    m, dev = ctx["model"], ctx["device"]

    def step(pose):
        return fpp.track_step(ctx["mesh"], m._refiner, ctx["rgb"], ctx["depth"], pose, m._K, 1,
                              ctx["cfg"])

    pose0 = torch.as_tensor(ctx["gt"][None], device=dev)
    step(pose0).cpu()
    t0 = time.perf_counter()
    pose = pose0
    for _ in range(iters):
        pose = step(pose)
    pose.cpu()
    return iters / (time.perf_counter() - t0)


def track_percall(ctx: dict, iters: int) -> float:
    """Frames/s of ``FoundationPose.track``: numpy frame and pose in, pose
    read back, every call."""
    m, (rgb, depth, _) = ctx["model"], ctx["frame"]
    name = ctx["sphere"].name
    pose = m.track(rgb, depth, ctx["gt"], name)
    t0 = time.perf_counter()
    for _ in range(iters):
        pose = m.track(rgb, depth, pose, name)
    return iters / (time.perf_counter() - t0)


def track_dispatch(ctx: dict, iters: int) -> float:
    """Frames/s of ``iters`` packed-tracker steps on one u16mm packed frame
    already on the card, the pose chained on the card, one read at the end."""
    m, dev, (rgb, depth, _) = ctx["model"], ctx["device"], ctx["frame"]
    step = m.make_packed_tracker(ctx["sphere"].name, ctx["hw"])
    packed = torch.from_numpy(m.pack_frame(rgb, depth)).to(dev)
    pose0 = torch.as_tensor(ctx["gt"], device=dev)
    step(packed, pose0).cpu()
    t0 = time.perf_counter()
    pose = pose0
    for _ in range(iters):
        pose = step(packed, pose)
    pose.cpu()
    return iters / (time.perf_counter() - t0)


def track_pipelined(ctx: dict, iters: int) -> float:
    """Frames/s of ``AsyncTracker.run`` while a producer thread pushes the
    frame every millisecond (f32 meters, quantized on its thread)."""
    rgb, depth, _ = ctx["frame"]
    tracker = AsyncTracker(ctx["model"], ctx["sphere"].name, ctx["hw"], capacity=4)
    halt = threading.Event()

    def feeder():
        while not halt.is_set():
            tracker.push_frame(rgb, depth)
            time.sleep(0.001)

    thread = threading.Thread(target=feeder, daemon=True)
    thread.start()
    try:
        tracker.run(ctx["gt"], max_frames=2)  # warm-up
        t0 = time.perf_counter()
        records = tracker.run(ctx["gt"], max_frames=iters)
        fps = len(records) / (time.perf_counter() - t0)
    finally:
        halt.set()
        thread.join(timeout=10)
        tracker.close()
    return fps


@torch.inference_mode()
def register_fps(ctx: dict, iters: int, refine_itr: int = 1) -> float:
    """Registers/s of ``iters`` ``register_step`` calls on resident tensors,
    the best poses read once at the end."""
    m = ctx["model"]

    def step():
        return fpp.register_step(ctx["mesh"], m._refiner, m._scorer, ctx["rgb"], ctx["depth"],
                                 ctx["mask"], m._rot_grid, m._K, refine_itr, ctx["cfg"])[0]

    step().cpu()
    t0 = time.perf_counter()
    best = [step() for _ in range(iters)]
    torch.stack(best).cpu()
    return iters / (time.perf_counter() - t0)


def h2d_block(ctx: dict, iters: int) -> dict | None:
    """One 480x640 u16mm packed frame uploaded from pageable and from pinned
    host memory, by CUDA events; the fetch round trip by the host clock.
    None on the CPU, where nothing is uploaded."""
    dev = ctx["device"]
    if dev.type != "cuda":
        return None
    h, w = ctx["hw"]
    frame = np.zeros(fpp.FoundationPose.packed_frame_bytes((h, w)), np.uint8)
    pageable = torch.from_numpy(frame)
    pinned = pageable.pin_memory()
    page_ms = device_ms(lambda: pageable.to(dev), iters, dev)
    pin_ms = device_ms(lambda: pinned.to(dev, non_blocking=True), iters, dev)
    one = torch.zeros(1, device=dev)
    one.cpu()
    t0 = time.perf_counter()
    one.cpu()
    rtt_ms = (time.perf_counter() - t0) * 1e3
    return {
        "frame_bytes": int(frame.nbytes),
        "depth_format": "u16mm",
        "ms_per_frame": page_ms,
        "gib_per_s": frame.nbytes / (page_ms / 1e3) / 2**30,
        "fetch_rtt_ms": rtt_ms,
        "pinned_ms_per_frame": pin_ms,
        "pinned_gib_per_s": frame.nbytes / (pin_ms / 1e3) / 2**30,
    }


def poses_252(ctx: dict) -> torch.Tensor:
    """The rotation grid at the true translation, as bench.py's stages."""
    poses = ctx["model"]._rot_grid.clone()
    poses[:, :3, 3] = torch.as_tensor(ctx["gt"][:3, 3], device=ctx["device"])
    return poses


@torch.inference_mode()
def stage_ms(ctx: dict, iters: int) -> dict:
    """render_and_transform (crop 1.2), refiner and scorer at 252 poses."""
    m, cfg, dev = ctx["model"], ctx["cfg"], ctx["device"]
    poses = poses_252(ctx)
    xyz_map = depth_ops.depth_to_xyz(ctx["depth"], m._K, cfg.min_depth)

    def render():
        return render_and_transform(ctx["mesh"], poses, ctx["rgb"], xyz_map, m._K,
                                    cfg.refine_crop_ratio, cfg)

    r_in, t_in = render()
    return {
        "render_252": device_ms(render, iters, dev),
        "render_252_corner": None,
        "refiner_252": device_ms(lambda: m._refiner(r_in, t_in), iters, dev),
        "scorer_252": device_ms(lambda: m._scorer(r_in, t_in), iters, dev),
    }


def scan_block(ctx: dict, iters: int, scan: dict = SCAN) -> dict:
    """The scanned-mesh chain and its 252-pose render (bench.py:430-493)."""
    # imported here: tools/bench_trees.py runs this file's Track loops on
    # checkouts that predate these modules
    from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
    from foundationpose_cpp_tpu_torch.meshio.subdivide import subdivide_adaptive

    raw = procedural.scanned_blob(**scan["blob"])
    with tempfile.TemporaryDirectory() as td:
        procedural.write_ply(raw, f"{td}/scan.ply", f"{td}/scan_tex.png", binary=True)
        native.load_mesh_library()  # the build is not part of the parse
        t0 = time.perf_counter()
        native.parse_ply_native(f"{td}/scan.ply")
        parse_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = mesh_loader.load_mesh("scan", f"{td}/scan.ply")
        load_ms = (time.perf_counter() - t0) * 1e3
    decimated = decimate_vertex_clustering(loaded, target_faces=scan["target_faces"])
    final, info = subdivide_adaptive(decimated, max_faces=scan["max_faces"],
                                     patch_k=scan["patch_k"])
    m, cfg, dev = ctx["model"], ctx["cfg"], ctx["device"]
    mesh = MeshConstants.from_asset(final, dev)
    h, w = ctx["hw"]
    ch, cw = cfg.crop_window_h, cfg.crop_window_w
    with torch.inference_mode():
        poses = poses_252(ctx)
        tfs = transforms.compute_crop_window_tf(poses, m._K, (ch, cw), cfg.refine_crop_ratio,
                                                mesh.diameter)
        bbox = transforms.construct_bbox2d(tfs, ch, cw)
        clip = transforms.pose_clip_matrix(poses, bbox, m._K, h, w, cfg.znear, cfg.zfar)
        render_ms = device_ms(lambda: render_branch(mesh, poses, clip, ch, cw, cfg), iters, dev)
    return {
        "faces_raw": int(loaded.num_faces),
        "faces_decimated": int(decimated.num_faces),
        "faces_final": int(final.num_faces),
        "subdivide_rounds": int(info["rounds"]),
        "native_parse_ms": parse_ms,
        "load_ms": load_ms,
        "render_ms_scan": render_ms,
    }


def sharded_block(device: torch.device) -> dict:
    """``tools/bench_sharded.py``'s JSON line (bench.py:495-514), on the
    bench's device; ``{"error": ...}`` when it fails. Its log goes to this
    process's stderr."""
    cmd = [sys.executable, "-m", "foundationpose_cpp_tpu_torch.tools.bench_sharded"]
    if device.type == "cpu":
        cmd += ["--device", "cpu"]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=600, check=True,
                              cwd=pathlib.Path(__file__).resolve().parents[1])
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (subprocess.SubprocessError, ValueError, IndexError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"[:500]}


def run(device=None, hw=(480, 640), crop: int = 160, iters: dict = ITERS,
        net_cfg: networks.NetConfig | None = None, scan: dict = SCAN) -> dict:
    """Every measurement of the bench; returns bench.py's result dict."""
    ctx = setup(device, hw, crop, net_cfg)
    dev = ctx["device"]
    card = card_name_and_power_limit() if dev.type == "cuda" else None
    mem = {}

    def peak(name, fn, *args):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out = fn(*args)
        if dev.type == "cuda":
            mem[name] = {"peak_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
        return out

    track = peak("track_once", track_chained, ctx, iters["track"])
    percall = track_percall(ctx, iters["percall"])
    reg = peak("register_scan32", register_fps, ctx, iters["register"])
    reg2 = register_fps(ctx, iters["register_itr2"], refine_itr=2)
    dispatch = track_dispatch(ctx, iters["dispatch"])
    pipelined = track_pipelined(ctx, iters["pipelined"])
    h2d = h2d_block(ctx, iters["h2d"])
    stages = stage_ms(ctx, iters["stage"])
    scan_out = scan_block(ctx, iters["scan"], scan)
    sharded = sharded_block(dev)
    projected = 1e3 / max(h2d["ms_per_frame"], 1e3 / dispatch) if h2d else None
    hbm_peak = max(v["peak_gb"] for v in mem.values()) if mem else None
    macs = networks.flops_per_pair(ctx["net_cfg"])
    rate = (f"; refiner at 252 {2 * 252 * macs / stages['refiner_252'] / 1e9:.1f} TFLOP/s"
            if card else "")
    print(f"[bench] {card or 'cpu'}: refiner {networks.count_params(ctx['model']._refiner)} "
          f"params, scorer {networks.count_params(ctx['model']._scorer)}, {macs} MACs a "
          f"hypothesis pair{rate}", file=sys.stderr, flush=True)
    return {
        "metric": "register_fps",
        "value": reg,
        "unit": "fps",
        "vs_baseline": reg / BASELINE_REGISTER_FPS,
        "details": {
            "track_fps": track,
            "track_fps_percall": percall,
            "track_fps_dispatch": dispatch,
            "track_fps_pipelined": pipelined,
            "track_fps_pipelined_projected": projected,
            "h2d": h2d,
            "track_vs_baseline": track / BASELINE_TRACK_FPS,
            "register_fps_itr2": reg2,
            "stage_ms": stages,
            "scan": scan_out,
            "sharded": sharded,
            "hbm_peak_gb": hbm_peak,
            "memory": ({"register_scan32": mem["register_scan32"], "track_once": mem["track_once"],
                        "runtime_stats_gb": torch.cuda.max_memory_reserved(dev) / 2**30}
                       if mem else None),
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "card": card,
            "mesh_faces": int(ctx["sphere"].num_faces),
            "image": list(ctx["hw"]),
            "hypotheses": int(ctx["model"]._rot_grid.shape[0]),
            "track_iters": iters["track"],
            "register_iters": iters["register"],
        },
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--crop", type=int, default=160, help="crop window and net crop size")
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640), help="frame height and width")
    ap.add_argument("--iters", type=int, default=None,
                    help="run every loop this many times instead of bench.py's counts")
    args = ap.parse_args(argv)
    iters = ITERS if args.iters is None else {k: args.iters for k in ITERS}
    result = run(args.device, tuple(args.hw), args.crop, iters)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
