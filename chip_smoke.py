#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``foundationpose_cpp_tpu_torch/csrc``
(one nvcc per source, all at once), holds each against its plain PyTorch
version at the main paths' shapes (the probe kernel at its tool's two; the
observed-crop kernel at Register's 252 views, Track's 1 and the mixed
cell's 8, each with its own diameter; the convolution epilogue at a net's
nine conv outputs at 252 and at 1 pair) and
times both (with the one PyTorch call
that computes the same function, where there is one); the render and raster
kernels also run on plane coefficients handed in from the plain version,
where they must agree on every pixel. Then it drives the
port's paths end to end, each with the launch counts set to 0 just before
it and read just after:

- Register and Track at full width (252 hypotheses, the committed
  ``weights/*_multi_full.npz``, six 480x640 frames made by ``render_scene``);
- the serving paths on the same frames and weights: Register and Track with
  a (480, 640) size bucket, on the frame and on a 448x608 crop; the six
  frames chained through ``make_packed_tracker`` (u16mm, f32, rgb_half);
  ``AsyncTracker`` fed by a producer thread through the native frame ring;
  the refiner and scorer inference cores at n = 1, 5, 64, 252;
- the dataset sequence at full width: the same six frames and the textured
  mesh written in the mustard0 layout, then ``run_dataset`` on them;
- the dataset sequence with narrow seeded nets (head_dim 16), which routes
  attention to the head-split kernel;
- a scanned mesh (the reference's BundleSDF configuration): the 105k-face
  ``scanned_blob`` through a binary PLY, the native parser, decimation and
  adaptive subdivision; the render and raster kernels at its face counts
  against their plain versions; Track, scoring and Register on it;
- eight cubes tracked in one ``track_batch`` (the multi-object
  configuration);
- LM-O's eight distinct stand-in meshes (``benchmark/assets/lmo8_*``) in
  one ``track_batch``: K2 over their mesh table against its plain version
  at N=8 and 160x160, with its times and bound, then the mixed program's
  replay against its eager run, its launches (one K2, one K1 a call) and
  its poses' digest;
- a changing set of those objects: a program for each N from 1 to 8
  warmed, then 300 calls over at least 200 ordered sets with no capture
  and no catalog build, each call against its function run eagerly;
- 64 chained packed steps and a Register under
  ``torch.cuda.set_sync_debug_mode("error")``;
- every program key of the pipeline (Register at refine_itr 1 and 2,
  Track, ``track_batch`` of the eight cubes, the packed step in three
  formats, ``AsyncTracker`` at pipeline_depth 0 and 3, a size bucket fed
  two frame sizes, the inference cores at n = 1, 5, 64, 252): each CUDA
  graph's replay against its function run eagerly (max |d| 0), its
  launches a call, no host sync in a replay, capture ms, node count, ms a
  call graphed and eager, and the memory the graphs hold in one pool and
  in a pool each; a Register with a bool mask after a uint8 one, and a
  replay after 300 other constants, each against eager (the two faults of
  the first programs);
- the hypothesis split (``parallel.sharding``) in rank processes: Register
  on the house frame at W=1 over NCCL as a captured program (equal to its
  eager run and to ``register_step``, with no host sync), at W=2 and W=8
  over gloo with every rank on this card, and the eight cubes'
  ``track_batch`` at W=2, each against the single process;
- the port bench (``foundationpose_cpp_tpu_torch.bench``), whose JSON line
  it prints;
- model ingest: the published-structure refiner and scorer at the published
  widths with seeded weights, converted with no JAX, held against their own
  forward on 252 crop pairs in f32 and bf16, saved, reloaded and served;
- the trainers on a bank of 4 family objects: one batch and its gradients
  on the card against the CPU, 60 refiner and 20 scorer steps from scratch
  through the step programs (K2 twice a step, no attention kernel), the
  committed weights evaluated, the trained refiner saved as bf16 and
  served; then, in cuDNN's default and deterministic modes, 20 graphed
  steps of each trainer against 20 eager steps (eager against eager
  first; held bit for bit in deterministic mode), their ms a step,
  capture, nodes, kernel time and largest kernels, peak memory, and no
  host sync once every object's program is captured;
- the perf harnesses at the published widths: the grid-overhead probe
  (K5), then ``profile_nets``, ``bench_stem``, ``bench_attn`` (with and
  without ``--encode-ab``) and ``profile_register`` at 4 iterations, each
  A/B held against its production form.

It checks that each path went through its kernels and found the object.
Prints the card, a ``{"kernels": [...]}`` line and, last, the device line.
Exits nonzero without a result when there is no CUDA card or no port beside
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # CUDA-core f32, no tensor cores
# |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain|, elementwise. With randn
# qkv the outputs are weighted means of ~150 keys, |out| ~ 0.06-0.1, where a
# bf16 ulp is 2**-11. Another exp/sum order and P's bf16 rounding move an
# output by up to 2 ulps, so: 4 ulps at the typical size plus 2 ulps of the
# value itself (2**-6 relative at the bottom of a binade).
ATTN_ATOL, ATTN_RTOL = 2.0**-9, 2.0**-6
# f32 attention (no rounding between the steps): f32 sums of up to 1500
# terms in another order than cuBLAS's
ATTN_F32_TOL = 1e-5
RASTER_AGREE, RASTER_TOL = 0.995, 1e-4  # tests/test_rasterize_pallas.py:27-30
RENDER_TOL, RENDER_BAD_FRAC = 2e-3, 0.01  # tests/test_torch_render.py
RENDER_TEST_FLOPS = 20  # mul/add of one pixel's 5 planes (a0, a1, a2, z, w)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_queued(torch, fn, iters: int) -> float:
    """Mean device time of fn() alone: the launches are enqueued behind a few
    milliseconds of matrix products, so the host's time to make each launch
    (which bounds cuda_ms for a kernel of a few microseconds) is not in it."""
    if not hasattr(cuda_ms_queued, "blocker"):
        cuda_ms_queued.blocker = torch.zeros((8192, 8192), dtype=torch.bfloat16, device="cuda")
    a = cuda_ms_queued.blocker
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(4):
        torch.mm(a, a)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def split_heads(qkv, heads):
    """(B, T, 3D) packed projection -> q, k, v views of (B, H, T, hd)."""
    b, t, d3 = qkv.shape
    return qkv.reshape(b, t, 3, heads, d3 // 3 // heads).permute(2, 0, 3, 1, 4)


def attention_variant(torch, q, k, v, scale_mult=1.0, keep_keys=None, round_p=True):
    """The plain attention on (B, H, T, hd) with a planted fault: q scaled by
    scale_mult too, only the keys of keep_keys (a slice), or P left in f32
    before P.v."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    q = (q * (scale_mult / math.sqrt(q.shape[-1]))).to(dtype).float()
    if keep_keys is not None:
        k, v = k[:, :, keep_keys], v[:, :, keep_keys]
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    if round_p:
        p = p.to(dtype).float()
    return (p @ v).to(dtype)


def merge_heads(out):
    """(B, H, T, hd) -> (B, T, H*hd)."""
    b, h, t, hd = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, t, h * hd)


def attention_excess(torch, got, want) -> float:
    """max |got - want| / (atol + rtol |want|) at the dtype's tolerance:
    above 1 fails."""
    atol, rtol = ((ATTN_ATOL, ATTN_RTOL) if got.dtype == torch.bfloat16
                  else (ATTN_F32_TOL, ATTN_F32_TOL))
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def check_faults(torch, got, q, k, v, to_layout) -> None:
    """Planted faults in the plain version must fail the tolerance against
    the kernel's output."""
    t = q.shape[2]
    faults = {"scale x1.05": dict(scale_mult=1.05), "one key skipped": dict(keep_keys=slice(1, None))}
    if t > 64:
        faults["first 64-key chunk skipped"] = dict(keep_keys=slice(64, None))
    for name, kw in faults.items():
        bad = attention_excess(torch, got, to_layout(attention_variant(torch, q, k, v, **kw)))
        log(f"  planted fault '{name}': err/tol={bad:.3f} (must exceed 1)")
        if bad <= 1.0:
            raise AssertionError(f"the attention tolerance misses the fault '{name}'")


def attention_row(torch, F, name, run, plain, q, k, v, out, dtype):
    """Time the kernel, its plain version and SDPA on the same (B, H, T, hd)
    tensors; the bound counts q, k, v and the output once and 4 T^2 hd
    operations per (batch, head)."""
    b, h, t, hd = q.shape

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=1 / math.sqrt(hd))

    k_ms = cuda_ms(torch, run, 20)
    p_ms = cuda_ms(torch, plain, 3)
    l_ms = cuda_ms(torch, sdpa, 20)
    # the same without the host's launch time, which is most of a small shape's
    k_dev, l_dev = cuda_ms_queued(torch, run, 20), cuda_ms_queued(torch, sdpa, 20)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    b_ms, b_by = bound(4 * nbytes(out), 4.0 * b * h * t * t * hd, peak)
    log(f"{name} {str(dtype)[6:]} (B={b}, H={h}, T={t}, hd={hd}): kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms(sdpa)={l_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"queued behind other work: kernel_ms={k_dev:.4f} sdpa_ms={l_dev:.4f}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)


def check_attention(torch, attention):
    """K1 in bf16 at the encoder (252, 400, 3*512), att_cross (1, 252, 3*512),
    Track (1, 400, 3*512) and track_batch of 8 (8, 400, 3*512) shapes and at
    (4, 1500, 3*512), more tokens
    than a block could keep f32 logits for in shared memory, and at the encoder shape in f32; planted faults in the
    plain version must fail the same tolerance against the kernel."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, rows = 4, []
    for b, t, dtype in ((252, 400, torch.bfloat16), (1, 252, torch.bfloat16),
                        (252, 400, torch.float32), (1, 400, torch.bfloat16),
                        (8, 400, torch.bfloat16), (4, 1500, torch.bfloat16)):
        qkv = torch.randn((b, t, 1536), generator=gen, device="cuda").to(dtype)
        got = attention.mha_packed_qkv(qkv, heads)
        want = attention.mha_packed_qkv_plain(qkv, heads)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        excess = attention_excess(torch, got, want)
        log(f"mha_packed_qkv {str(dtype)[6:]} B={b} T={t}: max_abs_err={err:.3e} mean|out|="
            f"{want.float().abs().mean().item():.4f} err/tol={excess:.3f}")
        if excess > 1.0:
            raise AssertionError(f"mha_packed_qkv disagrees at B={b} T={t} {dtype}: max err {err}")
        q, k, v = split_heads(qkv, heads)
        if dtype == torch.bfloat16:
            check_faults(torch, got, q, k, v, merge_heads)
            unrounded = merge_heads(attention_variant(torch, q, k, v, round_p=False))
            log(f"  P left in f32 (no fault check; below the output's own bf16 rounding): "
                f"err/tol={attention_excess(torch, got, unrounded):.3f} max_abs="
                f"{(got.float() - unrounded.float()).abs().max().item():.3e}")
        row = attention_row(torch, F, "mha_packed_qkv", lambda: attention.mha_packed_qkv(qkv, heads),
                            lambda: attention.mha_packed_qkv_plain(qkv, heads), q, k, v, got, dtype)
        rows.append(dict(shape=(b, t), dtype=str(dtype), err=err, **row))
    return rows


def check_whole_head(torch, attention):
    """K3 in bf16 at the narrow net's (252, 4, 16, 16) and full-width 8-head
    (252, 8, 400, 64) and (1, 8, 252, 64) shapes, with planted faults, and
    in f32 at (252, 4, 16, 16) and (252, 8, 400, 64)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for shape, dtype in (((252, 4, 16, 16), torch.bfloat16), ((252, 8, 400, 64), torch.bfloat16),
                         ((1, 8, 252, 64), torch.bfloat16), ((252, 4, 16, 16), torch.float32),
                         ((252, 8, 400, 64), torch.float32)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        got = attention.mha_whole_head(q, k, v)
        want = attention.mha_whole_head_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        excess = attention_excess(torch, got, want)
        log(f"mha_whole_head {str(dtype)[6:]} {shape}: max_abs_err={err:.3e} mean|out|="
            f"{want.float().abs().mean().item():.4f} err/tol={excess:.3f}")
        if excess > 1.0:
            raise AssertionError(f"mha_whole_head disagrees at {shape} {dtype}: max err {err}")
        if dtype == torch.bfloat16:
            check_faults(torch, got, q, k, v, lambda o: o)
        row = attention_row(torch, F, "mha_whole_head", lambda: attention.mha_whole_head(q, k, v),
                            lambda: attention.mha_whole_head_plain(q, k, v), q, k, v, got, dtype)
        rows.append(dict(shape=shape, dtype=str(dtype), err=err, **row))
    return rows


def check_render(torch, transforms, render, sweep, cases=None):
    """K2 at 160x160 on the 6016-face sphere (faces of a few pixels) and the
    house (a dozen faces of thousands) at 252 views, and on the sphere at one
    view (Track's shape), or on ``cases`` of (name, n, crop, asset): parity
    on up to 16 views, the same on plane coefficients handed in (the scatter
    and the resolve alone: 0 pixels off), and the times of the wrapper, of
    the render kernel's launch alone on a filled vertex buffer, and of the
    wrapper queued behind other work."""
    from foundationpose_cpp_tpu_torch.ops import rasterize as ras

    rows = []
    for name, n, crop, asset in cases or [(*c, None) for c in sweep.RENDER_CASES[:3]]:
        case = sweep.render_case(name, n, crop, asset=asset)
        mesh_args, poses, clip_mat, tail = case[:5], case[5], case[6], case[7:]
        sl = slice(0, min(n, 16))
        got = render.render_views(*case)
        want = render.render_views_plain(*mesh_args, poses[sl], clip_mat[sl], *tail)
        torch.cuda.synchronize()
        bad, err = sweep.render_disagreement(got[sl], want, RENDER_TOL)
        fg = (want.abs().sum(-1) > 0).float().mean().item()
        if not (bad < RENDER_BAD_FRAC and fg > 0.1 and torch.isfinite(got).all()):
            raise AssertionError(f"render kernel disagrees on {name} N={n}: {bad:.4%} pixels "
                                 f"off, fg {fg:.2f}")
        verts = render.vertex_prepass_plain(case[0], case[1], poses, clip_mat)
        coeffs, bbox, _ = render.render_prepass(*case[:4], poses, clip_mat, crop, crop)
        launch_args = (verts, case[2], case[3], case[4], poses, *tail)
        exact = render.launch_render(*launch_args, coeffs=coeffs)
        bad_x, err_x = sweep.render_disagreement(exact[sl], want, RENDER_TOL)
        if bad_x != 0.0:
            raise AssertionError(f"render kernel on handed-in coefficients: {bad_x:.4%} pixels "
                                 f"off on {name} N={n}, want none")
        k_ms = cuda_ms(torch, lambda: render.render_views(*case), 10)
        launch_ms = cuda_ms(torch, lambda: render.launch_render(*launch_args), 10)
        q_ms = cuda_ms_queued(torch, lambda: render.render_views(*case), 10)
        p_ms = cuda_ms(torch, lambda: render.render_views_plain(*case), 1, warmup=0)
        clip = transforms.transform_points_homogeneous(clip_mat, case[0])
        done = render.face_pixel_tests(bbox)
        needed = tests_needed(torch, ras, clip, case[3], crop, crop)
        b_ms, b_by = bound(nbytes(*mesh_args, poses, clip_mat, got), needed * RENDER_TEST_FLOPS,
                           F32_FLOPS)
        empty = (bbox[..., 1] < bbox[..., 0]) | (bbox[..., 3] < bbox[..., 2])
        log(f"render {name} N={n} {crop}x{crop} {case[3].shape[0]} faces: pixels_off={bad:.4%} "
            f"max_abs_err={err:.3e}; on handed-in coefficients pixels_off={bad_x:.4%} "
            f"max_abs_err={err_x:.3e}; wrapper_ms={k_ms:.4f} (checks + 2 launches) "
            f"render_kernel_launch_ms={launch_ms:.4f} wrapper_ms_queued={q_ms:.4f} "
            f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; {needed} face-pixel tests "
            f"needed, {done} done; {empty.float().mean().item():.2%} of the faces' pixel "
            f"bboxes empty; vertex buffer {n * case[0].shape[0] * 32} bytes)")
        rows.append(dict(name=name, n=n, err=err, ms=k_ms, queued_ms=q_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def tests_needed(torch, ras, clip, faces, h: int, w: int) -> int:
    """Face-pixel tests the data needs: each face that survives culling
    against the pixel centers inside its own projected bbox."""
    _, valid = ras.edge_coefficients(clip, faces)
    tri = clip[:, faces.long()]  # (N, F, 3, 4)
    ndc = tri[..., :2] / tri[..., 3:4]
    size = torch.tensor([w, h], dtype=torch.float32, device=clip.device)
    # pixel i's center is at (2i + 1) / size - 1 in NDC
    lo = torch.ceil(((ndc.amin(dim=2) + 1.0) * size - 1.0) / 2.0).clamp(min=0.0)
    hi = torch.minimum(torch.floor(((ndc.amax(dim=2) + 1.0) * size - 1.0) / 2.0), size - 1.0)
    span = (hi - lo + 1.0).clamp(min=0.0).double().prod(dim=-1)
    return int(span[valid].sum().item())


def check_rasterize(torch, transforms, rasterize_tiled, render, sweep, cases=None):
    """K4 against its plain version: N=1 at 480x640 for the house and the
    6016-face sphere, N=4 at 120x160 for the sphere, N=2 at a ragged 123x157
    for the house, or ``cases`` of (name, n, h, w, asset); share of pixels
    whose face ids agree and max error where they agree, the same on plane
    coefficients handed in (100%), and the times of the wrapper (checks +
    one launch), of the same queued behind other work (the kernel alone,
    without the host's launch cost) and of the plain version."""
    from foundationpose_cpp_tpu_torch.ops import rasterize as ras

    rows = []
    for name, n, h, w, asset in cases or [(*c, None) for c in sweep.RASTER_CASES]:
        clip, faces, _, _ = sweep.raster_case(name, n, h, w, asset=asset)
        got = rasterize_tiled.rasterize_tiled(clip, faces, h, w)
        want = rasterize_tiled.rasterize_tiled_plain(clip, faces, h, w)
        coeffs, bbox = rasterize_tiled.rasterize_prepass(clip, faces, h, w)
        exact = rasterize_tiled.launch_rasterize(clip, faces, h, w, coeffs=coeffs)
        torch.cuda.synchronize()
        share, err = sweep.raster_agreement(got, want)
        share_x, err_x = sweep.raster_agreement(exact, want)
        fg = (want[..., 3] > 0).float().mean().item()
        log(f"rasterize_tiled {name} N={n} {h}x{w}: ids agree on {share:.6%} of pixels "
            f"(foreground {fg:.2%}), max_abs_err where they agree={err:.3e}; on handed-in "
            f"coefficients {share_x:.6%}, {err_x:.3e}")
        if not (share > RASTER_AGREE and err <= RASTER_TOL and fg > 0.005):
            raise AssertionError(f"rasterize_tiled disagrees on {name} N={n} {h}x{w}")
        if not (share_x == 1.0 and err_x <= RASTER_TOL):
            raise AssertionError(f"rasterize_tiled on handed-in coefficients disagrees on "
                                 f"{name} N={n} {h}x{w}")

        def run():
            return rasterize_tiled.rasterize_tiled(clip, faces, h, w)

        k_ms = cuda_ms(torch, run, 20)
        q_ms = cuda_ms_queued(torch, run, 20)
        p_ms = cuda_ms(torch, lambda: rasterize_tiled.rasterize_tiled_plain(clip, faces, h, w), 3)
        done = render.face_pixel_tests(bbox)
        needed = tests_needed(torch, ras, clip, faces, h, w)
        b_ms, b_by = bound(nbytes(clip, faces, got), needed * RENDER_TEST_FLOPS, F32_FLOPS)
        log(f"rasterize_tiled {name} N={n} {h}x{w} {faces.shape[0]} faces: wrapper_ms={k_ms:.4f} "
            f"(checks + 1 launch) kernel_ms_queued={q_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}; "
            f"{needed} face-pixel tests needed, {done} done)")
        rows.append(dict(name=name, n=n, err=err, share=share, ms=k_ms, queued_ms=q_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def log_ptxas(name: str, text: str, attention) -> None:
    """ptxas's registers, static shared memory and spills per kernel; for the
    attention kernels also the dynamic shared memory their launches ask for."""
    import re

    import torch

    entry, spill = "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            extra = ""
            found = re.search(r"mha_(bf16|f32)_kernelILi(\d+)E(?:Li(\d+)E)?", entry)
            if found:
                dtype = torch.bfloat16 if found.group(1) == "bf16" else torch.float32
                shared = attention.kernel_shared_bytes(int(found.group(2)), dtype,
                                                       int(found.group(3) or 1))
                extra = f"; {shared} bytes dynamic smem"
            log(f"  ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}; {spill}{extra}")


def add_s(np, pts, est, gt) -> float:
    """Mean distance from each ground-truth model point to the nearest
    estimated one (symmetric ADD)."""
    a = pts @ gt[:3, :3].T + gt[:3, 3]
    b = pts @ est[:3, :3].T + est[:3, 3]
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return float(d.min(axis=1).mean())


def rot_err_deg(np, a, b) -> float:
    c = (np.trace(a[:3, :3] @ b[:3, :3].T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def surface_points(np, asset, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    v = asset.vertices - asset.model_center[None, :]
    tri = v[asset.faces]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    idx = rng.choice(len(tri), size=n, p=area / area.sum())
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    w = np.stack([1 - s, s * (1 - r2), s * r2], axis=1)
    return np.einsum("nk,nkj->nj", w, tri[idx])


def stage_breakdown(torch, model, rgb, depth, mask) -> None:
    """Device time of each Register stage at 252 hypotheses, by CUDA events,
    and within render_and_transform the shares of the crop and clip matrices,
    of the render kernel and of the observed-crop kernel."""
    from foundationpose_cpp_tpu_torch.geometry import transforms
    from foundationpose_cpp_tpu_torch.ops import crop
    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
    from foundationpose_cpp_tpu_torch.pipeline.renderer import render_and_transform, render_branch

    cfg, K, mesh = model._cfg, model._K, model._meshes["house"]
    rgb_t, depth_t, mask_t = (model._upload(a) for a in (rgb, depth, mask))
    with torch.inference_mode():
        times = {"prepare_register": cuda_ms(torch, lambda: fpp.prepare_register(
            depth_t, mask_t, model._rot_grid, K, cfg), 5)}
        poses, xyz_map, _ = fpp.prepare_register(depth_t, mask_t, model._rot_grid, K, cfg)
        times["render_and_transform"] = cuda_ms(torch, lambda: render_and_transform(
            mesh, poses, rgb_t, xyz_map, K, cfg.refine_crop_ratio, cfg), 5)
        r_in, t_in = render_and_transform(mesh, poses, rgb_t, xyz_map, K, cfg.refine_crop_ratio, cfg)
        times["refiner"] = cuda_ms(torch, lambda: model._refiner(r_in, t_in), 5)
        times["scorer"] = cuda_ms(torch, lambda: model._scorer(r_in, t_in), 5)

        ch, cw = cfg.crop_window_h, cfg.crop_window_w

        def matrices():
            tfs = transforms.compute_crop_window_tf(poses, K, (ch, cw), cfg.refine_crop_ratio,
                                                    mesh.diameter)
            bbox2d = transforms.construct_bbox2d(tfs, ch, cw)
            return tfs, transforms.pose_clip_matrix(poses, bbox2d, K, *rgb_t.shape[:2],
                                                    cfg.znear, cfg.zfar)

        def observed(tfs):
            return crop.crop_observed(rgb_t, xyz_map, tfs, poses, mesh.diameter / 2.0, ch, cw,
                                      cfg.min_depth, cfg.max_depth)

        tfs, clip_mat = matrices()
        inside = {"crop_and_clip_matrices": cuda_ms(torch, matrices, 5),
                  "render_views": cuda_ms(torch, lambda: render_branch(
                      mesh, poses, clip_mat, ch, cw, cfg), 5),
                  "crop_observed": cuda_ms(torch, lambda: observed(tfs), 5)}
    log("stages_252_ms: " + " ".join(f"{k}={v:.3f}" for k, v in times.items()))
    log("render_and_transform_252_ms: " + " ".join(f"{k}={v:.3f}" for k, v in inside.items()))


def drift_poses(np, syn, n=6):
    """A slow drift: 1.5 deg about y and 3 mm in x per frame."""
    gts = []
    for i in range(n):
        gt = syn.default_pose(tz=0.6)
        gt[:3, :3] = syn.euler_xyz_deg([0.0, 1.5 * i, 0.0]).astype(np.float32) @ gt[:3, :3]
        gt[0, 3] += 0.003 * i
        gts.append(gt)
    return gts


def reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def run_main_path(torch, np, fp, tproc, syn, attention, render, rasterize_tiled, K):
    """Register + Track on the card at full width; returns launches and times."""
    from foundationpose_cpp_tpu_torch.ops import crop, epilogue
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants

    h, w = 480, 640
    house = tproc.textured_house(name="house")
    scene_mesh = MeshConstants.from_asset(house, "cuda")
    gts = drift_poses(np, syn)
    rasterize_tiled.rasterize_tiled.launches = 0
    frames = [syn.render_scene(scene_mesh, gt, K, h, w) for gt in gts]
    raster_launches = rasterize_tiled.rasterize_tiled.launches
    if raster_launches != len(gts):
        raise AssertionError(f"render_scene launched the rasterizer {raster_launches} times, "
                             f"want {len(gts)}")
    model = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"),
        [house], K, h, w,
    )
    rgb, depth, mask = frames[0]
    model.register(rgb, depth, mask, "house")  # warm-up: cuDNN plans, allocator
    model.track(rgb, depth, gts[0], "house")

    counted = (render.render_views, attention.mha_packed_qkv, crop.crop_observed,
               epilogue.conv_epilogue)
    reset_counts(counted)
    t0 = time.perf_counter()
    pose = model.register(rgb, depth, mask, "house")
    reg_ms = (time.perf_counter() - t0) * 1e3
    counts = counts_of(counted)
    if counts != (2, 3, 2, 18):
        raise AssertionError(f"Register launched (render, attention, crop, epilogue) = {counts}, "
                             "want (2, 3, 2, 18)")
    errs, track_ms = [], []
    for i, (rgb_i, depth_i, _) in enumerate(frames):
        t0 = time.perf_counter()
        pose_i = model.track(rgb_i, depth_i, pose if i == 0 else errs[-1][2], "house")
        track_ms.append((time.perf_counter() - t0) * 1e3)
        errs.append((rot_err_deg(np, pose_i, gts[i]), float(np.linalg.norm(pose_i[:3, 3] - gts[i][:3, 3])), pose_i))
    counts = counts_of(counted)
    n = len(frames)
    if counts != (2 + n, 3 + n, 2 + n, 18 + 9 * n):
        raise AssertionError(f"Register + {n} Track launched {counts}, "
                             f"want {(2 + n, 3 + n, 2 + n, 18 + 9 * n)}")

    if not (pose.shape == (4, 4) and np.isfinite(pose).all()):
        raise AssertionError(f"Register pose is not a finite 4x4: {pose}")
    pts = surface_points(np, house)
    adds = add_s(np, pts, pose, gts[0])
    reg_rot = rot_err_deg(np, pose, gts[0])
    log(f"register: ADD-S={adds * 1e3:.2f} mm (limit {house.diameter * 100:.1f} mm) "
        f"rot_err={reg_rot:.2f} deg t_err={np.linalg.norm(pose[:3, 3] - gts[0][:3, 3]) * 1e3:.2f} mm")
    log("track rot_err_deg: " + " ".join(f"{e[0]:.2f}" for e in errs)
        + " | t_err_mm: " + " ".join(f"{e[1] * 1e3:.2f}" for e in errs))
    if adds >= 0.1 * house.diameter:
        raise AssertionError(f"Register ADD-S {adds:.4f} m >= 0.1 x diameter")
    if max(e[0] for e in errs) >= 5.0:
        raise AssertionError(f"tracked rotation error reached {max(e[0] for e in errs):.2f} deg")

    # steady-state times, host clock around work that ends in a synchronize
    reg_times, trk_times = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.register(rgb, depth, mask, "house")
        torch.cuda.synchronize()
        reg_times.append((time.perf_counter() - t0) * 1e3)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.track(rgb, depth, gts[0], "house")
        torch.cuda.synchronize()
        trk_times.append((time.perf_counter() - t0) * 1e3)
    reg_med, trk_med = float(np.median(reg_times)), float(np.median(trk_times))
    stage_breakdown(torch, model, rgb, depth, mask)
    log(f"register_ms={reg_med:.2f} (first timed {reg_ms:.2f}) register_fps={1e3 / reg_med:.2f} "
        f"track_ms={trk_med:.2f} track_fps={1e3 / trk_med:.2f}")
    return dict(render_launches=counts[0], attention_launches=counts[1],
                crop_launches=counts[2], epilogue_launches=counts[3],
                raster_launches=raster_launches, model=model,
                house=house, frames=frames, gts=gts, pose=pose)


def run_dataset_full_width(torch, np, tproc, syn, kernels, K, tmp):
    """The house drift sequence written in the mustard0 layout (frames
    through render_scene, the textured mesh through write_obj), then
    run_dataset on it with the trained weights at 480x640."""
    from foundationpose_cpp_tpu_torch.demo_dataset import run_dataset
    from foundationpose_cpp_tpu_torch.meshio import mesh_loader

    raster = kernels[-1]
    house = tproc.textured_house(name="house")
    gts = drift_poses(np, syn)
    root = tmp / "house_seq"
    reset_counts(kernels)
    syn.write_sequence(str(root), house, gts, K, 480, 640, texture=True, device="cuda")
    written = raster.launches
    loaded = mesh_loader.load_mesh("target", str(root / "mesh" / "house.obj"))
    want_tex = (house.texture * 255).astype(np.uint8).astype(np.float32) / 255.0
    if loaded.texture.shape != (96, 96, 3) or not np.array_equal(loaded.texture, want_tex):
        raise AssertionError(f"the written mesh loads with texture {loaded.texture.shape}, not its PNG")
    t0 = time.perf_counter()
    summary = run_dataset(str(root), str(tmp / "house_out"),
                          refiner=str(ROOT / "weights" / "refiner_multi_full.npz"),
                          scorer=str(ROOT / "weights" / "scorer_multi_full.npz"),
                          write_overlays=True, device="cuda")
    wall_s = time.perf_counter() - t0
    counts = tuple(k.launches for k in kernels)
    n = len(gts)
    want = (3 + (n - 1), 0, 2 + (n - 1), n)
    log(f"dataset full width: launches (packed attention, head-split attention, render, "
        f"rasterize) = {counts}, want {want}")
    if counts != want or written != n:
        raise AssertionError(f"the full-width dataset path launched {counts}, want {want}")
    poses = [np.loadtxt(tmp / "house_out" / f"pose_{i:06d}.txt") for i in range(n)]
    pts = surface_points(np, house)
    adds = add_s(np, pts, poses[0], gts[0])
    rot = [rot_err_deg(np, pose, gt) for pose, gt in zip(poses, gts)]
    log(f"dataset full width: register ADD-S={adds * 1e3:.2f} mm (limit "
        f"{house.diameter * 100:.1f} mm) rot_err_deg: " + " ".join(f"{r:.2f}" for r in rot)
        + f" | summary adds_mean={summary['adds_mean'] * 1e3:.2f} mm "
        f"track_ms_mean={summary['track_ms_mean']:.2f} run_dataset_wall_s={wall_s:.2f}")
    if adds >= 0.1 * house.diameter:
        raise AssertionError(f"dataset Register ADD-S {adds:.4f} m >= 0.1 x diameter")
    if max(rot) >= 5.0:
        raise AssertionError(f"dataset rotation error reached {max(rot):.2f} deg")
    return dict(track_ms_mean=summary["track_ms_mean"])


def run_dataset_narrow(torch, np, syn, kernels, tmp):
    """write_mini_dataset at its defaults (120x160, crop 32), then
    run_dataset with seeded narrow nets (embed 64, 4 heads of 16): attention
    goes through the head-split kernel, never the packed one."""
    from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
    from foundationpose_cpp_tpu_torch.demo_dataset import run_dataset
    from foundationpose_cpp_tpu_torch.models import networks

    raster = kernels[-1]
    cfg = FoundationPoseConfig(crop_window_h=32, crop_window_w=32)
    net = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
    reset_counts(kernels)
    syn.write_mini_dataset(str(tmp / "mini"), n_frames=3, cfg=cfg, device="cuda")
    written = raster.launches
    run_dataset(str(tmp / "mini"), str(tmp / "mini_out"), config=cfg, net_config=net,
                write_overlays=False, device="cuda")
    counts = tuple(k.launches for k in kernels)
    log(f"dataset narrow: launches (packed attention, head-split attention, render, "
        f"rasterize) = {counts}")
    if written != 3 or counts[0] != 0 or counts[1] != 4 or counts[2] != 4:
        raise AssertionError(f"the narrow dataset path launched {counts} (rasterize {written} "
                             f"while writing), want (0, 4, 4, 3)")
    poses = [np.loadtxt(tmp / "mini_out" / f"pose_{i:06d}.txt") for i in range(3)]
    if not all(p.shape == (4, 4) and np.isfinite(p).all() for p in poses):
        raise AssertionError("the narrow dataset path gave a pose that is not a finite 4x4")
    return dict(whole_head_launches=counts[1])


def counts_of(kernels) -> tuple:
    return tuple(k.launches for k in kernels)


def run_buckets(torch, np, fp, kernels, K, main):
    """Register and Track with size_buckets=((480, 640),) on the 480x640
    frame and on its top-left 448x608 crop (same intrinsics, the house's mask
    whole inside it): poses against the unbucketed model's, ADD-S on both
    sizes, one buffer set, (render, attention) launches per call."""
    house, frames, gts, base = main["house"], main["frames"], main["gts"], main["model"]
    rgb, depth, mask = frames[0]
    ch, cw = 448, 608
    if mask[ch:].any() or mask[:, cw:].any():
        raise AssertionError(f"the house's mask reaches past the {ch}x{cw} crop")
    crop = (rgb[:ch, :cw], depth[:ch, :cw], mask[:ch, :cw])
    model = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"),
        [house], K, 480, 640, config=fp.FoundationPoseConfig(size_buckets=((480, 640),)),
    )
    model.register(*crop, "house")  # warm-up: cuDNN plans for the bucket's shapes
    reset_counts(kernels)
    got = model.register_with_scores(rgb, depth, mask, "house")
    per_register = counts_of(kernels)
    pose_crop = model.register(*crop, "house")
    track_full = model.track(rgb, depth, got[0], "house")
    track_crop = model.track(crop[0], crop[1], pose_crop, "house")
    counts = counts_of(kernels)
    want = base.register_with_scores(rgb, depth, mask, "house")
    delta = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    track_delta = float(np.abs(track_full - base.track(rgb, depth, got[0], "house")).max())
    pts = surface_points(np, house)
    adds_full, adds_crop = add_s(np, pts, got[0], gts[0]), add_s(np, pts, pose_crop, gts[0])
    sets = len(model._bucket_buffers)
    log(f"buckets: 480x640 in (480, 640) vs unbucketed max|d| register (pose, 252 poses, "
        f"scores)={delta:.3e} track={track_delta:.3e}; ADD-S 480x640={adds_full * 1e3:.2f} mm "
        f"448x608={adds_crop * 1e3:.2f} mm (limit {house.diameter * 100:.1f} mm); track rot_err "
        f"480x640={rot_err_deg(np, track_full, gts[0]):.2f} 448x608="
        f"{rot_err_deg(np, track_crop, gts[0]):.2f} deg; bucket buffer sets={sets}; launches "
        f"(render, attention) per Register={per_register}, 2 Register + 2 Track={counts}")
    if delta > 1e-5 or track_delta > 1e-5:
        raise AssertionError(f"bucketed 480x640 differs from unbucketed by {delta}, {track_delta}")
    if max(adds_full, adds_crop) >= 0.1 * house.diameter:
        raise AssertionError(f"bucketed ADD-S {adds_full:.4f} / {adds_crop:.4f} m >= 0.1 x diameter")
    if sets != 1 or per_register != (2, 3) or counts != (6, 8):
        raise AssertionError(f"buckets: {sets} buffer sets, launches {per_register} / {counts}, "
                             f"want 1, (2, 3) / (6, 8)")


def run_packed(torch, np, profiling, kernels, main):
    """The six house frames chained through make_packed_tracker (u16mm, f32,
    u16mm with rgb_half), the pose left on the card: each pose against
    track() on the frame the step decodes, the rotation gate, and the
    per-frame ms of 64 chained steps (host clock, one synchronize at the end)
    beside track()'s per call."""
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import unpack_frame

    model, frames, gts = main["model"], main["frames"], main["gts"]
    # three windows each, to show the host's spread: track() per call over
    # the six frames chained, then each format's 64 chained steps
    track_ms = []
    for _ in range(3):
        pose, t0 = main["pose"], time.perf_counter()
        for i in range(24):
            pose = model.track(frames[i % 6][0], frames[i % 6][1], pose, "house")
        track_ms.append((time.perf_counter() - t0) * 1e3 / 24)

    def windows(values):
        return "/".join(f"{v:.3f}" for v in values)

    for fmt, half in (("u16mm", False), ("f32", False), ("u16mm", True)):
        name = fmt + ("+rgb_half" if half else "")
        step = model.make_packed_tracker("house", (480, 640), depth_format=fmt, rgb_half=half)
        host = [model.pack_frame(rgb, depth, fmt, half) for rgb, depth, _ in frames]
        dev = [torch.from_numpy(p).cuda() for p in host]
        pose = torch.from_numpy(main["pose"]).cuda()
        step(dev[0], pose)  # warm-up
        reset_counts(kernels)
        chain = []
        for packed in dev:
            chain.append(step(packed, pose))
            pose = chain[-1]
        counts = counts_of(kernels)
        poses = [p.cpu().numpy() for p in chain]
        delta, prev = 0.0, main["pose"]
        for packed, got in zip(dev, poses):
            rgb_q, depth_q = (t.cpu().numpy() for t in unpack_frame(packed, (480, 640), fmt, half))
            delta = max(delta, float(np.abs(got - model.track(rgb_q, depth_q, prev, "house")).max()))
            prev = got
        rot = [rot_err_deg(np, p, gt) for p, gt in zip(poses, gts)]
        times = {"numpy": [], "card": []}
        for _ in range(3):
            for src, frames_in in (("numpy", host), ("card", dev)):
                pose = torch.from_numpy(main["pose"]).cuda()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(64):
                    pose = step(frames_in[i % len(frames_in)], pose)
                torch.cuda.synchronize()
                times[src].append((time.perf_counter() - t0) * 1e3 / 64)
        if name == "u16mm":
            # the card's share of a chained step: kernel time per step under
            # torch.profiler against the unprofiled host time per frame
            with tempfile.TemporaryDirectory() as tmp, profiling.trace(tmp) as prof:
                pose = torch.from_numpy(main["pose"]).cuda()
                for i in range(16):
                    pose = step(dev[i % len(dev)], pose)
                torch.cuda.synchronize()
            kernels_run = [e for e in prof.key_averages()
                           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in kernels_run) / 16 / 1e3
            frame_ms = min(times["card"])
            busy = (f"{device_ms:.3f} ms of kernel time a step in {len(kernels_run)} distinct "
                    f"kernels, {sum(e.count for e in kernels_run) / 16:.0f} launches a step "
                    f"({device_ms / frame_ms:.1%} of the fastest window's {frame_ms:.3f} ms "
                    f"frame)" if kernels_run
                    else "device time not measured (the profiler saw no device activity)")
            log(f"packed {name}: {busy}; longest: " + ", ".join(
                f"{e.key[:48]}={e.self_device_time_total / 16 / 1e3:.3f}" for e in sorted(
                    kernels_run, key=lambda e: -e.self_device_time_total)[:5]))
        log(f"packed {name} ({len(host[0])} bytes a frame): max|d| vs track() on the decoded "
            f"frame={delta:.3e} (limit 1e-5); launches (render, attention)={counts}; rot_err_deg: "
            + " ".join(f"{r:.2f}" for r in rot)
            + f"; per frame over 64 chained steps, three windows: {windows(times['numpy'])} ms "
            f"from numpy (one upload each), {windows(times['card'])} ms from frames already on "
            f"the card; track() {windows(track_ms)} ms a call")
        if delta > 1e-5:
            raise AssertionError(f"packed {name} differs from track() by {delta}")
        if counts != (len(dev), len(dev)) or max(rot) >= 5.0:
            raise AssertionError(f"packed {name}: launches {counts}, rotation error {max(rot):.2f}")


def run_async(torch, np, profiling, kernels, main):
    """AsyncTracker over the port's frame ring, run(max_frames=64,
    pipeline_depth=3), while a producer thread pushes the six house frames in
    a cycle: a push a millisecond as bench.py's feeder, once with f32 meters
    (``pack_frame`` quantizes them to millimeters on the producer's thread,
    as bench.py feeds it) and once with uint16 millimeters, a depth camera's
    own frames, which pass through; then uint16 millimeters at a 30 fps
    camera's rate, with the poses read 3 frames late and at once, and at once
    with the uploader polling the empty ring every 5 ms instead of 0.5."""
    import threading

    from foundationpose_cpp_tpu_torch.pipeline.async_tracker import AsyncTracker

    model, frames = main["model"], main["frames"]
    sensor = [(rgb, np.round(depth.astype(np.float64) * 1000).astype(np.uint16))
              for rgb, depth, _ in frames]
    camera = "u16 millimeters at 30 frames/s"
    for name, feed, period, depth, poll in (("f32 meters", [f[:2] for f in frames], 0.001, 3, 0.0005),
                                            ("u16 millimeters", sensor, 0.001, 3, 0.0005),
                                            (camera, sensor, 1 / 30, 3, 0.0005),
                                            (camera, sensor, 1 / 30, 0, 0.0005),
                                            (camera, sensor, 1 / 30, 0, 0.005)):
        tracker = AsyncTracker(model, "house", (480, 640), capacity=4)
        halt = threading.Event()

        def producer(tracker=tracker, feed=feed, period=period, halt=halt):
            i = 0
            while not halt.is_set():
                tracker.push_frame(*feed[i % len(feed)])
                i += 1
                time.sleep(period)

        feeder = threading.Thread(target=producer, daemon=True)
        feeder.start()
        try:
            tracker.run(main["pose"], max_frames=2)  # warm-up
            dropped0 = tracker.dropped_frames
            reset_counts(kernels)
            t0 = time.perf_counter()
            records = tracker.run(main["pose"], max_frames=64, pipeline_depth=depth,
                                  idle_sleep_s=poll)
            rate = len(records) / (time.perf_counter() - t0)
            counts = counts_of(kernels)
        finally:
            halt.set()
            feeder.join(timeout=10)
        dropped = tracker.dropped_frames - dropped0
        tracker.close()
        lat = np.array([r.latency_s for r in records]) * 1e3
        skipped = sum(r.skipped_frames for r in records)
        log(f"async, producer pushing {name}, pipeline_depth={depth}, idle_sleep_s={poll}: "
            f"{len(records)} records, "
            f"{rate:.2f} frames/s, "
            f"latency_ms median={np.median(lat):.3f} p90={np.percentile(lat, 90):.3f}, "
            f"dispatch_ms median={np.median([r.dispatch_s for r in records]) * 1e3:.3f}, "
            f"dropped_frames={dropped}, skipped_frames={skipped}, pushed={tracker.pushed_frames}; "
            f"launches (render, attention)={counts}")
        if len(records) != 64 or not all(np.isfinite(r.pose).all() for r in records):
            raise AssertionError(f"async: {len(records)} records, or a pose that is not finite")
        if counts != (64, 64) or feeder.is_alive():
            raise AssertionError(f"async launched {counts}, want (64, 64)")


def run_infer_cores(torch, np, fp, kernels, main):
    """The refiner and scorer cores at n = 1, 5, 64, 252 on crops of the
    house from render_and_transform at 252 hypotheses: the refiner against a
    direct call of its net on the same rows, the scorer against a direct call
    on the same zero-padded batch (its att_cross attends across the padding)."""
    import torch.nn.functional as F

    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
    from foundationpose_cpp_tpu_torch.pipeline.renderer import render_and_transform

    model, (rgb, depth, mask) = main["model"], main["frames"][0]
    cfg, mesh, K = model._cfg, model._meshes["house"], model._K
    refiner = fp.create_refiner_core(str(ROOT / "weights" / "refiner_multi_full.npz"))
    scorer = fp.create_scorer_core(str(ROOT / "weights" / "scorer_multi_full.npz"))
    with torch.inference_mode():
        depth_t, mask_t, rgb_t = (model._upload(a) for a in (depth, mask, rgb))
        poses, xyz_map, _ = fpp.prepare_register(depth_t, mask_t, model._rot_grid, K, cfg)
        r_in, t_in = render_and_transform(mesh, poses, rgb_t, xyz_map, K, cfg.refine_crop_ratio, cfg)
    for core, per_call in ((refiner, (0, 1)), (scorer, (0, 2))):
        kind = core.output_names()
        for n in (1, 5, 64, 252):
            blobs = {"render_input": r_in[:n], "transf_input": t_in[:n]}
            core.infer(blobs)  # warm-up
            reset_counts(kernels)
            got = core.infer(blobs)
            counts = counts_of(kernels)
            bucket = next(b for b in core.buckets if b >= n)
            pad = (0, 0, 0, 0, 0, 0, 0, bucket - n)
            with torch.inference_mode():
                if "scores" in kind:
                    direct = core.net(F.pad(r_in[:n], pad), F.pad(t_in[:n], pad))
                    direct = {k: v[:n] for k, v in direct.items()}
                else:
                    direct = core.net(r_in[:n], t_in[:n])
            delta = max(float((got[k] - direct[k]).abs().max()) for k in kind)
            scale = max(float(direct[k].abs().max()) for k in kind)
            ms = cuda_ms(torch, lambda: core.infer(blobs), 5)
            # padded rows change nothing but the convolution plans of a
            # refiner batch that is not a bucket: bf16 rounding apart
            limit = 0.0 if ("scores" in kind or n == bucket) else 0.02 * max(scale, 1.0)
            log(f"infer core {'/'.join(kind)} n={n} (bucket {bucket}): max|d| vs direct "
                f"{'padded ' if 'scores' in kind else ''}call={delta:.3e} (limit {limit:.1e}, "
                f"max|out|={scale:.3f}) ms={ms:.3f} launches (render, attention)={counts}")
            if delta > limit or counts != per_call:
                raise AssertionError(f"infer core {kind} n={n}: |d| {delta}, launches {counts}")


def scan_chain(np, tproc, tmp):
    """The scanned-mesh chain of the reference's BundleSDF configuration:
    scanned_blob(seed=3) -> binary PLY with its PNG texture -> the native
    parser (timed alone) -> load_mesh (timed) -> decimation to 12,000 faces
    -> subdivide_adaptive(max_faces=32_768, patch_k=4). Returns (raw asset,
    final asset)."""
    from foundationpose_cpp_tpu_torch import native
    from foundationpose_cpp_tpu_torch.meshio import mesh_loader
    from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
    from foundationpose_cpp_tpu_torch.meshio.subdivide import subdivide_adaptive

    blob = tproc.scanned_blob(seed=3)
    ply = tmp / "scan.ply"
    tproc.write_ply(blob, str(ply), str(tmp / "scan_tex.png"), binary=True)
    t0 = time.perf_counter()
    native.load_mesh_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = native.parse_ply_native(str(ply))
    parse_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    raw = mesh_loader.load_mesh("scan", str(ply))
    load_ms = (time.perf_counter() - t0) * 1e3
    if parsed is None or raw.num_faces != blob.num_faces or not np.array_equal(raw.faces, blob.faces):
        raise AssertionError("the native PLY parser did not give back the scan's faces")
    t0 = time.perf_counter()
    dec = decimate_vertex_clustering(raw, target_faces=12_000)
    final, info = subdivide_adaptive(dec, max_faces=32_768, patch_k=4)
    prep_s = time.perf_counter() - t0
    log(f"scan: faces raw={raw.num_faces} decimated={dec.num_faces} final={final.num_faces} "
        f"subdivide_rounds={info['rounds']} (max residual {info['max_residual_error']:.3f}); "
        f"vertices raw={raw.vertices.shape[0]} final={final.vertices.shape[0]}; mesh library "
        f"build {build_s:.2f} s, native_parse_ms={parse_ms:.2f} load_ms={load_ms:.2f}, "
        f"decimate + subdivide {prep_s:.2f} s on the host")
    if not (raw.num_faces > 100_000 and dec.num_faces <= 12_000 and final.num_faces <= 32_768):
        raise AssertionError(f"scan chain face counts {raw.num_faces}, {dec.num_faces}, "
                             f"{final.num_faces}")
    return raw, final


def output_digests(np, model, name, frames) -> dict:
    """sha256 (16 hex digits) of a Register's best pose, of its poses and
    scores (``register_with_scores`` on ``frames[0]``) and of three Track
    poses chained from the best over ``frames[1:4]``: a change that keeps
    the numerics gives its parent's digests."""
    import hashlib

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    rgb, depth, mask = frames[0]
    best, poses, scores = model.register_with_scores(rgb, depth, mask, name)
    out = {"register best": digest(best), "register poses": digest(poses),
           "register scores": digest(scores)}
    pose = best
    for i, (rgb_i, depth_i, _) in enumerate(frames[1:4], 1):
        pose = model.track(rgb_i, depth_i, pose, name)
        out[f"track {i}"] = digest(pose)
    return out


def rotvec_matrix(np, axis, deg):
    """Rotation of deg degrees about axis (Rodrigues)."""
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = math.radians(deg)
    return np.eye(3) + math.sin(a) * kx + (1 - math.cos(a)) * kx @ kx


def run_scan(torch, np, fp, tproc, syn, transforms, render, rasterize_tiled, sweep, kernels, K,
             tmp):
    """Config 4 (a scanned object): the scan chain, then K2 at 252 views and
    at one view and K4 on the raw and the final mesh against their plain
    versions; then with the trained weights, on render_scene frames of the
    final mesh: Track from poses 15 deg / 8 mm off (tests/test_scan_pipeline.py's
    gate: mean rotation error under 5 deg), the true pose outscoring its
    180-degree flip, and a full Register with 6 Track frames (ADD-S and
    rotation error printed, not gated: the JAX package never ran a Register
    at scan scale)."""
    from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants

    raw, final = scan_chain(np, tproc, tmp)
    render_rows = check_render(torch, transforms, render, sweep,
                               [("scan", 252, 160, final), ("scan", 1, 160, final)])
    log(f"  render kernel regions (N=1 runs {render.kernel_config()['few_region_w']}x"
        f"{render.kernel_config()['few_region_h']} regions, "
        f"{math.ceil(160 / render.kernel_config()['few_region_w']) ** 2} blocks)")
    raster_rows = check_rasterize(torch, transforms, rasterize_tiled, render, sweep,
                                  [("scan_raw", 1, 480, 640, raw),
                                   ("scan_final", 1, 480, 640, final)])

    h, w = 480, 640
    mesh = MeshConstants.from_asset(final, "cuda")
    model = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), [final], K, h, w)
    gts = []
    for i in range(2):
        gt = syn.default_pose(tz=0.6)
        gt[:3, :3] = syn.euler_xyz_deg([0.0, 40.0 * i, 20.0 * i]) @ gt[:3, :3]
        gts.append(gt.astype(np.float32))
    reset_counts(kernels)
    frames = [syn.render_scene(mesh, gt, K, h, w) for gt in gts]
    rots, ranks = [], []
    cfg, Kt = model._cfg, model._K
    for i, ((rgb, depth, _), gt) in enumerate(zip(frames, gts)):
        hyp = gt.copy()
        hyp[:3, :3] = rotvec_matrix(np, np.array([0.15, -0.12, 0.10]) * (1 if i % 2 == 0 else -1),
                                    15.0) @ hyp[:3, :3]
        hyp[:3, 3] += np.array([0.004, -0.004, 0.006], np.float32)
        tracked = model.track(rgb, depth, hyp, "scan", refine_itr=2)
        rots.append(rot_err_deg(np, tracked, gt))
        flip = gt.copy()
        flip[:3, :3] = flip[:3, :3] @ syn.euler_xyz_deg([0.0, 0.0, 180.0])
        with torch.inference_mode():
            rgb_t, depth_t = model._upload(rgb), model._upload(depth)
            xyz_map = depth_ops.depth_to_xyz(depth_t, Kt, cfg.min_depth)
            _, scores = fpp.refine_and_score(
                model._meshes["scan"], model._refiner, model._scorer,
                torch.as_tensor(np.stack([gt, flip]).astype(np.float32), device="cuda"),
                rgb_t, xyz_map, Kt, 1, cfg)
        scores = scores.float().cpu().numpy()
        ranks.append(bool(scores[0] > scores[1]))
        log(f"scan track {i}: from {rot_err_deg(np, hyp, gt):.2f} deg / "
            f"{np.linalg.norm(hyp[:3, 3] - gt[:3, 3]) * 1e3:.2f} mm off -> rot_err="
            f"{rots[-1]:.2f} deg t_err={np.linalg.norm(tracked[:3, 3] - gt[:3, 3]) * 1e3:.2f} mm "
            f"(refine_itr 2); scores true={scores[0]:.4f} flip={scores[1]:.4f}")
    if float(np.mean(rots)) >= 5.0 or not all(ranks):
        raise AssertionError(f"scan: tracked rotation errors {rots} (mean must be < 5 deg), "
                             f"true pose outscores the flip {ranks}")

    # a full Register on frame 0, then six Track frames of a slow drift
    rgb, depth, mask = frames[0]
    model.register(rgb, depth, mask, "scan")  # warm-up
    drift = []
    for i in range(6):
        gt = gts[0].copy()
        gt[:3, :3] = syn.euler_xyz_deg([0.0, 1.5 * i, 0.0]).astype(np.float32) @ gt[:3, :3]
        gt[0, 3] += 0.003 * i
        drift.append(gt)
    seq = [frames[0]] + [syn.render_scene(mesh, gt, K, h, w) for gt in drift[1:]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose = reg_pose = model.register(rgb, depth, mask, "scan")
    reg_ms = (time.perf_counter() - t0) * 1e3
    adds = add_s(np, surface_points(np, final), reg_pose, gts[0])
    errs, track_ms = [], []
    for (rgb_i, depth_i, _), gt in zip(seq, drift):
        t0 = time.perf_counter()
        pose = model.track(rgb_i, depth_i, pose, "scan")
        track_ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(rot_err_deg(np, pose, gt))
    counts = counts_of(kernels)
    log(f"scan register: ADD-S={adds * 1e3:.2f} mm (0.1 x diameter = {final.diameter * 100:.1f} "
        f"mm, not gated) rot_err={rot_err_deg(np, reg_pose, gts[0]):.2f} "
        f"deg register_ms={reg_ms:.2f}; track rot_err_deg: " + " ".join(f"{e:.2f}" for e in errs)
        + " | track_ms: " + " ".join(f"{t:.2f}" for t in track_ms))
    log(f"scan launches (packed attention, head-split attention, render, rasterize) = {counts}")
    log("scan output digests: " + json.dumps(output_digests(np, model, "scan", seq)))
    if not np.isfinite(pose).all() or counts[0] == 0 or counts[2] == 0 \
            or counts[3] != len(frames) + len(seq) - 1:
        raise AssertionError(f"scan path launches {counts}")
    return dict(render=render_rows, raster=raster_rows, launches=counts)


def run_multi_object(torch, np, fp, tproc, syn, transforms, render, sweep, kernels, K):
    """Config 5 (multi-object tracking): 8 cubes on a 4x2 grid 0.15 m apart
    at 0.8 m, each rendered by render_scene and composited by nearest depth
    into one 480x640 frame; track_batch of the 8 from poses ~5 deg / 5 mm off
    their own for 5 frames (K1 at B=8, K2 at N=8). Each instance against its
    true pose (rotation modulo the cube's symmetries, translation) and
    against track() of that instance alone. K2 is first held against its
    plain version at N=8 on the cube."""
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
    from foundationpose_cpp_tpu_torch.utils import metrics

    h, w, n = 480, 640, 8
    cube = tproc.textured_cube(size=0.08)
    render_rows = check_render(torch, transforms, render, sweep, [("cube", n, 160, cube)])
    mesh = MeshConstants.from_asset(cube, "cuda")
    rng = np.random.default_rng(8)
    gts, rgb, depth = [], np.zeros((h, w, 3), np.uint8), np.zeros((h, w), np.float32)
    for i in range(n):
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = syn.euler_xyz_deg(rng.uniform(-40, 40, 3))
        gt[:3, 3] = [(i % 4 - 1.5) * 0.15, (i // 4 - 0.5) * 0.15, 0.8]
        gts.append(gt)
        rgb_i, depth_i, _ = syn.render_scene(mesh, gt, K, h, w)
        nearer = (depth_i > 0) & ((depth == 0) | (depth_i < depth))
        rgb[nearer], depth[nearer] = rgb_i[nearer], depth_i[nearer]
    gts = np.stack(gts)
    starts = gts.copy()
    for i in range(n):
        axis = rng.normal(size=3)
        starts[i, :3, :3] = rotvec_matrix(np, axis, 5.0) @ gts[i, :3, :3]
        d = rng.normal(size=3)
        starts[i, :3, 3] += 0.005 * d / np.linalg.norm(d)
    model = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), [cube], K, h, w)
    model.track_batch(rgb, depth, starts, "cube")  # warm-up: cuDNN plans at N=8
    reset_counts(kernels)
    poses, ms = starts, []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = model.track_batch(rgb, depth, poses, "cube")
        ms.append((time.perf_counter() - t0) * 1e3 / n)
    counts = counts_of(kernels)
    alone = []
    for i in range(n):
        pose = starts[i]
        for _ in range(5):
            pose = model.track(rgb, depth, pose, "cube")
        alone.append(pose)
    delta = float(np.abs(poses - np.stack(alone)).max())
    rot = [metrics.rotation_error_deg_sym(p, g, cube.symmetries) for p, g in zip(poses, gts)]
    trans = [float(np.linalg.norm(p[:3, 3] - g[:3, 3])) for p, g in zip(poses, gts)]
    log(f"multi-object: {n} cubes, 5 track_batch frames: rot_err_deg (mod the cube's "
        f"symmetries) " + " ".join(f"{r:.2f}" for r in rot) + " | t_err_mm "
        + " ".join(f"{t * 1e3:.2f}" for t in trans)
        + f"; max|d| vs track() of each alone={delta:.3e}; ms per object "
        + " ".join(f"{m:.3f}" for m in ms) + f"; launches (packed attention, head-split "
        f"attention, render, rasterize)={counts}")
    if max(rot) >= 5.0 or max(trans) >= 0.01:
        raise AssertionError(f"multi-object: rotation errors {rot}, translation errors {trans}")
    if counts != (5, 0, 5, 0):
        raise AssertionError(f"multi-object launched {counts}, want (5, 0, 5, 0)")
    return dict(launches=counts, ms_per_object=ms, render=render_rows, cube=cube, rgb=rgb,
                depth=depth, starts=starts, gts=gts, model=model)


def lmo8_scene(np, syn, K, device="cuda"):
    """LM-O's eight stand-in meshes (the committed
    ``benchmark/assets/lmo8_*.ply``, 5.7k-22.5k faces) on a 4x2 grid 0.24 x
    0.30 m apart at 1.0 m, each rendered by render_scene and composited by
    nearest depth into one 480x640 frame, and hypotheses 2 deg / 1 mm off:
    (assets, {name: MeshConstants}, true poses, rgb, depth, hypotheses)."""
    from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants

    config = json.loads((ROOT / "benchmark" / "configs" / "lmo8.json").read_text())
    assets = [load_mesh(m["name"], str(ROOT / m["file"])) for m in config["meshes"]]
    h, w, n = 480, 640, len(assets)
    meshes = {a.name: MeshConstants.from_asset(a, device) for a in assets}
    rng = np.random.default_rng(18)
    gts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        gts[i, :3, :3] = syn.euler_xyz_deg(rng.uniform(-180, 180, 3))
        gts[i, :3, 3] = [(i % 4 - 1.5) * 0.24, (i // 4 - 0.5) * 0.30, 1.0]
    rgb, depth = np.zeros((h, w, 3), np.uint8), np.zeros((h, w), np.float32)
    for i, name in enumerate(meshes):
        rgb_i, depth_i, _ = syn.render_scene(meshes[name], gts[i], K, h, w)
        nearer = (depth_i > 0) & ((depth == 0) | (depth_i < depth))
        rgb[nearer], depth[nearer] = rgb_i[nearer], depth_i[nearer]
    starts = gts.copy()
    for i in range(n):
        starts[i, :3, :3] = rotvec_matrix(np, rng.normal(size=3), 2.0) @ gts[i, :3, :3]
        d = rng.normal(size=3)
        starts[i, :3, 3] += 0.001 * d / np.linalg.norm(d)
    return assets, meshes, gts, rgb, depth, starts


def digest(np, a) -> str:
    """sha256 (16 hex digits) of an array's bytes."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def run_mixed_meshes(torch, np, fp, syn, transforms, render, sweep, profiling, kernels, K):
    """Distinct meshes in one ``track_batch`` (the lmo8 configuration,
    ``lmo8_scene``). K2 over their mesh table (one launch pair, each view on
    its own mesh and diameter) against its plain version at N=8 and 160x160,
    with the wrapper's, the queued and the plain ms, eight one-view
    launches' ms and the bound; then the mixed program from poses 2 deg /
    1 mm off: its replay against its function run eagerly (``check_program``)
    and, with the counts set to 0 just before a call, one K2 and one K1
    launch a call; the poses' digest (``lmo8 digest``), which a change
    that keeps the numerics shares with its parent."""
    from foundationpose_cpp_tpu_torch.ops import rasterize as ras
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import CATALOG
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshSet, render_branch
    from foundationpose_cpp_tpu_torch.utils import metrics

    assets, meshes, gts, rgb, depth, starts = lmo8_scene(np, syn, K)
    names = tuple(meshes)
    h, w, n, crop = 480, 640, len(assets), 160
    mesh_set = MeshSet.build(meshes).select(names)

    poses = torch.from_numpy(gts).cuda()
    Kt = torch.from_numpy(K).cuda()
    tfs = transforms.compute_crop_window_tf(poses, Kt, (crop, crop), 1.2, mesh_set.diameter)
    clip_mat = transforms.pose_clip_matrix(poses, transforms.construct_bbox2d(tfs, crop, crop),
                                           Kt, h, w)
    cfg = fp.FoundationPoseConfig()
    tail = (crop, crop, mesh_set.diameter, cfg.min_depth, cfg.max_depth, cfg.w_ambient,
            cfg.w_diffuse)
    set_args = (mesh_set.vertices, mesh_set.normals, mesh_set.texcoords, mesh_set.faces,
                mesh_set.texture, poses, clip_mat)
    reset_counts((render.render_views,))
    got = render.render_views(*set_args, *tail, table=mesh_set.table)
    want = render.render_views_plain(*set_args, *tail, table=mesh_set.table)
    torch.cuda.synchronize()
    bad, err = sweep.render_disagreement(got, want, RENDER_TOL)
    fg = (want.abs().sum(-1) > 0).float().mean().item()
    if not (bad < RENDER_BAD_FRAC and fg > 0.1 and torch.isfinite(got).all()
            and render.render_views.launches == 1):
        raise AssertionError(f"render kernel over the lmo8 table: {bad:.4%} pixels off, fg "
                             f"{fg:.2f}, {render.render_views.launches} launches")

    def one_view_each():
        for i, name in enumerate(names):
            m = meshes[name]
            render_branch(m, poses[i:i + 1], clip_mat[i:i + 1], crop, crop, cfg)

    k_ms = cuda_ms(torch, lambda: render.render_views(*set_args, *tail, table=mesh_set.table), 10)
    q_ms = cuda_ms_queued(torch, lambda: render.render_views(*set_args, *tail,
                                                             table=mesh_set.table), 10)
    p_ms = cuda_ms(torch, lambda: render.render_views_plain(*set_args, *tail,
                                                            table=mesh_set.table), 1, warmup=0)
    each_ms = cuda_ms_queued(torch, one_view_each, 10)
    needed = 0
    for i, name in enumerate(names):
        m = meshes[name]
        clip = transforms.transform_points_homogeneous(clip_mat[i:i + 1], m.vertices)
        needed += tests_needed(torch, ras, clip, m.faces, crop, crop)
    b_ms, b_by = bound(nbytes(*set_args, mesh_set.table.rows, mesh_set.diameter, got),
                       needed * RENDER_TEST_FLOPS, F32_FLOPS)
    log(f"render lmo8 table N={n} {crop}x{crop} {mesh_set.faces.shape[0]} faces in "
        f"{n} meshes: pixels_off={bad:.4%} max_abs_err={err:.3e}; wrapper_ms={k_ms:.4f} "
        f"(checks + 2 launches) wrapper_ms_queued={q_ms:.4f} plain_ms={p_ms:.4f} "
        f"{n}_one_view_launches_ms_queued={each_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; "
        f"{needed} face-pixel tests needed)")

    model = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), assets, K, h, w)
    model.track_batch(rgb, depth, starts, list(names))  # the capture
    program = model._track_cache[("track_batch", CATALOG, (h, w), 1, n, False)]
    idx = model._mesh_catalog().indices(names)
    row = check_program(torch, np, profiling, f"track_batch N={n} (lmo8, distinct meshes)",
                        program, [torch.from_numpy(a).cuda() for a in (rgb, depth, starts, idx)],
                        20, busy=True)
    reset_counts(kernels)
    out = model.track_batch(rgb, depth, starts, list(names))
    counts = counts_of(kernels)
    alone = np.concatenate([model.track_batch(rgb, depth, starts[i:i + 1], name)
                            for i, name in enumerate(names)])
    rot = [metrics.rotation_error_deg(p, g) for p, g in zip(out, gts)]
    trans = [float(np.linalg.norm(p[:3, 3] - g[:3, 3])) for p, g in zip(out, gts)]
    vs_alone = [metrics.rotation_error_deg(p, q) for p, q in zip(out, alone)]
    log(f"mixed meshes: {n} objects {names}, launches_per_call {program.launches_per_call}; "
        f"a call's launches (packed attention, head-split attention, render, rasterize)="
        f"{counts}; meshset_builds {model.meshset_builds}; rot_err_deg from 2 deg off "
        + " ".join(f"{r:.2f}" for r in rot) + " | t_err_mm "
        + " ".join(f"{t * 1e3:.2f}" for t in trans) + " | deg from each object's one-name "
        "call " + " ".join(f"{v:.3f}" for v in vs_alone))
    log(f"lmo8 digest: {digest(np, out)} (sha256 of the {n} poses of one track_batch over "
        f"{list(names)})")
    per_call = program.launches_per_call
    if (counts != (1, 0, 1, 0) or per_call.get("render_views") != 1
            or per_call.get("mha_packed_qkv") != 1 or model.meshset_builds != 1
            or not np.isfinite(out).all()):
        raise AssertionError(f"mixed meshes launched {counts} ({per_call}), "
                             f"{model.meshset_builds} mesh-set builds")
    return dict(render=dict(name="lmo8 table", n=n, err=err, ms=k_ms, queued_ms=q_ms,
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, one_view_ms=each_ms),
                program=row, model=model, names=names, rgb=rgb, depth=depth, starts=starts)


def run_churn(torch, np, profiling, kernels, mixed, calls: int = 300) -> dict:
    """A changing set of LM-O's objects through the mixed phase's model: one
    call at each N from 1 to 8 (the first N objects) warms a program for
    each N; then ``calls`` calls, each a seeded random ordered set of 1 to 8
    of the objects (at least 200 distinct), each object from its hypothesis.
    After the warm-up: no graph capture and no catalog build; every call's
    poses bit for bit its program's function run eagerly on the same
    inputs; one K2 and one K1 launch a call (the counts set to 0 just
    before it); a replay under set_sync_debug_mode("error") for three sets;
    ms a call (host clock, each call ending with its poses read back)."""
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import CATALOG

    model, names, rgb, depth, starts = (mixed[k] for k in ("model", "names", "rgb", "depth",
                                                           "starts"))
    n, (h, w) = len(names), depth.shape
    for k in range(1, n + 1):
        model.track_batch(rgb, depth, starts[:k], list(names[:k]))
    captures, builds = profiling.RECORDER.captures, model.meshset_builds
    rng = np.random.default_rng(22)
    sets = [tuple(rng.permutation(n)[:rng.integers(1, n + 1)].tolist()) for _ in range(calls)]
    catalog = model._mesh_catalog()
    frame = [torch.from_numpy(a).cuda() for a in (rgb, depth)]

    def args(objects):
        idx = torch.from_numpy(catalog.indices([names[j] for j in objects])).cuda()
        return [*frame, torch.from_numpy(starts[list(objects)]).cuda(), idx]

    ms, mismatched, launches = [], [], set()
    for objects in sets:
        reset_counts(kernels)
        t0 = time.perf_counter()
        got = model.track_batch(rgb, depth, starts[list(objects)], [names[j] for j in objects])
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.add(counts_of(kernels))
        program = model._track_cache[("track_batch", CATALOG, (h, w), 1, len(objects), False)]
        with torch.inference_mode():
            want = program.fn(*args(objects)).cpu().numpy()
        if not np.array_equal(got, want):
            mismatched.append(objects)
    sync_errors = []
    with torch.inference_mode():
        for objects in sets[:3]:
            program = model._track_cache[("track_batch", CATALOG, (h, w), 1, len(objects), False)]
            a = args(objects)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                program(*a)
            except RuntimeError as exc:
                sync_errors.append(str(exc)[:200])
            finally:
                torch.cuda.set_sync_debug_mode("default")
    keys = sorted(k[4] for k in model._track_cache if k[1] == CATALOG)
    made = profiling.RECORDER.captures - captures, model.meshset_builds - builds
    per_call = {k[4]: model._track_cache[k].launches_per_call for k in model._track_cache
                if k[1] == CATALOG}
    log(f"churn: {calls} calls over {len(set(sets))} distinct ordered sets of 1-{n} of {n} "
        f"objects after one warm-up call at each N; programs over the catalog at N={keys}; "
        f"captures and catalog builds after the warm-up {made}; replay vs eager: "
        f"{len(mismatched)} calls differ; a call's launches (packed attention, head-split "
        f"attention, render, rasterize) {sorted(launches)}; replay under sync debug 'error': "
        f"{sync_errors or 'no sync'}; ms a call mean {np.mean(ms):.3f} median "
        f"{np.median(ms):.3f} p95 {np.percentile(ms, 95):.3f} (host clock, with the eager "
        f"comparison between calls)")
    if (made != (0, 0) or mismatched or launches != {(1, 0, 1, 0)} or sync_errors
            or len(set(sets)) < 200 or keys != list(range(1, n + 1))
            or any(p.get("render_views") != 1 or p.get("mha_packed_qkv") != 1
                   for p in per_call.values())):
        raise AssertionError(f"churn: captures/builds {made}, {len(mismatched)} mismatched, "
                             f"launches {launches}, sync {sync_errors}, keys {keys}, {per_call}")
    return dict(distinct=len(set(sets)), ms_mean=float(np.mean(ms)))


def run_sync_free(torch, np, main):
    """64 chained packed steps and a register_step on tensors already on the
    card under torch.cuda.set_sync_debug_mode("error"): any operation that
    waits for the card raises. The poses must equal the same calls' outside
    the mode."""
    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp

    model, (rgb, depth, mask) = main["model"], main["frames"][0]
    step = model.make_packed_tracker("house", (480, 640))
    packed = torch.from_numpy(model.pack_frame(rgb, depth)).cuda()
    frame = [torch.from_numpy(a).cuda() for a in (rgb, depth, mask)]
    pose0 = torch.from_numpy(main["pose"]).cuda()

    def run():
        pose = pose0
        for _ in range(64):
            pose = step(packed, pose)
        with torch.inference_mode():
            best = fpp.register_step(model._meshes["house"], model._refiner, model._scorer,
                                     *frame, model._rot_grid, model._K, 1, model._cfg)[0]
        return pose, best

    want = [t.cpu() for t in run()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        got = run()
        queued_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    log(f"sync: 64 chained packed steps + register_step ran under set_sync_debug_mode('error'); "
        f"host done queueing after {queued_ms:.2f} ms, card done after {total_ms:.2f} ms; poses "
        f"equal to the same calls outside the mode: {same}")
    if not same:
        raise AssertionError("the calls under the sync debug mode gave other poses")


def tree_max_abs(got, want) -> float:
    """max |got - want| over a tensor, a tuple or a dict of them (bools as 0/1)."""
    if isinstance(got, dict):
        return max(tree_max_abs(got[k], want[k]) for k in want)
    if isinstance(got, (tuple, list)):
        return max(tree_max_abs(g, w) for g, w in zip(got, want))
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def host_ms(torch, fn, calls: int) -> list[float]:
    """ms a call of fn() by the host clock, over ``calls`` calls ended by a
    synchronize; three windows."""
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / calls)
    return out


def kernel_ms(torch, profiling, fn, calls: int) -> float | None:
    """The card's kernel time a call of fn() under torch.profiler, None when
    the profiler saw no device activity."""
    return kernel_split(torch, profiling, fn, calls)[0]


def check_program(torch, np, profiling, label, program, args, calls, busy=False) -> dict:
    """One program key: its replay on ``args`` against its function run
    eagerly on them (max |d| 0), launches a call the same both ways, a
    replay under set_sync_debug_mode("error"), then ms a call graphed and
    eager (host clock, median of three windows of ``calls`` calls) and, with
    ``busy``, the card's kernel time a call and its share of that ms."""
    from foundationpose_cpp_tpu_torch.ops import cuda_build

    def counted(fn):
        before = cuda_build.launch_counts()
        out = fn()
        return out, cuda_build.launches_since(before)

    with torch.inference_mode():
        if not program.captured:
            program(*args)
        want, eager_launches = counted(lambda: program.fn(*args))
        got, graph_launches = counted(lambda: program(*args))
        delta = tree_max_abs(got, want)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            program(*args)
            sync_error = None
        except RuntimeError as exc:
            sync_error = str(exc)[:200]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        graphed = host_ms(torch, lambda: program(*args), calls)
        eager = host_ms(torch, lambda: program.fn(*args), calls)
        shares = ""
        if busy:
            for name, fn, ms in (("graphed", lambda: program(*args), graphed),
                                 ("eager", lambda: program.fn(*args), eager)):
                k = kernel_ms(torch, profiling, fn, calls)
                shares += (f"; {name}: {k:.3f} ms of kernels a call, busy {k / min(ms):.1%} of "
                           f"the fastest window" if k is not None
                           else f"; {name}: kernel time not measured (no device activity seen)")
    g_med, e_med = float(np.median(graphed)), float(np.median(eager))
    log(f"graphs {label}: key {program.key}; capture {program.capture_ms:.1f} ms, "
        f"{program.nodes} nodes; replay vs eager max|d|={delta:.3e}; launches a call graphed "
        f"{graph_launches} eager {eager_launches}; replay under sync debug 'error': "
        f"{'no sync' if sync_error is None else sync_error}; ms a call graphed {g_med:.3f} "
        f"(windows {'/'.join(f'{v:.3f}' for v in graphed)}) eager {e_med:.3f} "
        f"(windows {'/'.join(f'{v:.3f}' for v in eager)}){shares}")
    if delta != 0.0 or graph_launches != eager_launches or sync_error is not None:
        raise AssertionError(f"graphs {label}: max|d| {delta}, launches {graph_launches} vs "
                             f"{eager_launches}, sync {sync_error}")
    return dict(key=program.key, capture_ms=program.capture_ms, nodes=program.nodes,
                graphed_ms=g_med, eager_ms=e_med, launches=graph_launches)


def chain_delta(torch, program, packed, pose0, steps: int = 64) -> float:
    """max |d| over ``steps`` chained replays of a packed step against the
    same chain of its function run eagerly."""
    with torch.inference_mode():
        got, want, g, w = [], [], pose0, pose0
        for _ in range(steps):
            g = program(packed, g)
            got.append(g)
        for _ in range(steps):
            w = program.fn(packed, w)
            want.append(w)
    return tree_max_abs(got, want)


def graph_memory(torch, fp, house, K, frame, shared: bool) -> dict:
    """GB over the process's baseline while a fresh house model captures its
    Register (refine_itr 1 and 2) and Track graphs, in one pool or
    (``shared`` False) in a pool each: ``max_memory_allocated`` (the peak of
    live tensors), the tensors still allocated after (the graphs' outputs
    and the model), and the memory the allocator keeps reserved after, which
    holds the graphs' private pools."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    model = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), [house], K, 480, 640)
    if not shared:
        model._graph_pool = None
    rgb, depth, mask = frame
    for itr in (1, 2):
        model.register(rgb, depth, mask, "house", refine_itr=itr)
    model.track(rgb, depth, model.register(rgb, depth, mask, "house"), "house")
    torch.cuda.synchronize()
    out = dict(held_gb=(torch.cuda.memory_allocated() - base) / 2**30,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 2**30,
               reserved_gb=(torch.cuda.memory_reserved() - base_reserved) / 2**30)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_program_faults(torch, np, model, frame, up) -> None:
    """The two faults of the first programs, on the house Register at
    refine_itr 1: a bool mask after a uint8 one is served by the same
    program and equals the eager Register; after 300 other constants
    (``transforms._constant``; a bounded cache would free the program's
    own and hand their memory to these), a replay equals eager."""
    from foundationpose_cpp_tpu_torch.geometry import transforms

    rgb, depth, mask = frame
    key = ("register", "house", (480, 640), 1, False)
    program = model._register_cache[key]
    keys = list(model._register_cache)
    with torch.inference_mode():
        want = program.fn(*up)
    got = model.register_with_scores(rgb, depth, mask > 0, "house")
    delta = max(float(np.abs(g - w.cpu().numpy()).max()) for g, w in zip(got, want))
    same = model._register_cache[key] is program and list(model._register_cache) == keys
    log(f"graphs fault pin, mask dtype: register_with_scores with a bool mask after uint8 ones, "
        f"the same program {same}, vs the eager Register max|d|={delta:.3e}")
    if delta != 0.0 or not same:
        raise AssertionError(f"a bool mask: max|d| {delta}, same program {same}")
    for i in range(300):
        transforms._constant((float(i) + 0.25, -1.0), model.device)
    with torch.inference_mode():
        got = program(*up)
        want = program.fn(*up)
    delta = tree_max_abs(got, want)
    log(f"graphs fault pin, constants: a replay after 300 other constants vs eager "
        f"max|d|={delta:.3e}")
    if delta != 0.0:
        raise AssertionError(f"a replay after 300 other constants differs by {delta}")


def run_graphs(torch, np, fp, profiling, main, multi, K):
    """Every program key of the pipeline on the card, each against its
    function run eagerly on the same inputs (``check_program``): Register at
    refine_itr 1 and 2 (and ``register_with_scores`` through the public
    call), Track, ``track_batch`` of the eight cubes, the packed step in its
    three formats (each also as a 64-step chain against the eager chain),
    ``AsyncTracker`` at pipeline_depth 0 and 3 on one frame pushed over and
    over (its 64 poses against the eager chain), Register and Track in a
    (480, 640) size bucket fed the frame and its 448x608 crop (one program
    each), and the refiner and scorer cores at n = 1, 5, 64, 252. Then the
    memory a model's graphs hold in one shared pool and in a pool each."""
    import threading

    from foundationpose_cpp_tpu_torch.pipeline.async_tracker import AsyncTracker

    model, house, (rgb, depth, mask) = main["model"], main["house"], main["frames"][0]
    up = [torch.from_numpy(a).cuda() for a in (rgb, depth, mask)]
    pose = torch.from_numpy(main["pose"]).cuda()
    rows = {}
    for itr in (1, 2):
        model.register(rgb, depth, mask, "house", refine_itr=itr)
        rows[f"register itr{itr}"] = check_program(
            torch, np, profiling, f"register refine_itr {itr}",
            model._register_cache[("register", "house", (480, 640), itr, False)], up, 3,
            busy=itr == 1)
    with torch.inference_mode():
        want = model._register_cache[("register", "house", (480, 640), 1, False)].fn(*up)
    got = model.register_with_scores(rgb, depth, mask, "house")
    delta = max(float(np.abs(g - w.cpu().numpy()).max()) for g, w in zip(got, want))
    log(f"graphs register_with_scores: (best, poses, scores) vs the eager register_step "
        f"max|d|={delta:.3e}")
    if delta != 0.0:
        raise AssertionError(f"register_with_scores differs from the eager Register by {delta}")
    check_program_faults(torch, np, model, (rgb, depth, mask), up)
    model.track(rgb, depth, main["pose"], "house")
    rows["track"] = check_program(
        torch, np, profiling, "track",
        model._track_cache[("track", "house", (480, 640), 1, False)], [*up[:2], pose], 20)
    cubes = multi["model"]
    cubes.track_batch(multi["rgb"], multi["depth"], multi["starts"], "cube")
    rows["track_batch 8"] = check_program(
        torch, np, profiling, "track_batch N=8 (cubes)",
        cubes._track_cache[("track_batch", "cube", (480, 640), 1, 8, False)],
        [torch.from_numpy(a).cuda() for a in (multi["rgb"], multi["depth"], multi["starts"])],
        10)
    for fmt, half in (("u16mm", False), ("f32", False), ("u16mm", True)):
        name = f"packed {fmt}" + ("+rgb_half" if half else "")
        step = model.make_packed_tracker("house", (480, 640), depth_format=fmt, rgb_half=half)
        packed = torch.from_numpy(model.pack_frame(rgb, depth, fmt, half)).cuda()
        step(packed, pose)
        rows[name] = check_program(torch, np, profiling, name, step.program, [packed, pose], 20,
                                   busy=name == "packed u16mm")
        delta = chain_delta(torch, step.program, packed, pose)
        log(f"graphs {name}: 64 chained replays vs the eager chain max|d|={delta:.3e}")
        if delta != 0.0:
            raise AssertionError(f"graphs {name}: the chain differs by {delta}")
    packed = torch.from_numpy(model.pack_frame(rgb, depth)).cuda()
    program = model._packed_cache[("packed", "house", (480, 640), 1, "u16mm", False)]
    with torch.inference_mode():
        want, p = [], pose
        for _ in range(64):
            p = program.fn(packed, p)
            want.append(p.cpu().numpy())
    for depth_n in (0, 3):
        tracker = AsyncTracker(model, "house", (480, 640), capacity=4)
        halt = threading.Event()

        def producer(tracker=tracker, halt=halt):
            while not halt.is_set():
                tracker.push_frame(rgb, depth)
                time.sleep(0.001)

        feeder = threading.Thread(target=producer, daemon=True)
        feeder.start()
        try:
            t0 = time.perf_counter()
            records = tracker.run(main["pose"], max_frames=64, pipeline_depth=depth_n)
            fps = len(records) / (time.perf_counter() - t0)
        finally:
            halt.set()
            feeder.join(timeout=10)
            tracker.close()
        delta = max(float(np.abs(r.pose - w).max()) for r, w in zip(records, want))
        log(f"graphs AsyncTracker pipeline_depth={depth_n}: {len(records)} records, "
            f"{fps:.1f} frames/s, poses vs the eager chain on the same frame max|d|={delta:.3e}")
        if len(records) != 64 or delta != 0.0:
            raise AssertionError(f"graphs async depth {depth_n}: {len(records)} records, "
                                 f"max|d| {delta}")
    bucketed = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), [house], K, 480, 640,
        config=fp.FoundationPoseConfig(size_buckets=((480, 640),)))
    for ch, cw in ((480, 640), (448, 608)):
        crop = (rgb[:ch, :cw], depth[:ch, :cw], mask[:ch, :cw])
        bucketed.register(*crop, "house")
        bucketed.track(*crop[:2], main["pose"], "house")
        rows[f"bucket register {ch}x{cw}"] = check_program(
            torch, np, profiling, f"bucket (480, 640) register {ch}x{cw}",
            bucketed._register_cache[("register", "house", (480, 640), 1, True)],
            bucketed._frame_args(*crop), 3)
        args = bucketed._frame_args(*crop[:2])
        rows[f"bucket track {ch}x{cw}"] = check_program(
            torch, np, profiling, f"bucket (480, 640) track {ch}x{cw}",
            bucketed._track_cache[("track", "house", (480, 640), 1, True)],
            [*args[:2], pose, args[2]], 20)
    if len(bucketed._register_cache) != 1 or len(bucketed._track_cache) != 1:
        raise AssertionError(f"the bucket holds {list(bucketed._register_cache)} and "
                             f"{list(bucketed._track_cache)}, want one program each")
    crops = torch.rand((2, 252, 160, 160, 6), device="cuda", generator=torch.Generator(
        "cuda").manual_seed(10))
    for kind in ("refiner", "scorer"):
        core = getattr(fp, f"create_{kind}_core")(str(ROOT / "weights" / f"{kind}_multi_full.npz"))
        for n in (1, 5, 64, 252):
            core.infer({"render_input": crops[0, :n], "transf_input": crops[1, :n]})
            bucket = next(b for b in core.buckets if b >= n)
            pad = (0, 0, 0, 0, 0, 0, 0, bucket - n)
            args = [torch.nn.functional.pad(c[:n], pad) for c in crops]
            key = ("infer", tuple(args[0].shape), tuple(args[1].shape))
            rows[f"{kind} core n={n}"] = check_program(
                torch, np, profiling, f"{kind} core n={n} (bucket {bucket})",
                core._programs[key], args, 5)
    memory = {name: graph_memory(torch, fp, house, K, (rgb, depth, mask), shared)
              for name, shared in (("one pool", True), ("a pool each", False))}
    log("graphs memory of a house model's Register (refine_itr 1, 2) and Track graphs, GB "
        "over the process's baseline: " + "; ".join(
            f"{name}: max_memory_allocated {m['peak_gb']:.3f}, allocated after "
            f"{m['held_gb']:.3f}, reserved after {m['reserved_gb']:.3f}"
            for name, m in memory.items()))
    log(f"graphs: {len(rows)} program keys, every replay equal to its eager function")
    return dict(rows=rows, memory=memory)


# JAX's tolerance for bf16 scores at per-shard batches on the TPU
# (tests/test_parallel.py:136-140), where the refined poses came out
# bit-identical; reported here, not gated (see run_sharded)
JAX_SHARD_SCORE_TOL = (2e-2, 2e-3)  # rtol, atol
# the split's bf16 scores may miss the f32 Register's by at most this many
# times the single process's own bf16 error
SHARD_BF16_ERR_FACTOR = 2.0


def check_ranks(res, backend: str, want_launches: dict, want_gathers: int, what: str,
                graphed: bool = False) -> None:
    """Every rank: its backend, no JAX, its kernel launches and its
    collectives (all-gathers only) in the counted run. ``graphed``: the
    counted run replays a program, which issues no collective from Python;
    its warm-up ran the function and captured it, issuing each twice."""
    for out in res:
        meta = out["meta"]
        (task,) = meta["tasks"]
        if meta["backend"] != backend or meta["jax_imported"]:
            raise AssertionError(f"{what}: rank {meta['rank']} ran {meta['backend']} (want "
                                 f"{backend}), jax imported: {meta['jax_imported']}")
        launches = {k: v for k, v in task["launches"].items() if v}
        gathers = ({}, {"all_gather": 2 * want_gathers}) if graphed else (
            {"all_gather": want_gathers}, task["warmup_collectives"])
        if launches != want_launches or (task["collectives"], task["warmup_collectives"]) != gathers:
            raise AssertionError(f"{what}: rank {meta['rank']} launched {task['launches']} and "
                                 f"issued {task['collectives']} (warm-up "
                                 f"{task['warmup_collectives']}), want {want_launches} and "
                                 f"{gathers}")


def run_sharded(torch, np, fp, main, multi, K, tmp):
    """The hypothesis split (``parallel.sharding``) in rank processes
    (``parallel.ranks``, ``python -m``, a ``file://`` rendezvous; this process
    joins no group), at full width on the main path's house frame with the
    committed weights (the scorer has att_cross):

    - W=1 over NCCL: the sharded Register is a captured program (its
      all-gathers in the graph) that equals its own eager run bit for bit
      and ``register_step`` at atol 1e-6, its counted run (a replay) made
      under ``set_sync_debug_mode("error")``;
    - W=2 and W=8, every rank on cuda:0 over gloo (NCCL refuses two ranks on
      one device), W=8 padding 252 to 256, against rank 0's ``register_step``
      on the padded grid with ``hyp_valid`` and, here, the same Register
      with f32 nets. In bf16 cuDNN's results change with the batch (126 or
      32 rows against 256), so the refined poses must equal a one-process
      refine at the same per-shard batches bit for bit, and the scores may
      miss the f32 Register's by at most SHARD_BF16_ERR_FACTOR times the
      single bf16 process's own error; -inf on the pad rows, the best pose
      under the ADD-S gate, and a best hypothesis other than the single
      process's must score within that error of its best;
    - W=2 over gloo: ``make_sharded_track_batch`` of the eight cubes of
      config 5, 4 a rank, 5 chained steps, each instance under the
      multi-object gates, against ``track_step`` of the 8.

    Each rank launches K2, K6 and the padded stem twice, K1 three times and
    K7 18 times a Register and issues three all-gathers and nothing else. Ranks sharing one card measure the
    split's correctness and overhead, not scaling."""
    import dataclasses

    from foundationpose_cpp_tpu_torch.geometry import icosphere
    from foundationpose_cpp_tpu_torch.parallel import ranks, sharding
    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
    from foundationpose_cpp_tpu_torch.utils import metrics

    rgb, depth, mask = main["frames"][0]
    house, gt, model = main["house"], main["gts"][0], main["model"]
    mesh, cfg = model._meshes["house"], model._cfg
    f32 = fp.create_foundationpose_model(
        str(ROOT / "weights" / "refiner_multi_full.npz"),
        str(ROOT / "weights" / "scorer_multi_full.npz"), [house], K, 480, 640,
        config=dataclasses.replace(cfg, use_bf16_models=False))
    frame = [torch.from_numpy(a).cuda() for a in (rgb, depth, mask)]

    @torch.inference_mode()
    def f32_scores(padded, valid):
        return fpp.register_step(mesh, f32._refiner, f32._scorer, *frame,
                                 torch.from_numpy(padded).cuda(), model._K, 1, cfg,
                                 hyp_valid=torch.from_numpy(valid).cuda())[2].cpu().numpy()

    @torch.inference_mode()
    def refine_in_shards(padded, n):
        poses, xyz_map, _ = fpp.prepare_register(frame[1], frame[2],
                                                 torch.from_numpy(padded).cuda(), model._K, cfg)
        m = poses.shape[0] // n
        return torch.cat([fpp.refine_loop(mesh, model._refiner, poses[i:i + m], frame[0], xyz_map,
                                          model._K, 1, cfg)
                          for i in range(0, poses.shape[0], m)]).cpu().numpy()

    pts = surface_points(np, house)
    job = dict(device=None, mesh=["textured_house", {"name": "house"}], K=K.tolist(), cfg={},
               refiner=str(ROOT / "weights" / "refiner_multi_full.npz"),
               scorers={"multi": str(ROOT / "weights" / "scorer_multi_full.npz")},
               tasks=[{"kind": "register", "scorer": "multi", "reps": 3}])
    grid = icosphere.make_rotation_grid()
    rtol, atol = JAX_SHARD_SCORE_TOL
    for n in (1, 2, 8):
        padded, valid = sharding.pad_grid(grid, n)
        (tmp / f"w{n}").mkdir()
        t0 = time.perf_counter()
        res = ranks.run(job, dict(rgb=rgb, depth=depth, mask=mask, rot_grid=padded,
                                  hyp_valid=valid), n, tmp / f"w{n}", timeout=300)
        wall = time.perf_counter() - t0
        backend = "nccl" if n <= torch.cuda.device_count() else "gloo"
        check_ranks(res, backend, {"render_views": 2, "mha_packed_qkv": 3, "padded_stem": 2,
                                   "crop_observed": 2, "conv_epilogue": 18}, 3,
                    f"sharded W={n}", graphed=n == 1)
        a, (task,) = res[0]["arrays"], res[0]["meta"]["tasks"]
        for r in res[1:]:
            if not all(np.array_equal(v, a[k]) for k, v in r["arrays"].items()
                       if not k.startswith(("t0_ref", "t0_eager"))):
                raise AssertionError(f"sharded W={n}: rank {r['meta']['rank']} returned "
                                     f"other poses or scores than rank 0")
        scores, single = a["t0_scores"][valid], a["t0_ref_scores"][valid]
        pose_d = float(np.abs(a["t0_poses"] - a["t0_ref_poses"]).max())
        score_d = float(np.abs(scores - single).max())
        best, ref_best = int(np.argmax(a["t0_scores"])), int(np.argmax(a["t0_ref_scores"]))
        adds = add_s(np, pts, a["t0_best"], gt)
        log(f"sharded W={n} ({backend}, {'a card each' if backend == 'nccl' else 'one shared card'}): "
            f"{padded.shape[0] // n} hypotheses a rank, {int((~valid).sum())} pad rows; "
            f"max|d| vs register_step poses {pose_d:.3e} scores {score_d:.3e}; argmax "
            f"{best} (single {ref_best}); ADD-S {adds * 1e3:.2f} mm; register_ms sharded "
            f"{task['ms']:.2f} single {task['ref_ms']:.2f} (rank 0, host clock, "
            f"3 reps); launches {task['launches']}; collectives {task['collectives']}; "
            f"wall {wall:.1f} s")
        if not (bool(a["t0_ok"]) and np.isfinite(a["t0_best"]).all()):
            raise AssertionError(f"sharded W={n}: Register failed or gave a non-finite pose")
        if not (np.isneginf(a["t0_scores"][~valid]).all() and np.isfinite(scores).all()
                and np.isneginf(a["t0_ref_scores"][~valid]).all()):
            raise AssertionError(f"sharded W={n}: pad rows are not -inf or real rows not finite")
        if adds >= 0.1 * house.diameter:
            raise AssertionError(f"sharded W={n}: ADD-S {adds:.4f} m >= 0.1 x diameter")
        if n == 1:
            names = ("best", "poses", "scores", "ok")
            eager_d = max(float(np.abs(a[f"t0_{k}"].astype(np.float64)
                                       - a[f"t0_eager_{k}"]).max()) for k in names)
            (program,) = task["programs"]
            log(f"  W=1 as a program: key {tuple(program['key'])}, capture "
                f"{program['capture_ms']:.1f} ms, {program['nodes']} nodes; replay vs its eager "
                f"run max|d|={eager_d:.3e}; register_ms graphed {task['ms']:.2f} eager "
                f"{task['eager_ms']:.2f} register_step eager {task['ref_ms']:.2f} (rank 0, host "
                f"clock, 3 reps); the replay under sync debug 'error'; all_gathers in the "
                f"warm-up (run + capture) {task['warmup_collectives']}, in a replay "
                f"{task['collectives'] or 'none from Python'}")
            if not all(np.array_equal(a[f"t0_{k}"], a[f"t0_eager_{k}"]) for k in names):
                raise AssertionError(f"sharded W=1: the program differs from its eager run by "
                                     f"{eager_d}")
            if max(pose_d, score_d, float(np.abs(a["t0_best"] - a["t0_ref_best"]).max())) > 1e-6:
                raise AssertionError(f"sharded W=1 differs from register_step: poses {pose_d}, "
                                     f"scores {score_d}")
            continue
        shard_pose_d = float(np.abs(a["t0_poses"] - refine_in_shards(padded, n)).max())
        truth = f32_scores(padded, valid)[valid]
        err_single = float(np.abs(single - truth).max())
        err_shard = float(np.abs(scores - truth).max())
        jax_rows = int((np.abs(scores - single) > atol + rtol * np.abs(single)).sum())
        jax_rows_f32 = int((np.abs(single - truth) > atol + rtol * np.abs(truth)).sum())
        log(f"  W={n}: poses vs one process refining {padded.shape[0] // n} rows at a time "
            f"max|d| {shard_pose_d:.3e}; scores vs the f32 Register: sharded {err_shard:.3e}, "
            f"single bf16 {err_single:.3e} (ratio {err_shard / max(err_single, 1e-30):.2f}, limit "
            f"{SHARD_BF16_ERR_FACTOR}); rows outside JAX's TPU tolerance (rtol {rtol}, atol "
            f"{atol}): sharded vs single {jax_rows}, single bf16 vs f32 {jax_rows_f32} of "
            f"{int(valid.sum())}")
        if shard_pose_d != 0.0:
            raise AssertionError(f"sharded W={n}: refined poses differ from a one-process refine "
                                 f"at the same batches by {shard_pose_d}")
        if err_shard > SHARD_BF16_ERR_FACTOR * err_single:
            raise AssertionError(f"sharded W={n}: scores miss the f32 Register by {err_shard}, "
                                 f"more than {SHARD_BF16_ERR_FACTOR} x bf16's own {err_single}")
        gap = float(a["t0_ref_scores"][ref_best] - a["t0_ref_scores"][best])
        if gap > SHARD_BF16_ERR_FACTOR * err_single:
            raise AssertionError(f"sharded W={n} picked hypothesis {best}, {gap} under the best "
                                 f"{ref_best}: more than the bf16 error")

    cube, gts = multi["cube"], multi["gts"]
    (tmp / "track").mkdir()
    t0 = time.perf_counter()
    res = ranks.run(
        dict(job, mesh=["textured_cube", {"size": 0.08}],
             tasks=[{"kind": "track", "steps": 5}]),
        dict(rgb=multi["rgb"], depth=multi["depth"], track_poses=multi["starts"]), 2,
        tmp / "track", timeout=300)
    wall = time.perf_counter() - t0
    check_ranks(res, "nccl" if torch.cuda.device_count() >= 2 else "gloo",
                {"render_views": 5, "mha_packed_qkv": 5, "padded_stem": 5, "crop_observed": 5,
                 "conv_epilogue": 45}, 5, "sharded track_batch")
    a = res[0]["arrays"]
    rot = [metrics.rotation_error_deg_sym(p, g, cube.symmetries) for p, g in zip(a["t0_poses"], gts)]
    trans = [float(np.linalg.norm(p[:3, 3] - g[:3, 3])) for p, g in zip(a["t0_poses"], gts)]
    delta = float(np.abs(a["t0_poses"] - a["t0_ref_poses"]).max())
    log(f"sharded track_batch W=2 (gloo): 8 cubes, 4 a rank, 5 steps: rot_err_deg "
        + " ".join(f"{r:.2f}" for r in rot) + " | t_err_mm " + " ".join(f"{t * 1e3:.2f}" for t in trans)
        + f"; max|d| vs track_step of the 8 {delta:.3e}; wall {wall:.1f} s")
    if max(rot) >= 5.0 or max(trans) >= 0.01:
        raise AssertionError(f"sharded track_batch: rotation errors {rot}, translation {trans}")


def run_bench(np):
    """foundationpose_cpp_tpu_torch.bench at its defaults: one JSON line with
    the keys of bench.py, the h2d, memory and scan blocks filled."""
    import ast

    from foundationpose_cpp_tpu_torch import bench

    result = bench.main([])
    tree = ast.parse((ROOT / "bench.py").read_text())
    (literal,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and any(getattr(t, "id", None) == "result" for t in n.targets)]

    def missing(node, got, prefix=""):
        out = []
        for key, value in zip(node.keys, node.values):
            if key.value not in got:
                out.append(prefix + key.value)
            elif isinstance(value, ast.Dict):
                out += missing(value, got[key.value], prefix + key.value + ".")
        return out

    d = result["details"]
    lost = missing(literal, result)
    sharded = d["sharded"]
    if lost or d["platform"] != "gpu" or d["stage_ms"]["render_252_corner"] is not None \
            or not d["card"]:
        raise AssertionError(f"bench line: keys of bench.py missing {lost}, or wrong nulls")
    if not isinstance(sharded, dict) or "error" in sharded or sharded.get("n_devices") != 8 \
            or sharded.get("collectives_fused") != {"all_gather": 2}:
        raise AssertionError(f"bench line: the sharded block failed: {sharded}")
    numbers = [result["value"], d["track_fps"], d["track_fps_percall"], d["track_fps_dispatch"],
               d["track_fps_pipelined"], d["h2d"]["ms_per_frame"], d["hbm_peak_gb"],
               *d["scan"].values(), d["stage_ms"]["render_252"], sharded["register_ms_single"],
               sharded["register_ms_sharded"], sharded["speedup"]]
    if not all(np.isfinite(v) and v > 0 for v in numbers):
        raise AssertionError(f"bench line has numbers that are not finite and positive: {numbers}")
    return result


INGEST_F32_TOL = (1e-3, 1e-4)  # rtol, atol: tests/test_torch_networks.py at full width
INGEST_BF16_TOL = (0.1, 0.05)  # rtol, atol: tests/test_onnx_roundtrip.py's bf16 policy bound
GRAD_REL_L2 = 1e-3


def randomize_published(torch, model, seed: int) -> None:
    """Trained-checkpoint stand-in (tests/test_onnx_roundtrip.py:_randomize):
    every tensor non-trivial and distinct, BN variances in [0.2, 2.2], the
    position table left sinusoidal."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if "num_batches" in k or "pos_embed" in k:
                continue
            if "running_var" in k:
                v.copy_(torch.rand(v.shape, generator=g) * 2 + 0.2)
            else:
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)


def run_ingest(torch, np, fp, attention, render, K, main, tmp):
    """Published-structure refiner and scorer (BatchNorm, nn.MultiheadAttention,
    NVlabs names) at the published widths with seeded weights, converted by
    the strict converter with no JAX; on 252 seeded crop pairs the f32
    converted nets (K1's f32 path) and the bf16 ones against the modules' own
    f32 forward on the card; saved through save_params, reloaded through
    create_foundationpose_model, one Register on the house scene."""
    from foundationpose_cpp_tpu_torch.models import convert, convert_jax, networks, torch_ref

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 comparisons below assume it off")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    a = torch.rand((252, 160, 160, 6), generator=gen, device=dev)
    b = torch.rand((252, 160, 160, 6), generator=gen, device=dev)
    sds, rows = {}, []
    for kind, seed in (("refiner", 11), ("scorer", 12)):
        cfg = networks.NetConfig(cross_attention=kind == "scorer")
        model = (torch_ref.build_refine_net(cfg) if kind == "refiner"
                 else torch_ref.build_score_net(cfg))
        randomize_published(torch, model, seed)
        t0 = time.perf_counter()
        sd, got_cfg = convert.convert_state_dict(torch_ref.state_dict_numpy(model), kind)
        convert_ms = (time.perf_counter() - t0) * 1e3
        if got_cfg != cfg:
            raise AssertionError(f"inferred {got_cfg}, want {cfg}")
        sds[kind] = sd
        model = model.to(dev)
        names = ("trans", "rot") if kind == "refiner" else ("scores",)
        with torch.no_grad():
            want = model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
            want = dict(zip(names, want if isinstance(want, tuple) else (want,)))
        for dtype, (rtol, atol) in ((torch.float32, INGEST_F32_TOL),
                                    (torch.bfloat16, INGEST_BF16_TOL)):
            net = convert_jax.as_net(sd, kind, dev, dtype)
            before = attention.mha_packed_qkv.launches
            with torch.inference_mode():
                out = net(a, b)
            launched = attention.mha_packed_qkv.launches - before
            for name in names:
                w, g = want[name].float(), out[name].float()
                excess = ((g - w).abs() / (atol + rtol * w.abs())).max().item()
                err = (g - w).abs().max().item()
                log(f"ingest {kind} {str(dtype)[6:]} N=252: {name} max_abs_err={err:.3e} "
                    f"(|{name}| up to {w.abs().max().item():.3f}) err/tol={excess:.3f} at rtol "
                    f"{rtol} atol {atol}; K1 launches {launched}; convert {convert_ms:.0f} ms")
                if not (excess <= 1.0 and torch.isfinite(g).all()):
                    raise AssertionError(f"ingest: the converted {kind} ({dtype}) disagrees "
                                         f"with the published module on {name}")
            if launched != 1 + (kind == "scorer"):
                raise AssertionError(f"ingest {kind}: {launched} K1 launches, want the kernel")
        del model
    paths = {}
    for kind, sd in sds.items():
        paths[kind] = str(tmp / f"{kind}_converted.npz")
        convert_jax.save_npz(sd, paths[kind])
        back = convert_jax.load_npz(paths[kind])
        if sorted(back) != sorted(sd) or not all(torch.equal(back[k], sd[k]) for k in sd):
            raise AssertionError(f"ingest: {kind} npz does not reload bit for bit")
    model = fp.create_foundationpose_model(paths["refiner"], paths["scorer"], [main["house"]], K,
                                           480, 640)
    rgb, depth, mask = main["frames"][0]
    model.register(rgb, depth, mask, "house")  # warm-up: cuDNN plans
    reset_counts((attention.mha_packed_qkv, render.render_views))
    pose = model.register(rgb, depth, mask, "house")
    counts = (render.render_views.launches, attention.mha_packed_qkv.launches)
    log(f"ingest: Register with the converted nets (seeded weights) pose finite="
        f"{bool(np.isfinite(pose).all())}; launches (render, attention)={counts}")
    if counts != (2, 3) or not np.isfinite(pose).all():
        raise AssertionError(f"ingest Register launched {counts}, want (2, 3), or its pose "
                             "is not finite")
    return dict(register_launches=counts)


TRAIN_PROGRAM_STEPS = 20
TRAIN_PROGRAM_WARMUP = 25  # the learning rate moves on every one of the 20 steps


def train_twenty(torch, programs, tr, multi, bank, cfg, net_cfg, tcfg, kind, graphed,
                 sync_check=False) -> dict:
    """TRAIN_PROGRAM_STEPS steps of the multi trainer of ``kind`` (its
    default seed) from seeded weights: through the step programs, or
    (``graphed`` False) with every program called eagerly. With
    ``sync_check`` the steps after the last object's capture run under
    ``set_sync_debug_mode("error")``. Returns the net, the losses, the
    programs made, the wall ms, the steps run under the sync check and the
    peak allocated GB."""
    made, losses, checked = [], [], []

    class Recorded(programs.Program):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    def on_step(i, loss):
        losses.append(loss)
        if checked:
            checked.append(i)
        elif sync_check and len(made) == bank.n_objects:
            torch.cuda.set_sync_debug_mode("error")
            checked.append(i)

    saved = tr.Program
    tr.Program = Recorded
    kcfg = dataclasses.replace(net_cfg, cross_attention=kind == "scorer")
    train = multi.train_refiner_multi if kind == "refiner" else multi.train_scorer_multi
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.nullcontext() if graphed else programs.eager():
            net = train(bank, cfg, kcfg, tcfg, steps=TRAIN_PROGRAM_STEPS,
                        seed=0 if kind == "refiner" else 1, on_step=on_step)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        tr.Program = saved
    return dict(net=net, losses=torch.stack(losses), programs=made,
                wall_ms=(time.perf_counter() - t0) * 1e3, checked=len(checked) - 1,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30)


def params_max_abs(a, b) -> float:
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].double() - sb[k].double()).abs().max()) for k in sa)


def kernel_split(torch, profiling, fn, calls: int, top: int = 6):
    """(the card's kernel ms a call of fn() under torch.profiler, the
    ``top`` kernels by time as (name, ms a call)); (None, []) when the
    profiler saw no device activity."""
    with tempfile.TemporaryDirectory() as tmp, profiling.trace(tmp) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    run = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not run:
        return None, []
    run.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in run) / calls / 1e3,
            [(e.key[:48], e.self_device_time_total / calls / 1e3) for e in run[:top]])


def run_train_programs(torch, np, profiling, render, bank, cfg, net_cfg, tcfg) -> dict:
    """The trainers' step as a program, at batch 64 on the bank, for the
    refiner and the scorer, in cuDNN's default mode and in its deterministic
    mode: in each, two eager runs of 20 steps from the same seed (eager
    against eager), then 20 graphed steps against them (max |d| of the
    parameters and the losses; in deterministic mode 0 to pass, or the
    eager spread where that is not 0), with K2 launched twice a step and no
    host sync once every object's program is captured. Then, on one
    object's program, ms a step replayed and run eagerly (host clock, three
    windows of 5), its capture ms and node count, its kernel time under
    torch.profiler with the busy share and the largest kernels, and the
    peak allocated memory of the graphed run."""
    from foundationpose_cpp_tpu_torch.pipeline import programs
    from foundationpose_cpp_tpu_torch.training import multi
    from foundationpose_cpp_tpu_torch.training import synthetic as tr

    tcfg = dataclasses.replace(tcfg, warmup_steps=TRAIN_PROGRAM_WARMUP)
    deterministic = torch.backends.cudnn.deterministic
    out = {}
    try:
        for kind, mode in (("refiner", False), ("refiner", True), ("scorer", False),
                           ("scorer", True)):
            torch.backends.cudnn.deterministic = mode
            mode_name = "deterministic" if mode else "default"
            args = (torch, programs, tr, multi, bank, cfg, net_cfg, tcfg, kind)
            eager = [train_twenty(*args, graphed=False) for _ in range(2)]
            render.render_views.launches = 0
            graphed = train_twenty(*args, graphed=True, sync_check=True)
            k2 = render.render_views.launches
            spread = params_max_abs(eager[0]["net"], eager[1]["net"])
            spread_loss = float((eager[0]["losses"] - eager[1]["losses"]).abs().max())
            delta = params_max_abs(graphed["net"], eager[0]["net"])
            delta_loss = float((graphed["losses"] - eager[0]["losses"]).abs().max())
            program = graphed["programs"][0]
            step = program.fn, program._inputs
            graphed_ms = host_ms(torch, lambda: program(*step[1]), 5)
            eager_ms = host_ms(torch, lambda: step[0](*step[1]), 5)
            kernels, largest = kernel_split(torch, profiling, lambda: program(*step[1]), 5)
            busy = (f"{kernels:.2f} ms of kernels a step, busy {kernels / min(graphed_ms):.1%} of "
                    f"the fastest window; largest: "
                    + ", ".join(f"{name} {ms:.2f}" for name, ms in largest)
                    if kernels is not None
                    else "kernel time not measured (no device activity seen)")
            log(f"train (e): {kind} step as a program, cuDNN {mode_name} mode, batch {tcfg.batch}, "
                f"{len(graphed['programs'])} programs {[p.key for p in graphed['programs']]}: "
                f"{TRAIN_PROGRAM_STEPS} graphed vs eager steps max|d| parameters {delta:.3e} "
                f"losses {delta_loss:.3e} (eager vs eager: {spread:.3e}, {spread_loss:.3e}); "
                f"K2 launches {k2} (want {2 * TRAIN_PROGRAM_STEPS}); {graphed['checked']} steps "
                f"under sync debug 'error' after the last capture; wall of the 20 steps graphed "
                f"{graphed['wall_ms']:.0f} ms (captures included) eager {eager[0]['wall_ms']:.0f} "
                f"ms; one program {program.key}: capture {program.capture_ms:.1f} ms, "
                f"{program.nodes} nodes, captures of all "
                f"{[round(p.capture_ms, 1) for p in graphed['programs']]} ms; ms a step graphed "
                f"{np.median(graphed_ms):.2f} (windows {'/'.join(f'{v:.2f}' for v in graphed_ms)}) "
                f"eager {np.median(eager_ms):.2f} (windows "
                f"{'/'.join(f'{v:.2f}' for v in eager_ms)}); {busy}; peak allocated GB graphed "
                f"{graphed['peak_gb']:.2f} eager {eager[0]['peak_gb']:.2f}")
            if k2 != 2 * TRAIN_PROGRAM_STEPS or graphed["checked"] < 1:
                raise AssertionError(f"train (e): {kind} launched K2 {k2} times, "
                                     f"{graphed['checked']} steps sync-checked")
            out[(kind, mode_name)] = dict(graphed_ms=float(np.median(graphed_ms)),
                                          eager_ms=float(np.median(eager_ms)), max_abs=delta)
            if not mode:
                continue  # eager steps there differ run to run: nothing to hold
            bound = (spread, spread_loss)
            if bound != (0.0, 0.0):
                log(f"train (e): {kind}: eager steps are not reproducible in deterministic mode "
                    f"here; graphed is held to the eager-to-eager spread {bound}")
            if delta > bound[0] or delta_loss > bound[1]:
                raise AssertionError(f"train (e): {kind} graphed steps differ from eager by "
                                     f"{delta} (losses {delta_loss}), bound {bound}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def run_train(torch, np, fp, attention, render, transforms, sweep, profiling, K, main, tmp):
    """The trainers at the published NetConfig on a bank of 4 family objects:
    (a) one fixed refiner batch of 8 built on the card (K2) and on the CPU
    (plain render), and the gradients of refiner_loss on both from that batch
    and the same parameters; (b) 60 refiner steps at batch 64 from scratch,
    then 20 scorer steps (8 scenes x 8 hypotheses, att_cross on); (c) the
    tools' evaluate on the committed multi weights; (d) the refiner of (b)
    saved as bf16 npz, reloaded, one Register."""
    import dataclasses
    import json as _json

    from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
    from foundationpose_cpp_tpu_torch.meshio import family
    from foundationpose_cpp_tpu_torch.models import networks
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
    from foundationpose_cpp_tpu_torch.tools import train_synthetic
    from foundationpose_cpp_tpu_torch.training import multi
    from foundationpose_cpp_tpu_torch.training import synthetic as tr

    cfg, net_cfg = FoundationPoseConfig(), networks.NetConfig()
    tcfg = tr.SyntheticTrainConfig(warmup_steps=10)
    assets = [family.random_family_asset(s) for s in range(4)]
    bank = multi.build_mesh_bank(assets, device="cuda")
    log(f"train: bank {bank.names}, faces "
        f"{[m.faces.shape[0] for m in bank.meshes]}, diameter {bank.diameter}")
    big = max(range(len(assets)), key=lambda i: assets[i].faces.shape[0])
    render_rows = check_render(torch, transforms, render, sweep,
                               [(bank.names[big], 64, 160, assets[big])])

    # (a) one fixed batch, card vs CPU; gradients from that batch
    K_np = tr.default_intrinsics(tcfg)
    tcfg8 = dataclasses.replace(tcfg, batch=8)
    gt, hyp = tr.sample_refiner_poses(torch.Generator().manual_seed(3), tcfg8, bank.diameter)
    mesh_cpu = MeshConstants.from_asset(assets[big], "cpu")
    with torch.no_grad():
        card = tr.refiner_batch(bank.meshes[big], gt.cuda(), hyp.cuda(), torch.from_numpy(K_np).cuda(),
                                cfg, tcfg8)
        host = tr.refiner_batch(mesh_cpu, gt, hyp, torch.from_numpy(K_np), cfg, tcfg8)
    for key in ("render_input", "transf_input"):
        bad, err = sweep.render_disagreement(card[key].cpu(), host[key], RENDER_TOL)
        log(f"train (a): {key} of 8, K2 vs the plain render on the CPU: pixels_off={bad:.4%} "
            f"max_abs_err={err:.3e}")
        if bad >= RENDER_BAD_FRAC:
            raise AssertionError(f"train (a): the card's {key} disagrees with the CPU's")
    for key in ("trans_target", "rotvec_target"):
        d = (card[key].cpu() - host[key]).abs().max().item()
        if d > 1e-5:
            raise AssertionError(f"train (a): {key} differs by {d:.3e} between card and CPU")
    plain_cfg = dataclasses.replace(net_cfg, attn_impl="plain")
    nets = {"cpu": networks.init_net("refiner", plain_cfg, 5)}
    nets["cuda"] = networks.init_net("refiner", plain_cfg, 5).cuda()
    grads = {}
    for where, net in nets.items():
        batch = {k: v.to(where) for k, v in host.items()}
        loss, _ = tr.refiner_loss(net, batch, cfg.rot_normalizer)
        loss.backward()
        grads[where] = ({k: p.grad.cpu() for k, p in net.named_parameters()}, float(loss.detach()))
    rel = {k: ((grads["cuda"][0][k] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for k, g in grads["cpu"][0].items()}
    worst = max(rel, key=rel.get)
    log(f"train (a): refiner_loss card {grads['cuda'][1]:.6f} cpu {grads['cpu'][1]:.6f}; "
        f"gradient relative L2, worst of {len(rel)} parameters: {rel[worst]:.3e} ({worst}), "
        f"median {float(np.median(list(rel.values()))):.3e}; TF32 off")
    if rel[worst] >= GRAD_REL_L2:
        raise AssertionError(f"train (a): gradient of {worst} off by {rel[worst]:.3e} relative L2")
    del nets, grads

    # (b) short runs from scratch
    counted = (attention.mha_packed_qkv, attention.mha_whole_head, render.render_views)
    runs = {}
    for kind, steps, lr in (("refiner", 60, tcfg.lr), ("scorer", 20, 1e-4)):
        losses = []
        kcfg = dataclasses.replace(net_cfg, cross_attention=kind == "scorer")
        ktcfg = dataclasses.replace(tcfg, lr=lr)
        train = multi.train_refiner_multi if kind == "refiner" else multi.train_scorer_multi
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counted)
        t0 = time.perf_counter()
        net = train(bank, cfg, kcfg, ktcfg, steps=steps, seed=0 if kind == "refiner" else 1,
                    log=log, on_step=lambda i, loss: losses.append(loss))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_of(counted)
        losses = torch.stack(losses).cpu().numpy()
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[kind] = dict(net=net, ms=wall * 1e3 / steps, losses=losses)
        log(f"train (b): {kind} {steps} steps at batch {ktcfg.batch}: ms_per_step={wall * 1e3 / steps:.1f} "
            f"steps_per_s={steps / wall:.3f} peak_allocated_gb={peak:.2f}; loss first 10 mean "
            f"{losses[:10].mean():.4f} last 10 mean {losses[-10:].mean():.4f}; launches (packed "
            f"attention, head-split attention, render)={counts}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"train (b): {kind} loss not finite")
        if counts != (0, 0, 2 * steps):
            raise AssertionError(f"train (b): {kind} launched {counts}, want (0, 0, {2 * steps})")
    if not runs["refiner"]["losses"][-10:].mean() < runs["refiner"]["losses"][:10].mean():
        raise AssertionError("train (b): the refiner loss did not fall over 60 steps")
    programs = run_train_programs(torch, np, profiling, render, bank, cfg, net_cfg, tcfg)

    # (c) evaluation of the committed weights
    report = _json.loads((ROOT / "weights" / "eval_multi_full.json").read_text())
    evals = {}
    for label, asset in (("unseen_seed", family.random_family_asset(20_000)),
                         ("heldout_wedge", family.random_family_asset(30_000, generator="wedge"))):
        reset_counts(counted)
        r = train_synthetic.evaluate(asset, str(ROOT / "weights" / "refiner_multi_full.npz"),
                                     str(ROOT / "weights" / "scorer_multi_full.npz"), cfg, tcfg,
                                     2, 0, device="cuda")
        counts = counts_of(counted)
        ref = report.get(f"{label}:{asset.name}", {})
        log(f"train (c): evaluate {label}:{asset.name} on the card (2 scenes): failures "
            f"{r['register_failures']} register_adds={r.get('register_adds', float('nan')) * 1e3:.2f} mm "
            f"(limit {asset.diameter * 100:.1f} mm) register_rot_deg={r.get('register_rot_deg', float('nan')):.2f} "
            f"tracked_rot_deg={r.get('tracked_rot_deg', float('nan')):.2f} flips={r.get('register_flips')}; "
            f"launches (packed attention, head-split attention, render)={counts}; the TPU report's "
            f"row (12 other scenes, context only): register_adds="
            f"{ref.get('register_adds', float('nan')) * 1e3:.2f} mm register_rot_deg="
            f"{ref.get('register_rot_deg', float('nan')):.2f} flips={ref.get('register_flips')}")
        if r["register_failures"] or r["register_adds"] >= 0.1 * asset.diameter \
                or r["register_flips"]:
            raise AssertionError(f"train (c): evaluate {label} failed its bounds: {r}")
        if counts != (12, 0, 12):
            raise AssertionError(f"train (c): evaluate launched {counts}, want (12, 0, 12)")
        evals[label] = r

    # (d) the trained refiner saved as bf16 and served
    path = str(tmp / "refiner_trained.npz")
    tr.save_bf16(runs["refiner"]["net"], path)
    model = fp.create_foundationpose_model(path, str(ROOT / "weights" / "scorer_multi_full.npz"),
                                           [main["house"]], K, 480, 640)
    rgb, depth, mask = main["frames"][0]
    reset_counts((attention.mha_packed_qkv, render.render_views))
    pose = model.register(rgb, depth, mask, "house")
    counts = (render.render_views.launches, attention.mha_packed_qkv.launches)
    log(f"train (d): Register with the trained refiner (bf16 npz) pose finite="
        f"{bool(np.isfinite(pose).all())}; launches (render, attention)={counts}")
    if counts != (2, 3) or not np.isfinite(pose).all():
        raise AssertionError(f"train (d): Register launched {counts} or gave a non-finite pose")
    return dict(ms_per_step={k: v["ms"] for k, v in runs.items()}, render=render_rows, evals=evals,
                programs=programs)


STEM_BF16_TOL = (2e-2, 2e-2)  # rtol, atol: the port's bf16 budget for one conv
STEM_F32_TOL = 1e-4  # atol: tests/test_training.py:171's s2d tolerance
ENCODE_AB_F32_TOL = 1e-3  # atol: three convs of 2304-4608 f32 terms in another order
PROBE_LANE_FLOPS = 18  # f32 operations a lane of the probe: coordinates 6, rows 2, adds 10


def check_probe_grid(torch, probe_grid):
    """K5 at the tool's narrow and wide shapes against its plain version, bit
    for bit; the kernel's time, the plain version's, and one PyTorch call
    that stores the same bytes from a tile made before it (``copy_`` of the
    tile expanded: it leaves out the tile's arithmetic and the scratch),
    beside the stores' bound."""
    rows = []
    for name, shape in (("narrow", probe_grid.NARROW), ("wide", probe_grid.WIDE)):
        got = probe_grid.probe_grid(*shape, "cuda")
        want = probe_grid.probe_grid_plain(*shape, "cuda")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"probe_grid {name} {shape} differs from its plain version "
                                 f"(max |d| {err})")
        tile = probe_grid.probe_tile(shape[3], "cuda")
        k_ms = cuda_ms(torch, lambda: probe_grid.probe_grid(*shape, "cuda"), 20)
        p_ms = cuda_ms(torch, lambda: probe_grid.probe_grid_plain(*shape, "cuda"), 5)
        l_ms = cuda_ms(torch, lambda: got.copy_(tile.expand(got.shape)), 20)
        b_ms, b_by = bound(nbytes(got), PROBE_LANE_FLOPS * got.numel() / 8, F32_FLOPS)
        blocks = shape[0] * shape[1] * shape[2]
        log(f"probe_grid {name} grid {shape[:3]} x {shape[3]} lanes ({blocks} blocks, "
            f"{8 * shape[3] * 4} bytes of shared memory a block): max_abs_err={err:.1e} (bit "
            f"for bit) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms(copy_ of the "
            f"expanded tile)={l_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; {nbytes(got)} bytes)")
        rows.append(dict(name=name, err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
        del got, want
    return rows


def check_crop(torch, np, transforms, crop):
    """The observed-crop kernel (K6) at Register's shape (252 views),
    Track's (1 view) and the mixed cell's (8 views, a diameter each),
    160x160 crops of a 480x640 frame on the rotation grid at 0.6 m, against
    its plain version bit for bit (NaN equal); the kernel's time (and the
    time queued behind other work), the plain version's, and the bound: the
    output's bytes at 3.35 TB/s (the frame stays in L2). At N=252 and N=1
    the downscale is a number, half a 0.1366 m diameter: not a power of two,
    so a reciprocal rounded otherwise than PyTorch's shows. At N=8 it is the
    (N,) f32 half-diameters of LM-O's eight objects, as a MeshSet gives them
    (the kernel's per-view branch)."""
    from foundationpose_cpp_tpu_torch.geometry import icosphere

    h, w, ch, cw, diameter = 480, 640, 160, 160, 0.1366
    lmo8_mm = (102.1, 201.4, 154.5, 261.5, 109.0, 176.4, 164.6, 148.2)
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]]).cuda()
    gen = np.random.default_rng(0)
    rgb = torch.from_numpy(gen.integers(0, 256, (h, w, 3), dtype=np.uint8)).cuda()
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 0.55 + 0.1 * np.hypot(xs - 320, ys - 240) / 400 + 0.01 * gen.random((h, w))
    depth[gen.random((h, w)) < 0.05] = 0.0
    xyz = ((torch.from_numpy(np.stack([xs, ys, np.ones_like(xs)], -1)).cuda()
            @ torch.linalg.inv(K).T) * torch.from_numpy(depth[..., None].astype(np.float32)).cuda())
    grid = torch.from_numpy(icosphere.make_rotation_grid()).cuda()
    rows = []
    for n in (252, 1, 8):
        poses = grid[:n].clone()
        poses[:, :3, 3] = torch.tensor([0.01, -0.02, 0.6]).cuda()
        # a MeshSet's (N,) f32 diameters, halved as render_and_transform does
        diam = (torch.tensor(lmo8_mm, dtype=torch.float32).cuda() / 1000.0 if n == 8
                else diameter)
        tfs = transforms.compute_crop_window_tf(poses, K, (ch, cw), 1.2, diam)
        args = (rgb, xyz, tfs, poses, diam / 2.0, ch, cw, 0.001, 4.0)
        got = crop.crop_observed(*args)
        want = crop.crop_observed_plain(*args)
        torch.cuda.synchronize()
        off = int((~((got == want) | (got.isnan() & want.isnan()))).sum())
        err = float((got - want).abs().nan_to_num(0.0).max())
        if off:
            raise AssertionError(f"crop_observed N={n}: {off} values off its plain version "
                                 f"(max |d| {err})")
        k_ms = cuda_ms(torch, lambda: crop.crop_observed(*args), 20)
        q_ms = cuda_ms_queued(torch, lambda: crop.crop_observed(*args), 20)
        p_ms = cuda_ms(torch, lambda: crop.crop_observed_plain(*args), 5)
        b_ms, b_by = bound(nbytes(got), 0.0, F32_FLOPS)
        log(f"crop_observed N={n} {ch}x{cw} of {h}x{w}: values off {off} (bit for bit) "
            f"kernel_ms={k_ms:.4f} queued_ms={q_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}; {nbytes(got)} bytes written)")
        rows.append(dict(name=f"N={n}", err=err, ms=k_ms, queued_ms=q_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# a net's nine convs at n pairs: (name, output shape, whether a residual is
# added) in the forward's order
def net_convs(n: int) -> list:
    return [("stem", (2 * n, 64, 80, 80), False), ("conv1", (2 * n, 128, 40, 40), False),
            ("res.conv1", (2 * n, 128, 40, 40), False), ("res.conv2", (2 * n, 128, 40, 40), True),
            ("res0.conv1", (n, 256, 40, 40), False), ("res0.conv2", (n, 256, 40, 40), True),
            ("conv", (n, 512, 20, 20), False), ("res1.conv1", (n, 512, 20, 20), False),
            ("res1.conv2", (n, 512, 20, 20), True)]


def check_epilogue(torch, epilogue):
    """The convolution epilogue kernel (K7) at a net's nine conv outputs at
    N=252 (Register's shapes) and at N=1 (Track's), bf16 with the ReLU and,
    where the nets add one, the residual: against its plain version bit for
    bit (NaN and -0.0 planted), then the kernel's time (at N=1 also queued
    behind other work), the plain version's, the sequence the nets ran
    before it (``add_`` of the bias, ``residual + y``, ``F.relu``: the
    library's time) and the bound: y read and written, the residual read, at
    3.35 TB/s. The sums over the nine are a net's; a Register runs two."""
    import torch.nn.functional as F

    def parent(y, bias, residual):
        y = y.add_(bias.reshape(1, -1, 1, 1))
        return F.relu(y if residual is None else residual + y)

    rows = []
    for n in (252, 1):
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, queued_ms=0.0)
        for name, shape, with_residual in net_convs(n):
            gen = torch.Generator(device="cuda").manual_seed(shape[1] + n)
            y = (torch.randn(shape, generator=gen, device="cuda") * 4).to(torch.bfloat16)
            y = y.contiguous(memory_format=torch.channels_last)
            y.permute(0, 2, 3, 1).view(-1)[::997] = float("nan")
            y.permute(0, 2, 3, 1).view(-1)[5::991] = -0.0
            bias = torch.randn((shape[1],), generator=gen, device="cuda").to(torch.bfloat16)
            residual = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                        .contiguous(memory_format=torch.channels_last)
                        if with_residual else None)
            want = epilogue.conv_epilogue_plain(y.clone(), bias, residual)
            got = epilogue.conv_epilogue(y.clone(), bias, residual)
            torch.cuda.synchronize()
            off = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            if off:
                raise AssertionError(f"conv_epilogue {name} {shape}: {off} values off its plain "
                                     "version")
            # each timed call adds the bias again to its own output: the
            # values drift, the bytes and the work do not
            k_ms = cuda_ms(torch, lambda: epilogue.conv_epilogue(got, bias, residual), 20)
            q_ms = (cuda_ms_queued(torch, lambda: epilogue.conv_epilogue(got, bias, residual), 20)
                    if n == 1 else k_ms)
            p_ms = cuda_ms(torch, lambda: epilogue.conv_epilogue_plain(want, bias, residual), 5)
            l_ms = cuda_ms(torch, lambda: parent(y, bias, residual), 5)
            moved = 2 * nbytes(y) + (nbytes(residual) if with_residual else 0)
            b_ms, b_by = bound(moved, 0.0, F32_FLOPS)
            log(f"conv_epilogue N={n} {name} {shape} residual={with_residual}: values off {off} "
                f"(bit for bit) kernel_ms={k_ms:.4f} queued_ms={q_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms(add_, add, relu)={l_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; "
                f"{moved} bytes)")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                           ("bound_ms", b_ms), ("queued_ms", q_ms)):
                total[key] += v
            del y, got, want, residual
        log(f"conv_epilogue N={n}, a net's nine: " + " ".join(
            f"{k}={v:.4f}" for k, v in total.items()) + f" ({total['bound_ms'] / total['ms']:.1%}"
            " of the bound)")
        rows.append(dict(total, name=f"net N={n}", err=0.0, bound_by="bytes"))
    torch.cuda.empty_cache()
    return rows


def run_profile(torch, np, attention, render, probe_grid):
    """The perf harnesses at the published widths (N=252, crop 160): the
    probe tool as it is, then profile_nets, bench_stem, bench_attn (both
    modes) and profile_register at --iters 4, with the launch counts of K1,
    K2 and K5 set to 0 just before and read just after; every time finite
    and positive but the two documented nulls; every stem variant against
    the direct stem (bf16 at STEM_BF16_TOL, f32 at STEM_F32_TOL) and the
    split-weight encodeAB against the concat form in f32."""
    from foundationpose_cpp_tpu_torch.models import networks
    from foundationpose_cpp_tpu_torch.tools import (
        bench_attn, bench_stem, probe_grid_overhead, profile_nets, profile_register,
    )
    from foundationpose_cpp_tpu_torch.utils.profiling import full_f32

    counted = (attention.mha_packed_qkv, render.render_views, probe_grid.probe_grid)
    reset_counts(counted)
    t0 = time.perf_counter()
    out = {"probe": probe_grid_overhead.run("cuda")}
    for name, tool in (("nets", profile_nets.run), ("stem", bench_stem.run),
                       ("attn", bench_attn.run), ("encode_ab", bench_attn.run_encode_ab),
                       ("register", profile_register.run)):
        log(f"profile: {name}")
        out[name] = tool("cuda", iters=4)
        torch.cuda.empty_cache()
    counts = dict(zip(("attention", "render", "probe_grid"), counts_of(counted)))
    log(f"profile: launches {counts} in {time.perf_counter() - t0:.1f} s")
    if min(counts.values()) < 1:
        raise AssertionError(f"profile: a kernel of the harnesses was never launched: {counts}")

    probe, attn, ab = out["probe"], out["attn"], out["encode_ab"]
    times = [v["ms"] for k, v in probe.items() if k != "us_per_block"]
    times += list(out["nets"].values()) + list(out["stem"]["ms"].values())
    times += [v for k, v in attn.items() if "diff" not in k]
    times += [ab["encodeAB concat form"], ab["encodeAB split-weight form"]]
    reg = out["register"]
    nulls = [k for k, v in reg.items() if v is None]
    times += [v for v in reg.values() if v is not None]
    if sorted(nulls) != sorted(profile_register.NO_PREPASS):
        raise AssertionError(f"profile_register: nulls {nulls}, want {profile_register.NO_PREPASS}")
    if not all(np.isfinite(v) and v > 0 for v in times):
        raise AssertionError(f"profile: times that are not finite and positive: {times}")

    # the stem variants against the direct stem on one 2N batch
    with torch.inference_mode():
        conv0 = profile_nets.seeded_net("refiner", torch.device("cuda"), networks.NetConfig(),
                                        0).encodeA["conv0"]
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = profile_nets.nchw(torch.rand((504, 160, 160, 6), generator=gen, device="cuda"))
        rtol, atol = STEM_BF16_TOL
        bf16 = bench_stem.excess(conv0.weight, conv0.bias, x.to(torch.bfloat16), rtol)
        with full_f32():
            f32 = bench_stem.excess(conv0.weight.float(), conv0.bias.float(), x)
    log("profile: stem variants against direct, bf16 max(|d| - rtol |direct|) / f32 max |d|: "
        + ", ".join(f"{k} {bf16[k]:.3e} / {f32[k]:.3e}" for k in bf16))
    bad = [k for k in bf16 if not (bf16[k] <= atol and f32[k] <= STEM_F32_TOL)]
    if bad:
        raise AssertionError(f"stem variants disagree with the direct stem: {bad}")
    ab_err = ab["max abs diff (f32 inputs)"]
    if not ab_err <= ENCODE_AB_F32_TOL:
        raise AssertionError(f"split-weight encodeAB differs from the concat form by {ab_err}")
    log(f"profile: us a block of the probe {probe['us_per_block']:.4f}; split-weight encodeAB "
        f"max |d| {ab_err:.3e} (f32); register busy share "
        f"{reg['FULL register busy share']}")
    log("profile: " + json.dumps(out))
    return dict(out, launches=counts)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import foundationpose_cpp_tpu_torch as fp
        from foundationpose_cpp_tpu_torch.geometry import transforms
        from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
        from foundationpose_cpp_tpu_torch.ops import (
            attention, crop, cuda_build, epilogue, probe_grid, rasterize_tiled, render,
        )
        from foundationpose_cpp_tpu_torch.tools import raster_region_sweep as sweep
        from foundationpose_cpp_tpu_torch.utils import profiling
        from foundationpose_cpp_tpu_torch.utils import synthetic as syn
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = cuda_build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(cuda_build.KERNEL_SOURCES)}")
    for name, text in logs.items():
        log_ptxas(name, text, attention)
    log(f"  render kernel: {render.kernel_config()}")
    log(f"  rasterize kernel: {rasterize_tiled.kernel_config()}")

    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
    def phase(name, fn, *args):
        """Run one phase and print its wall time."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    attn_rows = phase("K1", check_attention, torch, attention)
    head_rows = phase("K3", check_whole_head, torch, attention)
    render_rows = phase("K2", check_render, torch, transforms, render, sweep)
    raster_rows = phase("K4", check_rasterize, torch, transforms, rasterize_tiled, render, sweep)
    probe_rows = phase("K5", check_probe_grid, torch, probe_grid)
    crop_rows = phase("K6", check_crop, torch, np, transforms, crop)
    epilogue_rows = phase("K7", check_epilogue, torch, epilogue)
    launches = phase("main path", run_main_path, torch, np, fp, tproc, syn, attention, render,
                     rasterize_tiled, K)
    # the serving paths around Track and Register, each with the counts of
    # (render, attention) set to 0 just before it and read just after
    serving = (render.render_views, attention.mha_packed_qkv)
    phase("buckets", run_buckets, torch, np, fp, serving, K, launches)
    phase("packed", run_packed, torch, np, profiling, serving, launches)
    phase("async", run_async, torch, np, profiling, serving, launches)
    phase("infer cores", run_infer_cores, torch, np, fp, serving, launches)
    counted = (attention.mha_packed_qkv, attention.mha_whole_head, render.render_views,
               rasterize_tiled.rasterize_tiled)
    with tempfile.TemporaryDirectory() as tmp:
        phase("dataset full width", run_dataset_full_width, torch, np, tproc, syn, counted, K,
              pathlib.Path(tmp))
        narrow = phase("dataset narrow", run_dataset_narrow, torch, np, syn, counted,
                       pathlib.Path(tmp))
        phase("scan", run_scan, torch, np, fp, tproc, syn, transforms, render, rasterize_tiled,
              sweep, counted, K, pathlib.Path(tmp))
    multi = phase("multi-object", run_multi_object, torch, np, fp, tproc, syn, transforms,
                  render, sweep, counted, K)
    mixed = phase("mixed meshes", run_mixed_meshes, torch, np, fp, syn, transforms, render, sweep,
                  profiling, counted, K)
    phase("churn", run_churn, torch, np, profiling, counted, mixed)
    del mixed
    phase("sync", run_sync_free, torch, np, launches)
    phase("graphs", run_graphs, torch, np, fp, profiling, launches, multi, K)
    with tempfile.TemporaryDirectory() as tmp:
        phase("sharded", run_sharded, torch, np, fp, launches, multi, K, pathlib.Path(tmp))
    phase("bench", run_bench, np)
    with tempfile.TemporaryDirectory() as tmp:
        phase("ingest", run_ingest, torch, np, fp, attention, render, K, launches,
              pathlib.Path(tmp))
        phase("train", run_train, torch, np, fp, attention, render, transforms, sweep, profiling,
              K, launches, pathlib.Path(tmp))
    profile = phase("profile", run_profile, torch, np, attention, render, probe_grid)

    def row(r):
        return {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    kernels = [
        dict(name="mha_packed_qkv", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/attention.cu",
             replaces="foundationpose_cpp_tpu/ops/attention_pallas.py:110",
             launches=launches["attention_launches"], max_abs_err=max(r["err"] for r in attn_rows),
             **row(attn_rows[0])),
        dict(name="render_views", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/render.cu",
             replaces="foundationpose_cpp_tpu/ops/render_fused.py:502",
             launches=launches["render_launches"], max_abs_err=max(r["err"] for r in render_rows),
             **row(dict(render_rows[0], library_ms=None))),
        dict(name="mha_whole_head", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/attention.cu",
             replaces="foundationpose_cpp_tpu/ops/attention_pallas.py:41",
             launches=narrow["whole_head_launches"], max_abs_err=max(r["err"] for r in head_rows),
             **row(head_rows[0])),
        dict(name="rasterize_tiled", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/rasterize.cu",
             replaces="foundationpose_cpp_tpu/ops/rasterize_pallas.py:66",
             launches=launches["raster_launches"], max_abs_err=max(r["err"] for r in raster_rows),
             **row(dict(raster_rows[0], library_ms=None))),
        dict(name="probe_grid", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/probe_grid.cu",
             replaces="tools/probe_grid_overhead.py:62",
             launches=profile["launches"]["probe_grid"],
             max_abs_err=max(r["err"] for r in probe_rows), **row(probe_rows[0])),
        dict(name="crop_observed", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/crop.cu",
             replaces="none (the JAX package's gather warps, foundationpose_cpp_tpu/ops/warp.py)",
             launches=launches["crop_launches"], max_abs_err=max(r["err"] for r in crop_rows),
             **row(dict(crop_rows[0], library_ms=None))),
        dict(name="conv_epilogue", route="cuda",
             source="foundationpose_cpp_tpu_torch/csrc/epilogue.cu",
             replaces="none (XLA fuses it into the JAX package's convolutions)",
             launches=launches["epilogue_launches"],
             max_abs_err=max(r["err"] for r in epilogue_rows), **row(epilogue_rows[0])),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
