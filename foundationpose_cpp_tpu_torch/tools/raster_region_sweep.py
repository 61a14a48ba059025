"""Build ``csrc/render.cu`` and ``csrc/rasterize.cu`` with several regions,
block sizes and small/large face thresholds and compare them on the card.

    python -m foundationpose_cpp_tpu_torch.tools.raster_region_sweep \\
        [--kernel render rasterize] [--regions 160x160 80x80] [--few-regions 32x32] \\
        [--threads 1024] [--small 64] [--ablate noatomics] [--no-time]

A variant is (region columns x rows, the render kernel's region for launches
of few views, threads a block, the bbox area up to which a face is tested by
its own thread); what a flag leaves out is each source's own default. For
each it compiles the source into its own library (all nvcc runs at once),
prints what ptxas reports, holds the kernel against its plain version at the
main paths' shapes (render: under 1% of pixels off by more than 2e-3; rasterizer: face
ids agree on more than 99.5% of pixels, 1e-4 where they agree) and on plane
coefficients handed in from ``edge_coefficients`` (0 pixels off, 100%
agreement) and, unless ``--no-time``, times every variant by CUDA events in
turns (a, b, b, a) in the one process, so that the numbers share a card.
``--ablate`` times builds with one part of the work taken out, to see what
the rest costs (their outputs are wrong on purpose, so it reports times
only): ``noatomics`` stores the key without the atomic, ``noresolve`` stops
after the scatter, ``nosetup`` walks no face (the clear, the resolve and the
stores remain), ``notests`` sets every face up and tests no pixel.

The scenes (``render_case``, ``raster_case``) are the ones ``chip_smoke.py``
checks and times. Needs a CUDA card and nvcc; imports neither at module
level.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import subprocess
import sys
import tempfile

RENDER_TOL, RENDER_BAD_FRAC = 2e-3, 0.01
RASTER_AGREE, RASTER_TOL = 0.995, 1e-4
ABLATIONS = {"noatomics": "RASTER_ABLATE_NOATOMICS", "noresolve": "RASTER_ABLATE_NORESOLVE",
             "nosetup": "RASTER_ABLATE_NOSETUP", "notests": "RASTER_ABLATE_NOTESTS"}
RENDER_CASES = [("sphere", 252, 160), ("house", 252, 160), ("sphere", 1, 160), ("cube", 6, 37)]
RASTER_CASES = [("house", 1, 480, 640), ("sphere", 1, 480, 640), ("sphere", 4, 120, 160),
                ("house", 2, 123, 157)]


def mesh_asset(name: str):
    """The procedural meshes of the checks: the 6016-face UV sphere has faces
    of a few pixels, the house and the cube a dozen faces of thousands."""
    from foundationpose_cpp_tpu_torch.meshio import procedural

    if name == "sphere":
        return procedural.textured_uv_sphere(radius=0.05, n_lat=48, n_lon=64)
    if name == "house":
        return procedural.textured_house(name="house")
    if name == "cube":
        return procedural.textured_cube(size=0.1)
    raise ValueError(f"unknown mesh {name!r}")


def render_case(name: str, n: int, crop: int, device="cuda", asset=None):
    """The arguments of ``render_views`` for the first n poses of the
    Register rotation grid at 0.6 m, cropped as Register crops them; of the
    mesh ``name`` or of ``asset`` when one is given."""
    import numpy as np
    import torch

    from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
    from foundationpose_cpp_tpu_torch.geometry import icosphere, transforms
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
    from foundationpose_cpp_tpu_torch.utils import synthetic

    cfg = FoundationPoseConfig()
    mesh = MeshConstants.from_asset(asset or mesh_asset(name), device)
    poses = torch.as_tensor(icosphere.make_rotation_grid()[:n], device=device).clone()
    poses[:, :3, 3] = torch.as_tensor(synthetic.default_pose(0.6)[:3, 3], device=device)
    K = torch.as_tensor(np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32),
                        device=device)
    tfs = transforms.compute_crop_window_tf(poses, K, (crop, crop), cfg.refine_crop_ratio,
                                            mesh.diameter)
    clip_mat = transforms.pose_clip_matrix(
        poses, transforms.construct_bbox2d(tfs, crop, crop), K, 480, 640, cfg.znear, cfg.zfar)
    return (mesh.vertices, mesh.normals, mesh.texcoords, mesh.faces, mesh.texture, poses,
            clip_mat, crop, crop, mesh.diameter, cfg.min_depth, cfg.max_depth, cfg.w_ambient,
            cfg.w_diffuse)


def raster_case(name: str, n: int, h: int, w: int, device="cuda", asset=None):
    """(clip, faces, h, w) of n views of the mesh ``name`` (or of
    ``asset``) at 0.6 m, turned by 25 degrees a view, with the whole frame as
    the window."""
    import numpy as np
    import torch

    from foundationpose_cpp_tpu_torch.geometry import transforms
    from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
    from foundationpose_cpp_tpu_torch.utils import synthetic

    mesh = MeshConstants.from_asset(asset or mesh_asset(name), device)
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], device=device)
    K[0] *= w / 640.0  # the same field of view at any size
    K[1] *= h / 480.0
    poses = np.stack([synthetic.default_pose(0.6) for _ in range(n)])
    for i in range(n):
        poses[i, :3, :3] = synthetic.euler_xyz_deg([0.0, 25.0 * i, 0.0]) @ poses[i, :3, :3]
    poses = torch.as_tensor(poses, device=device)
    bbox2d = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=device).expand(n, 4)
    clip_mat = transforms.pose_clip_matrix(poses, bbox2d, K, h, w)
    clip = transforms.transform_points_homogeneous(clip_mat, mesh.vertices)
    return clip, mesh.faces, h, w


def render_disagreement(got, want, tol: float = RENDER_TOL) -> tuple[float, float]:
    """(share of pixels off by more than tol, max abs error)."""
    diff = (got - want).abs().amax(dim=-1)
    return (diff > tol).float().mean().item(), diff.max().item()


def raster_agreement(got, want) -> tuple[float, float]:
    """(share of pixels whose face ids agree, max abs error where they do)."""
    agree = got[..., 3] == want[..., 3]
    return agree.float().mean().item(), (got[agree] - want[agree]).abs().max().item()


def ptxas_summary(log: str) -> list[str]:
    """'entry: registers, shared memory; spills' per kernel of one build."""
    lines, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


def start_build(cuda_build, source: str, out: str, defines: list[str]) -> subprocess.Popen:
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v",
           *(f"-D{d}" for d in defines), "-o", out, str(cuda_build.CSRC / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs="+", choices=["render", "rasterize"],
                    default=["render", "rasterize"])
    ap.add_argument("--regions", nargs="+", default=None,
                    help="region as COLUMNSxROWS; default: each source's own")
    ap.add_argument("--few-regions", nargs="+", default=[None],
                    help="the render kernel's region for launches of few views, COLUMNSxROWS")
    ap.add_argument("--threads", type=int, nargs="+", default=[None])
    ap.add_argument("--small", type=int, nargs="+", default=[None],
                    help="largest bbox area (pixels) a thread tests alone")
    ap.add_argument("--ablate", nargs="+", choices=sorted(ABLATIONS), default=[],
                    help="also time the first variant with this part of the work removed")
    ap.add_argument("--no-time", action="store_true", help="build and check only")
    args = ap.parse_args(argv)

    import torch

    from foundationpose_cpp_tpu_torch.ops import cuda_build, rasterize_tiled, render

    if not torch.cuda.is_available():
        print("raster_region_sweep: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    def ms(fn, iters):
        for _ in range(2):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    variants = []  # (label, defines, checked)
    for region, few, threads, small in itertools.product(
            args.regions or [None], args.few_regions, args.threads, args.small):
        defines, label = [], []
        if region:
            rw, rh = region.lower().split("x")
            defines += [f"RASTER_REGION_W={int(rw)}", f"RASTER_REGION_H={int(rh)}"]
            label.append(region)
        if few:
            rw, rh = few.lower().split("x")
            defines += [f"RASTER_FEW_REGION_W={int(rw)}", f"RASTER_FEW_REGION_H={int(rh)}"]
            label.append(f"few{few}")
        if threads:
            defines.append(f"RASTER_THREADS={threads}")
            label.append(f"t{threads}")
        if small is not None:
            defines.append(f"RASTER_SMALL_FACE={small}")
            label.append(f"s{small}")
        variants.append(("-".join(label) or "default", defines, True))
    for kind in args.ablate:
        label, defines, _ = variants[0]
        variants.append((f"{label}+{kind}", defines + [ABLATIONS[kind]], False))

    ok = True
    modules = {"render": render, "rasterize": rasterize_tiled}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for source in args.kernel:
            for i, (label, defines, _) in enumerate(variants):
                out = os.path.join(tmp, f"lib{source}_{i}.so")
                procs[source, label] = (start_build(cuda_build, source, out, defines), out)
        libs = {}

        def use(source, label):
            """Route the module's wrapper to one variant's library."""
            modules[source]._library = lambda lib=libs[source, label]: lib

        for (source, label), (proc, out) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                print(f"{source} {label}: nvcc failed:\n{stdout}{stderr}", flush=True)
                ok = False
                continue
            libs[source, label] = modules[source].bind(ctypes.CDLL(out))
            use(source, label)
            print(f"{source} {label}: {modules[source].kernel_config()}", flush=True)
            for line in ptxas_summary(stderr):
                print(f"{source} {label} ptxas {line}", flush=True)

        def run_variants(source, name, call, check, iters):
            """Check every variant, then time them in turns."""
            nonlocal ok
            parts, live = {}, []
            for label, _, checked in variants:
                if (source, label) not in libs:
                    continue
                use(source, label)
                try:
                    got = call()
                    torch.cuda.synchronize()
                except RuntimeError as exc:  # a launch the card refuses (shared memory)
                    parts[label] = f"{label}: {exc}"
                    continue
                live.append(label)
                parts[label] = f"{label}:"
                if checked:
                    good, text = check(got)
                    parts[label] += f" {text}" if args.no_time or not good else " agrees"
                    ok = ok and good
            if not args.no_time:
                times = {label: [] for label in live}
                for label in live + live[::-1]:
                    use(source, label)
                    times[label].append(ms(call, iters))
                for label, (first, second) in times.items():
                    parts[label] += f" ms={first:.4f}, {second:.4f}"
            print(f"{source} {name}: " + " | ".join(parts.values()), flush=True)

        if "render" in args.kernel:
            for name, n, crop in RENDER_CASES:
                case = render_case(name, n, crop)
                sl = slice(0, min(n, 16))
                part = case[:5] + (case[5][sl], case[6][sl]) + case[7:]
                want = render.render_views_plain(*part)
                verts = render.vertex_prepass_plain(case[0], case[1], part[5], part[6])
                coeffs, _, _ = render.render_prepass(*part[:4], part[5], part[6], crop, crop)
                exact_args = (verts, case[2], case[3], case[4], part[5]) + case[7:]

                def check(got, want=want, exact_args=exact_args, coeffs=coeffs, sl=sl):
                    bad, err = render_disagreement(got[sl], want)
                    exact = render.launch_render(*exact_args, coeffs=coeffs)
                    bad_x, err_x = render_disagreement(exact, want)
                    text = (f"pixels_off={bad:.4%} max_abs_err={err:.2e}; handed-in "
                            f"coefficients: pixels_off={bad_x:.4%} max_abs_err={err_x:.2e}")
                    return bad < RENDER_BAD_FRAC and bad_x == 0.0, text

                run_variants("render", f"{name} N={n} {crop}x{crop}",
                             lambda case=case: render.render_views(*case), check, 10)
        if "rasterize" in args.kernel:
            for name, n, h, w in RASTER_CASES:
                clip, faces, _, _ = raster_case(name, n, h, w)
                want = rasterize_tiled.rasterize_tiled_plain(clip, faces, h, w)
                coeffs, _ = rasterize_tiled.rasterize_prepass(clip, faces, h, w)

                def check(got, want=want, clip=clip, faces=faces, h=h, w=w, coeffs=coeffs):
                    share, err = raster_agreement(got, want)
                    exact = rasterize_tiled.launch_rasterize(clip, faces, h, w, coeffs=coeffs)
                    share_x, err_x = raster_agreement(exact, want)
                    text = (f"ids_agree={share:.6%} max_abs_err={err:.2e}; handed-in "
                            f"coefficients: ids_agree={share_x:.6%} max_abs_err={err_x:.2e}")
                    return (share > RASTER_AGREE and err <= RASTER_TOL and share_x == 1.0
                            and err_x <= RASTER_TOL), text

                run_variants("rasterize", f"{name} N={n} {h}x{w}",
                             lambda clip=clip, faces=faces, h=h, w=w:
                             rasterize_tiled.rasterize_tiled(clip, faces, h, w),
                             check, 20)
    print("sweep: " + ("every checked variant agrees with the plain version" if ok
                       else "DISAGREEMENT or a failed build"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
