"""Build ``csrc/attention.cu`` with several widths of its wide block and
compare them on the card.

    python -m foundationpose_cpp_tpu_torch.tools.attention_tile_sweep [--warpgroups 2 4] [--no-time]

For each value of ``MHA_WARPGROUPS`` (the warpgroups, 64 query rows each, of
the block that the bf16 body gives to launches that fill the card; the
source's default is the one the package ships) it compiles the source into
its own library, prints what ptxas reports for the widest kernels, holds
both layouts against the plain version at the main paths' shapes (bf16
within 2^-9 + 2^-6 |plain|, f32 within 1e-5 + 1e-5 |plain|) and, unless
``--no-time``, times every variant by CUDA events in turns (a, b, b, a) in
the one process, so that the numbers share a card. ``--ablate``
times a copy of the source with one part of the bf16 body's work taken out,
to see what the rest costs (its outputs are wrong on purpose, so it reports
times only): ``noexp`` replaces every exp by a multiply, ``nowgmma`` drops
the tensor-core instructions, ``stream`` leaves only the copies through the
ring and the barriers, ``nocopy`` keeps all compute and copies no k or v tile. Needs a CUDA card and nvcc; imports neither at module
level.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys
import tempfile

SHAPES_PACKED = [  # (B, T, heads, hd, dtype)
    (252, 4 * 4, 4, 16, "bfloat16"), (1, 252, 4, 128, "bfloat16"), (252, 400, 4, 128, "bfloat16"),
    (1, 400, 4, 128, "bfloat16"), (4, 1500, 4, 128, "bfloat16"), (252, 400, 4, 128, "float32"),
]
SHAPES_HEADS = [  # (B, H, T, hd, dtype)
    (252, 4, 16, 16, "bfloat16"), (252, 8, 400, 64, "bfloat16"), (1, 8, 252, 64, "bfloat16"),
    (3, 2, 65, 48, "bfloat16"), (252, 4, 16, 16, "float32"), (252, 8, 400, 64, "float32"),
    (3, 2, 65, 48, "float32"),
]


def ablated_source(text: str, kind: str) -> str:
    """The kernel source with one part of the bf16 body's work removed."""
    if kind == "noexp":
        out = text.replace("ex2(fmaf(", "not_exp(fmaf(").replace(
            "__device__ __forceinline__ uint32_t pack_bf16(",
            "__device__ __forceinline__ float not_exp(float x) { return x * 0.001f; }\n"
            "__device__ __forceinline__ uint32_t pack_bf16(", 1)
    elif kind == "nocopy":
        out = text.replace("mbar_expect_bytes(bar, SLOT * (int)sizeof(E));", "mbar_expect_bytes(bar, 0);")
        out = out.replace("      tma_load_3d(dst + cb", "      if (false) tma_load_3d(dst + cb")
        if out.count("if (false) tma_load_3d") != 1 or "mbar_expect_bytes(bar, 0);" not in out:
            raise ValueError("the ablation 'nocopy' did not find the copy")
    elif kind in ("nowgmma", "stream"):
        out = re.sub(r'      "wgmma\.mma_async[^;]*?;\\n\}\\n"', '      "}\\\\n"', text, flags=re.S)
        if '"wgmma.mma_async' in out:
            raise ValueError("a wgmma instruction survived the ablation")
        if kind == "stream":
            out = out.replace("const bool active = q0 + row0 < T;", "const bool active = false;")
    else:
        raise ValueError(f"unknown ablation {kind!r}")
    if out == text or (kind == "stream" and "const bool active = false;" not in out):
        raise ValueError(f"the ablation {kind!r} did not change the source")
    return out


def build_variant(cuda_build, tile: int, out_dir: str, source: str) -> tuple[ctypes.CDLL, str]:
    out = os.path.join(out_dir, f"libattention_wide{tile}.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v", f"-DMHA_WARPGROUPS={tile}",
           "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tile} warpgroups:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fp_mha_packed_qkv.restype = lib.fp_mha_whole_head.restype = ctypes.c_int
    lib.fp_mha_packed_qkv.argtypes = [ctypes.c_void_p] * 2 + tail
    lib.fp_mha_whole_head.argtypes = [ctypes.c_void_p] * 4 + tail
    return lib, proc.stderr


def ptxas_summary(log: str, want=("Li128E", "Li64E", "Li16E")) -> list[str]:
    """'entry: registers, spills' for the kernels whose mangled name holds one of want."""
    lines, entry = [], None
    spill = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry and any(w in entry for w in want):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warpgroups", type=int, nargs="+", default=[2, 4], help="warpgroups of the wide block")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--main-only", action="store_true", help="only the two full-width bf16 shapes")
    ap.add_argument("--ablate", choices=["noexp", "nowgmma", "stream", "nocopy"], default=None,
                    help="time the source with this part of the bf16 body's work removed")
    args = ap.parse_args(argv)

    import torch

    from foundationpose_cpp_tpu_torch.ops import attention, cuda_build

    if not torch.cuda.is_available():
        print("attention_tile_sweep: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    def excess(got, want):
        tol = (2.0**-9, 2.0**-6) if got.dtype == torch.bfloat16 else (1e-5, 1e-5)
        want = want.float()
        return ((got.float() - want).abs() / (tol[0] + tol[1] * want.abs())).max().item()

    def ms(fn, iters=20):
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

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        source = str(cuda_build.CSRC / "attention.cu")
        if args.ablate:
            with open(source) as f:
                text = ablated_source(f.read(), args.ablate)
            source = os.path.join(tmp, f"attention_{args.ablate}.cu")
            with open(source, "w") as f:
                f.write(text)
            print(f"ablation {args.ablate}: outputs are wrong on purpose, read the times only", flush=True)
        for tile in args.warpgroups:
            libs[tile], log = build_variant(cuda_build, tile, tmp, source)
            for line in ptxas_summary(log):
                print(f"wide {tile} ptxas {line}", flush=True)
        cases = []
        packed, heads_split = SHAPES_PACKED, SHAPES_HEADS
        if args.main_only:
            packed, heads_split = [SHAPES_PACKED[2]], [SHAPES_HEADS[1]]
        for b, t, heads, hd, dtype in packed:
            qkv = torch.randn((b, t, 3 * heads * hd), generator=gen, device="cuda").to(getattr(torch, dtype))
            out = torch.empty((b, t, heads * hd), dtype=qkv.dtype, device="cuda")
            want = attention.mha_packed_qkv_plain(qkv, heads)

            def run(lib, qkv=qkv, out=out, dims=(b, t, heads, hd)):
                err = lib.fp_mha_packed_qkv(qkv.data_ptr(), out.data_ptr(), *dims, 1 / math.sqrt(dims[3]),
                                            int(qkv.dtype == torch.float32), stream)
                cuda_build.check(err, "fp_mha_packed_qkv")
                return out

            cases.append((f"packed {dtype} B={b} T={t} {heads}x{hd}", run, want))
        for b, h, t, hd, dtype in heads_split:
            q, k, v = (torch.randn((b, h, t, hd), generator=gen, device="cuda").to(getattr(torch, dtype))
                       for _ in range(3))
            out = torch.empty_like(q)
            want = attention.mha_whole_head_plain(q, k, v)

            def run(lib, q=q, k=k, v=v, out=out, dims=(b, h, t, hd)):
                err = lib.fp_mha_whole_head(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
                                            1 / math.sqrt(dims[3]), int(q.dtype == torch.float32), stream)
                cuda_build.check(err, "fp_mha_whole_head")
                return out

            cases.append((f"head-split {dtype} ({b}, {h}, {t}, {hd})", run, want))
        for name, run, want in cases:
            parts = {}
            for tile, lib in libs.items():
                got = run(lib).clone()
                torch.cuda.synchronize()
                e = excess(got, want)
                ok = ok and (bool(args.ablate) or (e <= 1.0 and bool(torch.isfinite(got.float()).all())))
                parts[tile] = f"wide {tile}: err/tol={e:.3f}"
            if not args.no_time:
                times = {tile: [] for tile in libs}
                for tile in list(libs) + list(libs)[::-1]:
                    times[tile].append(ms(lambda: run(libs[tile])))
                for tile, (first, second) in times.items():
                    parts[tile] += f" ms={first:.4f}, {second:.4f}"
            print(f"{name}: " + " | ".join(parts.values()), flush=True)
    if not args.ablate:
        print("sweep: " + ("all variants agree with the plain version" if ok else "DISAGREEMENT"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
