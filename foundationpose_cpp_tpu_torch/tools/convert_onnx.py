"""Convert published FoundationPose refiner/scorer weights for the port.

The reference consumes ONNX models exported from NVIDIA's FoundationPose
training repo (reference README.md:72), converted to TensorRT engines by
tools/cvt_onnx2trt.bash. This tool ingests those weight files (a torch .pth,
or an ONNX export, named or constant-folded), maps every tensor BY NAME onto
the port's ``RefineNet`` / ``ScoreNet`` (BatchNorm folded into the convs,
``in_proj`` as the packed qkv; ``models/convert.py``) and writes an f32 npz
checkpoint in the JAX package's format, which ``FoundationPose`` and the
inference cores take as a path, and the JAX package loads too. It needs no
JAX and no ``onnx`` package, and runs on the host.

The mapping is strict: any unknown, missing or mis-shaped tensor aborts with
the offending names; it never writes a partial or shape-guessed checkpoint.

Usage:
  python -m foundationpose_cpp_tpu_torch.tools.convert_onnx --torch model_best.pth --net refiner --out r.npz
  python -m foundationpose_cpp_tpu_torch.tools.convert_onnx --onnx refiner_hwc.onnx --net refiner --out r.npz
  python -m foundationpose_cpp_tpu_torch.tools.convert_onnx --init refiner --out refiner.npz  # random init
  python -m foundationpose_cpp_tpu_torch.tools.convert_onnx --torch f.pth --net scorer --list  # inspect
"""

from __future__ import annotations

import argparse

from foundationpose_cpp_tpu_torch.models import convert, convert_jax, networks


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--onnx", help="path to refiner_hwc.onnx / scorer_hwc.onnx")
    src.add_argument("--torch", dest="torch_path", help="training-repo .pth")
    src.add_argument("--init", choices=["refiner", "scorer"],
                     help="write a seeded random checkpoint with the published structure")
    ap.add_argument("--net", choices=["refiner", "scorer"], default="refiner")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--list", action="store_true", help="only list tensors")
    ap.add_argument("--allow-pickle", action="store_true",
                    help="permit torch.load(weights_only=False) for legacy checkpoints "
                         "(pickle executes arbitrary code; only for trusted files)")
    ap.add_argument("--crop-hw", type=int, default=160)
    args = ap.parse_args(argv)

    if args.init:
        if not args.out:
            ap.error("--out is required with --init")
        net = networks.init_net(args.init, networks.NetConfig(), args.seed)
        convert_jax.save_npz(net.state_dict(), args.out)
        print(f"[convert_onnx] wrote RANDOM-init {args.init} checkpoint "
              f"({networks.count_params(net):,} params) to {args.out}")
        return

    path = args.onnx or args.torch_path
    try:
        if args.list:
            sd = (convert.load_onnx_initializers(path) if args.onnx
                  else convert.load_torch_checkpoint(path, args.allow_pickle))
            print(f"extracted {len(sd)} tensors:")
            for name, arr in sorted(sd.items()):
                print(f"  {name:60s} {arr.shape} {arr.dtype}")
            return
        if not args.out:
            ap.error("--out is required unless --list")
        sd, cfg = convert.convert_file(path, args.net, out_path=args.out,
                                       allow_pickle=args.allow_pickle, crop_hw=args.crop_hw)
        print(f"[convert_onnx] converted {path} -> {args.out} "
              f"({sum(t.numel() for t in sd.values()):,} params, cfg={cfg})")
    except convert.ConversionError as e:
        raise SystemExit(f"[convert_onnx] {e}")


if __name__ == "__main__":
    main()
