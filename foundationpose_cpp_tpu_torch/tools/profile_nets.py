"""Layer-by-layer time of the refiner's forward on the card (perf harness).

    python -m foundationpose_cpp_tpu_torch.tools.profile_nets [--iters 8] [--n 252] [--dtype f32]
    python -m foundationpose_cpp_tpu_torch.tools.profile_nets --device cpu --n 2 --iters 1

Counterpart of the JAX package's ``tools/profile_nets.py``, with its labels
and flags: encodeA over the 2N siamese batch, then its stem conv alone and
with ``conv1``; encodeAB from encodeA features, then ``res0`` and ``res1``
alone; the transformer from tokens, then one layer's self-attention (qkv,
the attention kernel, proj) and its FFN with the two LayerNorms; the full
refiner; and the forward's multiply-accumulates (``networks.flops_per_pair``).
Every part is the port's own module (``RefineNet.encodeA[...]``,
``ResBlock``, ``EncoderLayer``), so the transformer and the self-attention
launch the attention kernel.

Each part runs on ``iters`` distinct inputs, made on the device from a
seeded ``torch.Generator`` (building gigabytes on the host and copying them
stalls), after one warm-up call, timed by CUDA events around the queued
calls (``utils.profiling.stacked_ms``). The nets compute in bf16 on the
card and in f32 on the CPU; ``--dtype`` is the dtype of the crops fed to
them. Prints the JAX tool's lines, then one JSON line of the times with
the card's name and power limit. Without a card it raises unless
``--device cpu``, where the host clock times the plain versions.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.bench import card_name_and_power_limit
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.utils.device import resolve_device
from foundationpose_cpp_tpu_torch.utils.profiling import stacked_ms

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(device: torch.device) -> torch.dtype:
    """The nets' dtype: bf16 on the card (the port's default), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def seeded_net(kind: str, device: torch.device, cfg: networks.NetConfig, seed: int):
    """``networks.init_net`` on ``device`` in its compute dtype."""
    return networks.init_net(kind, cfg, seed=seed).to(device).cast_matmul_weights(
        compute_dtype(device))


def uniform(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """U[0, 1) of ``shape`` on the generator's device, in ``dtype``."""
    return torch.rand(shape, generator=gen, device=gen.device).to(dtype)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The nets' (N, C, H, W) view of channels-last (N, H, W, C) memory."""
    return x.permute(0, 3, 1, 2)


def timer(device: torch.device, results: dict):
    """``timed(label, fn, *stacks)``: time fn over the stacks, keep and print it."""
    def timed(label, fn, *stacks):
        ms = stacked_ms(fn, stacks, device)
        results[label] = ms
        print(f"{label:34s} {ms:8.2f} ms/iter")
        return ms
    return timed


def print_line(tool: str, device, **fields) -> None:
    """A harness's one JSON line: its results and settings, the device, and
    the card's name and power limit as ``nvidia-smi`` gives them."""
    dev = resolve_device(device)
    card = card_name_and_power_limit() if dev.type == "cuda" else None
    print(json.dumps({"tool": tool, **fields, "device": str(dev), "card": card}), flush=True)


@torch.inference_mode()
def run(device=None, iters: int = 8, n: int = 252, dtype: str = "f32",
        net_cfg: networks.NetConfig | None = None) -> dict:
    """Every part's ms per call, keyed by the JAX tool's labels, with
    ``GMAC per forward`` (multiply-accumulates of one batch-n forward) and
    the full refiner's ``FULL refiner TFLOP/s``."""
    dev = resolve_device(device)
    cfg = net_cfg or networks.NetConfig()
    net = seeded_net("refiner", dev, cfg, seed=0)
    cdt = compute_dtype(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    hw, s2, s3 = cfg.crop_hw, cfg.crop_hw // 4, cfg.crop_hw // 8
    crops_a = uniform(gen, (iters, n, hw, hw, cfg.in_channels), DTYPES[dtype])
    crops_b = uniform(gen, (iters, n, hw, hw, cfg.in_channels), DTYPES[dtype])
    out = {}
    timed = timer(dev, out)
    a, ab = net.encodeA, net.encodeAB

    def stem(x, y):  # as the refiner's forward runs it, the crops' write included
        return networks.stem(a["conv0"], x, y, cdt)

    def conv1(x, y):
        return networks.conv_act(a["conv1"], stem(x, y))

    timed("encodeA (2N batch)", lambda x, y: a["res"](conv1(x, y)), crops_a, crops_b)
    timed("conv0 7x7 s2 (6->64)", stem, crops_a, crops_b)
    timed("+conv1 3x3 s2 (64->128)", conv1, crops_a, crops_b)

    # encodeAB and the transformer from features made here
    feats_a = uniform(gen, (iters, n, s2, s2, cfg.width2), cdt)
    feats_b = uniform(gen, (iters, n, s2, s2, cfg.width2), cdt)

    def concat(fa, fb):
        return torch.cat([nchw(fa), nchw(fb)], dim=1)

    timed("encodeAB",
          lambda fa, fb: ab["res1"](networks.conv_act(ab["conv"], ab["res0"](concat(fa, fb)))),
          feats_a, feats_b)
    timed("res0 (2x 3x3 256ch @40)", lambda fa, fb: ab["res0"](concat(fa, fb)), feats_a, feats_b)
    del feats_a, feats_b
    feats_ab = uniform(gen, (iters, n, s3, s3, cfg.embed_dim), cdt)
    timed("res1 (2x 3x3 512ch @20)", lambda f: ab["res1"](nchw(f)), feats_ab)
    del feats_ab

    toks = uniform(gen, (iters, n, s3 * s3, cfg.embed_dim), cdt)

    def transformer(t):
        for layer in net.encoder:
            t = layer(t)
        return t

    layer0 = net.encoder[0]
    timed("transformer", transformer, toks)
    timed("self-attention (qkv+core+proj)", layer0.attn, toks)

    def ffn_ln(t):
        x = layer0.ln1(t)
        return layer0.ln2(x + layer0.mlp2(F.relu(layer0.mlp1(x))))

    timed("FFN + 2x LayerNorm", ffn_ln, toks)
    del toks
    timed("FULL refiner", net, crops_a, crops_b)
    gmac = networks.flops_per_pair(cfg) * n / 1e9
    out["GMAC per forward"] = gmac
    out["FULL refiner TFLOP/s"] = 2 * gmac / out["FULL refiner"]
    print(f"\nflops: {gmac:.1f} GMAC per batch-{n} forward ({2 * gmac / 1e3:.2f} TFLOP; "
        f"{out['FULL refiner TFLOP/s']:.1f} TFLOP/s)")
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=252)
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES),
                    help="dtype of the crop inputs fed to the net")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device, args.iters, args.n, args.dtype)
    print_line("profile_nets", args.device, results=out, n=args.n, iters=args.iters,
               dtype=args.dtype)
    return out


if __name__ == "__main__":
    main()
