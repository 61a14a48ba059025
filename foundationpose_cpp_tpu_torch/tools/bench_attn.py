"""A/B of the transformer encoder layer's numerics, and of encodeAB's first
conv, on the card (perf harness).

    python -m foundationpose_cpp_tpu_torch.tools.bench_attn [--iters 8] [--n 252]
    python -m foundationpose_cpp_tpu_torch.tools.bench_attn --encode-ab
    python -m foundationpose_cpp_tpu_torch.tools.bench_attn --device cpu --n 2 --iters 1

Counterpart of the JAX package's ``tools/bench_attn.py``, with its labels.
The default run times one encoder layer at N=252, T=400, D=512 three ways:
(a) the production layer (``EncoderLayer``, whose core is the attention
kernel: f32 logits and softmax, P rounded to bf16), (b) bf16 logits and a
softmax in the logits' dtype and (c) bf16 logits and an f32 softmax, both
written in plain PyTorch as the JAX tool writes them; prints the relative
difference of the summed output of (b) against (a) on the first batch; then
the stem A/B of the JAX tool (direct 7x7/s2 against ``networks.conv0_s2d``,
the crops cast before and after). ``--encode-ab`` times encodeAB on
concat(A, B) against the split-weight form, which convolves A and B with
the two halves of res0's first weight and never builds the concatenation
for that conv, and prints their difference on f32 inputs.

Inputs are made on the device from a seeded ``torch.Generator``; every
variant runs on ``iters`` distinct inputs after a warm-up, timed by CUDA
events. The nets compute in bf16 on the card, in f32 on the CPU. Ends with
one JSON line with the card's name and power limit. Without a card it
raises unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math

import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.tools.profile_nets import (
    compute_dtype, nchw, print_line, seeded_net, timer, uniform,
)
from foundationpose_cpp_tpu_torch.utils.device import resolve_device
from foundationpose_cpp_tpu_torch.utils.profiling import full_f32

VARIANTS = {  # label -> (logits dtype, f32 softmax), None: the production layer
    "(a) production f32 logits": None,
    "(b) bf16 logits + bf16 softmax": (torch.bfloat16, False),
    "(c) bf16 logits + f32 softmax": (torch.bfloat16, True),
}


def attn_core(attn: networks.SelfAttention, x: torch.Tensor, logits_dtype: torch.dtype,
              softmax_f32: bool) -> torch.Tensor:
    """Self-attention with the logits rounded to ``logits_dtype`` and the
    softmax taken in f32 or in that dtype (tools/bench_attn.py:59-80)."""
    n, t, d = x.shape
    nh = attn.num_heads
    hd = d // nh
    q, k, v = (a.reshape(n, t, nh, hd).transpose(1, 2) for a in attn.qkv(x).split(d, dim=-1))
    q = q / math.sqrt(hd)
    # the product accumulates in f32 and is rounded once to logits_dtype
    # (JAX's preferred_element_type) when x's dtype is bf16 or f32
    logits = torch.matmul(q, k.transpose(-1, -2)).to(logits_dtype)
    p = torch.softmax(logits.float() if softmax_f32 else logits, dim=-1).to(x.dtype)
    out = torch.matmul(p, v).transpose(1, 2).reshape(n, t, d)
    return attn.proj(out)


def layer_variant(layer: networks.EncoderLayer, x: torch.Tensor, variant) -> torch.Tensor:
    """The post-norm encoder layer with the self-attention of ``variant``."""
    if variant is None:
        return layer(x)
    x = layer.ln1(x + attn_core(layer.attn, x, *variant))
    return layer.ln2(x + layer.mlp2(F.relu(layer.mlp1(x))))


def encode_ab_concat(ab, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """encodeAB on concat(A, B), as the nets run it: (N, C, S, S) x2 -> (N, D, S/2, S/2)."""
    x = ab["res0"](torch.cat([fa, fb], dim=1))
    return ab["res1"](networks.conv_act(ab["conv"], x))


def encode_ab_split(ab, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """encodeAB with res0's first conv as conv(A, W[:, :C]) + conv(B, W[:, C:])."""
    c = fa.shape[1]
    res0 = ab["res0"]
    w1, b1 = res0.conv1.weight.to(fa.dtype), res0.conv1.bias.to(fa.dtype)
    h = F.relu(F.conv2d(fa, w1[:, :c], None, 1, 1) + F.conv2d(fb, w1[:, c:], b1, 1, 1))
    h = res0.conv2(h)
    x = F.relu(torch.cat([fa, fb], dim=1) + h)  # the skip still needs it
    return ab["res1"](networks.conv_act(ab["conv"], x))


@torch.inference_mode()
def run(device=None, iters: int = 8, n: int = 252, net_cfg: networks.NetConfig | None = None) -> dict:
    """The three layer variants' and the stem A/B's ms, keyed by the JAX
    tool's labels, ``sum-output rel diff (b vs a)`` and ``max abs diff (b
    vs a)`` on the first batch."""
    dev = resolve_device(device)
    cfg = net_cfg or networks.NetConfig()
    net = seeded_net("refiner", dev, cfg, seed=0)
    cdt = compute_dtype(dev)
    layer = net.encoder[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = uniform(gen, (iters, n, cfg.num_tokens, cfg.embed_dim), cdt)
    out = {}
    timed = timer(dev, out)
    for label, variant in VARIANTS.items():
        timed(label, lambda x, v=variant: layer_variant(layer, x, v), toks)
    ya = layer_variant(layer, toks[0], VARIANTS["(a) production f32 logits"]).float()
    yb = layer_variant(layer, toks[0], VARIANTS["(b) bf16 logits + bf16 softmax"]).float()
    # the JAX tool's measure; with LayerNorm's bias at 0 the sum is near 0,
    # so the elementwise difference is printed beside it
    out["sum-output rel diff (b vs a)"] = abs(float(ya.sum()) - float(yb.sum())) / abs(float(ya.sum()))
    out["max abs diff (b vs a)"] = float((ya - yb).abs().max())
    print(f"sum-output rel diff (b vs a): {out['sum-output rel diff (b vs a)']:.2e}; elementwise "
        f"max |d| {out['max abs diff (b vs a)']:.3e}")
    del toks

    gen = torch.Generator(device=dev).manual_seed(1)
    crops = uniform(gen, (iters, 2 * n, cfg.crop_hw, cfg.crop_hw, cfg.in_channels), torch.float32)
    conv0 = net.encodeA["conv0"]
    timed("conv0 direct 7x7/s2", lambda x: conv0(nchw(x).to(cdt)), crops)
    timed("conv0 space-to-depth",
          lambda x: networks.conv0_s2d(nchw(x).to(cdt), conv0.weight, conv0.bias), crops)
    timed("conv0 s2d (pre-cast bf16)",
          lambda x: networks.conv0_s2d(nchw(x.to(torch.bfloat16)), conv0.weight, conv0.bias),
          crops)
    return out


@torch.inference_mode()
def run_encode_ab(device=None, iters: int = 8, n: int = 252,
                  net_cfg: networks.NetConfig | None = None) -> dict:
    """The concat and split-weight forms' ms, ``sum-diff (f32 inputs)`` (the
    JAX tool's |sum(concat) - sum(split)|) and ``max abs diff (f32 inputs)``
    (elementwise, cuDNN in full f32), on the first batch."""
    dev = resolve_device(device)
    cfg = net_cfg or networks.NetConfig()
    ab = seeded_net("refiner", dev, cfg, seed=0).encodeAB
    s2, c = cfg.crop_hw // 4, cfg.width2
    gen = torch.Generator(device=dev).manual_seed(2)
    fa = uniform(gen, (iters, n, s2, s2, c), compute_dtype(dev))
    fb = uniform(gen, (iters, n, s2, s2, c), compute_dtype(dev))
    out = {}
    timed = timer(dev, out)
    timed("encodeAB concat form", lambda a, b: encode_ab_concat(ab, nchw(a), nchw(b)), fa, fb)
    timed("encodeAB split-weight form", lambda a, b: encode_ab_split(ab, nchw(a), nchw(b)), fa, fb)
    xa, xb = nchw(fa[0].float()), nchw(fb[0].float())
    with full_f32():
        want, got = encode_ab_concat(ab, xa, xb), encode_ab_split(ab, xa, xb)
    out["sum-diff (f32 inputs)"] = abs(float(want.sum()) - float(got.sum()))
    out["max abs diff (f32 inputs)"] = float((want - got).abs().max())
    print(f"sum-diff (f32 inputs): {out['sum-diff (f32 inputs)']:.3e}; elementwise max |d| "
        f"{out['max abs diff (f32 inputs)']:.3e}")
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=252)
    ap.add_argument("--encode-ab", action="store_true",
                    help="A/B encodeAB's concat and split-weight forms instead")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = (run_encode_ab if args.encode_ab else run)(args.device, args.iters, args.n)
    print_line("bench_attn" + (" --encode-ab" if args.encode_ab else ""), args.device,
               results=out, n=args.n, iters=args.iters)
    return out


if __name__ == "__main__":
    main()
