"""A/B of formulations of the encodeA stem conv (7x7/s2, 6->64) on the card.

    python -m foundationpose_cpp_tpu_torch.tools.bench_stem [--iters 8] [--n 252]
    python -m foundationpose_cpp_tpu_torch.tools.bench_stem --device cpu --n 2 --iters 1

Counterpart of the JAX package's ``tools/bench_stem.py``, with its labels:

  as served    the stem as ``_Backbone.forward`` runs it
               (``networks.stem``): the two halves of the batch, f32 as
               the crops reach the nets, written into the nets' input
               (on the card in bf16, the padded route: a zeroed buffer of
               ``networks.STEM_CHANNEL_MULTIPLE`` channels), then the conv
               and its ReLU (on the card in bf16, the conv without its
               bias and the epilogue kernel)
  direct       the production conv (``RefineNet.encodeA["conv0"]``: 7x7,
               stride 2, torch pad 3) on an input already cast
  C padded     the same, its input's channels padded with zeros to 8, 16
               and 32 (dim 1 of the nets' NCHW view of channels-last
               memory, which the padded input keeps)
  s2d          space-to-depth, then a 4x4 VALID conv (``networks.conv0_s2d``)
  polyphase    4 stride-2 slices of the padded input (its parity planes),
               each a 4x4 VALID conv with its taps of the 7x7, summed in f32
  blocked      a 4x4 VALID conv on an input already 2x2-blocked (the
               ceiling of a renderer and warp that would emit that layout:
               the blocking is made before the timed calls)

All use the weights of a seeded refiner's stem in the nets' (O, C, 7, 7)
layout and dtype (bf16 on the card, f32 on the CPU); all but "as served"
take their input in that dtype. Each variant runs on
``iters`` distinct 2N-crop batches made on the device, after a warm-up
(cuDNN picks its algorithms per shape), timed by CUDA events; then every
variant is held against ``direct`` on the first batch (max |d|). Prints
the JAX tool's lines and one JSON line with the card's name and power
limit. Without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.tools.profile_nets import (
    compute_dtype, nchw, print_line, seeded_net, timer, uniform,
)
from foundationpose_cpp_tpu_torch.utils.device import resolve_device

PADS = (8, 16, 32)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The (N, H, W, C) view of the nets' channels-last (N, C, H, W)."""
    return x.permute(0, 2, 3, 1)


def stem_conv(weight: torch.Tensor, bias: torch.Tensor) -> networks.Conv:
    """A 7x7/s2 stem ``Conv`` holding ``weight`` (O, C, 7, 7) and ``bias``
    themselves, in their device and dtype."""
    conv = networks.Conv(weight.shape[1], weight.shape[0], 7, stride=2)
    del conv.weight, conv.bias
    conv.weight, conv.bias = weight, bias
    return conv


def block2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2): channel (r, s, c) of block (y, x)
    is x[c, 2y + r, 2x + s]; channels-last, as the nets take it."""
    n, c, h, w = x.shape
    xb = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return xb.reshape(n, 4 * c, h // 2, w // 2).contiguous(memory_format=torch.channels_last)


def blocked_input(x: torch.Tensor) -> torch.Tensor:
    """The blocked variant's input: x padded by 4 before and 2 after each
    side, 2x2-blocked: (N, 4C, H/2 + 3, W/2 + 3)."""
    return block2x2(F.pad(x, (4, 2, 4, 2)))


def variants(weight: torch.Tensor, bias: torch.Tensor) -> dict:
    """label -> (prepare, stem): ``prepare`` makes a variant's input from an
    (N, C, H, W) batch outside the timed calls (the blocking of the ceiling;
    None for the others), ``stem`` is the timed conv, (N, O, H/2, W/2) in the
    input's dtype. ``weight`` (O, C, 7, 7), ``bias`` (O,)."""
    o, cin = weight.shape[:2]
    w8 = F.pad(weight, (0, 1, 0, 1))  # 7 -> 8 taps, the 8th zero

    def direct(x):
        return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), 2, 3)

    def padded(cpad):
        wp = F.pad(weight, (0, 0, 0, 0, 0, cpad - cin))

        def stem(x):
            xp = F.pad(x, (0, 0, 0, 0, 0, cpad - cin)).contiguous(
                memory_format=torch.channels_last)
            return F.conv2d(xp, wp.to(x.dtype), bias.to(x.dtype), 2, 3)
        return stem

    def polyphase(x):
        # out[o] = sum_i xpad[2o + i] w[i]: tap i = 2k + r of parity plane r
        h = x.shape[2] // 2
        xp = F.pad(x, (3, 4, 3, 4))
        acc = None
        for r in range(2):
            for s in range(2):
                taps = w8[:, :, r::2, s::2].to(x.dtype)  # (O, C, 4, 4)
                part = F.conv2d(xp[:, :, r::2, s::2], taps)[:, :, :h, :h].float()
                acc = part if acc is None else acc + part
        return (acc + bias.float()[:, None, None]).to(x.dtype)

    # the ceiling's weights: taps shifted by one (pad 1 before), 2x2-blocked
    wb = (F.pad(weight, (1, 0, 1, 0)).reshape(o, cin, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
          .reshape(o, 4 * cin, 4, 4))

    def blocked(xb):
        return F.conv2d(xb, wb.to(xb.dtype), bias.to(xb.dtype))

    served = stem_conv(weight, bias)

    def as_served(x):
        n = x.shape[0] // 2
        return networks.stem(served, nhwc(x[:n]), nhwc(x[n:]), weight.dtype)

    out = {"direct 7x7 s2": (None, direct)}
    out["as served"] = (lambda x: x.float(), as_served)
    for cpad in PADS:
        out[f"direct, C padded to {cpad}"] = (None, padded(cpad))
    out["s2d (6-D transpose)"] = (None, lambda x: networks.conv0_s2d(x, weight, bias))
    out["polyphase (4 sub-convs)"] = (None, polyphase)
    out["blocked input (ceiling)"] = (blocked_input, blocked)
    return out


def excess(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, rtol: float = 0.0) -> dict:
    """max of |variant - direct| - rtol |direct| over one (N, C, H, W) batch,
    per label (with rtol 0, the max |d|); "as served" against the direct
    stem's ReLU, which the served stem ends in."""
    table = variants(weight, bias)
    direct = table["direct 7x7 s2"][1](x).float()
    out = {}
    for label, (prepare, stem) in table.items():
        want = direct.clamp_min(0.0) if label == "as served" else direct
        got = stem(x if prepare is None else prepare(x)).float()
        out[label] = float(((got - want).abs() - rtol * want.abs()).max())
    return out


@torch.inference_mode()
def run(device=None, iters: int = 8, n: int = 252, net_cfg: networks.NetConfig | None = None) -> dict:
    """{"ms": {label: ms a call}, "max_abs_diff": {label: max |d| against
    direct on the first batch}}."""
    dev = resolve_device(device)
    cfg = net_cfg or networks.NetConfig()
    conv0 = seeded_net("refiner", dev, cfg, seed=0).encodeA["conv0"]
    weight, bias = conv0.weight, conv0.bias
    gen = torch.Generator(device=dev).manual_seed(0)
    hw, cin = cfg.crop_hw, cfg.in_channels
    crops = uniform(gen, (iters, 2 * n, hw, hw, cin), compute_dtype(dev))
    xs = [nchw(c) for c in crops]
    ms = {}
    timed = timer(dev, ms)
    for label, (prepare, stem) in variants(weight, bias).items():
        inputs = xs if prepare is None else [prepare(x) for x in xs]
        timed(label, stem, inputs)
        del inputs
    diff = excess(weight, bias, xs[0])
    print("max |d| against direct: " + ", ".join(f"{k}={v:.3e}" for k, v in diff.items()))
    return {"ms": ms, "max_abs_diff": diff}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=252)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device, args.iters, args.n)
    print_line("bench_stem", args.device, **out, n=args.n, iters=args.iters)
    return out


if __name__ == "__main__":
    main()
