"""Refiner / scorer networks: the published FoundationPose graphs as
``nn.Module``s.

Counterpart of ``foundationpose_cpp_tpu.models.networks``, layer for layer
(NVlabs FoundationPose ``RefineNet`` and ``ScoreNetMultiPair``):

  encodeA  (siamese, shared):  ConvBNReLU(6->64, 7x7, s2)
                               ConvBNReLU(64->128, 3x3, s2)
                               ResnetBasicBlock(128)
  encodeAB (on concat A||B):   ResnetBasicBlock(256)
                               ConvBNReLU(256->512, 3x3, s2)
                               ResnetBasicBlock(512)
  tokens:  (160/8)^2 = 400 spatial tokens of dim 512 + sinusoidal position
  encoder: 1x post-norm TransformerEncoderLayer (4 heads, FFN 512, ReLU)
  pool:    mean over tokens (scorer: + att_cross layer across hypotheses)
  heads:   refiner Linear(512->3) x2 (trans, rot); scorer Linear(512->1)

BatchNorm is folded into the convolutions, as in the JAX checkpoints. Inputs
and outputs are NHWC at the public boundary, like the JAX functions; inside,
``permute(0, 3, 1, 2)`` gives the convolutions a channels-last NCHW view with
no copy. On the card in a 16-bit dtype the stem writes the crops into a
buffer of 16 zero-padded channels instead (``padded_stem``), which cuDNN
runs on its tensor cores; in bf16 there each conv also runs without its bias,
which one kernel adds, with the residual and the ReLU that follow, in
place (``conv_act``, ``ops.epilogue.conv_epilogue``). Convs and the
qkv/proj/FFN projections run in the input dtype
(bf16 on the card, f32 accumulation in cuDNN and cuBLAS); LayerNorm
statistics and the heads run in f32. The attention core is a CUDA kernel
on the card, routed as the JAX function routes its Pallas kernels: a head
width that is a multiple of 128 reads the packed projection
(``ops.attention.mha_packed_qkv``), any other splits heads first
(``ops.attention.mha_whole_head``). The kernel is forward-only and raises
under autograd; ``NetConfig(attn_impl="plain")`` runs its plain version on
any device, with gradients, as the trainers do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from foundationpose_cpp_tpu_torch.ops import attention, cuda_build, epilogue


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Published-graph dimensions (defaults); tests shrink them for the CPU."""

    in_channels: int = 6
    width1: int = 64
    width2: int = 128
    embed_dim: int = 512
    num_heads: int = 4
    ffn_dim: int = 512
    num_encoder_layers: int = 1
    crop_hw: int = 160
    cross_attention: bool = False  # scorer ScoreNetMultiPair att_cross
    # attention core: "auto" launches the attention kernel on CUDA tensors
    # (forward only; it raises under autograd) and runs its plain version on
    # CPU tensors; "plain" runs the plain version on any device, with
    # autograd (the JAX package's "xla"), as the trainers do
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.attn_impl not in ("auto", "plain"):
            raise ValueError(f"attn_impl must be 'auto' or 'plain', got {self.attn_impl!r}")

    @property
    def num_tokens(self) -> int:
        # three stride-2 convs: crop_hw / 8 per side (160 -> 20; 400 tokens)
        return (self.crop_hw // 8) ** 2


REFINER_HEADS = {"trans": 3, "rot": 3}
SCORER_HEADS = {"scores": 1}


def sinusoidal_position_table(max_len: int, d_model: int) -> np.ndarray:
    """The PositionalEmbedding buffer (network_modules.py): sin/cos table."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class Conv(nn.Module):
    """Conv + bias (BN folded) with torch's symmetric (k-1)//2 padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.padding = (k - 1) // 2
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


def fuses_epilogue(x: torch.Tensor, conv: Conv) -> bool:
    """Whether ``conv`` over ``x`` takes the epilogue kernel: on the card, in
    bf16, with nothing for autograd to record (grad mode off, or neither x
    nor the conv's parameters requiring a gradient). Elsewhere (the CPU,
    float32, the trainers) the conv keeps its bias and PyTorch's residual
    add and ReLU run after it, as in the JAX package's layer order."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and (
                x.requires_grad or conv.weight.requires_grad or conv.bias.requires_grad)))


def conv_act(conv: Conv, x: torch.Tensor, residual: torch.Tensor | None = None,
             weight: torch.Tensor | None = None) -> torch.Tensor:
    """relu(residual + conv(x)) in x's dtype, the residual optional;
    ``weight`` in x's dtype convolves in place of the conv's own
    (the padded stem's). Where ``fuses_epilogue`` holds, the conv runs
    without its bias and ``conv_epilogue`` adds the bias, the residual and
    the ReLU in one pass over its output, with the same roundings."""
    w = conv.weight.to(x.dtype) if weight is None else weight
    b = conv.bias.to(x.dtype)
    if fuses_epilogue(x, conv):
        y = F.conv2d(x, w, None, conv.stride, conv.padding)
        return epilogue.conv_epilogue(y, b, residual)
    y = F.conv2d(x, w, b, conv.stride, conv.padding)
    if residual is not None:
        y = residual + y
    return F.relu(y)


# The stem's input channels are padded with zeros to a multiple of this on
# the padded route (``padded_stem``): cuDNN runs a bf16 channels-last conv
# on 6 channels with its generic engine and one on 16 as a tensor-core
# implicit GEMM (on an H100 at 504 crops: 2.8 ms a net as served, against
# 6.3 direct and 3.9 with 8 channels).
STEM_CHANNEL_MULTIPLE = 16


def pads_stem(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether the stem takes the padded route for crops ``x`` (N, H, W, C)
    computed in ``dtype``: on the card, in a 16-bit dtype, with a channel
    count that is not a multiple of 8. Elsewhere padding buys nothing (the
    CPU, float32 with TF32 off, an aligned input)."""
    return (x.device.type == "cuda" and dtype in (torch.bfloat16, torch.float16)
            and x.shape[-1] % 8 != 0)


@functools.cache
def _zeros(shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A zero tensor, built on the first call for its shape, dtype and
    device and kept: a captured graph reads it by address. Built outside
    inference mode, so it serves autograd-recording callers too; callers
    never write to it."""
    with torch.inference_mode(False):
        return torch.zeros(shape, dtype=dtype, device=device)


@cuda_build.counted
def padded_stem(conv: Conv, render_input: torch.Tensor, transf_input: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The stem ``conv`` and its ReLU over the siamese batch [render_input;
    transf_input] (each (N, H, W, C) NHWC) with the channels zero-padded to
    a multiple of ``STEM_CHANNEL_MULTIPLE``: the crops are written, cast to
    ``dtype``, into the channel slice [..., :C] of one zeroed (2N, H, W, Cp)
    buffer (the copy the direct route's cat and cast make), and the
    (O, C, k, k) weight is padded to (O, Cp, k, k) here, in channels-last
    memory, so a ``load_state_dict`` after a capture still reaches it and
    gradients reach the parameter. The padded channels are zero in both, so
    the sum is the direct route's. (2N, O, H/2, W/2) in ``dtype``,
    channels-last, through ``conv_act``."""
    n, h, w, c = render_input.shape
    cp = -(-c // STEM_CHANNEL_MULTIPLE) * STEM_CHANNEL_MULTIPLE
    both = torch.zeros((2 * n, h, w, cp), dtype=dtype, device=render_input.device)
    both[:n, ..., :c] = render_input
    both[n:, ..., :c] = transf_input
    o, _, kh, kw = conv.weight.shape
    pad = _zeros((o, kh, kw, cp - c), dtype, render_input.device)
    weight = torch.cat([conv.weight.to(dtype).permute(0, 2, 3, 1), pad], dim=-1)
    out = conv_act(conv, both.permute(0, 3, 1, 2), weight=weight.permute(0, 3, 1, 2))
    padded_stem.launches += 1
    return out


def stem(conv: Conv, render_input: torch.Tensor, transf_input: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """The stem ``conv`` and its ReLU over the siamese batch [render_input;
    transf_input] (each (N, H, W, C) NHWC) in ``dtype``, as
    ``_Backbone.forward`` runs it: ``padded_stem`` where ``pads_stem`` says
    so, else one concatenation and cast (torch.cat([A, B], 0) in the
    original) and the conv on its channels-last NCHW view."""
    if pads_stem(render_input, dtype):
        return padded_stem(conv, render_input, transf_input, dtype)
    both = torch.cat([render_input, transf_input], dim=0).to(dtype).permute(0, 3, 1, 2)
    return conv_act(conv, both)


def conv0_s2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The 7x7/stride-2 stem conv as a space-to-depth 4x4/stride-1 conv.

    Counterpart of the JAX package's ``networks._conv0_s2d``: equal to
    ``F.conv2d(x, weight, bias, 2, 3)`` on an (N, C, H, W) ``x`` with even H
    and W and an (O, C, 7, 7) ``weight`` (the layout of ``Conv``), in x's
    dtype. out[o] = sum_i xpad[2o + i] w[i], i in 0..6, pad 3; writing the
    padded row as 2(o + d) + r (block d = o..o+3, parity r) gives i = 2d + r,
    a VALID 4-tap conv over 2x2-blocked pixels, with an 8th tap of zeros.
    Nothing on the main path calls it: it is the A/B that
    ``tools/bench_stem.py`` and ``tools/bench_attn.py`` time against the
    direct stem.
    """
    n, c, h, w = x.shape
    o = weight.shape[0]
    xp = F.pad(x, (3, 3, 3, 3))  # (N, C, H+6, W+6)
    hp, wp = h + 6, w + 6
    # channel (r, s, c) of block (y, x) = xpad[c, 2y + r, 2x + s]
    xb = (xp.reshape(n, c, hp // 2, 2, wp // 2, 2).permute(0, 3, 5, 1, 2, 4)
          .reshape(n, 4 * c, hp // 2, wp // 2))
    w8 = F.pad(weight, (0, 1, 0, 1))  # 7 -> 8 taps
    wb = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)
    return F.conv2d(xb, wb.to(x.dtype), bias.to(x.dtype))


class ResBlock(nn.Module):
    """ResnetBasicBlock: conv-bn-relu-conv-bn + skip, then relu."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3)
        self.conv2 = Conv(ch, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_act(self.conv2, conv_act(self.conv1, x), residual=x)


class Linear(nn.Module):
    """y = x W^T + b in the input dtype (``nn.Linear`` layout)."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(dout, din) / math.sqrt(din))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """torch LayerNorm (eps 1e-5) with f32 statistics and parameters."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), 1e-5)
        return y.to(x.dtype)


class SelfAttention(nn.Module):
    """torch.nn.MultiheadAttention forward: packed in_proj, scaled dot."""

    def __init__(self, dim: int, num_heads: int, plain: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.plain = plain
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)  # (N, T, 3D)
        n, t, d = x.shape
        hd = d // self.num_heads
        if self.plain:
            # the kernels' numerics in tensor ops, differentiable
            out = attention.mha_packed_qkv_plain(qkv, self.num_heads, 1.0 / math.sqrt(hd))
        elif hd % 128 == 0:
            # heads are column slices of the projection: no transposes
            out = attention.mha_packed_qkv(qkv, self.num_heads, 1.0 / math.sqrt(hd))
        else:
            # other widths split heads to (N, H, T, hd), as the JAX function
            # does before mha_whole_head, and merge them back
            q, k, v = (a.contiguous() for a in
                       qkv.reshape(n, t, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4))
            out = attention.mha_whole_head(q, k, v, 1.0 / math.sqrt(hd))
            out = out.permute(0, 2, 1, 3).reshape(n, t, d)
        return self.proj(out)


class EncoderLayer(nn.Module):
    """Post-norm TransformerEncoderLayer with a ReLU FFN:
    x = norm1(x + attn(x)); x = norm2(x + linear2(relu(linear1(x))))."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, plain_attention: bool = False):
        super().__init__()
        self.attn = SelfAttention(dim, num_heads, plain_attention)
        self.ln1 = LayerNorm(dim)
        self.ln2 = LayerNorm(dim)
        self.mlp1 = Linear(dim, ffn_dim)
        self.mlp2 = Linear(ffn_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.mlp2(F.relu(self.mlp1(x))))


class _Backbone(nn.Module):
    head_dims: dict[str, int] = {}

    def __init__(self, cfg: NetConfig = NetConfig()):
        super().__init__()
        self.cfg = cfg
        self.encodeA = nn.ModuleDict({
            "conv0": Conv(cfg.in_channels, cfg.width1, 7, stride=2),
            "conv1": Conv(cfg.width1, cfg.width2, 3, stride=2),
            "res": ResBlock(cfg.width2),
        })
        self.encodeAB = nn.ModuleDict({
            "res0": ResBlock(2 * cfg.width2),
            "conv": Conv(2 * cfg.width2, cfg.embed_dim, 3, stride=2),
            "res1": ResBlock(cfg.embed_dim),
        })
        self.pos_embed = nn.Parameter(
            torch.from_numpy(sinusoidal_position_table(cfg.num_tokens, cfg.embed_dim))
        )
        plain = cfg.attn_impl == "plain"
        self.encoder = nn.ModuleList([
            EncoderLayer(cfg.embed_dim, cfg.num_heads, cfg.ffn_dim, plain)
            for _ in range(cfg.num_encoder_layers)
        ])
        self.att_cross = (
            EncoderLayer(cfg.embed_dim, cfg.num_heads, cfg.ffn_dim, plain)
            if cfg.cross_attention else None
        )
        self.heads = nn.ModuleDict({
            name: Linear(cfg.embed_dim, dim) for name, dim in sorted(self.head_dims.items())
        })

    def forward(
        self, render_input: torch.Tensor, transf_input: torch.Tensor,
        group_size: int | None = None, gather=None,
    ) -> dict[str, torch.Tensor]:
        """(N, crop, crop, 6) NHWC pair -> {head name: (N, dim) f32}, computed
        in the dtype of the convolution weights. ``group_size``: the number of
        hypotheses of one scene, when a batch packs several scenes; att_cross
        then attends within each group only (None: the batch is one scene, as
        at inference). ``gather``: a ``torch.distributed`` process group whose
        ranks each hold one shard of the scene's hypotheses, in rank order
        (``parallel.sharding``); att_cross then attends across the gathered
        set and the heads return this rank's rows (None: the batch is the
        whole set)."""
        dtype = self.encodeA["conv0"].weight.dtype
        n = render_input.shape[0]
        a = self.encodeA
        # siamese encode over a 2N batch
        h = stem(a["conv0"], render_input, transf_input, dtype)
        h = conv_act(a["conv1"], h)
        feats = a["res"](h)
        ab = torch.cat([feats[:n], feats[n:]], dim=1)  # channel concat
        p = self.encodeAB
        ab = p["res0"](ab)
        ab = conv_act(p["conv"], ab)
        ab = p["res1"](ab)  # (N, D, crop/8, crop/8)
        d = ab.shape[1]
        # token t = y * W + x, as the JAX NHWC reshape
        tokens = ab.permute(0, 2, 3, 1).reshape(n, -1, d) + self.pos_embed.to(dtype)[None]
        for layer in self.encoder:
            tokens = layer(tokens)
        pooled = tokens.mean(dim=1)  # (N, D)
        if self.att_cross is not None:
            if gather is not None:
                # only the pooled (N, D) embeddings cross between ranks: the
                # pad rows of a padded grid take part, as in the JAX package
                pooled = all_gather_rows(pooled, gather)
            # one encoder layer attending ACROSS the hypotheses of the scene
            seq = pooled[None] if group_size is None else pooled.reshape(-1, group_size, d)
            pooled = self.att_cross(seq).reshape(pooled.shape)
        pooled = pooled.float()
        out = {
            name: F.linear(pooled, head.weight.float(), head.bias.float())
            for name, head in self.heads.items()
        }
        if pooled.shape[0] != n:
            # this rank's hypotheses back out of the gathered set
            rank = dist.get_rank(gather)
            out = {name: v[rank * n:(rank + 1) * n] for name, v in out.items()}
        return out


    def cast_matmul_weights(self, dtype: torch.dtype) -> "_Backbone":
        """Cast the conv and projection weights and biases (not LayerNorm,
        heads or the position table) to the compute dtype, once."""
        for module in self.modules():
            if isinstance(module, (Conv, Linear)) and not any(
                module is head for head in self.heads.values()
            ):
                module.weight.data = module.weight.data.to(dtype)
                module.bias.data = module.bias.data.to(dtype)
        return self


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on each rank of ``group`` -> (n * world, ...) on every rank,
    in rank order (JAX's ``all_gather(..., tiled=True)``): one
    ``torch.distributed.all_gather``, in its list form, which NCCL and gloo
    take on CUDA and CPU tensors alike."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def init_net(kind: str, cfg: NetConfig = NetConfig(), seed: int = 0) -> _Backbone:
    """A RefineNet ("refiner") or ScoreNet ("scorer") with random weights
    drawn from ``torch.Generator().manual_seed(seed)``: He-normal convs,
    N(0, 1/din) linears, zero biases. Stands in for trained weights where
    only the shapes matter (tests, the smoke run's narrow dataset phase)."""
    net = {"refiner": RefineNet, "scorer": ScoreNet}[kind](cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, Conv):
                std = math.sqrt(2.0 / module.weight[0].numel())
                module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * std)
            elif isinstance(module, Linear):
                std = 1.0 / math.sqrt(module.weight.shape[1])
                module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * std)
    return net.eval()


class RefineNet(_Backbone):
    """(N,160,160,6) x2 -> {'trans': (N,3), 'rot': (N,3)} raw outputs; the
    tanh * 0.349 rot normalization happens in the pose composition."""

    head_dims = REFINER_HEADS


class ScoreNet(_Backbone):
    """(N,160,160,6) x2 -> {'scores': (N,1)} logits (MultiPair when
    cfg.cross_attention)."""

    head_dims = SCORER_HEADS


def count_params(net: nn.Module) -> int:
    """Number of parameter values in ``net`` (the position table included,
    as in the JAX parameter tree)."""
    return sum(p.numel() for p in net.parameters())


def flops_per_pair(cfg: NetConfig = NetConfig()) -> int:
    """Multiply-accumulates per hypothesis pair of the backbone: the two
    siamese encodes, the joint encode and the encoder layers (the JAX
    package's ``flops_per_pair``, which the bench reports beside its times)."""
    s1 = cfg.crop_hw // 2  # after conv0
    s2 = cfg.crop_hw // 4  # after conv1 / res
    s3 = cfg.crop_hw // 8  # after the encodeAB conv
    c1, c2, d = cfg.width1, cfg.width2, cfg.embed_dim
    t = cfg.num_tokens
    enc_a = (s1 * s1 * c1 * 49 * cfg.in_channels + s2 * s2 * c2 * 9 * c1
             + 2 * s2 * s2 * c2 * 9 * c2) * 2  # two crops
    enc_ab = (2 * s2 * s2 * (2 * c2) * 9 * (2 * c2) + s3 * s3 * d * 9 * (2 * c2)
              + 2 * s3 * s3 * d * 9 * d)
    xf = cfg.num_encoder_layers * (4 * t * d * d + 2 * t * t * d + 2 * t * d * cfg.ffn_dim)
    return enc_a + enc_ab + xf
