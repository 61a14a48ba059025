"""The refiner and the scorer (NVlabs FoundationPose RefineNet and
ScoreNetMultiPair, BatchNorm folded into the convolutions) as one plain
forward over a checkpoint's parameters, in float32.

  encodeA (both crops):  conv 7x7/2 (6->64) relu, conv 3x3/2 (64->128) relu,
                         residual block (128)
  encodeAB (concat):     residual block (256), conv 3x3/2 (256->512) relu,
                         residual block (512)
  tokens:                (crop/8)^2 positions of 512 + the position table
  encoder:               post-norm layers, 4 heads, ReLU FFN
  pool:                  mean over tokens; the scorer's att_cross layer
                         attends across the hypotheses
  heads:                 trans (3), rot (3) | scores (1)

``quant``, when given, rounds every operand of a convolution, a linear
layer and the attention's two products (the control's lower precision);
None computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in float32."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _q(quant, x):
    return x if quant is None else quant(x)


def conv(p: dict, name: str, x, stride: int, quant=None, w: str = "w", b: str = "b"):
    weight = p[f"{name}/{w}"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    k = weight.shape[-1]
    return F.conv2d(_q(quant, x), _q(quant, weight), p[f"{name}/{b}"], stride, (k - 1) // 2)


def res_block(p: dict, name: str, x, quant=None):
    h = F.relu(conv(p, name, x, 1, quant, "w1", "b1"))
    return F.relu(x + conv(p, name, h, 1, quant, "w2", "b2"))


def linear(p: dict, name: str, x, quant=None, w: str = "w", b: str = "b"):
    return F.linear(_q(quant, x), _q(quant, p[f"{name}{w}"].t()), p[f"{name}{b}"])


def encoder_layer(p: dict, name: str, x, heads: int, quant=None):
    """x = ln1(x + attn(x)); x = ln2(x + mlp2(relu(mlp1(x))))."""
    n, t, d = x.shape
    hd = d // heads
    qkv = linear(p, f"{name}/attn/", x, quant, "qkv_w", "qkv_b")
    q, k, v = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    logits = _q(quant, q) @ _q(quant, k).transpose(-1, -2) * (1.0 / math.sqrt(hd))
    att = (_q(quant, torch.softmax(logits, dim=-1)) @ _q(quant, v))
    att = att.permute(0, 2, 1, 3).reshape(n, t, d)
    x = x + linear(p, f"{name}/attn/", att, quant, "proj_w", "proj_b")
    x = F.layer_norm(x, (d,), p[f"{name}/ln1_s"], p[f"{name}/ln1_b"], 1e-5)
    h = F.relu(linear(p, f"{name}/", x, quant, "mlp_w1", "mlp_b1"))
    x = x + linear(p, f"{name}/", h, quant, "mlp_w2", "mlp_b2")
    return F.layer_norm(x, (d,), p[f"{name}/ln2_s"], p[f"{name}/ln2_b"], 1e-5)


def embed(p: dict, render_in: torch.Tensor, transf_in: torch.Tensor, heads: int = 4,
          quant=None) -> torch.Tensor:
    """(N, crop, crop, 6) NHWC pair -> (N, D) pooled embeddings."""
    n = render_in.shape[0]
    x = torch.cat([render_in, transf_in], dim=0).permute(0, 3, 1, 2)
    x = F.relu(conv(p, "encodeA/conv0", x, 2, quant))
    x = F.relu(conv(p, "encodeA/conv1", x, 2, quant))
    x = res_block(p, "encodeA/res", x, quant)
    x = torch.cat([x[:n], x[n:]], dim=1)
    x = res_block(p, "encodeAB/res0", x, quant)
    x = F.relu(conv(p, "encodeAB/conv", x, 2, quant))
    x = res_block(p, "encodeAB/res1", x, quant)
    d = x.shape[1]
    tokens = x.permute(0, 2, 3, 1).reshape(n, -1, d) + p["pos_embed"][None]
    i = 0
    while f"encoder/#{i}/ln1_s" in p:
        tokens = encoder_layer(p, f"encoder/#{i}", tokens, heads, quant)
        i += 1
    return tokens.mean(dim=1)


def refine(p: dict, render_in, transf_in, block: int, heads: int = 4, quant=None):
    """The refiner in blocks of ``block`` pairs -> (trans (N, 3), rot (N, 3))."""
    pooled = torch.cat([embed(p, render_in[i:i + block], transf_in[i:i + block], heads, quant)
                        for i in range(0, render_in.shape[0], block)])
    return linear(p, "head_trans/", pooled, quant), linear(p, "head_rot/", pooled, quant)


def score(p: dict, render_in, transf_in, block: int, heads: int = 4, quant=None):
    """The scorer: pooled embeddings in blocks of ``block`` pairs, then the
    att_cross layer across all of them, then the head -> (N,) logits."""
    pooled = torch.cat([embed(p, render_in[i:i + block], transf_in[i:i + block], heads, quant)
                        for i in range(0, render_in.shape[0], block)])
    if "att_cross/ln1_s" in p:
        pooled = encoder_layer(p, "att_cross", pooled[None], heads, quant)[0]
    return linear(p, "head_scores/", pooled, quant)[:, 0]
