"""Operations and bytes the benchmark's inputs need, and the card's peaks.

Counted from shapes and data, never from what a kernel happens to do, so a
change to a kernel cannot move the yardstick. The nets' count is the port's
``networks.flops_per_pair`` at the published widths; K1's and K2's operations
and bytes are ``chip_smoke.py``'s (its ``bound`` and ``attention_row``,
``check_render`` and ``tests_needed``).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12

RENDER_TEST_FLOPS = 20  # the mul/adds of one pixel's five planes (a0, a1, a2, z, w)


def bound_s(bytes_moved: float, flops: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(bytes_moved / PEAK_HBM_BYTES_PER_S, flops / peak_flops)


def net_macs_per_pair(crop: int = 160, in_channels: int = 6, width1: int = 64,
                      width2: int = 128, embed: int = 512, ffn: int = 512,
                      layers: int = 1) -> int:
    """Multiply-accumulates of one crop pair through the backbone: the two
    siamese encodes, the joint encode and the encoder layers."""
    s1, s2, s3 = crop // 2, crop // 4, crop // 8
    t = s3 * s3
    enc_a = (s1 * s1 * width1 * 49 * in_channels + s2 * s2 * width2 * 9 * width1
             + 2 * s2 * s2 * width2 * 9 * width2) * 2
    enc_ab = (2 * s2 * s2 * (2 * width2) * 9 * (2 * width2) + s3 * s3 * embed * 9 * (2 * width2)
              + 2 * s3 * s3 * embed * 9 * embed)
    xf = layers * (4 * t * embed * embed + 2 * t * t * embed + 2 * t * embed * ffn)
    return enc_a + enc_ab + xf


def encoder_layer_macs(tokens: int, embed: int = 512, ffn: int = 512) -> int:
    """One encoder layer over ``tokens`` positions (att_cross: the hypotheses)."""
    return 4 * tokens * embed * embed + 2 * tokens * tokens * embed + 2 * tokens * embed * ffn


def register_flops(hypotheses: int, refine_itr: int = 1, **widths) -> float:
    """The nets' operations in one Register: the refiner at every hypothesis
    per iteration, the scorer at every hypothesis, and att_cross across them."""
    pair = net_macs_per_pair(**widths)
    embed, ffn = widths.get("embed", 512), widths.get("ffn", 512)
    return 2.0 * (pair * hypotheses * (refine_itr + 1) + encoder_layer_macs(hypotheses, embed, ffn))


def track_flops(batch: int, refine_itr: int = 1, **widths) -> float:
    """The refiner's operations in one Track of ``batch`` poses."""
    return 2.0 * net_macs_per_pair(**widths) * batch * refine_itr


def attention_bound_s(batch: int, tokens: int, embed: int = 512, heads: int = 4,
                      elem_bytes: int = 2) -> float:
    """K1 on a (batch, tokens, 3 x embed) packed projection: q, k, v and the
    output read or written once, 4 T^2 hd operations a head, at bf16 peak."""
    hd = embed // heads
    bytes_moved = 4 * batch * tokens * embed * elem_bytes
    flops = 4.0 * batch * heads * tokens * tokens * hd
    return bound_s(bytes_moved, flops, PEAK_BF16_FLOPS)


def render_tests_needed(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int) -> int:
    """Face-pixel tests the data needs: each face with every w > 0 against
    the pixel centres inside its own projected box."""
    tri = clip[:, faces]  # (N, F, 3, 4)
    valid = torch.all(tri[..., 3] > 0.0, dim=-1)
    ndc = tri[..., :2] / tri[..., 3:4]
    size = torch.tensor([w, h], dtype=torch.float32, device=clip.device)
    lo = torch.ceil(((ndc.amin(dim=2) + 1.0) * size - 1.0) / 2.0).clamp(min=0.0)
    hi = torch.minimum(torch.floor(((ndc.amax(dim=2) + 1.0) * size - 1.0) / 2.0), size - 1.0)
    span = (hi - lo + 1.0).clamp(min=0.0).double().prod(dim=-1)
    return int(span[valid].sum().item())


def render_bound_s(n: int, crop: int, vertices: int, faces: int, texture_texels: int,
                   tests: int) -> float:
    """K2 rendering n views of crop x crop: the mesh (positions, normals,
    uvs, faces, face flags, texture), the poses and clip matrices read once
    and the (n, crop, crop, 6) f32 image written once; RENDER_TEST_FLOPS
    a face-pixel test at the f32 peak."""
    mesh_bytes = vertices * (3 + 3 + 2) * 4 + faces * (3 * 4 + 1) + texture_texels * 3 * 4
    bytes_moved = mesh_bytes + 2 * n * 16 * 4 + n * crop * crop * 6 * 4
    return bound_s(bytes_moved, float(tests) * RENDER_TEST_FLOPS, PEAK_F32_FLOPS)
