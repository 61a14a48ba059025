"""The benchmark's operation and byte counts against hand-worked values."""

from __future__ import annotations

import pytest
import torch

from benchmark import counts


def test_net_macs_at_published_widths():
    # encodeA 2 x (80*80*64*49*6 + 40*40*128*9*64 + 2*40*40*128*9*128)
    # + encodeAB (2*40*40*256*9*256 + 20*20*512*9*256 + 2*20*20*512*9*512)
    # + encoder (4*400*512*512 + 2*400*400*512 + 2*400*512*512)
    assert counts.net_macs_per_pair() == 6_460_211_200


def test_net_macs_equal_the_programs_count():
    from foundationpose_cpp_tpu_torch.models import networks

    assert counts.net_macs_per_pair() == networks.flops_per_pair()
    narrow = networks.NetConfig(width1=8, width2=16, embed_dim=64, ffn_dim=64, crop_hw=32)
    assert counts.net_macs_per_pair(crop=32, width1=8, width2=16, embed=64, ffn=64) \
        == networks.flops_per_pair(narrow)


def test_register_and_track_flops():
    pair = 6_460_211_200
    att_cross = 4 * 252 * 512 * 512 + 2 * 252 * 252 * 512 + 2 * 252 * 512 * 512
    assert counts.register_flops(252) == 2.0 * (pair * 504 + att_cross)
    assert counts.track_flops(8) == 2.0 * pair * 8


def test_attention_bound_at_the_register_shapes():
    # q, k, v and the output: 4 x 252 x 400 x 512 bf16 = 412,876,800 bytes
    b = counts.attention_bound_s(252, 400)
    assert b == pytest.approx(412_876_800 / 3.35e12)
    # 4 x 252 x 4 x 400^2 x 128 operations take less: the bytes bound it
    assert 4.0 * 252 * 4 * 400 * 400 * 128 / 989e12 < b
    assert counts.attention_bound_s(1, 252) == pytest.approx(4 * 252 * 512 * 2 / 3.35e12)


def test_render_bound_at_the_register_shape():
    # the image: 252 x 160 x 160 x 6 f32 = 154,828,800 bytes; the scan mesh
    # (8,062 vertices of 8 floats, 13,277 faces of 13 bytes, a 512x512 RGB
    # f32 texture) and 252 poses and clip matrices
    mesh = 8062 * 32 + 13277 * 13 + 512 * 512 * 12
    want = (mesh + 2 * 252 * 64 + 154_828_800) / 3.35e12
    assert counts.render_bound_s(252, 160, 8062, 13277, 512 * 512, 0) == pytest.approx(want)
    many = 10 ** 12
    assert counts.render_bound_s(1, 160, 3, 1, 4, many) == pytest.approx(many * 20 / 67e12)


def test_render_tests_needed_counts_the_pixel_centres_in_a_box():
    # one face spanning NDC x in [-0.5, 0.5], y in [-0.5, 0.5] on 8x8 pixels:
    # centres (2i + 1) / 8 - 1 inside are i = 2..5 each way: 16 tests
    clip = torch.tensor([[[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0], [0.5, 0.5, 0.0, 1.0]]])
    assert counts.render_tests_needed(clip, torch.tensor([[0, 1, 2]]), 8, 8) == 16
    behind = clip.clone()
    behind[0, 0, 3] = -1.0
    assert counts.render_tests_needed(behind, torch.tensor([[0, 1, 2]]), 8, 8) == 0
