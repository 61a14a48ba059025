"""The tile-by-tile walk of the attention kernel (``_core_blockwise_plain``,
the two passes of ``csrc/attention.cu`` written in PyTorch) against the plain
version and against the Pallas kernels in interpret mode, on the CPU.

Tolerances. Blockwise against plain in f32: 1e-5, as the card holds the f32
kernel (sums in another order). In bf16: |err| <= 2^-9 + 2^-6 |plain|, the
tolerance ``chip_smoke.py`` holds the bf16 kernel to (4 bf16 ulps at the
outputs' typical size plus 2 ulps of the value: another exp and sum order
can move a probability or an output across a bf16 rounding boundary).
Against the Pallas kernels: f32 1e-5; bf16 rtol = atol = 1.6e-2, about 2 bf16
ulps near 1, as tests/test_torch_attention.py holds the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.ops import attention_pallas
from foundationpose_cpp_tpu_torch.ops import attention

ATOL, RTOL = 2.0**-9, 2.0**-6


def _heads(shape, seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(scale=scale, size=shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _excess(got, want):
    """max |got - want| / (atol + rtol |want|) at the dtype's tolerance: above 1 fails."""
    atol, rtol = (ATOL, RTOL) if got.dtype == torch.bfloat16 else (1e-5, 1e-5)
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", list(attention.HEAD_DIMS))
def test_blockwise_matches_plain_at_every_head_width(hd, dtype):
    """T=70: one whole 64-key tile and a ragged one."""
    q, k, v = _heads((2, 3, 70, hd), hd, getattr(torch, dtype))
    scale = 1.0 / math.sqrt(hd)
    got = attention._core_blockwise_plain(q, k, v, scale, key_block=64)
    want = attention._core_plain(q, k, v, scale)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _excess(got, want) <= 1.0


@pytest.mark.parametrize("layout", ["packed", "head_split"])
@pytest.mark.parametrize("t", [1, 16, 63, 64, 65, 252, 400, 1100])
def test_blockwise_matches_plain_at_any_token_count(t, layout):
    """One key, one tile, around the tile edge, the paths' 252 and 400 tokens,
    and 1100 tokens, more than a block could keep f32 logits for in shared
    memory; bf16."""
    b, h, hd = 2, 2, 32
    scale = 1.0 / math.sqrt(hd)
    if layout == "packed":
        rng = np.random.default_rng(t)
        qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * hd)).astype(np.float32)).bfloat16()
        q, k, v = qkv.reshape(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        got = attention._core_blockwise_plain(q, k, v, scale).permute(0, 2, 1, 3).reshape(b, t, h * hd)
        want = attention.mha_packed_qkv(qkv, h)  # the CPU route: the plain version
    else:
        q, k, v = _heads((b, h, t, hd), t, torch.bfloat16)
        got = attention._core_blockwise_plain(q, k, v, scale)
        want = attention.mha_whole_head(q, k, v)
    assert torch.isfinite(got.float()).all()
    assert _excess(got, want) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "head_split"])
def test_blockwise_matches_pallas_interpret(layout, dtype):
    # the packed Pallas kernel takes head widths that are multiples of 128
    b, t, h, hd = 2, 70, 2, (128 if layout == "packed" else 64)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    scale = 1.0 / math.sqrt(hd)
    rng = np.random.default_rng(7)
    if layout == "packed":
        qkv = rng.normal(scale=1.5, size=(b, t, 3 * h * hd)).astype(np.float32)
        want = np.asarray(attention_pallas.mha_packed_qkv(
            jnp.asarray(qkv).astype(dtype), h, interpret=True).astype(jnp.float32))
        q, k, v = torch.from_numpy(qkv).to(getattr(torch, dtype)).reshape(
            b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        got = attention._core_blockwise_plain(q, k, v, scale).permute(0, 2, 1, 3).reshape(b, t, h * hd)
    else:
        qkv = [rng.normal(scale=1.5, size=(b, h, t, hd)).astype(np.float32) for _ in range(3)]
        want = np.asarray(attention_pallas.mha_whole_head(
            *(jnp.asarray(a).astype(dtype) for a in qkv), interpret=True).astype(jnp.float32))
        got = attention._core_blockwise_plain(
            *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv), scale)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _single_pass(q, k, v, scale, key_block=64):
    """FlashAttention's order on (B, H, T, hd), T a multiple of key_block or
    below it: one walk over the keys, the unnormalised exp(s - m) rounded to
    the input dtype, the accumulator rescaled as m moves, the division by the
    sum last."""
    dtype = q.dtype
    qf = (q.float() * scale).to(dtype).float()
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for j in range(0, q.shape[-2], key_block):
        s = torch.matmul(qf, k[..., j:j + key_block, :].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha, e = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(e.to(dtype).float(), v[..., j:j + key_block, :].float())
        m = m_new
    return (acc * (1.0 / l)).to(dtype)


def test_single_pass_order_misses_the_tolerance_on_short_rows():
    """Why the bf16 kernel walks the keys twice. Rounding the unnormalised
    exp(s - m) to bf16 and dividing by the sum at the end is outside the
    kernel's tolerance against the plain version at the narrow net's shape
    (T=16, hd=16: large outputs, few terms to average the rounding over);
    normalising before rounding, which needs the max and the sum before the
    P.v pass, stays inside."""
    q, k, v = _heads((252, 4, 16, 16), 0, torch.bfloat16)
    want = attention._core_plain(q, k, v, 0.25)
    two_pass = attention._core_blockwise_plain(q, k, v, 0.25)
    single = _single_pass(q, k, v, 0.25)
    assert _excess(two_pass, want) <= 1.0
    assert _excess(single, want) > 1.0
    # in f32 nothing is rounded between the steps and either order agrees
    qf, kf, vf = q.float(), k.float(), v.float()
    assert _excess(_single_pass(qf, kf, vf, 0.25), attention._core_plain(qf, kf, vf, 0.25)) <= 1.0
    # and with more keys to average over, the single pass is inside in bf16 too
    q, k, v = _heads((4, 4, 384, 128), 1, torch.bfloat16)
    scale = 1.0 / math.sqrt(128)
    assert _excess(_single_pass(q, k, v, scale), attention._core_plain(q, k, v, scale)) <= 1.0


def test_key_block_does_not_change_the_result_in_f32():
    q, k, v = _heads((1, 2, 100, 16), 5, torch.float32)
    want = attention._core_plain(q, k, v, 0.25)
    for key_block in (8, 32, 64, 128):
        got = attention._core_blockwise_plain(q, k, v, 0.25, key_block=key_block)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_padding_keys_get_no_weight_and_padded_values_are_zero():
    """v = 1 everywhere: every output is 1 only if the -inf logits of the
    padding take no probability; a NaN in the padding would spread."""
    q, k, _ = _heads((1, 1, 70, 16), 6, torch.float32)
    out = attention._core_blockwise_plain(q, k, torch.ones(1, 1, 70, 16), 0.25)
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-6, atol=0)


def test_cpu_route_takes_more_than_1024_tokens():
    qkv = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 1500, 3 * 16)).astype(np.float32))
    before = attention.mha_packed_qkv.launches
    out = attention.mha_packed_qkv(qkv, 1)
    assert attention.mha_packed_qkv.launches == before  # no kernel on the CPU
    assert out.shape == (1, 1500, 16) and torch.isfinite(out).all()
    q, k, v = qkv.reshape(1, 1500, 3, 1, 16).permute(2, 0, 3, 1, 4)
    split = attention.mha_whole_head(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(split[:, 0], out, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["fp16", "head_dim_24", "head_dim_144", "offset_by_8_bytes",
                                  "not_contiguous", "no_tokens"])
def test_kernel_input_check_rejects(case):
    """What a CUDA tensor must satisfy before the kernel is launched."""
    good = torch.zeros((2, 1500, 3 * 64), dtype=torch.bfloat16)
    attention._check_kernel_input(good, 1500, 64, 2, "test")  # any T >= 1 passes
    t, tokens, hd, match = good, 1500, 64, None
    if case == "fp16":
        t, match = good.to(torch.float16), "bf16 or f32"
    elif case == "head_dim_24":
        hd, match = 24, "head_dim"
    elif case == "head_dim_144":
        hd, match = 144, "head_dim"
    elif case == "offset_by_8_bytes":
        t, match = torch.zeros(2 * 1500 * 192 + 4, dtype=torch.bfloat16)[4:].reshape(2, 1500, 192), "aligned"
        assert t.is_contiguous() and t.data_ptr() % 16 == 8
    elif case == "not_contiguous":
        t, match = good[:, ::2], "contiguous"
    else:
        tokens, match = 0, "at least 1 token"
    with pytest.raises(ValueError, match=match):
        attention._check_kernel_input(t, tokens, hd, 2, "test")


def test_kernel_shared_memory_fits_two_blocks_an_sm():
    """The ring and the q tile of every head width leave room for two blocks
    in an SM's 227 KB, in bf16 (one and two warpgroups) and in f32."""
    for hd in attention.HEAD_DIMS:
        for dtype, warpgroups in ((torch.bfloat16, 1), (torch.bfloat16, 2), (torch.float32, 1)):
            assert 2 * (attention.kernel_shared_bytes(hd, dtype, warpgroups) + 1024) <= 232448
    assert attention.kernel_shared_bytes(128, torch.bfloat16, 2) == 98304 + 32
