"""The port's head-split attention (plain version, CPU) against the Pallas
kernel ``mha_whole_head`` in interpret mode, and the narrow networks that
route to it against the JAX networks with ``attn_impl="pallas_interpret"``.

Attention: f32 within 1e-5; bf16 within rtol = atol = 1.6e-2, about 2 bf16
ulps near 1, as tests/test_torch_attention.py holds the packed kernel (exp
and the row sums run in another order). Networks at head_dim 16 in f32:
rtol 1e-4, atol 1e-5, the tolerance of the JAX suite's torch oracle
(tests/test_convert.py:93-117); the weights are carried across by
``models/convert_jax.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu.ops import attention_pallas
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.models import networks as tnet
from foundationpose_cpp_tpu_torch.ops import attention

NARROW = jnet.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                        dtype=jnp.float32, attn_impl="pallas_interpret")


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=1.5, size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4, 16, 16), (2, 3, 40, 48), (1, 2, 70, 128)])
def test_plain_matches_pallas_interpret(dtype, shape):
    q, k, v = _qkv(shape, 0)
    want = np.asarray(attention_pallas.mha_whole_head(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)), interpret=True).astype(jnp.float32))
    before = attention.mha_whole_head.launches
    got = attention.mha_whole_head(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                     for a in (q, k, v)))
    assert attention.mha_whole_head.launches == before  # no kernel on the CPU
    assert got.shape == shape and got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_packed_and_head_split_layouts_agree():
    """The same heads through both layouts: identical outputs."""
    b, t, h, hd = 2, 24, 4, 16
    qkv = torch.from_numpy(np.random.default_rng(3).normal(size=(b, t, 3 * h * hd)).astype(np.float32))
    packed = attention.mha_packed_qkv(qkv, h)
    q, k, v = qkv.reshape(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
    split = attention.mha_whole_head(q, k, v).permute(0, 2, 1, 3).reshape(b, t, h * hd)
    torch.testing.assert_close(packed, split, rtol=0, atol=0)


@pytest.mark.parametrize("hd,route", [(16, "mha_whole_head"), (128, "mha_packed_qkv")])
def test_self_attention_routes_by_head_width(monkeypatch, hd, route):
    """head_dim % 128 == 0 reads the packed projection; other widths split
    heads first, as the JAX function routes its Pallas kernels."""
    calls = []
    for name in ("mha_whole_head", "mha_packed_qkv"):
        real = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _r=real, _n=name, **kw: calls.append(_n) or _r(*a, **kw))
    layer = tnet.SelfAttention(4 * hd, 4)
    out = layer(torch.randn(2, 9, 4 * hd))
    assert calls == [route] and out.shape == (2, 9, 4 * hd)


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_narrow_nets_match_jax_pallas_interpret(kind):
    cfg = dataclasses.replace(NARROW, cross_attention=kind == "scorer")
    params = jnet.init_refiner(0, cfg) if kind == "refiner" else jnet.init_scorer(1, cfg)
    sd = convert_jax.params_from_jax(jax.tree.map(np.asarray, params))
    net = convert_jax.build_net(sd, kind)
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(size=(6, 32, 32, 6)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))
    apply = jnet.apply_refiner if kind == "refiner" else jnet.apply_scorer
    want = apply(params, jnp.asarray(a), jnp.asarray(b), cfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-5)


def test_seeded_nets_are_reproducible():
    cfg = tnet.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
    a, b = tnet.init_net("refiner", cfg, seed=0), tnet.init_net("refiner", cfg, seed=0)
    c = tnet.init_net("refiner", cfg, seed=1)
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        if name.endswith("weight") and x.dim() > 1:
            assert not torch.equal(x, z), name
