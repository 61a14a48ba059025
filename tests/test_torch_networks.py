"""The port's RefineNet / ScoreNet against the JAX package's networks on the CPU.

Small width (width1 8, width2 16, embed 64, 4 heads, crop 32) in f32 with the
JAX attention on its XLA path, so its logits stay f32: rtol 1e-4, atol 1e-5,
the tolerance of the JAX suite's torch oracle (tests/test_convert.py:93-117).
Full width with the trained npz weights cast to f32, on N=4 pairs: rtol 1e-3,
atol 1e-4 (five more layers of 512-wide f32 sums in another order). Both
weight routes (JAX tree -> params_from_jax, npz -> load_npz) give identical
tensors. The stem's padded route, forced on the CPU in f32, gives the direct
conv's outputs and gradients within 1e-5, and is not taken on the CPU. The
convolution epilogue's route (``networks.conv_act``) is taken only on the
card in bf16 with nothing for autograd to record; forced on the CPU in
bf16, it gives the direct forward bit for bit.
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.models import checkpoint as jckpt
from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import epilogue

WDIR = pathlib.Path(__file__).resolve().parents[1] / "weights"
SMALL = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _inputs(n, crop, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, size=(n, crop, crop, 6)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, size=(n, crop, crop, 6)).astype(np.float32)
    return a, b


def _compare(kind, jparams, jcfg, n, seed, rtol, atol):
    net = convert_jax.build_net(
        {k: v.float() for k, v in convert_jax.params_from_jax(_np_tree(jparams)).items()},
        kind, num_heads=jcfg.num_heads,
    )
    a, b = _inputs(n, jcfg.crop_hw, seed)
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))
    apply = jnet.apply_refiner if kind == "refiner" else jnet.apply_scorer
    want = apply(jparams, jnp.asarray(a), jnp.asarray(b), jcfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=rtol, atol=atol)


def test_small_refiner_matches_jax():
    _compare("refiner", jnet.init_refiner(0, SMALL), SMALL, 5, 0, 1e-4, 1e-5)


def test_small_scorer_with_cross_attention_matches_jax():
    import dataclasses

    cfg = dataclasses.replace(SMALL, cross_attention=True)
    params = jnet.init_scorer(1, cfg)
    assert "att_cross" in params
    _compare("scorer", params, cfg, 6, 1, 1e-4, 1e-5)


def _full(kind):
    path = WDIR / f"{kind}_multi_full.npz"
    params = jax.tree.map(lambda x: x.astype(jnp.float32), jckpt.load_params(str(path)))
    return params


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_full_width_trained_weights_match_jax(kind):
    params = _full(kind)
    cfg = jnet.NetConfig(dtype=jnp.float32, attn_impl="xla", cross_attention=kind == "scorer")
    _compare(kind, params, cfg, 4, 2, 1e-3, 1e-4)


@pytest.mark.parametrize("kind,count", [("refiner", 35), ("scorer", 45)])
def test_both_weight_routes_identical(kind, count):
    path = str(WDIR / f"{kind}_multi_full.npz")
    via_jax = convert_jax.params_from_jax(_np_tree(jckpt.load_params(path)))
    via_npz = convert_jax.load_npz(path)
    assert len(via_npz) == count
    assert via_jax.keys() == via_npz.keys()
    for k in via_npz:
        assert via_jax[k].dtype == via_npz[k].dtype, k
        assert torch.equal(via_jax[k], via_npz[k]), k
    net = convert_jax.build_net(via_npz, kind)
    assert net.cfg.embed_dim == 512 and net.cfg.crop_hw == 160
    assert net.cfg.cross_attention == (kind == "scorer")
    assert net.encodeA["conv0"].weight.dtype == torch.bfloat16


# The stem's padded route (``networks.padded_stem``): on the card it runs
# the 6-channel stem as a 16-channel conv; here it is forced in f32, where it
# must give the direct conv's sums.

def _stem_case(seed, n=3, crop=32, cout=16):
    """A stem conv and its inputs, the bias shifted so that every sum is at
    least 1: the stem's ReLU is then the identity, and every output and
    gradient of the padded route is compared."""
    gen = torch.Generator().manual_seed(seed)
    conv = networks.Conv(6, cout, 7, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(torch.randn(cout, generator=gen))
    a = torch.rand((n, crop, crop, 6), generator=gen)
    b = torch.rand((n, crop, crop, 6), generator=gen)
    with torch.no_grad():
        conv.bias += 1.0 - conv(torch.cat([a, b], dim=0).permute(0, 3, 1, 2)).amin()
    return conv, a, b


def _direct_stem(conv, a, b):
    """The stem conv and its ReLU, as ``_Backbone.forward`` ran them before
    the stem routes took the ReLU in."""
    return torch.relu(conv(torch.cat([a, b], dim=0).permute(0, 3, 1, 2)))


@pytest.mark.parametrize("seed,n,crop", [(0, 3, 32), (1, 1, 160), (2, 4, 24)])
def test_padded_stem_equals_the_direct_conv(seed, n, crop):
    conv, a, b = _stem_case(seed, n, crop)
    before = networks.padded_stem.launches
    with torch.no_grad():
        got = networks.padded_stem(conv, a, b, torch.float32)
        want = _direct_stem(conv, a, b)
    assert networks.padded_stem.launches == before + 1
    assert got.shape == want.shape == (2 * n, 16, crop // 2, crop // 2)
    assert got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert want.amin() > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_padded_stem_gradients_reach_the_parameter_as_the_direct_route():
    conv, a, b = _stem_case(3)
    a.requires_grad_(True)
    probe = torch.randn((6, 16, 16, 16), generator=torch.Generator().manual_seed(4))
    grads = []
    for run in (lambda: networks.padded_stem(conv, a, b, torch.float32),
                lambda: _direct_stem(conv, a, b)):
        conv.zero_grad()
        a.grad = None
        (run() * probe).sum().backward()
        grads.append((conv.weight.grad.clone(), conv.bias.grad.clone(), a.grad.clone()))
    (w_pad, b_pad, a_pad), (w_dir, b_dir, a_dir) = grads
    assert w_pad.shape == (16, 6, 7, 7)
    torch.testing.assert_close(w_pad, w_dir, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b_pad, b_dir, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a_pad, a_dir, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_forced_padded_stem_through_a_net_equals_the_direct_forward(kind, monkeypatch):
    cfg = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                             cross_attention=kind == "scorer")
    net = networks.init_net(kind, cfg, seed=5)
    a, b = (torch.from_numpy(x) for x in _inputs(3, 32, 6))
    with torch.no_grad():
        want = net(a, b)
        monkeypatch.setattr(networks, "pads_stem", lambda x, dtype: True)
        before = networks.padded_stem.launches
        got = net(a, b)
    assert networks.padded_stem.launches == before + 1
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device,dtype,channels,padded", [
    ("cuda", torch.bfloat16, 6, True),
    ("cuda", torch.float16, 6, True),
    ("cuda", torch.bfloat16, 3, True),
    ("cuda", torch.float32, 6, False),
    ("cuda", torch.bfloat16, 8, False),
    ("cuda", torch.bfloat16, 16, False),
    ("cpu", torch.bfloat16, 6, False),
    ("cpu", torch.float32, 6, False),
])
def test_stem_route_engages_on_the_card_in_16_bit_on_unaligned_channels(
        device, dtype, channels, padded):
    crops = types.SimpleNamespace(device=torch.device(device), shape=(2, 160, 160, channels))
    assert networks.pads_stem(crops, dtype) is padded


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_route_not_taken_on_the_cpu(kind, dtype):
    cfg = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                             cross_attention=kind == "scorer")
    net = networks.init_net(kind, cfg, seed=6).cast_matmul_weights(dtype)
    a, b = (torch.from_numpy(x) for x in _inputs(2, 32, 7))
    before = networks.padded_stem.launches
    with torch.no_grad():
        out = net(a, b)
    assert networks.padded_stem.launches == before
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_state_dict_keys_and_shapes_are_the_checkpoints(kind):
    net = networks.init_net(kind, networks.NetConfig(cross_attention=kind == "scorer"))
    ckpt = convert_jax.load_npz(str(WDIR / f"{kind}_multi_full.npz"))
    state = net.state_dict()
    assert state.keys() == ckpt.keys()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ckpt.items()}
    assert state["encodeA.conv0.weight"].shape == (64, 6, 7, 7)


# The convolution epilogue's route (``networks.conv_act``): on the card in
# bf16 each conv runs without its bias and ``ops.epilogue.conv_epilogue``
# adds it, with the residual and the ReLU. Forced here in bf16, the wrapper
# runs its plain version, which must give the direct forward's bits.

def _epilogue_spy(monkeypatch):
    """Count the calls that reach ``epilogue.conv_epilogue`` from the nets."""
    calls = []
    wrapper = epilogue.conv_epilogue

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return wrapper(*args, **kwargs)
    monkeypatch.setattr(epilogue, "conv_epilogue", spy)
    return calls


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_forced_epilogue_route_through_a_net_equals_the_direct_forward(kind, monkeypatch):
    cfg = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                             cross_attention=kind == "scorer")
    net = networks.init_net(kind, cfg, seed=5).cast_matmul_weights(torch.bfloat16)
    a, b = (torch.from_numpy(x) for x in _inputs(3, 32, 6))
    calls = _epilogue_spy(monkeypatch)
    with torch.no_grad():
        want = net(a, b)
        assert calls == []
        monkeypatch.setattr(networks, "fuses_epilogue", lambda x, conv: True)
        got = net(a, b)
    # stem, conv1, two a ResBlock (three of them), the encodeAB conv
    assert [tuple(s) for s in calls] == [(6, 8, 16, 16), (6, 16, 8, 8), (6, 16, 8, 8),
                                         (6, 16, 8, 8), (3, 32, 8, 8), (3, 32, 8, 8),
                                         (3, 64, 4, 4), (3, 64, 4, 4), (3, 64, 4, 4)]
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("device,dtype,channels,grad_mode,x_grad,param_grad,fused", [
    ("cuda", torch.bfloat16, 64, False, False, True, True),
    ("cuda", torch.float16, 64, False, False, True, False),
    ("cuda", torch.bfloat16, 512, True, False, False, True),
    ("cuda", torch.bfloat16, 64, True, False, True, False),
    ("cuda", torch.bfloat16, 64, True, True, False, False),
    ("cuda", torch.bfloat16, 12, False, False, False, True),
    ("cuda", torch.float32, 64, False, False, False, False),
    ("cpu", torch.bfloat16, 64, False, False, False, False),
    ("cpu", torch.float32, 64, False, False, False, False),
])
def test_epilogue_route_engages_on_the_card_in_16_bit_without_autograd(
        device, dtype, channels, grad_mode, x_grad, param_grad, fused):
    x = types.SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=x_grad)
    conv = networks.Conv(8, channels, 3).requires_grad_(param_grad)
    with torch.set_grad_enabled(grad_mode):
        assert networks.fuses_epilogue(x, conv) is fused


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_route_not_taken_on_the_cpu(kind, dtype, monkeypatch):
    cfg = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                             cross_attention=kind == "scorer")
    net = networks.init_net(kind, cfg, seed=6).cast_matmul_weights(dtype)
    a, b = (torch.from_numpy(x) for x in _inputs(2, 32, 7))
    calls = _epilogue_spy(monkeypatch)
    with torch.no_grad():
        out = net(a, b)
    assert calls == []
    assert all(torch.isfinite(v).all() for v in out.values())
