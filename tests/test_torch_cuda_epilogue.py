"""The convolution epilogue kernel (``csrc/epilogue.cu``) against its plain
version, and the nets' route through it, on the card.

These need a CUDA card and skip without one; no JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_epilogue.py -q

Tolerance: none. The kernel sums in f32 and rounds to 16 bits at the points
where PyTorch's bias ``add_``, residual add and ReLU do, with the same
intrinsics, so it is held bit for bit, NaN and -0.0 included; so are the
nets through it against the nets with the route forced off (the same cuDNN
convolutions, then PyTorch's bias add, residual add and ReLU).
"""

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import epilogue

from .test_torch_cuda_kernels import WEIGHTS, _house_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _net_shapes(n):
    """The distinct (N, C, H, W) outputs of a net's nine convs at n pairs:
    the stem (2n, 64, 80, 80); conv1 and both of the res block's convs
    (2n, 128, 40, 40); res0's two (n, 256, 40, 40); the encodeAB conv and
    res1's two (n, 512, 20, 20)."""
    return [(2 * n, 64, 80, 80), (2 * n, 128, 40, 40), (n, 256, 40, 40), (n, 512, 20, 20)]


def _case(card, shape, seed, dtype=torch.bfloat16):
    """y, bias and residual as in tests/test_torch_epilogue.py, on the card."""
    gen = torch.Generator(device=card).manual_seed(seed)
    y = (torch.randn(shape, generator=gen, device=card) * 4).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last)
    flat = y.permute(0, 2, 3, 1).view(-1)
    flat[::997] = float("nan")
    flat[5::991] = -0.0
    bias = (torch.randn((shape[1],), generator=gen, device=card) * 2).to(dtype)
    bias[3::11] = -0.0
    residual = (torch.randn(shape, generator=gen, device=card) * 3).to(dtype)
    residual = residual.contiguous(memory_format=torch.channels_last)
    rflat = residual.permute(0, 2, 3, 1).view(-1)
    rflat[11::1009] = float("nan")
    rflat[13::1013] = -0.0
    return y, bias, residual


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("n", [252, 1, 8])
@pytest.mark.parametrize("which", range(4))
def test_epilogue_kernel_equals_plain_bit_for_bit(card, which, n, with_residual):
    shape = _net_shapes(n)[which]
    y, bias, residual = _case(card, shape, seed=which * 1000 + n)
    residual = residual if with_residual else None
    want = epilogue.conv_epilogue_plain(y.clone(), bias, residual)
    before = epilogue.conv_epilogue.launches
    got = epilogue.conv_epilogue(y, bias, residual)
    assert epilogue.conv_epilogue.launches == before + 1
    assert got is y
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_epilogue_kernel_refuses_what_it_does_not_take(card):
    y, bias, residual = _case(card, (2, 64, 8, 8), seed=0)
    odd = torch.zeros((2, 12, 8, 8), dtype=torch.bfloat16, device=card).contiguous(
        memory_format=torch.channels_last)
    for args, match in (
        ((y.contiguous(), bias, None), "channels-last"),
        ((y, bias, residual.contiguous()), "residual"),
        ((y, bias, residual[:1]), "residual"),
        ((odd, torch.zeros(12, dtype=torch.bfloat16, device=card), None), "multiple of 8"),
        ((y, bias, y), "shares"),
        ((y.half(), bias.half(), None), "bf16"),
    ):
        with pytest.raises(ValueError, match=match):
            epilogue.conv_epilogue(*args)
    grad_bias = bias.float().requires_grad_(True).to(torch.bfloat16)
    before = epilogue.conv_epilogue.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        epilogue.conv_epilogue(y, grad_bias)
    assert epilogue.conv_epilogue.launches == before
    with torch.no_grad():
        epilogue.conv_epilogue(y, grad_bias)
    assert epilogue.conv_epilogue.launches == before + 1


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_nets_through_the_epilogue_equal_the_plain_route(card, kind, monkeypatch):
    """The trained bf16 nets at N=252 run nine epilogue launches a forward
    and give the outputs of the same nets with the route forced off, bit
    for bit."""
    net = convert_jax.as_net(str(WEIGHTS / f"{kind}_multi_full.npz"), kind, card, torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(12)
    a, b = (torch.rand((252, 160, 160, 6), generator=gen, device=card) for _ in range(2))
    with torch.inference_mode():
        before = epilogue.conv_epilogue.launches
        got = net(a, b)
        assert epilogue.conv_epilogue.launches == before + 9
        monkeypatch.setattr(networks, "fuses_epilogue", lambda x, conv: False)
        want = net(a, b)
        assert epilogue.conv_epilogue.launches == before + 9
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_epilogue_counts_on_every_replay(card):
    """The epilogue's counter reads 18 a Register replay (nine convs of the
    refiner and of the scorer) and 9 a Track or track_batch replay, as each
    program's launches_per_call says."""
    model, gt, rgb, depth, mask = _house_model(card)
    poses = np.stack([gt, gt])
    model.register(rgb, depth, mask, "house")
    model.track(rgb, depth, gt, "house")
    model.track_batch(rgb, depth, poses, "house")
    calls = [
        (model.register, (rgb, depth, mask, "house"),
         model._register_cache[("register", "house", (480, 640), 1, False)], 18),
        (model.track, (rgb, depth, gt, "house"),
         model._track_cache[("track", "house", (480, 640), 1, False)], 9),
        (model.track_batch, (rgb, depth, poses, "house"),
         model._track_cache[("track_batch", "house", (480, 640), 1, 2, False)], 9),
    ]
    for call, args, program, want in calls:
        assert program.captured and program.launches_per_call["conv_epilogue"] == want
        before = epilogue.conv_epilogue.launches
        call(*args)
        assert epilogue.conv_epilogue.launches == before + want
