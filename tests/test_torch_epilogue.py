"""The convolution epilogue's plain version (``ops/epilogue.py``) on the CPU.

``conv_epilogue_plain`` is the kernel's specification: it must equal, bit
for bit, the sequence the nets ran before it existed (``y.add_(bias)``
after the convolution, ``residual + y``, ``F.relu``) at the nets' channel
counts, in bf16, with NaN and -0.0 among the inputs. The wrapper
takes the plain version for CPU tensors, counts no launch there, and refuses
what the kernel does not take. No JAX is imported.
"""

import pytest
import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.ops import cuda_build, epilogue


def _case(c, seed, n=2, hw=5, dtype=torch.bfloat16):
    """A channels-last conv output y, its bias and a residual, with NaN and
    -0.0 planted in y, the bias and the residual, and values that round
    (a bf16 sum of two random values is rarely exact)."""
    gen = torch.Generator().manual_seed(seed)
    y = (torch.randn((n, c, hw, hw), generator=gen) * 4).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last)
    flat = y.permute(0, 2, 3, 1).view(-1)
    flat[::37] = float("nan")
    flat[5::29] = -0.0
    flat[7::31] = 0.0
    bias = (torch.randn((c,), generator=gen) * 2).to(dtype)
    bias[3::11] = -0.0
    bias[c // 2] = float("nan")
    residual = (torch.randn((n, c, hw, hw), generator=gen) * 3).to(dtype)
    residual = residual.contiguous(memory_format=torch.channels_last)
    rflat = residual.permute(0, 2, 3, 1).view(-1)
    rflat[11::41] = float("nan")
    rflat[13::43] = -0.0
    # y + bias == -residual somewhere: a -0.0 or +0.0 sum reaches the ReLU
    rflat[17::47] = -(flat[17::47] + bias.repeat(n * hw * hw)[17::47])
    return y, bias, residual


def _parent(y, bias, residual):
    """What the nets ran before the epilogue: cuDNN's conv without bias,
    then PyTorch's bias add_, then the block's residual add and ReLU."""
    y = y.add_(bias.reshape(1, -1, 1, 1))
    if residual is not None:
        y = residual + y
    return F.relu(y)


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("with_residual", [True, False])
def test_plain_epilogue_equals_the_parent_sequence_bit_for_bit(with_residual, c):
    y, bias, residual = _case(c, seed=c)
    residual = residual if with_residual else None
    want = _parent(y.clone(), bias, residual)
    got = epilogue.conv_epilogue_plain(y.clone(), bias, residual)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(want))
    assert got.isnan().any()


def test_plain_epilogue_writes_y_in_place():
    y, bias, residual = _case(64, seed=1)
    out = epilogue.conv_epilogue_plain(y, bias, residual)
    assert out is y


@pytest.mark.parametrize("with_residual", [True, False])
def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_nothing(with_residual):
    y, bias, residual = _case(128, seed=2)
    residual = residual if with_residual else None
    want = epilogue.conv_epilogue_plain(y.clone(), bias, residual)
    before = epilogue.conv_epilogue.launches
    got = epilogue.conv_epilogue(y, bias, residual)
    assert epilogue.conv_epilogue.launches == before
    assert got is y and torch.equal(_bits(got), _bits(want))
    assert cuda_build.COUNTERS["conv_epilogue"] is epilogue.conv_epilogue


def _refusals():
    y, bias, residual = _case(64, seed=3)
    odd = torch.zeros((2, 12, 5, 5), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return {
        "contiguous NCHW": (y.contiguous(), bias, None, "channels-last"),
        "float32": (y.float(), bias.float(), None, "bf16"),
        "float16": (y.half(), bias.half(), None, "bf16"),
        "C not a multiple of 8": (odd, torch.zeros(12, dtype=torch.bfloat16), None,
                                  "multiple of 8"),
        "bias dtype": (y, bias.half(), None, "bias"),
        "bias shape": (y, bias[:32], None, "bias"),
        "residual dtype": (y, bias, residual.half(), "residual"),
        "residual shape": (y, bias, residual[:1], "residual"),
        "residual strides": (y, bias, residual.contiguous(), "residual"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    y, bias, residual, match = _refusals()[name]
    with pytest.raises(ValueError, match=match):
        epilogue.conv_epilogue(y, bias, residual)
