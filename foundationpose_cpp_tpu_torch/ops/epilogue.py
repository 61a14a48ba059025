"""The epilogue of a convolution: its bias, an optional residual add and the
ReLU as one pass over the bf16 output, in place.

``conv_epilogue`` launches ``csrc/epilogue.cu`` on the card and runs
``conv_epilogue_plain`` for the CPU: the sequence PyTorch runs after a cuDNN
convolution with a bias (the convolution, then ``add_`` of the bias as
(1, C, 1, 1)), followed by the nets' ``residual + y`` and ``torch.relu``.
The kernel repeats each step's f32 sum and bf16 rounding and equals that
sequence on the card bit for bit, NaN and -0.0 included. It replaces no
Pallas kernel: XLA fuses this epilogue into the JAX package's convolutions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build

VEC = 8  # bf16 values a thread reads at once: 16 bytes
THREADS = 256  # a block, csrc/epilogue.cu's NTHREAD
BLOCKS_PER_SM = 8  # 2048 threads, an SM's most


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version, any device: the bias added to ``y`` in
    place, then ``residual + y`` into ``y``, then the ReLU in place; returns
    ``y``."""
    y.add_(bias.reshape(1, -1, 1, 1))
    if residual is not None:
        torch.add(residual, y, out=y)
    return torch.relu_(y)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, its signature set once."""
    lib = cuda_build.load("epilogue")
    lib.fp_conv_epilogue.restype = ctypes.c_int
    lib.fp_conv_epilogue.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 3 + [ctypes.c_void_p]
    )
    return lib


@functools.cache
def _blocks_cap(device: torch.device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _check(y: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take."""
    if y.dim() != 4 or y.dtype != torch.bfloat16:
        raise ValueError(f"conv_epilogue: y must be a 4-D bf16 tensor, "
                         f"got {y.dtype} {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_epilogue: y must be channels-last contiguous (an NCHW view of "
                         f"NHWC memory), got strides {y.stride()}")
    c = y.shape[1]
    if c % VEC:
        raise ValueError(f"conv_epilogue: the channel count {c} is not a multiple of {VEC}")
    if (bias.dtype != y.dtype or tuple(bias.shape) != (c,) or bias.device != y.device
            or not bias.is_contiguous()):
        raise ValueError(f"conv_epilogue: bias must be contiguous {y.dtype} ({c},) on "
                         f"{y.device}, got {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if residual is not None and (residual.dtype != y.dtype or residual.shape != y.shape
                                 or residual.stride() != y.stride()
                                 or residual.device != y.device):
        raise ValueError(f"conv_epilogue: residual must have y's dtype, shape and strides "
                         f"({y.dtype} {tuple(y.shape)} {y.stride()}), got {residual.dtype} "
                         f"{tuple(residual.shape)} {residual.stride()}")


@cuda_build.counted
def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """relu(residual + (y + bias)) written over ``y``, the residual
    optional; returns ``y``.

    y (N, C, H, W) bf16, channels-last contiguous, C a multiple of 8;
    bias (C,) and residual (y's shape, dtype and strides) on y's device. The
    wrapper raises otherwise. CPU tensors go through the plain version. CUDA
    tensors go through the kernel (one launch, no allocation), which raises
    on an input that requires a gradient under grad mode (it is
    forward-only and writes ``y`` in place), on 2^31 vectors or more, on a
    pointer that is not 16-byte aligned and on a residual that shares
    ``y``'s memory.
    """
    _check(y, bias, residual)
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, bias, residual)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    cuda_build.refuse_grad(y, bias, residual, what="conv_epilogue")
    nvec = y.numel() // VEC
    if nvec >= 2**31:
        raise ValueError(f"conv_epilogue: {nvec} vectors exceed the kernel's 32-bit index")
    if any(t is not None and t.data_ptr() % 16 for t in (y, bias, residual)):
        raise ValueError("conv_epilogue: y, bias and residual must be 16-byte aligned")
    if residual is not None and (residual.untyped_storage().data_ptr()
                                 == y.untyped_storage().data_ptr()):
        raise ValueError("conv_epilogue: the residual shares y's memory")
    if nvec == 0:
        return y
    blocks = min(-(-nvec // THREADS), _blocks_cap(y.device))
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().fp_conv_epilogue(
            y.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(),
            nvec, y.shape[1] // VEC, blocks, stream,
        )
    cuda_build.check(err, "conv_epilogue")
    conv_epilogue.launches += 1
    return y
