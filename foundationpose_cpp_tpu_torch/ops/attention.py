"""Multi-head attention cores: straight off the packed qkv projection, and on
head-split q, k, v.

Replaces the Pallas kernels ``_kernel_packed`` / ``mha_packed_qkv`` and
``_kernel`` / ``mha_whole_head`` of
``foundationpose_cpp_tpu/ops/attention_pallas.py`` with the hand-written
CUDA kernel ``csrc/attention.cu`` on the card (one kernel body, two
layouts); ``mha_packed_qkv_plain`` and ``mha_whole_head_plain`` are their
plain PyTorch versions, which the wrappers use for CPU tensors only.

Numerics (those of the Pallas kernels): q is scaled in f32 and cast back to
the input dtype; logits accumulate in f32; the softmax is exact over the
whole row (max-subtract, exp, multiply by 1/sum); the probabilities are cast
to the input dtype before P.v, which accumulates in f32. In the packed
layout head j of each of q, k, v is the column slice [j*hd, (j+1)*hd) of its
D-wide third of the (B, T, 3D) projection, and the output is (B, T, D),
heads concatenated; the head-split layout is (B, H, T, hd) in and out.
"""

from __future__ import annotations

import ctypes
import math

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build

# the kernel keeps one block's f32 logits for all keys in shared memory
MAX_TOKENS = 1024
HEAD_DIMS = tuple(range(16, 129, 16))
DTYPES = (torch.bfloat16, torch.float32)


def _core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax((q * scale) k^T) v on (B, H, T, hd), the kernels' numerics."""
    dtype = q.dtype
    qf = (q.float() * scale).to(dtype).float()
    logits = torch.matmul(qf, k.float().transpose(-1, -2))  # (B, H, T, T) f32
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    attn = (e * (1.0 / s)).to(dtype).float()
    return torch.matmul(attn, v.float()).to(dtype)


def mha_packed_qkv_plain(
    qkv: torch.Tensor, num_heads: int, scale: float | None = None
) -> torch.Tensor:
    """The plain PyTorch version of ``mha_packed_qkv``: any device and dtype."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q, k, v = qkv.reshape(b, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (B, H, T, hd) each
    return _core_plain(q, k, v, scale).permute(0, 2, 1, 3).reshape(b, t, d)


def mha_whole_head_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """The plain PyTorch version of ``mha_whole_head``: any device and dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _core_plain(q, k, v, scale)


def _check_kernel_input(t: torch.Tensor, tokens: int, hd: int, batch: int, what: str) -> None:
    if t.dtype not in DTYPES:
        raise ValueError(f"{what}: the attention kernel takes bf16 or f32, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: the attention kernel takes contiguous, 16-byte aligned input")
    if not 1 <= tokens <= MAX_TOKENS:
        raise ValueError(f"{what}: the attention kernel takes 1..{MAX_TOKENS} tokens, got {tokens}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: the attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if batch > 65535:
        raise ValueError(f"{what}: the attention kernel takes at most 65535 batch rows, got {batch}")


def mha_packed_qkv(
    qkv: torch.Tensor, num_heads: int, scale: float | None = None
) -> torch.Tensor:
    """Attention core of one encoder layer: (B, T, 3D) -> (B, T, D).

    A CPU tensor goes through the plain version. A CUDA tensor launches the
    kernel, which takes contiguous bf16 or f32 input with T <= 1024 and a
    head width in HEAD_DIMS, and raises on anything else.
    """
    b, t, d3 = qkv.shape
    if d3 % (3 * num_heads):
        raise ValueError(f"qkv width {d3} is not 3 * heads * head_dim")
    d = d3 // 3
    hd = d // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if qkv.device.type == "cpu":
        return mha_packed_qkv_plain(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_kernel_input(qkv, t, hd, b, "mha_packed_qkv")
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    fn = cuda_build.load("attention").fp_mha_packed_qkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), b, t, num_heads, hd, scale,
                 int(qkv.dtype == torch.float32), stream)
    cuda_build.check(err, "mha_packed_qkv")
    mha_packed_qkv.launches += 1
    return out


mha_packed_qkv.launches = 0


def mha_whole_head(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """softmax(q k^T * scale) v per (batch, head) on (B, H, T, hd) -> (B, H,
    T, hd) in q's dtype; scale defaults to 1/sqrt(hd).

    CPU tensors go through the plain version. CUDA tensors launch the
    kernel, which takes contiguous bf16 or f32 q, k, v of one shape and
    dtype with T <= 1024 and hd in HEAD_DIMS, and raises on anything else.
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return mha_whole_head_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"mha_whole_head: {name} must be {q.dtype} on {q.device}")
        _check_kernel_input(x, t, hd, b, "mha_whole_head")
    if h > 65535:
        raise ValueError(f"mha_whole_head: at most 65535 heads, got {h}")
    out = torch.empty_like(q)
    fn = cuda_build.load("attention").fp_mha_whole_head
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, hd, scale,
                 int(q.dtype == torch.float32), stream)
    cuda_build.check(err, "mha_whole_head")
    mha_whole_head.launches += 1
    return out


mha_whole_head.launches = 0
