"""Multi-head attention cores: straight off the packed qkv projection, and on
head-split q, k, v.

Replaces the Pallas kernels ``_kernel_packed`` / ``mha_packed_qkv`` and
``_kernel`` / ``mha_whole_head`` of
``foundationpose_cpp_tpu/ops/attention_pallas.py`` with the hand-written
CUDA kernel ``csrc/attention.cu`` on the card (one kernel body per dtype,
two layouts); ``mha_packed_qkv_plain`` and ``mha_whole_head_plain`` are their
plain PyTorch versions, which the wrappers use for CPU tensors only.

Numerics (those of the Pallas kernels): q is scaled in f32 and cast back to
the input dtype; logits accumulate in f32; the softmax is exact over the
whole row (max-subtract, exp, multiply by 1/sum); the probabilities are cast
to the input dtype after they are normalised and before P.v, which
accumulates in f32. In the packed layout head j of each of q, k, v is the
column slice [j*hd, (j+1)*hd) of its D-wide third of the (B, T, 3D)
projection, and the output is (B, T, D), heads concatenated; the head-split
layout is (B, H, T, hd) in and out.

The kernel's design: a warpgroup takes 64 query rows of one (batch, head),
one or two warpgroups a block, and streams the head's keys and values in
64-key tiles through a ring of shared memory that the Tensor Memory
Accelerator fills ahead of the products, in the tensor cores' swizzled
layout; it keeps nothing of size T, so any number of tokens goes through. In bf16 it walks the keys twice: pass A keeps
each row's running max and sum of exp, pass B recomputes the logits, forms
the normalised probabilities with the final max and sum, rounds them to bf16
in registers and multiplies them with v, both products as ``wgmma`` on the
tensor cores. One pass that rounds the unnormalised exp and divides at the
end (FlashAttention's order) lands outside the tolerance the kernel is held
to on short rows (T=16, hd=16), where the Pallas order, normalise and then
round, stays inside (``tests/test_torch_attention_blockwise.py`` pins it);
``_core_blockwise_plain`` walks the same two passes in PyTorch. Its
bound at the main path's shape (B=252, T=400, 4 heads of 128) is the 413 MB
it must move, 0.123 ms on an H100; computing q k^T twice costs about as much
at the card's bf16 peak. In f32, where nothing is rounded between the steps,
the kernel takes one pass with the online rescale on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build

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


def _core_blockwise_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, key_block: int = 64
) -> torch.Tensor:
    """``_core_plain`` computed the way the bf16 kernel walks it, one tile of
    ``key_block`` keys at a time on (B, H, T, hd).

    The keys are padded to whole tiles: logits of the padding are -inf and
    its v rows zero. Pass A keeps the running max m and the sum l of
    exp(s - m) per row; pass B, from the last tile back, recomputes each
    tile's logits, forms exp(s - m) * (1/l) with the final m and l, rounds it
    to the input dtype and accumulates P.v in f32.
    """
    dtype = q.dtype
    t = q.shape[-2]
    n_tiles = -(-t // key_block)
    pad = n_tiles * key_block - t
    qf = (q.float() * scale).to(dtype).float()
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))  # zero rows
    key_ok = torch.arange(n_tiles * key_block, device=q.device) < t

    def tile_logits(j):
        sl = slice(j * key_block, (j + 1) * key_block)
        s = torch.matmul(qf, kf[..., sl, :].transpose(-1, -2))
        return s.masked_fill(~key_ok[sl], float("-inf")), sl

    m = torch.full(q.shape[:-1] + (1,), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for j in range(n_tiles):
        s, _ = tile_logits(j)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(dim=-1, keepdim=True)
        m = m_new
    inv_l = 1.0 / l
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in reversed(range(n_tiles)):  # the kernel still holds the last tile's logits
        s, sl = tile_logits(j)
        p = (torch.exp(s - m) * inv_l).to(dtype).float()
        acc = acc + torch.matmul(p, vf[..., sl, :])
    return acc.to(dtype)


def kernel_shared_bytes(hd: int, dtype: torch.dtype, warpgroups: int = 1) -> int:
    """Dynamic shared memory of one block of the kernel, as ``csrc/attention.cu``
    sizes it: bf16, a ring of 4 tiles of 64 keys, the q tile of 64 rows a
    warpgroup and the ring's 4 barriers; f32, a ring of 4 tiles of 32 keys and the 64-row q tile with
    rows padded by 4 floats, and a 64 x 36 tile of probabilities."""
    if dtype == torch.bfloat16:
        return (4 * 64 + 64 * warpgroups) * hd * 2 + 4 * 8
    return ((4 * 32 + 64) * (hd + 4) + 64 * (32 + 4)) * 4


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


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its two entry points'
    signatures set once."""
    lib = cuda_build.load("attention")
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fp_mha_packed_qkv.restype = ctypes.c_int
    lib.fp_mha_packed_qkv.argtypes = [ctypes.c_void_p] * 2 + tail
    lib.fp_mha_whole_head.restype = ctypes.c_int
    lib.fp_mha_whole_head.argtypes = [ctypes.c_void_p] * 4 + tail
    return lib


def _check_kernel_input(t: torch.Tensor, tokens: int, hd: int, batch: int, what: str) -> None:
    if t.dtype not in DTYPES:
        raise ValueError(f"{what}: the attention kernel takes bf16 or f32, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: the attention kernel takes contiguous, 16-byte aligned input")
    if tokens < 1:
        raise ValueError(f"{what}: the attention kernel takes at least 1 token, got {tokens}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: the attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if batch > 65535:
        raise ValueError(f"{what}: the attention kernel takes at most 65535 batch rows, got {batch}")


@cuda_build.counted
def mha_packed_qkv(
    qkv: torch.Tensor, num_heads: int, scale: float | None = None
) -> torch.Tensor:
    """Attention core of one encoder layer: (B, T, 3D) -> (B, T, D).

    A CPU tensor goes through the plain version. A CUDA tensor launches the
    kernel, which takes contiguous, 16-byte aligned bf16 or f32 input with a
    head width in HEAD_DIMS and any T >= 1, and raises on anything else,
    and on an input that requires a gradient under grad mode (the kernel is
    forward-only).
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
    cuda_build.refuse_grad(qkv, what="mha_packed_qkv")
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    fn = _library().fp_mha_packed_qkv
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), b, t, num_heads, hd, scale,
                 int(qkv.dtype == torch.float32), stream)
    cuda_build.check(err, "mha_packed_qkv")
    mha_packed_qkv.launches += 1
    return out


@cuda_build.counted
def mha_whole_head(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """softmax(q k^T * scale) v per (batch, head) on (B, H, T, hd) -> (B, H,
    T, hd) in q's dtype; scale defaults to 1/sqrt(hd).

    CPU tensors go through the plain version. CUDA tensors launch the
    kernel, which takes contiguous bf16 or f32 q, k, v of one shape and
    dtype with hd in HEAD_DIMS and any T >= 1, and raises on anything else,
    and on an input that requires a gradient under grad mode.
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
    cuda_build.refuse_grad(q, k, v, what="mha_whole_head")
    out = torch.empty_like(q)
    fn = _library().fp_mha_whole_head
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, hd, scale,
                 int(q.dtype == torch.float32), stream)
    cuda_build.check(err, "mha_whole_head")
    mha_whole_head.launches += 1
    return out
