"""The grid-overhead probe: a kernel whose blocks only store their tile.

Counterpart of the Pallas kernel of the JAX package's
``tools/probe_grid_overhead.py`` (its body at :45-54, ``pallas_call`` at
:62), which splits the renderer's per-cell cost from its per-lane cost. Every
cell (view, row, column) of a (n_views, n_rows, n_tx) grid stores one
(8, lanes) f32 tile: the lane coordinates fx, fy, their product and sum and
four more fx, each plus the f32 sum of an int32 scratch whose row 0 is
0x7F000000 and row 1 is 0. The two shapes of the tool store the same bytes
in many narrow or in few wide blocks: ``NARROW`` (6300 cells of 1024 lanes)
and ``WIDE`` (1260 of 5120).

``probe_grid`` launches ``csrc/probe_grid.cu`` on the card (one block a
cell) and runs ``probe_grid_plain`` for the CPU; the two are equal bit for
bit (the scratch sum is exact in f32 in any order).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build

# (n_views, n_rows, n_tx, lanes) of the tool's two shapes
NARROW = (252, 5, 5, 1024)
WIDE = (252, 5, 1, 5120)
MAX_LANES = 7260  # 8 x lanes int32 of scratch + 128 B of warp sums within 227 KB a block
SCRATCH_ROW0 = 0x7F000000


def probe_tile(lanes: int, device="cpu") -> torch.Tensor:
    """The (8, lanes) f32 tile every cell stores, computed as the TPU kernel
    computes it (lane iota, f32 coordinates, the scratch rows summed) on the
    CPU, where a division by 160 is a true division (PyTorch on the card
    multiplies by the reciprocal), then moved to ``device``."""
    lane = torch.arange(lanes, dtype=torch.int32)[None]
    fy = (2.0 * (lane // 32).to(torch.float32) + 1.0) / 160.0
    fx = (2.0 * (lane % 32).to(torch.float32) + 1.0) / 160.0
    scratch = torch.stack([torch.full((lanes,), SCRATCH_ROW0, dtype=torch.int32),
                           torch.zeros((lanes,), dtype=torch.int32)])
    acc = torch.cat([fx, fy, fx * fy, fx + fy] + [fx] * 4, dim=0)
    return (acc + scratch.to(torch.float32).sum()).to(device)


def probe_grid_plain(n_views: int, n_rows: int, n_tx: int, lanes: int, device="cpu") -> torch.Tensor:
    """(n_views, n_rows, n_tx, 8, lanes) f32: the tile in every cell."""
    tile = probe_tile(lanes, device)
    return tile.expand(n_views, n_rows, n_tx, 8, lanes).contiguous()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("probe_grid")
    lib.fp_probe_grid.restype = ctypes.c_int
    lib.fp_probe_grid.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


@cuda_build.counted
def probe_grid(n_views: int, n_rows: int, n_tx: int, lanes: int, device="cuda") -> torch.Tensor:
    """The probe's output, (n_views, n_rows, n_tx, 8, lanes) f32.

    ``device`` "cpu" runs the plain version. A CUDA device launches the
    kernel, one block of 1024 threads a cell with 8 x lanes int32 of dynamic
    shared memory, and raises on a grid or a width it does not take."""
    device = torch.device(device)
    if device.type == "cpu":
        return probe_grid_plain(n_views, n_rows, n_tx, lanes, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not (1 <= lanes <= MAX_LANES):
        raise ValueError(f"probe_grid: lanes must be in 1..{MAX_LANES}, got {lanes}")
    if not (1 <= n_views <= 65535 and 1 <= n_rows <= 65535 and n_tx >= 1):
        raise ValueError(f"probe_grid: bad grid ({n_views}, {n_rows}, {n_tx})")
    out = torch.empty((n_views, n_rows, n_tx, 8, lanes), dtype=torch.float32, device=device)
    fn = _library().fp_probe_grid
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(out.data_ptr(), n_views, n_rows, n_tx, lanes, stream)
    cuda_build.check(err, "probe_grid")
    probe_grid.launches += 1
    return out
