"""Measure the fixed cost of a block of the grid-overhead probe on the card.

    python -m foundationpose_cpp_tpu_torch.tools.probe_grid_overhead [--iters 32]
    python -m foundationpose_cpp_tpu_torch.tools.probe_grid_overhead --device cpu --iters 1

Counterpart of the JAX package's ``tools/probe_grid_overhead.py``. The
render kernels' per-region cost splits into a per-block part and a
per-pixel part; this probe runs a minimal kernel (``ops/probe_grid.py``:
lane coordinates, a scratch initialised and summed, one (8, lanes) store a
block) over the same total lanes arranged as (a) 1024-lane blocks in a
252 x 5 x 5 grid and (b) 5120-lane blocks in a 252 x 5 x 1 grid. Both store
206,438,400 bytes; what (a) costs beyond (b), over its 5040 more blocks, is
the fixed cost of a block. It is the input that decides how small the
render and raster kernels' regions may get.

Each shape is launched ``iters`` times back to back between two CUDA events
after a warm-up launch, then synchronised once. Prints the JAX tool's two
lines (ms an iteration, us a cell), then one JSON line with both shapes'
times, the us a cell and a block, and the card's name and power limit.
Without a card it raises unless ``--device cpu``, where the host clock
times the plain version.
"""

from __future__ import annotations

import argparse

from foundationpose_cpp_tpu_torch.ops import probe_grid
from foundationpose_cpp_tpu_torch.tools.profile_nets import print_line
from foundationpose_cpp_tpu_torch.utils.device import resolve_device
from foundationpose_cpp_tpu_torch.utils.profiling import stacked_ms

SHAPES = {  # the JAX tool's labels -> (n_views, n_rows, n_tx, lanes)
    "narrow (32x32 tiles)": probe_grid.NARROW,
    "wide   (32x160 tiles)": probe_grid.WIDE,
}


def run(device=None, iters: int = 32) -> dict:
    """{label: {"grid", "lanes", "cells", "ms", "us_per_cell"}} for both
    shapes and ``us_per_block``, the narrow shape's extra time over its
    extra blocks (negative if the wide shape took longer)."""
    dev = resolve_device(device)
    out = {}
    for label, (views, rows, n_tx, lanes) in SHAPES.items():
        ms = stacked_ms(lambda _: probe_grid.probe_grid(views, rows, n_tx, lanes, dev),
                        [range(iters)], dev)
        cells = views * rows * n_tx
        out[label] = {"grid": [views, rows, n_tx], "lanes": lanes, "cells": cells, "ms": ms,
                      "us_per_cell": ms * 1e3 / cells}
        print(f"{label}: grid {(views, rows, n_tx)} = {cells} cells x {lanes} lanes: "
            f"{ms:.2f} ms/iter = {ms * 1e3 / cells:.2f} us/cell")
    narrow, wide = out.values()
    out["us_per_block"] = (narrow["ms"] - wide["ms"]) * 1e3 / (narrow["cells"] - wide["cells"])
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device, args.iters)
    print_line("probe_grid_overhead", args.device, results=out, iters=args.iters)
    return out


if __name__ == "__main__":
    main()
