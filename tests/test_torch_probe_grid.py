"""The grid-overhead probe's plain version against the TPU kernel's arithmetic.

The JAX package's probe kernel is a closure inside ``main()`` of
``tools/probe_grid_overhead.py`` and cannot be called without editing that
file, so the reference here is a numpy transcription of its body (:45-54),
held against ``probe_grid_plain`` at a small grid of both of the tool's
tile shapes with atol 0; the shapes themselves are read from the tool's
source with ``ast``. On the CPU the wrapper runs the plain version and its
launch count stays 0; it raises on a width or a grid that the kernel does
not take before it touches a card. The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch.ops import probe_grid

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPES = {"narrow": probe_grid.NARROW, "wide": probe_grid.WIDE}


def reference_cell(lanes: int) -> np.ndarray:
    """tools/probe_grid_overhead.py:45-54 in numpy, one (8, lanes) cell."""
    lane = np.arange(lanes, dtype=np.int32)[None]
    fy = (np.float32(2.0) * (lane // 32).astype(np.float32) + np.float32(1.0)) / np.float32(160.0)
    fx = (np.float32(2.0) * (lane % 32).astype(np.float32) + np.float32(1.0)) / np.float32(160.0)
    scratch = np.empty((8, lanes), np.int32)
    scratch[0:1] = np.full((1, lanes), 0x7F000000, np.int32)
    scratch[1:2] = np.zeros((1, lanes), np.int32)
    acc = np.concatenate([fx, fy, fx * fy, fx + fy] + [fx] * 4, axis=0)
    return acc + scratch[0:2].astype(np.float32).sum(dtype=np.float32)


def jax_tool_shapes() -> list[tuple]:
    """(grid, lanes, n_tx) of each ``make(lanes, n_tx, label)`` call of the
    JAX tool, with its ``grid = (252, 5, n_tx)``."""
    tree = ast.parse((ROOT / "tools" / "probe_grid_overhead.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "make"]
    (grid,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "grid"]
    views, rows = grid.elts[0].value, grid.elts[1].value
    return [(views, rows, c.args[1].value, c.args[0].value) for c in calls]


def test_shapes_are_the_jax_tools():
    assert jax_tool_shapes() == [probe_grid.NARROW, probe_grid.WIDE]
    for views, rows, n_tx, lanes in SHAPES.values():
        assert views * rows * n_tx * 8 * lanes * 4 == 206_438_400


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_the_tpu_kernel_body(name):
    _, rows, n_tx, lanes = SHAPES[name]
    got = probe_grid.probe_grid_plain(3, rows - 3, n_tx, lanes, "cpu").numpy()
    want = np.broadcast_to(reference_cell(lanes), (3, rows - 3, n_tx, 8, lanes))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert probe_grid.probe_tile(lanes).dtype == torch.float32


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cpu_wrapper_runs_the_plain_version(name):
    _, rows, n_tx, lanes = SHAPES[name]
    before = probe_grid.probe_grid.launches
    got = probe_grid.probe_grid(3, 2, n_tx, lanes, "cpu")
    assert probe_grid.probe_grid.launches == before == 0
    assert torch.equal(got, probe_grid.probe_grid_plain(3, 2, n_tx, lanes))


@pytest.mark.parametrize("args", [(1, 1, 1, probe_grid.MAX_LANES + 1), (1, 1, 1, 0),
                                  (65536, 1, 1, 1024), (1, 1, 0, 1024)])
def test_wrapper_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        probe_grid.probe_grid(*args, "cuda")
    with pytest.raises(ValueError):
        probe_grid.probe_grid(1, 1, 1, 1024, "meta")
