"""The port's symmetry sets and symmetry-aware rotation error against the JAX package's.

``geometry/symmetry.py`` is numpy on both sides, so the factories must give
the same arrays (atol 0). ``rotation_error_deg_sym`` is held on the cases of
``tests/test_geometry.py`` (a cube flip is 0 modulo the cube's group, None and
the identity set reduce to the plain error) and against the JAX function on
random poses; the cube asset keeps the same 24 symmetries now that it takes
them from ``symmetry.box()``.
"""

import numpy as np
import pytest

from foundationpose_cpp_tpu.geometry import symmetry as jsym
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.utils import metrics as jmetrics
from foundationpose_cpp_tpu_torch.geometry import symmetry as tsym
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.utils import metrics as tmetrics


@pytest.mark.parametrize("name, args", [
    ("identity", ()),
    ("axis_cyclic", (2, 6)),
    ("axis_cyclic", (0, 4)),
    ("axis_continuous", (1,)),
    ("axis_continuous", (2, 12)),
    ("box", ()),
    ("box", ((0.1, 0.1, 0.2),)),
    ("box", ((0.1, 0.2, 0.3),)),
])
def test_factories_equal_jax(name, args):
    got, want = getattr(tsym, name)(*args), getattr(jsym, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def test_rotation_error_deg_sym_cube_flip():
    """tests/test_geometry.py's case, through the port."""
    rng = np.random.default_rng(0)
    gt = np.eye(4)
    gt[:3, :3] = _random_rotation(rng)
    cube = tsym.box()
    est = gt.copy()
    est[:3, :3] = gt[:3, :3] @ cube[5][:3, :3]
    plain = tmetrics.rotation_error_deg(est, gt)
    if plain < 1.0:
        est[:3, :3] = gt[:3, :3] @ cube[10][:3, :3]
        plain = tmetrics.rotation_error_deg(est, gt)
    assert plain > 45.0
    assert tmetrics.rotation_error_deg_sym(est, gt, cube) < 1e-4
    assert tmetrics.rotation_error_deg_sym(est, gt, None) == plain
    np.testing.assert_allclose(tmetrics.rotation_error_deg_sym(est, gt, tsym.identity()),
                               plain, atol=1e-6)


@pytest.mark.parametrize("sym", ["box", "cyclic", "continuous", "none"])
def test_rotation_error_deg_sym_equals_jax(sym):
    sets = {"box": tsym.box(), "cyclic": tsym.axis_cyclic(2, 6),
            "continuous": tsym.axis_continuous(0), "none": None}
    rng = np.random.default_rng(7)
    for _ in range(20):
        gt, est = np.eye(4), np.eye(4)
        gt[:3, :3], est[:3, :3] = _random_rotation(rng), _random_rotation(rng)
        got = tmetrics.rotation_error_deg_sym(est, gt, sets[sym])
        assert got == jmetrics.rotation_error_deg_sym(est, gt, sets[sym])


def test_cube_asset_symmetries_unchanged():
    """The cube declares the same 24 rotations as the JAX cube; the
    face-coloured cube declares none."""
    got, want = tproc.textured_cube(size=0.1).symmetries, jproc.textured_cube(size=0.1).symmetries
    assert got.shape == (24, 4, 4)
    np.testing.assert_array_equal(got, want)
    assert tproc.face_colored_cube().symmetries is None
