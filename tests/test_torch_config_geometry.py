"""The port's config, rotation grid and pose geometry against the JAX package.

Inputs are made with numpy from a seed and fed to both; the port runs on the
CPU. Grid and config must match exactly; the transforms within rtol 1e-5,
atol 1e-6 (f32 products summed in another order).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu import config as jconfig
from foundationpose_cpp_tpu.geometry import icosphere as jico
from foundationpose_cpp_tpu.geometry import transforms as jtf
from foundationpose_cpp_tpu_torch import config as tconfig
from foundationpose_cpp_tpu_torch.geometry import icosphere as tico
from foundationpose_cpp_tpu_torch.geometry import transforms as ttf

RTOL, ATOL = 1e-5, 1e-6


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _poses(n=7, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = _rotations(rng, n)
    poses[:, :3, 3] = np.stack(
        [rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.4, 0.8, n)],
        axis=-1,
    )
    return poses


K = np.array([[610.0, 0.0, 322.5], [0.0, 605.0, 238.0], [0.0, 0.0, 1.0]], np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_config_field_for_field():
    jf = [(f.name, f.type) for f in dataclasses.fields(jconfig.FoundationPoseConfig)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tconfig.FoundationPoseConfig)]
    assert jf == tf
    assert dataclasses.asdict(jconfig.DEFAULT_CONFIG) == dataclasses.asdict(tconfig.DEFAULT_CONFIG)
    assert dataclasses.asdict(jconfig.DepthFilterConfig()) == dataclasses.asdict(
        tconfig.DepthFilterConfig()
    )
    assert tconfig.DEFAULT_CONFIG.num_hypotheses == jconfig.DEFAULT_CONFIG.num_hypotheses == 252


def test_rotation_grid_exact():
    got = tico.make_rotation_grid()
    want = jico.make_rotation_grid()
    assert got.shape == (252, 4, 4)
    np.testing.assert_array_equal(got, want)


def _case(name, poses):
    """(port result, JAX result) of one transform on the same inputs."""
    tp, jp = torch.from_numpy(poses), jnp.asarray(poses)
    tK, jK = torch.from_numpy(K), jnp.asarray(K)
    rng = np.random.default_rng(3)
    n = poses.shape[0]
    if name == "projection_from_intrinsics":
        return ttf.projection_from_intrinsics(tK, 480, 640), jtf.projection_from_intrinsics(jK, 480, 640)
    if name == "compute_crop_window_tf":
        return (ttf.compute_crop_window_tf(tp, tK, (160, 160), 1.2, 0.17),
                jtf.compute_crop_window_tf(jp, jK, (160, 160), 1.2, 0.17))
    tfs = np.array(jtf.compute_crop_window_tf(jp, jK, (160, 160), 1.2, 0.17))
    if name == "invert_affine3":
        return ttf.invert_affine3(torch.from_numpy(tfs)), jtf.invert_affine3(jnp.asarray(tfs))
    if name == "construct_bbox2d":
        return (ttf.construct_bbox2d(torch.from_numpy(tfs), 160, 160),
                jtf.construct_bbox2d(jnp.asarray(tfs), 160, 160))
    bbox = np.array(jtf.construct_bbox2d(jnp.asarray(tfs), 160, 160))
    if name == "pose_clip_matrix":
        return (ttf.pose_clip_matrix(tp, torch.from_numpy(bbox), tK, 480, 640),
                jtf.pose_clip_matrix(jp, jnp.asarray(bbox), jK, 480, 640))
    pts = rng.normal(scale=0.05, size=(11, 3)).astype(np.float32)
    if name == "transform_points":
        return (ttf.transform_points(tp, torch.from_numpy(pts)),
                jtf.transform_points(jp, jnp.asarray(pts)))
    if name == "transform_points_homogeneous":
        return (ttf.transform_points_homogeneous(tp, torch.from_numpy(pts)),
                jtf.transform_points_homogeneous(jp, jnp.asarray(pts)))
    if name == "diffuse_intensity":
        nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        nrm[0] = 0.0  # zero normal -> 0
        return (ttf.diffuse_intensity(tp, torch.from_numpy(nrm)),
                jtf.diffuse_intensity(jp, jnp.asarray(nrm)))
    rv = rng.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    rv[0] = 0.0
    if name == "axis_angle_to_matrix":
        return ttf.axis_angle_to_matrix(torch.from_numpy(rv)), jtf.axis_angle_to_matrix(jnp.asarray(rv))
    if name == "matrix_to_axis_angle":
        mats = poses[:, :3, :3].copy()
        mats[1] = np.diag([1.0, -1.0, -1.0])  # exactly pi
        return ttf.matrix_to_axis_angle(torch.from_numpy(mats)), jtf.matrix_to_axis_angle(jnp.asarray(mats))
    if name == "apply_refine_delta":
        tr = rng.normal(size=(n, 3)).astype(np.float32)
        return (ttf.apply_refine_delta(tp, torch.from_numpy(tr), torch.from_numpy(rv), 0.17),
                jtf.apply_refine_delta(jp, jnp.asarray(tr), jnp.asarray(rv), 0.17))
    if name == "convert_pose_mesh2bbox":
        center = np.array([0.01, -0.02, 0.03], np.float32)
        ob = poses[2]
        return (ttf.convert_pose_mesh2bbox(tp[0], torch.from_numpy(center), torch.from_numpy(ob)),
                jtf.convert_pose_mesh2bbox(jp[0], jnp.asarray(center), jnp.asarray(ob)))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "projection_from_intrinsics", "compute_crop_window_tf", "invert_affine3",
    "construct_bbox2d", "pose_clip_matrix", "transform_points",
    "transform_points_homogeneous", "diffuse_intensity", "axis_angle_to_matrix",
    "matrix_to_axis_angle", "apply_refine_delta", "convert_pose_mesh2bbox",
])
def test_transform_matches_jax(name):
    got, want = _case(name, _poses())
    _close(got.numpy(), want)


def test_crop_window_rounds_half_away_from_zero():
    """Window bounds at an exact .5: std::round gives 39, half-to-even 38."""
    K5 = np.array([[96.0, 0.0, 50.5], [0.0, 96.0, 40.0], [0.0, 0.0, 1.0]], np.float32)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, 2, 3] = 1.0
    # r = diameter * ratio / 2 = 0.125 -> radius 12 px; left = 50.5 - 12 = 38.5
    got = ttf.compute_crop_window_tf(torch.from_numpy(pose), torch.from_numpy(K5), (160, 160), 1.0, 0.25)
    want = jtf.compute_crop_window_tf(jnp.asarray(pose), jnp.asarray(K5), (160, 160), 1.0, 0.25)
    _close(got.numpy(), want)
    sx = float(got[0, 0, 0])
    assert sx == pytest.approx(160.0 / (63.0 - 39.0))
    assert float(got[0, 0, 2]) == pytest.approx(-sx * 39.0)


def test_port_imports_no_jax():
    """No module of the port package pulls in JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys, foundationpose_cpp_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "for n in ('ops.rasterize_tiled', 'utils.png', 'utils.io', 'utils.metrics', 'utils.viz',"
        " 'demo_dataset'): assert 'foundationpose_cpp_tpu_torch.' + n in sys.modules, n\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'foundationpose_cpp_tpu.'))"
        " or m == 'foundationpose_cpp_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
