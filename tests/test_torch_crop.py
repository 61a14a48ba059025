"""The observed crops (``ops/crop.py``) on the CPU.

``crop_observed`` takes its plain route here, and ``render_and_transform``'s
observed crops equal the composition it replaced (``warp_crop_linear_u8``,
``warp_crop_nearest_f32``, ``threshold_and_downscale_pointcloud``,
``concat_channels``) bit for bit, NaN included: on one mesh (a number for
the diameter), on views of a ``MeshSet`` ((N,) diameters), with a pose at z = 0 and
on a frame zero-padded into a size bucket. The wrapper raises on an input
the kernel does not take, on every device. The kernel against the plain
version on the card: ``tests/test_torch_cuda_crop.py``. No JAX is imported.
"""

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.ops import crop, pointcloud, warp
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.pipeline.renderer import (
    MeshConstants,
    MeshSet,
    render_and_transform,
)

H, W = 60, 80
K = np.array([[90.0, 0.0, 40.0], [0.0, 90.0, 30.0], [0.0, 0.0, 1.0]], np.float32)
CFG = FoundationPoseConfig(crop_window_h=24, crop_window_w=20)
EXACT = dict(rtol=0, atol=0, equal_nan=True)


def _frame(h=H, w=W, seed=0):
    """A u8 frame and the xyz map of a tilted depth with holes and a far
    patch (beyond max_depth once centred and downscaled)."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 0.45 + 0.002 * xs + 0.001 * ys + 0.01 * rng.random((h, w))
    depth[rng.random((h, w)) < 0.1] = 0.0
    depth[:8, :10] = 3.0
    xyz = depth_ops.depth_to_xyz(torch.from_numpy(depth.astype(np.float32)),
                                 torch.from_numpy(K), CFG.min_depth)
    return torch.from_numpy(rgb), xyz


def _poses(n, seed=1):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(a), np.sin(a)
        poses[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i, :3, 3] = [rng.uniform(-0.12, 0.12), rng.uniform(-0.1, 0.1),
                           rng.uniform(0.4, 0.6)]
    return torch.from_numpy(poses)


def _meshes():
    return {"cube": MeshConstants.from_asset(procedural.textured_cube("cube", 0.08), "cpu"),
            "house": MeshConstants.from_asset(procedural.textured_house("house", 0.13), "cpu")}


def _replaced(mesh, poses, rgb, xyz, crop_ratio):
    """The observed branch of render_and_transform before the crop kernel."""
    ch, cw = CFG.crop_window_h, CFG.crop_window_w
    tfs = transforms.compute_crop_window_tf(poses, torch.from_numpy(K), (ch, cw), crop_ratio,
                                            mesh.diameter)
    rgb_crop = warp.warp_crop_linear_u8(rgb, tfs, ch, cw)
    xyz_crop = warp.warp_crop_nearest_f32(xyz, tfs, ch, cw)
    xyz_crop = pointcloud.threshold_and_downscale_pointcloud(
        xyz_crop, poses, mesh.diameter / 2.0, CFG.min_depth, CFG.max_depth
    )
    return pointcloud.concat_channels(rgb_crop, xyz_crop)


@pytest.mark.parametrize("case", ["mesh", "mesh_set", "nan_pose", "bucket"])
def test_render_and_transform_crops_equal_the_replaced_composition(case):
    """The observed crops bit for bit against the composition they replace,
    for both crop ratios; the crop wrapper counts no launch on the CPU."""
    meshes = _meshes()
    rgb, xyz = _frame()
    poses = _poses(5)
    mesh = meshes["cube"]
    image_hw = None
    if case == "mesh_set":
        mesh = MeshSet.build(meshes).select(("house", "cube", "house", "cube", "cube"))
    if case == "nan_pose":
        poses[2, :3, 3] = 0.0  # a failed translation guess
    if case == "bucket":
        pad_rgb = torch.zeros((H + 20, W + 16, 3), dtype=torch.uint8)
        pad_xyz = torch.zeros((H + 20, W + 16, 3), dtype=torch.float32)
        pad_rgb[:H, :W], pad_xyz[:H, :W] = rgb, xyz
        image_hw = (H, W)
    before = crop.crop_observed.launches
    for ratio in (CFG.refine_crop_ratio, CFG.score_crop_ratio):
        want = _replaced(mesh, poses, rgb, xyz, ratio)
        if case == "bucket":
            got = render_and_transform(mesh, poses, pad_rgb, pad_xyz, torch.from_numpy(K), ratio,
                                       CFG, image_hw)[1]
            torch.testing.assert_close(got, _replaced(mesh, poses, pad_rgb, pad_xyz, ratio),
                                       **EXACT)
        else:
            got = render_and_transform(mesh, poses, rgb, xyz, torch.from_numpy(K), ratio, CFG)[1]
        assert got.shape == (5, CFG.crop_window_h, CFG.crop_window_w, 6)
        # the zero padding reads as the zero border: the bucket changes nothing
        torch.testing.assert_close(got, want, **EXACT)
        assert float(got[..., 3:].abs().max()) > 0.1  # points survive the threshold
        zeros = (got[..., 3:] == 0).all(-1)
        assert zeros.any() and not zeros.all()  # the threshold cut some points, not all
    assert crop.crop_observed.launches == before
    if case == "nan_pose":
        assert torch.isnan(got[2, ..., :3]).all() and not torch.isnan(got[2, ..., 3:]).any()
        assert float(got[2, ..., 3:].abs().max()) == 0.0
        assert not torch.isnan(got[[0, 1, 3, 4]]).any()


def _affines(n, seed=2):
    """Crop affines that map the crop across every border of the frame."""
    rng = np.random.default_rng(seed)
    tfs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        scale = rng.uniform(0.3, 1.5)
        tfs[i, 0, 0], tfs[i, 1, 1] = scale, scale * rng.uniform(0.8, 1.2)
        tfs[i, 0, 2] = -scale * rng.uniform(-20, W + 10)
        tfs[i, 1, 2] = -scale * rng.uniform(-20, H + 10)
    return torch.from_numpy(tfs)


def _bad_inputs():
    rgb, xyz = _frame()
    tfs, poses = _affines(3), _poses(3)
    good = dict(rgb=rgb, xyz_map=xyz, tfs=tfs, poses=poses, downscale=0.05)
    return {
        "rgb_f32": dict(good, rgb=rgb.float()),
        "rgb_strided": dict(good, rgb=rgb.transpose(0, 1)),
        "rgb_batched": dict(good, rgb=rgb[None].expand(3, H, W, 3)),
        "xyz_f64": dict(good, xyz_map=xyz.double()),
        "xyz_strided": dict(good, xyz_map=xyz[:, ::2]),
        "tfs_strided": dict(good, tfs=tfs.transpose(1, 2)),
        "tfs_2x3": dict(good, tfs=tfs[:, :2].contiguous()),
        "poses_count": dict(good, poses=poses[:2]),
        "downscale_f64": dict(good, downscale=torch.full((3,), 0.05, dtype=torch.float64)),
        "downscale_count": dict(good, downscale=torch.full((2,), 0.05)),
    }


@pytest.mark.parametrize("bad", ["rgb_f32", "rgb_strided", "rgb_batched", "xyz_f64",
                                 "xyz_strided", "tfs_strided", "tfs_2x3", "poses_count",
                                 "downscale_f64", "downscale_count"])
def test_crop_observed_raises_on_what_the_kernel_does_not_take(bad):
    args = _bad_inputs()[bad]
    with pytest.raises(ValueError, match="crop_observed"):
        crop.crop_observed(args["rgb"], args["xyz_map"], args["tfs"], args["poses"],
                           args["downscale"], 24, 20, CFG.min_depth, CFG.max_depth)
