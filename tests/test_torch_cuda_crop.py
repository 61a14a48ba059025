"""The observed-crop kernel (``csrc/crop.cu``) against its plain version, on
the card.

These need a CUDA card and skip without one; no JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_crop.py -q

Tolerance: none. The kernel repeats the plain composition's f32 operations
in its order, without FMA contraction, and divides by a number as PyTorch on
the card does (a product with its reciprocal, taken in double and rounded to
f32; a true division by a tensor), so it is held bit for bit, NaN included.
"""

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.ops import crop
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants, render_and_transform
from foundationpose_cpp_tpu_torch.meshio import procedural

from .test_torch_cuda_kernels import _house_model

H, W = 480, 640
K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
CH = CW = 160
MIN_DEPTH, MAX_DEPTH = 0.45, 2.5  # both cut: holes, near points, far points
EXACT = dict(rtol=0, atol=0, equal_nan=True)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frame(card, h=H, w=W, seed=0):
    """A random u8 frame and the xyz map of a tilted, noisy depth with holes
    and a far patch, on the card."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 0.4 + 0.0004 * xs + 0.0002 * ys + 0.05 * rng.random((h, w))
    depth[rng.random((h, w)) < 0.1] = 0.0
    depth[: h // 6, : w // 6] = 3.0
    xyz = depth_ops.depth_to_xyz(torch.from_numpy(depth.astype(np.float32)).to(card),
                                 torch.from_numpy(K).to(card), 0.001)
    return torch.from_numpy(rgb).to(card), xyz


def _affines(n, seed, h=H, w=W):
    """Crop affines whose windows cross every border of the frame (centres
    from 80 pixels outside it, scales 0.2-2): M maps the frame into the
    crop."""
    rng = np.random.default_rng(seed)
    tfs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        sx = rng.uniform(0.2, 2.0)
        sy = sx * rng.uniform(0.7, 1.3)
        cx, cy = rng.uniform(-80, w + 80), rng.uniform(-80, h + 80)
        tfs[i] = [[sx, 0, CW / 2 - sx * cx], [0, sy, CH / 2 - sy * cy], [0, 0, 1]]
    return torch.from_numpy(tfs)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = rng.uniform([-0.2, -0.15, 0.4], [0.2, 0.15, 0.8], (n, 3))
    return torch.from_numpy(poses)


@pytest.mark.parametrize("downscale", ["number", "per_view"])
@pytest.mark.parametrize("n", [1, 8, 252])
def test_crop_kernel_equals_plain(card, n, downscale):
    """Affines across every border, a NaN affine (n > 1), min and max depth
    both cutting, a number's reciprocal or distinct per-view downscales:
    bit for bit, one launch."""
    rgb, xyz = _frame(card, seed=n)
    tfs, poses = _affines(n, seed=n + 1), _poses(n, seed=n + 2)
    if n > 1:
        tfs[n // 2] = float("nan")
    tfs, poses = tfs.to(card), poses.to(card)
    ds = 0.0683 if downscale == "number" else torch.linspace(0.031, 0.131, n, device=card)
    before = crop.crop_observed.launches
    got = crop.crop_observed(rgb, xyz, tfs, poses, ds, CH, CW, MIN_DEPTH, MAX_DEPTH)
    assert crop.crop_observed.launches == before + 1
    want = crop.crop_observed_plain(rgb, xyz, tfs, poses, ds, CH, CW, MIN_DEPTH, MAX_DEPTH)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **EXACT)
    kept = (got[..., 3:] != 0).any(-1)
    assert kept.any() and not kept.all()
    if n > 1:
        assert torch.isnan(got[n // 2, ..., :3]).all()
        assert not torch.isnan(got[n // 2, ..., 3:]).any()


def test_crop_kernel_on_a_padded_frame_equals_the_unpadded_extent(card):
    """A 448x608 frame zero-padded into a 480x640 bucket gives the crops of
    the unpadded frame: the padding reads as the zero border."""
    rgb, xyz = _frame(card, 448, 608, seed=5)
    pad_rgb = torch.zeros((H, W, 3), dtype=torch.uint8, device=card)
    pad_xyz = torch.zeros((H, W, 3), dtype=torch.float32, device=card)
    pad_rgb[:448, :608], pad_xyz[:448, :608] = rgb, xyz
    tfs, poses = _affines(16, 6, 448, 608).to(card), _poses(16, 7).to(card)
    args = (tfs, poses, 0.0611, CH, CW, MIN_DEPTH, MAX_DEPTH)
    got = crop.crop_observed(pad_rgb, pad_xyz, *args)
    torch.testing.assert_close(got, crop.crop_observed(rgb, xyz, *args), **EXACT)
    torch.testing.assert_close(got, crop.crop_observed_plain(pad_rgb, pad_xyz, *args), **EXACT)


def test_render_and_transform_crops_with_a_pose_at_z0(card):
    """render_and_transform on the card (one crop launch a call) against the
    plain composition on the same crop affines; a pose at z = 0 (a failed
    translation guess) gives NaN colour and zero xyz there."""
    mesh = MeshConstants.from_asset(procedural.textured_house(name="house"), card)
    cfg = FoundationPoseConfig()
    rgb, xyz = _frame(card, seed=8)
    poses = _poses(8, 9).to(card)
    poses[3, :3, 3] = 0.0
    Kt = torch.from_numpy(K).to(card)
    before = crop.crop_observed.launches
    got = render_and_transform(mesh, poses, rgb, xyz, Kt, cfg.refine_crop_ratio, cfg)[1]
    assert crop.crop_observed.launches == before + 1
    tfs = transforms.compute_crop_window_tf(poses, Kt, (CH, CW), cfg.refine_crop_ratio,
                                            mesh.diameter)
    want = crop.crop_observed_plain(rgb, xyz, tfs, poses, mesh.diameter / 2.0, CH, CW,
                                    cfg.min_depth, cfg.max_depth)
    torch.testing.assert_close(got, want, **EXACT)
    assert torch.isnan(got[3, ..., :3]).all() and float(got[3, ..., 3:].abs().max()) == 0.0


def test_crop_launches_a_replay(card):
    """A Register replay counts 2 crop launches, a Track or track_batch
    replay 1, as each program's launches_per_call says."""
    model, gt, rgb, depth, mask = _house_model(card)
    poses = np.stack([gt, gt])
    model.register(rgb, depth, mask, "house")
    model.track(rgb, depth, gt, "house")
    model.track_batch(rgb, depth, poses, "house")
    calls = [
        (model.register, (rgb, depth, mask, "house"),
         model._register_cache[("register", "house", (480, 640), 1, False)], 2),
        (model.track, (rgb, depth, gt, "house"),
         model._track_cache[("track", "house", (480, 640), 1, False)], 1),
        (model.track_batch, (rgb, depth, poses, "house"),
         model._track_cache[("track_batch", "house", (480, 640), 1, 2, False)], 1),
    ]
    for call, args, program, want in calls:
        assert program.captured and program.launches_per_call["crop_observed"] == want
        before = crop.crop_observed.launches
        call(*args)
        assert crop.crop_observed.launches == before + want
