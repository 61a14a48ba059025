"""The port's Track step and Register run no operation that reads the card
back before their one final read.

On the card each of these waits for the stream to drain: a scalar read
(``aten.item`` / ``aten._local_scalar_dense``, what indexing by a 0-d tensor
or ``float(t)`` does), a tensor built from a Python list (``aten.lift_fresh``:
a copy from pageable memory, which PyTorch synchronizes), an op whose output
size depends on the data (``aten.nonzero``, ``aten.masked_select``), and
``torch.linalg.solve``, which reads its error code back (``solve_ex`` with
``check_errors=False`` does not). A ``TorchDispatchMode`` counts them on the
CPU, where the same ops are dispatched; the card-only test in
``tests/test_torch_cuda_kernels.py`` runs the same paths under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from foundationpose_cpp_tpu_torch import FoundationPoseConfig, create_foundationpose_model
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic

SYNCING = {"aten.item.default", "aten._local_scalar_dense.default", "aten.lift_fresh.default",
           "aten.nonzero.default", "aten.masked_select.default", "aten.linalg_solve.default",
           "aten.is_nonzero.default"}
H, W = 120, 160
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
CFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
NET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)


class CountSyncs(TorchDispatchMode):
    """Counts the dispatched ops of ``SYNCING`` by name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in SYNCING:
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def scene():
    house = tproc.textured_house(name="house")
    pose = synthetic.default_pose(tz=0.5)
    rgb, depth, mask = synthetic.render_scene(MeshConstants.from_asset(house, "cpu"), pose, K, H,
                                              W, CFG)
    model = create_foundationpose_model(
        networks.init_net("refiner", NET, seed=0),
        networks.init_net("scorer", dataclasses.replace(NET, cross_attention=True), seed=1),
        [house], K, H, W, config=CFG, device="cpu",
    )
    return model, pose, rgb, depth, mask


@pytest.mark.parametrize("depth_format, rgb_half", [("u16mm", False), ("f32", False),
                                                    ("u16mm", True)])
def test_packed_step_reads_nothing_back(scene, depth_format, rgb_half):
    model, pose, rgb, depth, _ = scene
    step = model.make_packed_tracker("house", (H, W), depth_format=depth_format,
                                     rgb_half=rgb_half)
    packed = torch.from_numpy(model.pack_frame(rgb, depth, depth_format, rgb_half))
    pose_t = torch.from_numpy(pose)
    step(packed, pose_t)  # first call: the constants are built once
    with CountSyncs() as mode:
        for _ in range(3):
            pose_t = step(packed, pose_t)
    assert mode.counts == {}, mode.counts
    assert torch.isfinite(pose_t).all()


def test_register_reads_nothing_back_before_its_final_read(scene):
    model, _, rgb, depth, mask = scene
    model.register(rgb, depth, mask, "house")
    frame = [torch.from_numpy(a) for a in (rgb, depth, mask)]
    with torch.inference_mode(), CountSyncs() as mode:
        best, poses, scores, ok = fpp.register_step(
            model._meshes["house"], model._refiner, model._scorer, *frame, model._rot_grid,
            model._K, 1, CFG)
    assert mode.counts == {}, mode.counts
    with CountSyncs() as mode:
        got = model.register(rgb, depth, mask, "house")  # ends in the one read, a copy
    # the frame's three arrays become tensors (uploads on the card); nothing else
    assert mode.counts == {"aten.lift_fresh.default": 3}, mode.counts
    np.testing.assert_array_equal(got, best.numpy())
    assert bool(ok) and scores.shape == (252,) and poses.shape == (252, 4, 4)


def test_track_step_chain_reads_nothing_back(scene):
    model, pose, rgb, depth, _ = scene
    mesh = model._meshes["house"]
    rgb_t, depth_t = torch.from_numpy(rgb), torch.from_numpy(depth)
    poses = torch.from_numpy(np.stack([pose, pose]))
    with torch.inference_mode():
        fpp.track_step(mesh, model._refiner, rgb_t, depth_t, poses, model._K, 1, CFG)
        with CountSyncs() as mode:
            for _ in range(2):
                poses = fpp.track_step(mesh, model._refiner, rgb_t, depth_t, poses, model._K, 2,
                                       CFG)
    assert mode.counts == {}, mode.counts


def test_guess_translation_solves_without_an_error_read():
    """The translation guess's solve leaves its error code on the device and
    gives solve's bits."""
    from foundationpose_cpp_tpu_torch.ops import depth as depth_ops

    rng = np.random.default_rng(0)
    depth = torch.from_numpy(rng.uniform(0.4, 0.6, (H, W)).astype(np.float32))
    mask = torch.zeros((H, W), dtype=torch.uint8)
    mask[40:80, 50:110] = 255
    Kt = torch.from_numpy(K)
    with CountSyncs() as mode:
        center, ok = depth_ops.guess_translation(depth, mask, Kt, 0.001)
    assert mode.counts == {}, mode.counts
    assert bool(ok)
    # solve's result for the same right-hand side, bit for bit
    ys, xs = torch.nonzero(mask, as_tuple=True)
    uv1 = torch.stack([(xs.min() + xs.max()) / 2.0, (ys.min() + ys.max()) / 2.0,
                       torch.tensor(1.0)]).float()
    z = center[2]
    torch.testing.assert_close(center, torch.linalg.solve(Kt, uv1) * z, rtol=0, atol=0)
