"""Two faults of the port's compiled programs, pinned on the CPU.

A ``Program`` on the card reads its inputs and every tensor its function
read during the capture by address. The card's bookkeeping runs here with a
stand-in for the CUDA graph (``tests/graph_standin.py``), on the small f32
nets and the 120x160 cube scene of tests/test_torch_programs.py (36
hypotheses):

- a mask of another dtype than the first call's (uint8, then bool, then
  uint8) is served by the same Register program, unbucketed and in a size
  bucket, with the eager poses;
- the constants a capture read (``transforms._constant``) stay alive while
  300 other constants are built, and the next replay equals eager.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import FoundationPoseConfig, create_foundationpose_model
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic

from .graph_standin import FakeGraphs, graphs, one_thread  # noqa: F401 (a fixture)

NET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
HW = (120, 160)
BUCKETS = ((128, 192),)


def _cfg(buckets=None):
    """Crop 32 and 36 hypotheses (12 views, 3 in-plane steps) keep a
    Register on the CPU short; neither fault depends on the grid."""
    return FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False,
                                size_buckets=buckets, n_views=12, inplane_step_deg=120)


@pytest.fixture(scope="module")
def nets():
    return (networks.init_net("refiner", NET, 0),
            networks.init_net("scorer", dataclasses.replace(NET, cross_attention=True), 1))


@pytest.fixture(scope="module")
def scene():
    """(rgb, depth, mask u8 0/255) of the textured cube at 0.5 m."""
    mesh = MeshConstants.from_asset(procedural.textured_cube(size=0.1), "cpu")
    return synthetic.render_scene(mesh, synthetic.default_pose(tz=0.5), K, *HW, _cfg())


def _model(nets, buckets=None):
    return create_foundationpose_model(nets[0], nets[1], [procedural.textured_cube(size=0.1)],
                                       K, 256, 256, config=_cfg(buckets), device="cpu")


@pytest.mark.parametrize("buckets", [None, BUCKETS], ids=["unbucketed", "bucket"])
def test_mask_dtype_change_keeps_the_program(nets, scene, buckets):
    """uint8, bool, uint8: one program key, one capture, two replays, each
    result equal to the eager model's (atol 0); unbucketed, the eager
    result is also register_step's on the caller's uint8 mask as it is."""
    rgb, depth, mask = scene
    masks = [mask, mask > 0, (mask > 0).astype(np.uint8)]
    graphed, eager = _model(nets, buckets), _model(nets, buckets)
    with graphs(FakeGraphs()) as standin:
        got = [graphed.register_with_scores(rgb, depth, m, "cube") for m in masks]
    with graphs(None):
        want = [eager.register_with_scores(rgb, depth, m, "cube") for m in masks]
    assert standin.captures == 1 and standin.replays == 2
    assert len(graphed._register_cache) == 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    if buckets is None:
        with torch.inference_mode():
            before = fpp.register_step(
                eager._meshes["cube"], eager._refiner, eager._scorer,
                *(torch.from_numpy(a) for a in (rgb, depth, mask)), eager._rot_grid, eager._K, 1,
                eager._cfg)
        for a, b in zip(want[0], before[:3]):
            np.testing.assert_array_equal(a, b.numpy())
    else:
        bufs = graphed._bucket_buffers[BUCKETS[0]]
        program = graphed._register_cache[("register", "cube", BUCKETS[0], 1, True)]
        assert bufs["mask"].dtype == torch.uint8
        assert program._inputs[2].data_ptr() == bufs["mask"].data_ptr()


def test_constants_a_capture_read_outlive_other_constants(nets, scene, monkeypatch):
    """Every constant the Register's first call (its warm-up run and its
    capture) read is alive after 300 other constants are built, and the
    next call (a replay) equals the eager model's."""
    rgb, depth, mask = scene
    graphed, eager = _model(nets), _model(nets)
    build = transforms._constant
    read = []

    def recording(values, device):
        t = build(values, device)
        read.append(weakref.ref(t))
        return t

    with graphs(FakeGraphs()) as standin:
        monkeypatch.setattr(transforms, "_constant", recording)
        graphed.register_with_scores(rgb, depth, mask, "cube")
        monkeypatch.setattr(transforms, "_constant", build)
        assert standin.captures == 1 and read
        for i in range(300):
            transforms._constant((float(i) + 0.25, -1.0), torch.device("cpu"))
        gc.collect()
        dead = sum(r() is None for r in read)
        assert dead == 0, f"{dead} of the {len(read)} constants the capture read were freed"
        got = graphed.register_with_scores(rgb, depth, mask, "cube")
        assert standin.replays == 1
    with graphs(None):
        want = eager.register_with_scores(rgb, depth, mask, "cube")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
