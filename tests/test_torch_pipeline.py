"""The port's Register / Track end to end against the JAX pipeline on the CPU.

The scene of tests/test_pipeline_e2e.py (textured cube, 120x160, crop 32)
with small f32 nets (the JAX attention on its f32 XLA path), the same
seeded weights carried across with ``convert_jax``. Refined poses and scores
within 1e-4; the same argmax unless the JAX top two are within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu import FoundationPoseConfig as JConfig
from foundationpose_cpp_tpu import create_foundationpose_model as j_create
from foundationpose_cpp_tpu import networks as jnet
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.pipeline.renderer import MeshConstants as JMesh
from foundationpose_cpp_tpu.utils import synthetic as jsyn
from foundationpose_cpp_tpu_torch import FoundationPose, FoundationPoseConfig
from foundationpose_cpp_tpu_torch import create_foundationpose_model as t_create
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants as TMesh
from foundationpose_cpp_tpu_torch.utils import synthetic as tsyn

NET = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)
NET_S = dataclasses.replace(NET, cross_attention=True)
JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
H, W = 120, 160
TOL = 1e-4


def _port_net(params, kind):
    sd = convert_jax.params_from_jax(jax.tree.map(np.asarray, params))
    return convert_jax.build_net(sd, kind)


@pytest.fixture(scope="module")
def scene():
    cube = jproc.textured_cube(size=0.1)
    pose = jsyn.default_pose(tz=0.5)
    rgb, depth, mask = jsyn.render_scene(JMesh.from_asset(cube), pose, K, H, W, JCFG)
    return pose, rgb, depth, mask


@pytest.fixture(scope="module")
def models():
    pr, ps = jnet.init_refiner(0, NET), jnet.init_scorer(1, NET_S)
    jm = j_create(pr, ps, [jproc.textured_cube(size=0.1)], K, H, W, config=JCFG, net_config=NET)
    tm = t_create(
        _port_net(pr, "refiner"), _port_net(ps, "scorer"), [tproc.textured_cube(size=0.1)],
        K, H, W, config=TCFG, device="cpu",
    )
    return jm, tm


def test_render_scene_matches_jax(scene):
    pose, rgb, depth, mask = scene
    t_rgb, t_depth, t_mask = tsyn.render_scene(
        TMesh.from_asset(tproc.textured_cube(size=0.1), device="cpu"), pose, K, H, W, TCFG
    )
    np.testing.assert_array_equal(tsyn.default_pose(0.5), jsyn.default_pose(0.5))
    assert (t_mask != mask).mean() < 0.01
    both = (t_mask > 0) & (mask > 0)
    np.testing.assert_allclose(t_depth[both], depth[both], rtol=1e-5, atol=1e-6)
    assert (np.abs(t_rgb.astype(int) - rgb.astype(int))[both] > 1).mean() < 0.01


def test_register_matches_jax(scene, models):
    _, rgb, depth, mask = scene
    jm, tm = models
    jb, jp, js = jm.register_with_scores(rgb, depth, mask, "cube")
    tb, tp, ts = tm.register_with_scores(rgb, depth, mask, "cube")
    assert tp.shape == (252, 4, 4) and ts.shape == (252,)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts, js, rtol=TOL, atol=TOL)
    top2 = np.sort(js)[-2:]
    if top2[1] - top2[0] > TOL:
        assert np.argmax(ts) == np.argmax(js)
        np.testing.assert_allclose(tb, jb, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.register(rgb, depth, mask, "cube"), tb, rtol=0, atol=0)


def test_track_matches_jax(scene, models):
    pose, rgb, depth, _ = scene
    jm, tm = models
    got = tm.track(rgb, depth, pose, "cube")
    want = jm.track(rgb, depth, pose, "cube")
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_track_batch_matches_jax(scene, models):
    pose, rgb, depth, _ = scene
    jm, tm = models
    poses = np.stack([pose, pose, pose])
    poses[1, :3, 3] += [0.01, 0.0, 0.005]
    poses[2, :3, 3] += [-0.01, 0.005, -0.005]
    got = tm.track_batch(rgb, depth, poses, "cube")
    want = jm.track_batch(rgb, depth, poses, "cube")
    assert got.shape == (3, 4, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0], tm.track(rgb, depth, pose, "cube"), rtol=0, atol=1e-6)


def test_register_empty_mask_raises(scene, models):
    _, rgb, depth, _ = scene
    _, tm = models
    with pytest.raises(RuntimeError, match="translation guess failed"):
        tm.register(rgb, depth, np.zeros_like(depth, dtype=np.uint8), "cube")


def test_input_validation(scene, models):
    _, rgb, depth, mask = scene
    _, tm = models
    with pytest.raises(ValueError, match="size mismatch"):
        tm.register(rgb[:-2], depth, mask, "cube")
    with pytest.raises(KeyError, match="unknown target"):
        tm.register(rgb, depth, mask, "mustard")
    with pytest.raises(TypeError, match="uint8"):
        tm.register(rgb.astype(np.float32), depth, mask, "cube")
    with pytest.raises(TypeError, match="float32"):
        tm.register(rgb, depth.astype(np.float64), mask, "cube")
    big = np.zeros((H + 8, W + 8, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="exceeds construction max"):
        tm.register(big, np.zeros(big.shape[:2], np.float32),
                    np.zeros(big.shape[:2], np.uint8), "cube")


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nets = (jnet.init_refiner(0, NET), jnet.init_scorer(1, NET_S))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FoundationPose(
            _port_net(nets[0], "refiner"), _port_net(nets[1], "scorer"),
            [tproc.textured_cube(size=0.1)], K, H, W, config=TCFG,
        )
