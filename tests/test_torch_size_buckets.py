"""The port's size buckets against its own unbucketed path and the JAX package.

A frame smaller than its bucket is copied into the bucket's device buffers
(zeros beyond its real extent) and the real (h, w) rides along, so one set
of buffers serves every size in the bucket (reference README.md:20). In
eager PyTorch the extents are Python ints, so bucketed and unbucketed
results agree to 1e-6 (the JAX package's traced extents move XLA's constant
folding, tests/test_size_buckets.py:66-73). Small f32 nets as in
tests/test_torch_pipeline.py, carried across with ``convert_jax``.
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
from foundationpose_cpp_tpu.ops import depth as jdepth
from foundationpose_cpp_tpu.pipeline.renderer import MeshConstants as JMesh
from foundationpose_cpp_tpu.utils import synthetic as jsyn
from foundationpose_cpp_tpu_torch import FoundationPoseConfig
from foundationpose_cpp_tpu_torch import create_foundationpose_model as t_create
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.ops import depth as tdepth

NET = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)
NET_S = dataclasses.replace(NET, cross_attention=True)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
TOL = 1e-4


def _jcfg(buckets=None):
    return JConfig(crop_window_h=32, crop_window_w=32, size_buckets=buckets)


def _tcfg(buckets=None):
    return FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False,
                                size_buckets=buckets)


@pytest.fixture(scope="module")
def nets():
    return jnet.init_refiner(0, NET), jnet.init_scorer(1, NET_S)


@pytest.fixture(scope="module")
def scenes():
    """{(h, w): (pose, rgb, depth, mask)} of the textured cube at 0.5 m."""
    mesh = JMesh.from_asset(jproc.textured_cube(size=0.1))
    pose = jsyn.default_pose(tz=0.5)
    return {hw: (pose, *jsyn.render_scene(mesh, pose, K, *hw, _jcfg()))
            for hw in ((120, 160), (96, 128))}


def _port(nets, buckets=None):
    sds = [convert_jax.params_from_jax(jax.tree.map(np.asarray, p)) for p in nets]
    return t_create(
        convert_jax.build_net(sds[0], "refiner"), convert_jax.build_net(sds[1], "scorer"),
        [tproc.textured_cube(size=0.1)], K, 256, 256, config=_tcfg(buckets), device="cpu",
    )


def _jax(nets, buckets=None):
    return j_create(nets[0], nets[1], [jproc.textured_cube(size=0.1)], K, 256, 256,
                    config=_jcfg(buckets), net_config=NET)


@pytest.fixture(scope="module")
def port_models(nets):
    return {"off": _port(nets), "on": _port(nets, ((160, 192), (128, 192)))}


@pytest.fixture(scope="module")
def registered(scenes, port_models):
    """{(h, w): {"off"|"on": (best, poses, scores)}}: the port's Register of
    each scene, unbucketed and in the (128, 192) bucket."""
    return {hw: {name: model.register_with_scores(*scenes[hw][1:], "cube")
                 for name, model in port_models.items()} for hw in scenes}


@pytest.mark.parametrize("hw", [(120, 160), (96, 128)], ids=["120x160", "96x128"])
def test_bucketed_equals_unbucketed(scenes, port_models, registered, hw):
    pose, rgb, depth, _ = scenes[hw]
    off, on = port_models["off"], port_models["on"]
    for g, w in zip(registered[hw]["on"], registered[hw]["off"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(on.track(rgb, depth, pose, "cube"),
                               off.track(rgb, depth, pose, "cube"), rtol=0, atol=1e-6)
    poses = np.stack([pose, pose])
    poses[1, :3, 3] += [0.01, 0.0, 0.005]
    np.testing.assert_allclose(on.track_batch(rgb, depth, poses, "cube"),
                               off.track_batch(rgb, depth, poses, "cube"), rtol=0, atol=1e-6)


def test_bucketed_matches_jax_unbucketed(scenes, nets, port_models, registered):
    pose, rgb, depth, mask = scenes[(120, 160)]
    jm = _jax(nets)
    _, jp, js = jm.register_with_scores(rgb, depth, mask, "cube")
    _, tp, ts = registered[(120, 160)]["on"]
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts, js, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port_models["on"].track(rgb, depth, pose, "cube"),
                               jm.track(rgb, depth, pose, "cube"), rtol=TOL, atol=TOL)


def test_register_in_bucket_matches_jax_bucketed(scenes, nets, registered):
    """96x128 in the (128, 192) bucket against the JAX package's bucketed
    program, at tests/test_size_buckets.py's own limits (its traced extents
    flip razor-edge ties by an ulp)."""
    _, rgb, depth, mask = scenes[(96, 128)]
    _, jp, js = _jax(nets, ((128, 192),)).register_with_scores(rgb, depth, mask, "cube")
    _, tp, ts = registered[(96, 128)]["on"]
    assert (np.abs(ts - js) < 1e-4).mean() > 0.5
    np.testing.assert_allclose(ts, js, atol=0.2)
    np.testing.assert_allclose(tp, jp, atol=0.02)


def test_two_sizes_share_one_buffer_set(scenes, nets, registered):
    """Register of both sizes gave finite rigid poses (``registered``); here
    both sizes go through one bucket's single buffer set, which then holds
    the last frame zero-padded as ``_pad_to`` pads it."""
    for result in registered.values():
        best = result["on"][0]
        assert best.shape == (4, 4) and np.isfinite(best).all()
        np.testing.assert_allclose(best[:3, :3] @ best[:3, :3].T, np.eye(3), atol=1e-3)
    model = _port(nets, ((128, 192),))
    for hw in ((120, 160), (96, 128)):
        pose, rgb, depth, mask = scenes[hw]
        assert np.isfinite(model.track(rgb, depth, pose, "cube")).all()
        (rgb_t, depth_t, mask_t), image_hw = model._frame(rgb, depth, mask)
        assert image_hw == hw
    assert list(model._bucket_buffers) == [(128, 192)], "sizes must share one buffer set"
    bufs = model._bucket_buffers[(128, 192)]
    assert sorted(bufs) == ["depth", "mask", "rgb"]
    for name, a in (("rgb", rgb), ("depth", depth), ("mask", mask)):
        assert bufs[name].data_ptr() == {"rgb": rgb_t, "depth": depth_t, "mask": mask_t}[name].data_ptr()
        np.testing.assert_array_equal(bufs[name].numpy(), model._pad_to(a, 128, 192))
    assert model._bucket_for(128, 192) == (128, 192)


def test_smallest_bucket_by_area_and_oversize_rejected(scenes, nets):
    model = _port(nets, ((256, 256), (128, 192), (160, 192)))
    assert model._bucket_for(96, 128) == (128, 192)
    assert model._bucket_for(150, 100) == (160, 192)
    assert model._bucket_for(200, 100) == (256, 256)
    assert _port(nets)._bucket_for(96, 128) is None
    _, rgb, depth, mask = scenes[(120, 160)]
    small = _port(nets, ((64, 64),))
    with pytest.raises(ValueError, match="bucket"):
        small.register(rgb, depth, mask, "cube")
    with pytest.raises(ValueError, match="bucket"):
        small.track(rgb, depth, np.eye(4, dtype=np.float32), "cube")


@pytest.mark.parametrize("extent", [(40, 50), (33, 64), (48, 21)])
def test_erode_depth_valid_matches_jax(extent):
    rng = np.random.default_rng(sum(extent))
    depth = rng.uniform(0.3, 0.7, size=(48, 64)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    depth[10:20, 10:30] = 0.52  # a flat patch that survives
    valid = np.zeros(depth.shape, bool)
    valid[: extent[0], : extent[1]] = True
    args = (2, 0.001, 0.8, 100.0)
    want = np.asarray(jdepth.erode_depth(jnp.asarray(depth), *args, valid=jnp.asarray(valid)))
    got = tdepth.erode_depth(torch.from_numpy(depth), *args, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # on the padded frame it erodes the crop as the crop alone erodes
    crop = tdepth.erode_depth(torch.from_numpy(depth[: extent[0], : extent[1]].copy()), *args)
    np.testing.assert_array_equal(got.numpy()[: extent[0], : extent[1]], crop.numpy())
    assert not got.numpy()[~valid].any()
