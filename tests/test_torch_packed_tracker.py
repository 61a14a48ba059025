"""The port's packed-frame tracker against the JAX package's and its own track().

``make_packed_tracker`` is the deployment fast path: one uint8 buffer (rgb
bytes then depth bytes, ``pack_frame``'s layout) in, a device pose out.
``pack_frame`` must give the JAX package's bytes; the step must give the JAX
step's pose within 1e-4 (small f32 nets as in tests/test_torch_pipeline.py)
and the port's own track() on the same quantized frame within 1e-6.
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
from foundationpose_cpp_tpu.pipeline.foundationpose import FoundationPose as JFP
from foundationpose_cpp_tpu.pipeline.renderer import MeshConstants as JMesh
from foundationpose_cpp_tpu.utils import synthetic as jsyn
from foundationpose_cpp_tpu_torch import FoundationPoseConfig
from foundationpose_cpp_tpu_torch import create_foundationpose_model as t_create
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as tfp
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose as TFP

NET = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)
NET_S = dataclasses.replace(NET, cross_attention=True)
JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
H, W = 120, 160
ODD = (37, 53)  # h*w*3 = 5883: the depth bytes start at an odd offset
K_ODD = np.array([[120.0, 0, 53 / 2], [0, 120.0, 37 / 2], [0, 0, 1]], np.float32)
TOL = 1e-4


def _quantize_mm(depth):
    return np.round(depth.astype(np.float64) * 1000).astype(np.uint16).astype(np.float32) * 1e-3


@pytest.fixture(scope="module")
def frames():
    """{name: (K, pose, rgb, depth)}: the textured cube at 120x160 and a
    random frame at odd 37x53."""
    pose = jsyn.default_pose(tz=0.5)
    rgb, depth, _ = jsyn.render_scene(JMesh.from_asset(jproc.textured_cube(size=0.1)),
                                      pose, K, H, W, JCFG)
    rng = np.random.default_rng(5)
    odd_rgb = rng.integers(0, 255, size=(*ODD, 3), dtype=np.uint8)
    odd_depth = rng.uniform(0.3, 0.7, size=ODD).astype(np.float32)
    return {"scene": (K, pose, rgb, depth), "odd": (K_ODD, pose, odd_rgb, odd_depth)}


@pytest.fixture(scope="module")
def models():
    """{name: (jax model, port model)} for each frame of ``frames``."""
    pr, ps = jnet.init_refiner(0, NET), jnet.init_scorer(1, NET_S)
    sds = [convert_jax.params_from_jax(jax.tree.map(np.asarray, p)) for p in (pr, ps)]
    out = {}
    for name, k, hw in (("scene", K, (H, W)), ("odd", K_ODD, ODD)):
        jm = j_create(pr, ps, [jproc.textured_cube(size=0.1)], k, *hw, config=JCFG,
                      net_config=NET)
        tm = t_create(convert_jax.build_net(sds[0], "refiner"),
                      convert_jax.build_net(sds[1], "scorer"), [tproc.textured_cube(size=0.1)],
                      k, *hw, config=TCFG, device="cpu")
        out[name] = (jm, tm)
    return out


@pytest.mark.parametrize("depth_format", ["u16mm", "f32"])
@pytest.mark.parametrize("rgb_half", [False, True])
@pytest.mark.parametrize("hw", [(2, 4), (37, 53), (120, 160)])
def test_pack_frame_matches_jax(depth_format, rgb_half, hw):
    rng = np.random.default_rng(hw[0] * hw[1])
    rgb = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    depth = rng.uniform(-0.5, 70.0, size=hw).astype(np.float32)
    depth.flat[:: 7] = np.nan
    if rgb_half and (hw[0] % 2 or hw[1] % 2):
        rgb, depth = rgb[: hw[0] // 2 * 2, : hw[1] // 2 * 2], depth[: hw[0] // 2 * 2, : hw[1] // 2 * 2]
    if depth_format == "f32":
        depth = np.nan_to_num(depth)
    got = TFP.pack_frame(rgb, depth, depth_format, rgb_half)
    want = JFP.pack_frame(rgb, depth, depth_format, rgb_half)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert got.nbytes == TFP.packed_frame_bytes(rgb.shape[:2], depth_format, rgb_half) \
        == JFP.packed_frame_bytes(rgb.shape[:2], depth_format, rgb_half)
    if depth_format == "u16mm":  # a u16 sensor frame passes through
        mm = rng.integers(0, 65536, size=depth.shape, dtype=np.uint16)
        assert TFP.pack_frame(rgb, mm, "u16mm", rgb_half).tobytes() == \
            JFP.pack_frame(rgb, mm, "u16mm", rgb_half).tobytes()


def test_pack_frame_u16_edge_cases():
    """tests/test_pipeline_e2e.py:263-286 on the port: mm quantization clips
    to the u16 range and flushes NaN holes to 0; a u16 frame passes through."""
    rgb = np.zeros((2, 3, 3), np.uint8)
    depth = np.array([[0.0, np.nan, 1.2345], [70.0, -0.5, 0.0004]], np.float32)
    mm = TFP.pack_frame(rgb, depth, "u16mm")[rgb.size:].view(np.uint16).reshape(2, 3)
    assert mm[0, 0] == 0 and mm[0, 1] == 0
    assert mm[0, 2] in (1234, 1235)
    assert mm[1, 0] == 65535 and mm[1, 1] == 0 and mm[1, 2] == 0
    sensor = np.arange(6, dtype=np.uint16).reshape(2, 3) * 300
    np.testing.assert_array_equal(
        TFP.pack_frame(rgb, sensor, "u16mm")[rgb.size:].view(np.uint16).reshape(2, 3), sensor)
    with pytest.raises(ValueError):
        TFP.pack_frame(rgb, depth, "f16mm")


@pytest.mark.parametrize("hw", [(2, 2), (3, 5), (60, 80), (240, 320)])
def test_upsample_matches_jax_resize(hw):
    small = np.random.default_rng(hw[1]).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(small, jnp.float32),
                                       (2 * hw[0], 2 * hw[1], 3), method="linear"))
    got = tfp.upsample_rgb_half(torch.from_numpy(small)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth_format", ["u16mm", "f32"])
@pytest.mark.parametrize("hw", [(37, 53), (36, 52), (5, 7)])
def test_unpack_frame_is_the_jax_decode(depth_format, hw):
    """Depth decodes bit for bit as the JAX step's bitcast (u16mm: f32(mm) *
    1e-3), also where the depth bytes start at an unaligned offset."""
    rng = np.random.default_rng(hw[0])
    rgb = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    depth = rng.uniform(0.0, 3.0, size=hw).astype(np.float32)
    packed = TFP.pack_frame(rgb, depth, depth_format)
    got_rgb, got_depth = tfp.unpack_frame(torch.from_numpy(packed), hw, depth_format)
    np.testing.assert_array_equal(got_rgb.numpy(), rgb)
    if depth_format == "u16mm":
        want = np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(packed[rgb.size:]).reshape(*hw, 2), jnp.uint16).astype(jnp.float32) * 1e-3)
    else:
        want = depth
    np.testing.assert_array_equal(got_depth.numpy(), want)


@pytest.mark.parametrize("name,depth_format,rgb_half", [
    ("scene", "u16mm", False), ("scene", "f32", False), ("scene", "u16mm", True),
    ("odd", "u16mm", False), ("odd", "f32", False),
])
def test_packed_step_matches_jax(frames, models, name, depth_format, rgb_half):
    k, pose, rgb, depth = frames[name]
    jm, tm = models[name]
    hw = rgb.shape[:2]
    packed = TFP.pack_frame(rgb, depth, depth_format, rgb_half)
    want = np.asarray(jm.make_packed_tracker("cube", hw, depth_format=depth_format,
                                             rgb_half=rgb_half)(jnp.asarray(packed),
                                                                jnp.asarray(pose, jnp.float32)))
    step = tm.make_packed_tracker("cube", hw, depth_format=depth_format, rgb_half=rgb_half)
    got = step(packed, pose)
    assert isinstance(got, torch.Tensor) and got.shape == (4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,depth_format,rgb_half", [
    ("scene", "u16mm", False), ("scene", "f32", False), ("scene", "u16mm", True),
    ("odd", "u16mm", False), ("odd", "f32", False),
])
def test_packed_step_matches_track(frames, models, name, depth_format, rgb_half):
    """The step equals track() on the frame it decodes: depth quantized to
    whole millimeters for u16mm, and for rgb_half the upsampled colour
    truncated to uint8. Two chained steps (the pose fed forward as a tensor)
    equal two chained track() calls."""
    k, pose, rgb, depth = frames[name]
    _, tm = models[name]
    hw = rgb.shape[:2]
    packed = TFP.pack_frame(rgb, depth, depth_format, rgb_half)
    if depth_format == "u16mm":
        depth = _quantize_mm(depth)
    if rgb_half:
        small = torch.from_numpy(packed[: (hw[0] // 2) * (hw[1] // 2) * 3].reshape(
            hw[0] // 2, hw[1] // 2, 3))
        rgb = tfp.upsample_rgb_half(small).numpy().astype(np.uint8)
    step = tm.make_packed_tracker("cube", hw, depth_format=depth_format, rgb_half=rgb_half)
    dev = torch.from_numpy(packed)
    p1 = step(dev, torch.from_numpy(pose))
    p2 = step(dev, p1)
    t1 = tm.track(rgb, depth, pose, "cube")
    t2 = tm.track(rgb, depth, t1, "cube")
    np.testing.assert_allclose(p1.numpy(), t1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p2.numpy(), t2, rtol=0, atol=1e-6)


def test_packed_tracker_rejections(frames, models):
    _, tm = models["odd"]
    with pytest.raises(KeyError, match="unknown target"):
        tm.make_packed_tracker("mustard", ODD)
    with pytest.raises(ValueError, match="depth_format"):
        tm.make_packed_tracker("cube", ODD, depth_format="f16")
    with pytest.raises(ValueError, match="exceeds max"):
        tm.make_packed_tracker("cube", (ODD[0] + 1, ODD[1]))
    with pytest.raises(ValueError, match="even frame dims"):
        tm.make_packed_tracker("cube", ODD, rgb_half=True)
    step = tm.make_packed_tracker("cube", ODD)
    _, pose, rgb, depth = frames["odd"]
    packed = TFP.pack_frame(rgb, depth, "u16mm")
    with pytest.raises(ValueError, match="uint8 bytes"):
        step(packed[:-1], pose)
    with pytest.raises(ValueError, match="uint8 bytes"):
        step(packed.astype(np.int16), pose)
