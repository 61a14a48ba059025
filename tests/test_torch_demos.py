"""The port's two synthetic demos at 120x160, crop 32, on the CPU.

``demo_multi_object`` is held against the JAX package's ``track_batch``: the
same 4 cube poses on the same frame through nets with the same weights (JAX
seeded nets carried over by ``convert_jax``), frame after frame, within 1e-4
(the pipeline tests' bound for f32 nets). ``demo_synthetic`` Registers and
Tracks with seeded nets and must write its overlays and finite poses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from foundationpose_cpp_tpu import FoundationPoseConfig as JConfig
from foundationpose_cpp_tpu import create_foundationpose_model as j_create
from foundationpose_cpp_tpu import networks as jnet
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu_torch import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.demo_multi_object import run_multi_object
from foundationpose_cpp_tpu_torch.demo_synthetic import run_demo
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.utils import png

NET = jnet.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                     dtype=jnp.float32, attn_impl="xla")
TNET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
H, W = 120, 160
TOL = 1e-4


def test_multi_object_track_batch_matches_jax():
    pr = jnet.init_refiner(0, NET)
    ps = jnet.init_scorer(1, dataclasses.replace(NET, cross_attention=True))
    nets = [convert_jax.build_net(convert_jax.params_from_jax(jax.tree.map(np.asarray, p)), kind)
            for p, kind in ((pr, "refiner"), (ps, "scorer"))]
    got = run_multi_object(4, 2, (H, W), "cpu", TCFG, TNET, *nets)
    assert got["poses"].shape == (2, 4, 4, 4) and np.isfinite(got["poses"]).all()
    assert len(got["ms_per_object"]) == 2
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]], np.float32)
    jm = j_create(pr, ps, [jproc.textured_cube(size=0.08)], K, H, W, config=JCFG, net_config=NET)
    poses = got["poses0"]
    for i in range(2):
        poses = np.asarray(jm.track_batch(got["rgb"], got["depth"], poses, "cube"))
        np.testing.assert_allclose(got["poses"][i], poses, atol=TOL, rtol=0)
    # the frame shows instance 0; the other instances' crops see background
    assert (got["depth"] > 0).any()


def test_demo_synthetic_writes_overlays(tmp_path):
    out = run_demo(frames=3, out_dir=str(tmp_path), hw=(H, W), mesh_name="house",
                   weights_dir="", device="cpu", config=TCFG, net_config=TNET)
    assert out["poses"].shape == (3, 4, 4) and np.isfinite(out["poses"]).all()
    names = sorted(p.name for p in tmp_path.glob("*.png"))
    assert names == ["register_bbox.png", "track_001.png", "track_002.png"]
    img = png.read_png(str(tmp_path / "register_bbox.png"))
    assert img.shape == (H, W, 3) and (img == [0, 255, 0]).all(axis=-1).any()
    assert len(out["rot_err_deg"]) == 3 and np.isfinite(out["t_err_m"]).all()
