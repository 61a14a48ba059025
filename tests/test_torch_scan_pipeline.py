"""The scanned-mesh chain through the port's Track and scoring, against the JAX package.

The chain of tests/test_scan_pipeline.py at a size the CPU takes in seconds:
``scanned_blob`` at 40x40 (3,120 faces, a 64^2 speckled texture) ->
``decimate_vertex_clustering`` -> ``subdivide_adaptive`` (texel-patch
metric), then, at crop 32 with narrow f32 nets whose seeded JAX weights are
carried over by ``convert_jax``: ``track_step`` at refine_itr 2 from a
perturbed pose (the JAX test's 12.7 deg / 8.2 mm) and ``refine_and_score``
on the true pose and its 180-degree flip. Poses and scores within 1e-4, the
bound of the pipeline tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from foundationpose_cpp_tpu import FoundationPoseConfig as JConfig
from foundationpose_cpp_tpu import networks as jnet
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.meshio.decimate import decimate_vertex_clustering as jdecimate
from foundationpose_cpp_tpu.meshio.subdivide import subdivide_adaptive as jsubdivide
from foundationpose_cpp_tpu.ops import depth as jdepth
from foundationpose_cpp_tpu.pipeline import foundationpose as jfp
from foundationpose_cpp_tpu.pipeline.renderer import MeshConstants as JMesh
from foundationpose_cpp_tpu.utils import synthetic as jsyn
from foundationpose_cpp_tpu_torch import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
from foundationpose_cpp_tpu_torch.meshio.subdivide import subdivide_adaptive
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.ops import depth as tdepth
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as tfp
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants as TMesh

NET = jnet.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                     dtype=jnp.float32, attn_impl="xla")
JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
H, W = 120, 160
TOL = 1e-4
BLOB = dict(seed=11, radius=0.048, n_lat=40, n_lon=40, tex_size=64)


@pytest.fixture(scope="module")
def chain():
    """(port MeshConstants, JAX MeshConstants, faces at each step)."""
    t_dec = decimate_vertex_clustering(tproc.scanned_blob(**BLOB), target_faces=1_500)
    t_asset, info = subdivide_adaptive(t_dec, max_faces=4_096, patch_k=4)
    j_asset, _ = jsubdivide(jdecimate(jproc.scanned_blob(**BLOB), target_faces=1_500),
                            max_faces=4_096, patch_k=4)
    np.testing.assert_array_equal(t_asset.faces, j_asset.faces)
    assert t_asset.num_faces > t_dec.num_faces and info["rounds"] >= 1
    return TMesh.from_asset(t_asset, "cpu"), JMesh.from_asset(j_asset), t_asset


@pytest.fixture(scope="module")
def nets():
    pr = jnet.init_refiner(0, NET)
    ps = jnet.init_scorer(1, dataclasses.replace(NET, cross_attention=True))
    port = [convert_jax.build_net(convert_jax.params_from_jax(jax.tree.map(np.asarray, p)), kind)
            for p, kind in ((pr, "refiner"), (ps, "scorer"))]
    return (pr, ps), port


@pytest.fixture(scope="module")
def scene(chain):
    gt = jsyn.default_pose(tz=0.5)
    rgb, depth, _ = jsyn.render_scene(chain[1], gt, K, H, W, JCFG)
    assert (depth > 0).mean() > 0.02
    return gt, rgb, depth


@pytest.mark.parametrize("sign", [1, -1])
def test_scan_track_step_matches_jax(chain, nets, scene, sign):
    tmesh, jmesh, _ = chain
    (pr, _), (t_ref, _) = nets
    gt, rgb, depth = scene
    hyp = gt.copy()
    hyp[:3, :3] = Rotation.from_rotvec(np.array([0.15, -0.12, 0.10]) * sign).as_matrix() @ hyp[:3, :3]
    hyp[:3, 3] += np.array([0.004, -0.004, 0.006])
    hyps = np.stack([hyp, gt]).astype(np.float32)
    want = np.asarray(jfp.track_step(jmesh, pr, jnp.asarray(rgb), jnp.asarray(depth),
                                     jnp.asarray(hyps), jnp.asarray(K), 2, JCFG, NET))
    with torch.inference_mode():
        got = tfp.track_step(tmesh, t_ref, torch.from_numpy(rgb), torch.from_numpy(depth),
                             torch.from_numpy(hyps), torch.from_numpy(K), 2, TCFG).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_scan_refine_and_score_matches_jax(chain, nets, scene):
    tmesh, jmesh, _ = chain
    (pr, ps), (t_ref, t_sc) = nets
    gt, rgb, depth = scene
    flip = gt.copy()
    flip[:3, :3] = flip[:3, :3] @ Rotation.from_euler("z", 180, degrees=True).as_matrix()
    poses = np.stack([gt, flip]).astype(np.float32)
    j_xyz = jdepth.depth_to_xyz(jnp.asarray(depth), jnp.asarray(K), JCFG.min_depth)
    j_poses, j_scores = jfp.refine_and_score(jmesh, pr, ps, jnp.asarray(poses), jnp.asarray(rgb),
                                             j_xyz, jnp.asarray(K), 1, JCFG, NET)
    with torch.inference_mode():
        t_xyz = tdepth.depth_to_xyz(torch.from_numpy(depth), torch.from_numpy(K), TCFG.min_depth)
        t_poses, t_scores = tfp.refine_and_score(tmesh, t_ref, t_sc, torch.from_numpy(poses),
                                                 torch.from_numpy(rgb), t_xyz,
                                                 torch.from_numpy(K), 1, TCFG)
    np.testing.assert_allclose(t_poses.numpy(), np.asarray(j_poses), atol=TOL, rtol=0)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), atol=TOL, rtol=0)
