"""The port's mesh family and mesh bank against the JAX package's.

``random_family_asset`` of the port equals the JAX one for every generator
and a few seeds: name, vertices, faces, uvs, normals, texture, diameter and
center all equal (the same numpy draws in the same order; scipy's hull in the
same face order). The port's bank keeps the JAX bank's ADD-label points
(``np.random.default_rng(0)``) and its common-diameter contract; every
family object renders through the port's render branch.
"""

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.meshio import family as jfamily
from foundationpose_cpp_tpu.training import multi as jmulti
from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import family, procedural
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants, render_branch
from foundationpose_cpp_tpu_torch.training import multi

ALL_GENERATORS = family.TRAIN_GENERATORS + family.HELDOUT_GENERATORS
FIELDS = ("vertices", "vertex_normals", "texcoords", "faces", "texture", "model_center",
          "orient_bounds", "dimensions")


def _assert_assets_equal(a, b):
    assert a.name == b.name
    assert a.diameter == b.diameter
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_family_constants_match_jax():
    assert family.TRAIN_GENERATORS == jfamily.TRAIN_GENERATORS
    assert family.HELDOUT_GENERATORS == jfamily.HELDOUT_GENERATORS
    assert family.FAMILY_DIAMETER == jfamily.FAMILY_DIAMETER


@pytest.mark.parametrize("generator", ALL_GENERATORS)
@pytest.mark.parametrize("seed", [0, 7, 30_000])
def test_random_family_asset_equals_jax(generator, seed):
    _assert_assets_equal(family.random_family_asset(seed, generator=generator),
                         jfamily.random_family_asset(seed, generator=generator))


def test_seed_drawn_generators_equal_jax():
    """generator=None draws the generator from the seed, as in training."""
    for seed in (0, 1, 2, 3, 20_000, 20_017):
        _assert_assets_equal(family.random_family_asset(seed), jfamily.random_family_asset(seed))


def test_family_deterministic_and_normalized():
    for gen in ALL_GENERATORS:
        a = family.random_family_asset(7, generator=gen)
        assert abs(a.diameter - family.FAMILY_DIAMETER) < 1e-5, gen
        ref = np.unique(a.faces)
        np.testing.assert_allclose(np.linalg.norm(a.vertex_normals[ref], axis=-1), 1.0, atol=1e-4)


def test_family_renders_nonempty():
    """Every generator renders a visible, lit object through the port."""
    cfg = FoundationPoseConfig()
    K = torch.tensor([[450.0, 0, 64], [0, 450.0, 64], [0, 0, 1]])
    pose = torch.eye(4)[None].clone()
    pose[0, 2, 3] = 0.5
    bbox = torch.tensor([[0.0, 0.0, 128.0, 128.0]])
    clip = transforms.pose_clip_matrix(pose, bbox, K, 128, 128, cfg.znear, cfg.zfar)
    for gen in ALL_GENERATORS:
        mesh = MeshConstants.from_asset(family.random_family_asset(3, generator=gen), device="cpu")
        out = render_branch(mesh, pose, clip, 128, 128, cfg)[0]
        fg = (out[..., 3:] != 0).any(-1)
        assert fg.float().mean() > 0.02, gen
        assert out[..., :3][fg].mean() > 0.01, gen


def test_mesh_bank_add_points_equal_jax():
    assets = [family.random_family_asset(s) for s in range(3)]
    bank = multi.build_mesh_bank(assets, device="cpu")
    jbank = jmulti.build_mesh_bank([jfamily.random_family_asset(s) for s in range(3)])
    np.testing.assert_array_equal(bank.add_pts.numpy(), np.asarray(jbank.add_pts))
    assert bank.names == jbank.names and bank.diameter == jbank.diameter
    assert bank.n_objects == 3
    for mesh, asset in zip(bank.meshes, assets):
        np.testing.assert_array_equal(
            mesh.vertices.numpy(), (asset.vertices - asset.model_center[None]).astype(np.float32))


def test_mesh_bank_rejects_mixed_diameters():
    with pytest.raises(ValueError, match="diameter"):
        multi.build_mesh_bank([family.random_family_asset(0), procedural.textured_house()],
                              device="cpu")
