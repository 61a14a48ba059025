"""The committed mesh assets: what the recipe says they hold."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from benchmark.reference import assets

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


@pytest.mark.parametrize("name,faces", [("scan13k", 13_277), ("cube8cm", 12)])
def test_asset_face_counts_through_the_programs_loader(name, faces):
    from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh

    asset = load_mesh(name, str(ASSETS / f"{name}.ply"))
    assert asset.num_faces == faces
    assert asset.texture.shape[-1] == 3 and asset.texture.std() > 0.05
    ply = assets.read_ply(str(ASSETS / f"{name}.ply"))
    assert ply["faces"].shape == (faces, 3)
    assert np.array_equal(ply["vertices"], asset.vertices)


def test_cube_is_eight_centimetres():
    ply = assets.read_ply(str(ASSETS / "cube8cm.ply"))
    assert np.allclose(ply["vertices"].max(0) - ply["vertices"].min(0), 0.08)
