"""``track_batch`` over a changing set of names, on the CPU: one program
for each N over the model's catalog of meshes.

The three meshes, seeded narrow f32 nets and the frame of
``test_torch_track_mixed.py`` (five objects, two of them cubes and two
bumpy meshes). A sequence of calls over ordered sets of those objects, N
from 1 to 5 and names repeated, runs through the stand-in of
tests/graph_standin.py, so a program is captured on its first call and its
"replays" read the names' indices from the static buffer. Each call is held
against the plain render route run eagerly on its own names, bit for bit,
and against each object tracked alone. No JAX is imported.
"""

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.ops import render
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import (
    CATALOG,
    FoundationPose,
    track_step,
)
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshSet

from .graph_standin import FakeGraphs, graphs, one_thread  # noqa: F401  (a fixture)
from .test_torch_track_mixed import (  # noqa: F401  (fixtures)
    CFG,
    H,
    NAMES,
    ORDER,
    W,
    _model,
    files,
    frame,
)

# ordered sets of the frame's objects (ORDER[i] is object i's mesh): every N
# from 1 to 5, the two cubes (1, 3) and the two bumpy meshes (0, 4) together,
# sets that return after others and one object in several places of a set
SETS = [(2,), (1, 3), (0, 2, 4), (3, 1), (4, 0, 2, 1, 3), (2,), (3, 0, 1, 4), (1,),
        (0, 1, 2, 3, 4), (2, 3), (4, 2, 0), (0, 1, 2, 3, 4), (1, 4, 3, 2)]


def _names(objects) -> list:
    return [ORDER[i] for i in objects]


@pytest.fixture(scope="module")
def served(files, frame):
    """The sequence through one model's programs (the stand-in's graphs):
    the model, the stand-in, each call's poses and the catalog builds and
    captures that the calls after the first at each N made."""
    rgb, depth, hyp = frame
    model = _model(files)
    seen, after = set(), {"builds": 0, "captures": 0}
    with graphs(FakeGraphs()) as standin:
        out = []
        for objects in SETS:
            builds, captures = model.meshset_builds, standin.captures
            out.append(model.track_batch(rgb, depth, hyp[list(objects)], _names(objects)))
            if len(objects) in seen:
                after["builds"] += model.meshset_builds - builds
                after["captures"] += standin.captures - captures
            seen.add(len(objects))
    return model, standin, out, after


def test_each_call_equals_the_plain_render_route_on_its_own_names(served, frame):
    """Every replay, whatever set the call before it tracked, equals
    ``track_step`` run eagerly on the catalog's views of the call's own
    names (the plain render over the mesh table), bit for bit."""
    rgb, depth, hyp = frame
    model, _, out, _ = served
    catalog = model._mesh_catalog()
    rgb_t, depth_t = torch.as_tensor(rgb), torch.as_tensor(depth)
    for objects, got in zip(SETS, out):
        poses = torch.as_tensor(hyp[list(objects)])
        with torch.inference_mode():
            want = track_step(catalog.select(_names(objects)), model._refiner, rgb_t, depth_t,
                              poses, model._K, 1, CFG)
        assert np.array_equal(got, want.numpy()), objects
        assert np.abs(got - hyp[list(objects)]).max() > 1e-4  # the refiner moved them


def test_each_call_equals_each_object_tracked_alone(served, frame):
    """Pose i of a call against ``track`` of object i alone: the CPU's
    convolutions and matrix products round by batch (up to ~4e-7 in the
    refiner's outputs, ``test_torch_track_mixed.py``), and a crop window's
    bound may fall a pixel apart between batches of different sizes, as
    the ``track_batch`` docstring states; here no bound moved, so the poses
    agree within rtol 1e-5, atol 1e-6."""
    rgb, depth, hyp = frame
    model, _, out, _ = served
    alone = [model.track(rgb, depth, hyp[i], ORDER[i]) for i in range(len(ORDER))]
    for objects, got in zip(SETS, out):
        want = np.stack([alone[i] for i in objects])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_one_program_for_each_n_and_one_catalog(served):
    model, _, _, after = served
    sizes = sorted({len(s) for s in SETS})
    keys = [k for k in model._track_cache if k[1] == CATALOG]
    assert sorted(keys, key=lambda k: k[4]) == [("track_batch", CATALOG, (H, W), 1, n, False)
                                                for n in sizes]
    assert model.meshset_builds == 1 and model._catalog.names == NAMES
    assert after == {"builds": 0, "captures": 0}
    assert [model._track_cache[k].captures for k in keys] == [1] * len(sizes)
    assert sum(model._track_cache[k].replays for k in keys) == len(SETS) - len(sizes)


def test_the_catalog_rows_select_each_mesh_and_views_gather_them(files):
    """Each catalog row selects its mesh's own vertices, faces and texels;
    views gather the rows of their names, with scratch slots n * V_max, and
    their diameters are the meshes' f32 numbers."""
    model = _model(files)
    catalog = MeshSet.build(model._meshes)
    col = {c: i for i, c in enumerate(render.TABLE_COLS)}
    assert catalog.vertex_max == max(m.vertices.shape[0] for m in model._meshes.values())
    for row, (name, mesh) in zip(catalog.rows.tolist(), model._meshes.items()):
        v0, nv, f0, nf, t0, th, tw, scratch = row
        assert scratch == 0 and (th, tw) == tuple(mesh.texture.shape[:2])
        assert torch.equal(catalog.vertices[v0:v0 + nv], mesh.vertices)
        assert torch.equal(catalog.normals[v0:v0 + nv], mesh.normals)
        assert torch.equal(catalog.texcoords[v0:v0 + nv], mesh.texcoords)
        assert torch.equal(catalog.faces[f0:f0 + nf], mesh.faces)
        assert torch.equal(catalog.texture[t0:t0 + th * tw], mesh.texture.reshape(-1, 3))
    names = ["quad", "cube", "quad", "bumpy"]
    views = catalog.select(names)
    idx = [NAMES.index(n) for n in names]
    rows = views.table.rows
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    assert torch.equal(rows[:, :7], catalog.rows[idx, :7])
    assert rows[:, col["scratch_first"]].tolist() == [n * catalog.vertex_max for n in range(4)]
    assert views.table.scratch_vertices == 4 * catalog.vertex_max
    assert views.diameter.tolist() == torch.tensor(
        [model._meshes[n].diameter for n in names], dtype=torch.float32).tolist()


@pytest.mark.parametrize("names,match", [
    (["cube", "mug", "quad"], "unknown"),
    ([], "no target names"),
    (["cube", "quad"], "2 target names for 3 poses"),
    (["cube", "quad", "bumpy", "cube"], "4 target names for 3 poses"),
])
def test_names_that_do_not_fit_raise_before_any_upload(files, frame, monkeypatch, names, match):
    rgb, depth, hyp = frame
    model = _model(files)

    def no_upload(*args):
        raise AssertionError("uploaded")

    monkeypatch.setattr(FoundationPose, "_frame_args", no_upload)
    monkeypatch.setattr(FoundationPose, "_upload", no_upload)
    with pytest.raises(ValueError, match=match):
        model.track_batch(rgb, depth, hyp[:3], names)
    assert model.meshset_builds == 0 and not model._track_cache


def test_a_size_bucket_serves_changing_names_from_its_buffers(files, frame):
    """In a size bucket the catalog program reads the bucket's frame
    buffers and its device (h, w) in place (the names' indices are its
    fourth argument) and equals the unbucketed program on every set."""
    rgb, depth, hyp = frame
    paths, refiner, scorer = files
    off = _model(files)
    bucketed = FoundationPoseConfig(**{**CFG.__dict__, "size_buckets": ((H + 8, W + 16),)})
    on = FoundationPose(refiner, scorer, list(off._assets.values()), off._K.numpy(), H, W,
                        bucketed, device="cpu")
    with graphs(FakeGraphs()):
        for objects in SETS[:6]:
            names, h = _names(objects), hyp[list(objects)]
            np.testing.assert_allclose(on.track_batch(rgb, depth, h, names),
                                       off.track_batch(rgb, depth, h, names), rtol=0, atol=1e-6)
    program = on._track_cache[("track_batch", CATALOG, (H + 8, W + 16), 1, 2, True)]
    assert program._inputs[0] is on._bucket_buffers[(H + 8, W + 16)]["rgb"]
    assert program._inputs[4] is on._bucket_extents[(H + 8, W + 16)]

