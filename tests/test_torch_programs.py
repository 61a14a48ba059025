"""The port's compiled programs against the JAX package's program caches.

Each entry point of the JAX ``FoundationPose`` is a jitted program cached
under a key; the port's is a ``pipeline.programs.Program`` cached under the
same key, a CUDA graph on the card and an eager call on the CPU. Here, on
the CPU, with small f32 nets and the 120x160 cube scene of
tests/test_torch_pipeline.py:

- the same sequence of calls leaves the same keys in both packages' caches
  (two sizes in one bucket, refine_itr 1 and 2, ``track_batch`` at N=1 and
  N=3, and no buckets);
- Register and Track through a bucketed program, whose real (h, w) are 0-d
  tensors, equal the JAX bucketed programs and the port's Python-int path
  (bit for bit);
- the bookkeeping of a Program on the card (static buffers, bucket buffers
  read in place, clones of the outputs, launch counters that count per
  call, a capture that fails raising with the key) runs with a stand-in for
  the CUDA graph (``FakeGraphs`` of tests/graph_standin.py) whose replay
  runs the function again on the static buffers and writes the graph's
  output tensors.
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
from foundationpose_cpp_tpu_torch import FoundationPoseConfig, create_refiner_core
from foundationpose_cpp_tpu_torch import create_foundationpose_model as t_create
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.ops import render
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline import programs

from .graph_standin import FakeGraphs, graphs

NET = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)
NET_S = dataclasses.replace(NET, cross_attention=True)
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
BUCKETS = ((128, 192),)
SIZES = ((120, 160), (96, 128))
TOL = 1e-4  # tests/test_torch_pipeline.py


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
    return {hw: (pose, *jsyn.render_scene(mesh, pose, K, *hw, _jcfg())) for hw in SIZES}


def _port(nets, buckets=None):
    sds = [convert_jax.params_from_jax(jax.tree.map(np.asarray, p)) for p in nets]
    return t_create(
        convert_jax.build_net(sds[0], "refiner"), convert_jax.build_net(sds[1], "scorer"),
        [tproc.textured_cube(size=0.1)], K, 256, 256, config=_tcfg(buckets), device="cpu",
    )


def _jax(nets, buckets=None):
    return j_create(nets[0], nets[1], [jproc.textured_cube(size=0.1)], K, 256, 256,
                    config=_jcfg(buckets), net_config=NET)


def _batch(pose, n):
    poses = np.stack([pose] * n).astype(np.float32)
    poses[:, :3, 3] += np.linspace(0.0, 0.01, n, dtype=np.float32)[:, None]
    return poses


def _sequence(model, scenes, bucketed):
    """The calls both packages make, with their results by name."""
    out = {}
    big = scenes[SIZES[0]]
    if bucketed:
        for hw in SIZES:
            out[f"register {hw}"] = model.register_with_scores(*scenes[hw][1:], "cube")
            out[f"track {hw}"] = model.track(*scenes[hw][1:3], scenes[hw][0], "cube")
        out["register itr2"] = model.register_with_scores(*big[1:], "cube", refine_itr=2)
        out["track_batch 1"] = model.track_batch(*big[1:3], _batch(big[0], 1), "cube")
    else:
        out["register"] = model.register_with_scores(*big[1:], "cube")
        out["track"] = model.track(*big[1:3], big[0], "cube")
    out["track_batch 3"] = model.track_batch(*big[1:3], _batch(big[0], 3), "cube")
    return out


@pytest.fixture(scope="module")
def runs(nets, scenes):
    """{"on"|"off": (JAX model, port model, JAX results, port results)}."""
    res = {}
    for name, buckets in (("on", BUCKETS), ("off", None)):
        jm, tm = _jax(nets, buckets), _port(nets, buckets)
        res[name] = (jm, tm, _sequence(jm, scenes, buckets is not None),
                     _sequence(tm, scenes, buckets is not None))
    return res


@pytest.mark.parametrize("name", ["on", "off"])
def test_cache_keys_equal_jax(runs, name):
    jm, tm, _, _ = runs[name]
    assert set(tm._register_cache) == set(jm._register_cache)
    assert set(tm._track_cache) == set(jm._track_cache)
    assert all(isinstance(p, programs.Program) and p.key == k
               for cache in (tm._register_cache, tm._track_cache) for k, p in cache.items())
    if name == "on":
        # one program serves both sizes of the bucket
        assert ("register", "cube", BUCKETS[0], 1, True) in tm._register_cache
        assert len(tm._register_cache) == 2 and len(tm._track_cache) == 3


@pytest.mark.parametrize("name", ["on", "off"])
def test_programs_match_jax(runs, name):
    """Every Track and the unbucketed Register within 1e-4 of the JAX
    package's programs, and the bucketed Register of the 120x160 frame too.
    The 96x128 frame and refine_itr 2 in the bucket are held at
    tests/test_torch_size_buckets.py's limits: there the JAX bucketed
    program moves off its own unbucketed result (its traced extents change
    XLA's constant folding, tests/test_size_buckets.py), to 4.5e-4 in a
    score at 96x128 and 2.1e-2 at refine_itr 2 on this CPU."""
    _, _, want, got = runs[name]
    assert set(got) == set(want)
    for call in want:
        if call.startswith("register"):
            (gb, gp, gs), (wb, wp, ws) = got[call], want[call]
            if name == "off" or call == f"register {SIZES[0]}":
                np.testing.assert_allclose(gp, wp, rtol=TOL, atol=TOL)
                np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
            else:
                assert (np.abs(gs - ws) < TOL).mean() > 0.5
                np.testing.assert_allclose(gs, ws, atol=0.2)
                np.testing.assert_allclose(gp, wp, atol=0.02)
            assert np.isfinite(gb).all() and gb.shape == (4, 4)
        else:
            np.testing.assert_allclose(got[call], want[call], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", SIZES, ids=["120x160", "96x128"])
def test_bucketed_program_equals_python_int_path(runs, scenes, hw):
    """The bucketed programs read the real (h, w) from a (2,) f32 tensor;
    the same calls with Python ints give the same bits."""
    _, tm, _, got = runs["on"]
    pose, rgb, depth, mask = scenes[hw]
    mesh = tm._meshes["cube"]
    with torch.inference_mode():
        (rgb_t, depth_t, mask_t), image_hw = tm._frame(rgb, depth, mask)
        assert image_hw == hw
        want = fpp.register_step(mesh, tm._refiner, tm._scorer, rgb_t, depth_t, mask_t,
                                 tm._rot_grid, tm._K, 1, tm._cfg, image_hw)
        track = fpp.track_step(mesh, tm._refiner, rgb_t, depth_t,
                               torch.from_numpy(pose[None].astype(np.float32)), tm._K, 1,
                               tm._cfg, image_hw)[0]
    for g, w in zip(got[f"register {hw}"], want[:3]):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(got[f"track {hw}"], track.numpy())


@pytest.mark.parametrize("hw", [(120, 160), (96, 128), (481, 639)])
def test_clip_matrix_device_extent_equals_numbers(hw):
    rng = np.random.default_rng(hw[0])
    poses = torch.from_numpy(np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)))
    poses[:, :3, 3] = torch.from_numpy(rng.uniform([-0.05, -0.05, 0.4], [0.05, 0.05, 0.8],
                                                   (5, 3)).astype(np.float32))
    Kt = torch.from_numpy(K)
    tfs = transforms.compute_crop_window_tf(poses, Kt, (32, 32), 1.2, 0.1)
    bbox = transforms.construct_bbox2d(tfs, 32, 32)
    extent = torch.tensor(hw, dtype=torch.float32)
    assert torch.equal(transforms.projection_from_intrinsics(Kt, extent[0], extent[1]),
                       transforms.projection_from_intrinsics(Kt, *hw))
    assert torch.equal(transforms.pose_clip_matrix(poses, bbox, Kt, extent[0], extent[1]),
                       transforms.pose_clip_matrix(poses, bbox, Kt, *hw))


@pytest.fixture
def fake_graphs(monkeypatch):
    standin = FakeGraphs()
    monkeypatch.setattr(programs, "graphs_for", lambda device: standin)
    return standin


def _counted_double(x):
    render.render_views.launches += 2  # as if it launched a kernel twice
    return {"y": x * 2.0, "z": (x + 1.0, x.sum())}


def test_program_outputs_never_alias(fake_graphs):
    program = programs.Program(_counted_double, ("double",), "cpu")
    first = program(torch.ones(3))
    second = program(torch.full((3,), 5.0))
    third = program(torch.full((3,), 7.0))
    assert fake_graphs.captures == 1 and fake_graphs.replays == 2 and program.nodes == 7
    assert torch.equal(first["y"], torch.full((3,), 2.0))
    assert torch.equal(second["y"], torch.full((3,), 10.0))
    assert torch.equal(third["z"][0], torch.full((3,), 8.0)) and third["z"][1].item() == 21.0
    graph_memory = {t.data_ptr() for t in (program._outputs["y"], *program._outputs["z"])}
    for out in (second, third):
        assert not {t.data_ptr() for t in (out["y"], *out["z"])} & graph_memory
    with pytest.raises(ValueError, match="double"):
        program(torch.ones(4))


def test_launch_counters_count_per_call(fake_graphs):
    program = programs.Program(_counted_double, ("double",), "cpu")
    before = render.render_views.launches
    program(torch.ones(3))  # the run before the capture launched; the capture did not
    assert render.render_views.launches == before + 2
    assert program.launches_per_call == {"render_views": 2}
    for i in range(3):
        program(torch.ones(3))
        assert render.render_views.launches == before + 2 * (i + 2)


COUNTED = {"mha_packed_qkv", "mha_whole_head", "render_views", "rasterize_tiled", "probe_grid",
           "crop_observed", "padded_stem", "conv_epilogue"}


def test_the_registry_holds_the_counted_wrappers():
    """``cuda_build.COUNTERS`` is the one list of counted wrappers: each
    registers itself where it is defined, under its own name."""
    from foundationpose_cpp_tpu_torch.models import networks
    from foundationpose_cpp_tpu_torch.ops import (
        attention, crop, cuda_build, epilogue, probe_grid, rasterize_tiled,
    )

    assert set(cuda_build.COUNTERS) == COUNTED
    for module in (attention, render, rasterize_tiled, probe_grid, crop, epilogue, networks):
        for name in COUNTED & set(vars(module)):
            assert cuda_build.COUNTERS[name] is getattr(module, name)
            assert isinstance(cuda_build.COUNTERS[name].launches, int)


def test_the_program_layer_imports_none_of_the_layers_it_runs():
    """pipeline/programs.py reads the registry, so it imports no model and
    no kernel wrapper: of ``ops``, only ``cuda_build``."""
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(programs.__file__).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    port = sorted(m for m in imported if m.startswith("foundationpose_cpp_tpu_torch."))
    assert "foundationpose_cpp_tpu_torch.ops.cuda_build" in port
    for name in port:
        assert not name.startswith("foundationpose_cpp_tpu_torch.models"), name
        assert (not name.startswith("foundationpose_cpp_tpu_torch.ops")
                or name == "foundationpose_cpp_tpu_torch.ops.cuda_build"), name


def test_a_wrapper_registered_during_a_capture_shifts_no_other_count(fake_graphs, monkeypatch):
    """The capture's counts are keyed by name: a wrapper first registered
    while a program is captured counts from 0, and the others keep theirs."""
    from foundationpose_cpp_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "COUNTERS", dict(cuda_build.COUNTERS))
    calls = []

    def late_kernel():
        late_kernel.launches += 3

    def fn(x):
        calls.append(1)
        if len(calls) == 2:  # the capture
            cuda_build.counted(late_kernel)
        if "late_kernel" in cuda_build.COUNTERS:
            late_kernel()
        return _counted_double(x)

    program = programs.Program(fn, ("late",), "cpu")
    before = render.render_views.launches
    program(torch.ones(3))
    assert program.launches_per_call == {"render_views": 2, "late_kernel": 3}
    assert render.render_views.launches == before + 2 and late_kernel.launches == 0
    program(torch.ones(3))
    assert render.render_views.launches == before + 4 and late_kernel.launches == 3


def test_failed_capture_raises_with_key(monkeypatch):
    monkeypatch.setattr(programs, "graphs_for", lambda device: FakeGraphs(fail=True))
    program = programs.Program(_counted_double, ("register", "cube", (120, 160), 1, False), "cpu")
    before = render.render_views.launches
    with pytest.raises(RuntimeError, match=r"'register', 'cube'.*capture failed"):
        program(torch.ones(3))
    assert render.render_views.launches == before + 2 and not program.captured


def test_bucket_program_reads_bucket_buffers_in_place(nets, scenes, fake_graphs):
    """With the graph stand-in, one bucketed Register and one Track program
    serve both sizes, reading the bucket's buffers in place, and give the
    eager programs' results."""
    eager, graphed = _port(nets, BUCKETS), _port(nets, BUCKETS)
    for hw in SIZES + SIZES[:1]:
        pose, rgb, depth, mask = scenes[hw]
        with graphs(None):
            want = (eager.register_with_scores(rgb, depth, mask, "cube"),
                    eager.track(rgb, depth, pose, "cube"))
        got = (graphed.register_with_scores(rgb, depth, mask, "cube"),
               graphed.track(rgb, depth, pose, "cube"))
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], want[1])
    assert fake_graphs.captures == 2 and fake_graphs.replays == 4
    program = graphed._register_cache[("register", "cube", BUCKETS[0], 1, True)]
    bufs = graphed._bucket_buffers[BUCKETS[0]]
    assert [t.data_ptr() for t in program._inputs] == [
        bufs["rgb"].data_ptr(), bufs["depth"].data_ptr(), bufs["mask"].data_ptr(),
        graphed._bucket_extents[BUCKETS[0]].data_ptr()]


def test_packed_step_and_core_programs(nets, scenes, fake_graphs):
    """The packed step is one program a key, shared by the steps made for
    it, and chains like the eager step; the core has one program a padded
    shape and gives the eager net's outputs."""
    model = _port(nets)
    pose, rgb, depth, _ = scenes[SIZES[0]]
    step = model.make_packed_tracker("cube", SIZES[0])
    assert model.make_packed_tracker("cube", SIZES[0]).program is step.program
    assert list(model._packed_cache) == [("packed", "cube", SIZES[0], 1, "u16mm", False)]
    packed = torch.from_numpy(model.pack_frame(rgb, depth))
    chain, p = [], torch.from_numpy(pose)
    for _ in range(3):
        p = step(packed, p)
        chain.append(p)
    with graphs(None):
        want, q = [], torch.from_numpy(pose)
        for _ in range(3):
            q = step(packed, q)
            want.append(q)
    for g, w in zip(chain, want):
        assert torch.equal(g, w)
    core = create_refiner_core(
        convert_jax.params_from_jax(jax.tree.map(np.asarray, nets[0])), device="cpu",
        dtype=torch.float32)
    core.buckets = (2, 4)
    rng = np.random.default_rng(0)
    for n in (1, 3, 2, 4, 3):
        a, b = (rng.uniform(size=(n, 32, 32, 6)).astype(np.float32) for _ in range(2))
        got = core.infer({"render_input": a, "transf_input": b})
        pad = (0, 0, 0, 0, 0, 0, 0, (2 if n <= 2 else 4) - n)
        with torch.inference_mode():
            want = core.net(torch.nn.functional.pad(torch.from_numpy(a), pad),
                            torch.nn.functional.pad(torch.from_numpy(b), pad))
        for k in ("trans", "rot"):
            assert torch.equal(got[k], want[k][:n])
    assert sorted(k[1][0] for k in core._programs) == [2, 4]


def test_cpu_programs_launch_no_epilogue_kernel(nets, scenes, fake_graphs):
    """On the CPU the nets keep each conv's bias and PyTorch's ReLU and
    residual add, so a captured Register or Track program launches the
    convolution epilogue's kernel 0 times a call (18 and 9 on the card)."""
    from foundationpose_cpp_tpu_torch.ops import epilogue

    model = _port(nets)
    pose, rgb, depth, mask = scenes[SIZES[0]]
    before = epilogue.conv_epilogue.launches
    for _ in range(2):  # the capture, then a replay
        model.register(rgb, depth, mask, "cube")
        model.track(rgb, depth, pose, "cube")
    for cache in (model._register_cache, model._track_cache):
        (program,) = cache.values()
        assert program.captured and "conv_epilogue" not in program.launches_per_call
    assert epilogue.conv_epilogue.launches == before
