"""The trainers' step and the W=1 sharded builders as programs, on the CPU.

On the card each is captured once as a CUDA graph and replayed. Here the
card's bookkeeping runs with the stand-in for the graph of
tests/graph_standin.py, on small f32 nets (the widths of
tests/test_torch_programs.py):

- three training steps through the step programs equal three eager steps
  at atol 0 (losses, parameters, AdamW state), for the refiner on one mesh
  and for the multi-object scorer on two family objects (one program each),
  under a schedule whose learning rate changes every step. The stand-in's
  capture runs the step and then puts the parameters, gradients and AdamW
  state back, because a real capture runs nothing;
- in an in-process gloo group of one rank, the sharded Register and Track
  through their programs equal the same builders run eagerly and
  ``register_step`` / ``track_step``.

The JAX parity of the trainers is in tests/test_torch_training.py, of the
split in tests/test_torch_sharding.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import icosphere
from foundationpose_cpp_tpu_torch.meshio import family, procedural
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.parallel import sharding
from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.training import multi
from foundationpose_cpp_tpu_torch.training import synthetic as tr
from foundationpose_cpp_tpu_torch.utils import synthetic

from .graph_standin import FakeGraphs, graphs, one_thread  # noqa: F401 (a fixture)

NET = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32)
CFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
# the learning rate of steps 0, 1, 2: 0, lr / 3, 2 lr / 3
TCFG = tr.SyntheticTrainConfig(frame_hw=64, focal=180.0, batch=4, hyps_per_scene=2,
                               steps_per_call=1, lr=1e-3, warmup_steps=3)
STEPS = 3
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
HW = (120, 160)


@pytest.fixture(scope="module")
def bank():
    return multi.build_mesh_bank([family.random_family_asset(s) for s in range(2)], device="cpu")


def _train(monkeypatch, bank, kind, standin):
    """(trained net, its optimizer, the step losses) with ``standin`` as the
    graph backend (None: eager programs)."""
    made = []
    make = tr.make_optimizer
    monkeypatch.setattr(tr, "make_optimizer", lambda net, tcfg: made.append(make(net, tcfg))
                        or made[-1])
    if standin is not None:
        standin.optimizers = made
    losses = []
    with graphs(standin):
        if kind == "refiner":
            net = tr.train_net("refiner", NET, tr.refiner_source(
                bank.meshes[0], torch.from_numpy(tr.default_intrinsics(TCFG)), CFG, TCFG),
                lambda n, b: tr.refiner_loss(n, b, CFG.rot_normalizer), TCFG, STEPS, 0, "cpu",
                on_step=lambda i, loss: losses.append(loss))
        else:
            net = multi.train_scorer_multi(bank, CFG, dataclasses.replace(NET, cross_attention=True),
                                           TCFG, steps=STEPS, seed=0,
                                           on_step=lambda i, loss: losses.append(loss))
    return net, made[-1], losses


@pytest.mark.parametrize("kind, captures", [("refiner", 1), ("scorer", 2)],
                         ids=["refiner", "scorer_multi"])
def test_step_programs_equal_eager_steps(monkeypatch, bank, kind, captures):
    """The scorer's two objects are drawn in the order 0, 1, 1: two
    programs, the second replayed once; the refiner's one program is
    replayed twice."""
    standin = FakeGraphs()
    net, opt, losses = _train(monkeypatch, bank, kind, standin)
    eager_net, eager_opt, eager_losses = _train(monkeypatch, bank, kind, None)
    assert standin.captures == captures and standin.replays == STEPS - captures
    assert len(losses) == STEPS and all(torch.equal(a, b) for a, b in zip(losses, eager_losses))
    assert len({float(loss) for loss in losses}) == STEPS
    want = eager_net.state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    for p, q in zip(opt.param_groups[0]["params"], eager_opt.param_groups[0]["params"]):
        state, eager_state = opt.state[p], eager_opt.state[q]
        assert set(state) == set(eager_state) == {"step", "exp_avg", "exp_avg_sq"}
        assert float(state["step"]) == STEPS
        for k in state:
            assert torch.equal(state[k], eager_state[k]), k


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A one-rank gloo group on the CPU, the cube scene, small nets."""
    group = sharding.make_hyp_group(f"file://{tmp_path_factory.mktemp('rdv')}/rendezvous", 0, 1,
                                    device="cpu")
    try:
        mesh = MeshConstants.from_asset(procedural.textured_cube(size=0.1), "cpu")
        pose = synthetic.default_pose(tz=0.5)
        frame = synthetic.render_scene(mesh, pose, K, *HW, CFG)
        yield dict(group=group, mesh=mesh, pose=pose,
                   frame=[torch.from_numpy(a) for a in frame],
                   refiner=networks.init_net("refiner", NET, 0),
                   scorer=networks.init_net("scorer", dataclasses.replace(
                       NET, cross_attention=True), 1))
    finally:
        group.close()


def test_sharded_register_program_equals_eager_and_register_step(split):
    mesh, group = split["mesh"], split["group"]
    grid, valid = sharding.pad_grid(icosphere.make_rotation_grid(12, 120), 1)  # 36 poses
    grid, valid = torch.from_numpy(grid), torch.from_numpy(valid)
    args = (split["refiner"], split["scorer"], *split["frame"], grid, valid)
    fn = sharding.make_sharded_register(mesh, group, K, 1, CFG)
    with graphs(FakeGraphs()) as standin:
        got = [fn(*args) for _ in range(2)]
    with graphs(None):
        eager = sharding.make_sharded_register(mesh, group, K, 1, CFG)(*args)
    with torch.inference_mode():
        single = fpp.register_step(mesh, *args[:6], torch.from_numpy(K), 1, CFG,
                                   hyp_valid=valid)
    assert list(fn.programs) == [(split["refiner"], split["scorer"],
                                  ("sharded_register", 36, HW, 1))]
    assert standin.captures == 1 and standin.replays == 1
    for g in got:
        for a, b, c in zip(g, eager, single):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_sharded_track_program_equals_eager_and_track_step(split):
    mesh, group = split["mesh"], split["group"]
    poses = torch.from_numpy(np.stack([split["pose"]] * 3))
    poses[:, :3, 3] += torch.linspace(0.0, 0.01, 3)[:, None]
    rgb, depth, _ = split["frame"]
    fn = sharding.make_sharded_track_batch(mesh, group, K, 1, CFG)
    with graphs(FakeGraphs()) as standin:
        got = fn(split["refiner"], rgb, depth, poses)
        got = fn(split["refiner"], rgb, depth, got)  # a replay, chained
    with graphs(None):
        eager = sharding.make_sharded_track_batch(mesh, group, K, 1, CFG)
        want = eager(split["refiner"], rgb, depth, eager(split["refiner"], rgb, depth, poses))
    with torch.inference_mode():
        single = poses
        for _ in range(2):
            single = fpp.track_step(mesh, split["refiner"], rgb, depth, single,
                                    torch.from_numpy(K), 1, CFG)
    assert list(fn.programs) == [(split["refiner"], ("sharded_track_batch", 3, HW, 1))]
    assert standin.captures == 1 and standin.replays == 1
    assert torch.equal(got, want) and torch.equal(got, single)
