"""The port's synthetic trainers against the JAX package's, on the CPU.

Sizes of tests/test_training.py:24-30 (crop 32, 64x64 frames, widths
8/8/16). The two packages draw from different generators, so nothing here
compares random streams: poses are drawn once and handed to both.

- Batch builders on fixed poses (the JAX builders are given the same poses
  by replacing their samplers for the call): ``render_observed`` and the
  model inputs at the render budget of tests/test_torch_render.py (under 1%
  of pixels off by more than 2e-3), targets, ADD and labels at 1e-5; the
  batched warps bit for bit against the one-frame ones.
- Losses from the same parameters (``params_from_jax``) and the same batch
  at rtol 1e-4; gradients against ``jax.grad`` at relative L2 under 1e-3 per
  leaf; three AdamW steps against ``optax.adamw`` under the same schedule
  (step 0 at learning rate 0) at 1e-6 relative.
- The JAX suite's trainer tests, ported: the loss falls, the scorer runs,
  att_cross stays within its group, exact principal flips, bounded
  perturbations, targets that invert ``apply_refine_delta``; a multi-bank
  run; the forward-only guard and the plain attention's gradients; every
  new module imported with jax, optax and onnx blocked.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from foundationpose_cpp_tpu import networks as jnet
from foundationpose_cpp_tpu.config import FoundationPoseConfig as JConfig
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.ops import warp as jwarp
from foundationpose_cpp_tpu.pipeline.renderer import MeshConstants as JMesh
from foundationpose_cpp_tpu.training import synthetic as jtr
from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import family, procedural
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import cuda_build, warp
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.training import multi
from foundationpose_cpp_tpu_torch.training import synthetic as tr

CFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32)
JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = tr.SyntheticTrainConfig(frame_hw=64, focal=180.0, batch=4, hyps_per_scene=4,
                               steps_per_call=2)
JTCFG = jtr.SyntheticTrainConfig(frame_hw=64, focal=180.0, batch=4, hyps_per_scene=4,
                                 steps_per_call=2)
NET = networks.NetConfig(width1=8, width2=8, embed_dim=16, num_heads=2, ffn_dim=16, crop_hw=32)
JNET = jnet.NetConfig(width1=8, width2=8, embed_dim=16, num_heads=2, ffn_dim=16, crop_hw=32,
                      dtype=jnp.float32, attn_impl="xla")
K_NP = tr.default_intrinsics(TCFG)
K = torch.from_numpy(K_NP)


@pytest.fixture(scope="module")
def meshes():
    return (MeshConstants.from_asset(procedural.textured_cube(size=0.1), device="cpu"),
            JMesh.from_asset(jproc.textured_cube(size=0.1)))


def _bad_frac(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.ndim == want.ndim and got.shape[-1] in (3, 6):
        return float((np.abs(got - want).max(axis=-1) > 2e-3).mean())
    return float((np.abs(got - want) > 2e-3).mean())


def _refiner_poses(seed, n=4):
    gen = torch.Generator().manual_seed(seed)
    return tr.sample_refiner_poses(gen, dataclasses.replace(TCFG, batch=n), 0.1)


def _jax_batch(monkeypatch, make, jmesh, gt, hyp, tcfg):
    """A JAX batch built from the given poses: its samplers return them."""
    monkeypatch.setattr(jtr, "sample_scene_poses", lambda key, n, t: jnp.asarray(gt.numpy()))
    monkeypatch.setattr(jtr, "perturb_poses", lambda key, g, *a, **k: jnp.asarray(hyp.numpy()))
    monkeypatch.setattr(jtr, "principal_flip_poses", lambda key, g, *a, **k: jnp.asarray(hyp.numpy()))
    batch = jax.jit(lambda key: make(jmesh, key, jnp.asarray(K_NP), JCFG, tcfg))(
        jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in batch.items()}


def _jax_render_observed(jmesh, gt):
    return jax.jit(lambda g: jtr.render_observed(jmesh, g, jnp.asarray(K_NP), 64, 64, JCFG))(
        jnp.asarray(gt.numpy()))


# ---------------------------------------------------------------------------
# batch builders on fixed poses


def test_render_observed_matches_jax(meshes):
    mesh, jmesh = meshes
    gt, _ = _refiner_poses(0)
    rgb, depth = tr.render_observed(mesh, gt, K, 64, 64, CFG)
    jrgb, jdepth = _jax_render_observed(jmesh, gt)
    assert rgb.dtype == torch.uint8 and rgb.shape == (4, 64, 64, 3)
    assert (depth > 0).float().mean() > 0.02
    assert _bad_frac(rgb.float() / 255.0, np.asarray(jrgb, np.float32) / 255.0) < 0.01
    assert _bad_frac(depth, jdepth) < 0.01


def test_model_inputs_match_jax(meshes):
    """The same observed frames through both packages' model inputs."""
    mesh, jmesh = meshes
    gt, hyp = _refiner_poses(1)
    jrgb, jdepth = _jax_render_observed(jmesh, gt)
    r_in, t_in = tr._model_inputs(mesh, hyp, torch.from_numpy(np.array(jrgb)),
                                  torch.from_numpy(np.array(jdepth)), K, 1.2, CFG)
    jr, jt = jax.jit(lambda h, r, d: jtr._model_inputs(jmesh, h, r, d, jnp.asarray(K_NP), 1.2,
                                                       JCFG, None, False))(
        jnp.asarray(hyp.numpy()), jrgb, jdepth)
    assert r_in.shape == t_in.shape == (4, 32, 32, 6)
    assert _bad_frac(r_in, jr) < 0.01
    assert _bad_frac(t_in, jt) < 0.01
    fg = (t_in[..., 3:] != 0).any(-1).float().mean()
    assert fg > 0.02


def test_batched_warps_equal_one_frame_warps():
    """Pose i of a batched warp reads frame i, bit for bit as the one-frame
    warp of that frame alone (the JAX trainer vmaps that warp)."""
    rng = np.random.default_rng(3)
    rgb = torch.from_numpy(rng.integers(0, 256, size=(3, 40, 48, 3), dtype=np.uint8))
    xyz = torch.from_numpy(rng.normal(size=(3, 40, 48, 3)).astype(np.float32))
    tfs = torch.tensor([[[0.8, 0.05, -3.0], [-0.02, 0.9, 2.5], [0, 0, 1]],
                        [[1.1, 0.0, 1.5], [0.0, 1.2, -4.0], [0, 0, 1]],
                        [[0.7, -0.1, 5.0], [0.1, 0.75, 0.5], [0, 0, 1]]], dtype=torch.float32)
    lin = warp.warp_crop_linear_u8(rgb, tfs, 24, 20)
    near = warp.warp_crop_nearest_f32(xyz, tfs, 24, 20)
    for i in range(3):
        assert torch.equal(lin[i], warp.warp_crop_linear_u8(rgb[i], tfs[i:i + 1], 24, 20)[0])
        assert torch.equal(near[i], warp.warp_crop_nearest_f32(xyz[i], tfs[i:i + 1], 24, 20)[0])
        j = jwarp.warp_crop_linear_u8(jnp.asarray(rgb[i].numpy()), jnp.asarray(tfs[i:i + 1].numpy()),
                                      24, 20)
        np.testing.assert_array_equal(lin[i].numpy(), np.asarray(j)[0])


def test_refiner_batch_matches_jax(meshes, monkeypatch):
    mesh, jmesh = meshes
    gt, hyp = _refiner_poses(2)
    got = tr.refiner_batch(mesh, gt, hyp, K, CFG, TCFG)
    want = _jax_batch(monkeypatch, jtr.make_refiner_batch, jmesh, gt, hyp, JTCFG)
    assert set(got) == set(want)
    for k in ("render_input", "transf_input"):
        assert got[k].shape == want[k].shape
        assert _bad_frac(got[k], want[k]) < 0.01, k
    for k in ("trans_target", "rotvec_target"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, rtol=0, err_msg=k)


def test_scorer_batch_matches_jax(meshes, monkeypatch):
    mesh, jmesh = meshes
    gen = torch.Generator().manual_seed(4)
    gt, hyp = tr.sample_scorer_poses(gen, TCFG, mesh.diameter)
    assert gt.shape == (1, 4, 4) and hyp.shape == (4, 4, 4)
    got = tr.scorer_batch(mesh, gt, hyp, K, CFG, TCFG)
    want = _jax_batch(monkeypatch, jtr.make_scorer_batch, jmesh, gt, hyp, JTCFG)
    for k in ("render_input", "transf_input"):
        assert _bad_frac(got[k], want[k]) < 0.01, k
    for k in ("labels", "add"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["labels"].sum(-1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# losses, gradients, optimizer


def _nets(cross=False):
    jcfg = dataclasses.replace(JNET, cross_attention=cross)
    jparams = (jnet.init_scorer(1, jcfg) if cross else jnet.init_refiner(0, jcfg))
    sd = convert_jax.params_from_jax(jax.tree.map(np.asarray, jparams))
    kind = "scorer" if cross else "refiner"
    cfg = dataclasses.replace(convert_jax.net_config_from_state_dict(sd, num_heads=2),
                              attn_impl="plain")
    net = {"refiner": networks.RefineNet, "scorer": networks.ScoreNet}[kind](cfg)
    net.load_state_dict(sd)
    return net, jparams, jcfg


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads_match(net, jgrads, zero=()):
    """Relative L2 under 1e-3 per leaf. The leaves in ``zero`` have a
    gradient that is zero analytically (a shift that moves every score of a
    scene alike leaves the per-scene softmax unchanged), so both sides hold
    f32 rounding noise there: those must stay under 1e-6 of the whole
    gradient's norm instead."""
    port = convert_jax.params_to_jax({k: p.grad for k, p in net.named_parameters()})
    got = jax.tree_util.tree_leaves_with_path(port)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    total = np.sqrt(sum(float(np.sum(np.asarray(w) ** 2)) for _, w in want))
    for (path, g), (_, w) in zip(got, want):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name in zero:
            assert max(np.linalg.norm(g.numpy()), np.linalg.norm(np.asarray(w))) < 1e-6 * total, name
        else:
            assert _rel_l2(g.numpy(), np.asarray(w)) < 1e-3, name


def test_refiner_loss_and_gradients_match_jax(meshes):
    mesh, _ = meshes
    gt, hyp = _refiner_poses(5)
    batch = tr.refiner_batch(mesh, gt, hyp, K, CFG, TCFG)
    net, jparams, jcfg = _nets()
    loss, aux = tr.refiner_loss(net, batch, CFG.rot_normalizer)
    loss.backward()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jtr.refiner_loss, has_aux=True),
                                    static_argnums=(2, 3))(jparams, jbatch, jcfg,
                                                           JCFG.rot_normalizer)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-4)
    _grads_match(net, jgrads)


def test_scorer_loss_and_gradients_match_jax(meshes):
    """Two scenes of four hypotheses, att_cross grouped by scene."""
    mesh, _ = meshes
    tcfg = dataclasses.replace(TCFG, batch=8)
    gt, hyp = tr.sample_scorer_poses(torch.Generator().manual_seed(6), tcfg, mesh.diameter)
    batch = tr.scorer_batch(mesh, gt, hyp, K, CFG, tcfg)
    assert batch["labels"].shape == (2, 4)
    net, jparams, jcfg = _nets(cross=True)
    loss, aux = tr.scorer_loss(net, batch)
    loss.backward()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jtr.scorer_loss, has_aux=True),
                                    static_argnums=(2,))(jparams, jbatch, jcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    assert float(aux["top1"]) == float(jaux["top1"])
    _grads_match(net, jgrads, zero=("att_cross/ln2_b", "head_scores/b"))


def test_warmup_cosine_equals_optax():
    """Equal to optax's schedule to its f32 evaluation: a few f32 ulps of
    the value, and of lr where the cosine nears zero (the port's schedule is
    in double precision)."""
    for lr, warm, decay in ((2e-4, 100, 2000), (1e-3, 10, 60), (1e-2, 2, 5)):
        ours = tr.warmup_cosine(lr, warm, decay)
        theirs = optax.warmup_cosine_decay_schedule(0.0, lr, warm, decay)
        assert ours(0) == 0.0 == float(theirs(0))
        for step in range(0, decay + 3):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-5, atol=1e-6 * lr)


def test_three_adamw_steps_match_optax():
    """Identical parameters and identical gradients: torch AdamW under the
    port's schedule equals optax.adamw under optax's, step 0 at lr 0."""
    net, jparams, _ = _nets()
    tcfg = dataclasses.replace(TCFG, lr=1e-2, weight_decay=0.1, warmup_steps=2)
    schedule = tr.warmup_cosine(tcfg.lr, tcfg.warmup_steps, 5)
    opt = tr.make_optimizer(net, tcfg)
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, tcfg.lr, tcfg.warmup_steps, 5),
                       weight_decay=tcfg.weight_decay)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(7)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    for step in range(3):
        grads = {k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
                 for k, p in net.named_parameters()}
        for k, p in net.named_parameters():
            p.grad = grads[k].clone()
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        jg = jax.tree.map(lambda t: jnp.asarray(t.numpy()), convert_jax.params_to_jax(grads))
        updates, jstate = jupdate(jg, jstate, jparams)
        jparams = jax.jit(optax.apply_updates)(jparams, updates)
        if step == 0:
            for k, p in net.named_parameters():
                assert torch.equal(p.detach(), before[k]), k
    got = jax.tree_util.tree_leaves_with_path(
        convert_jax.params_to_jax({k: p.detach() for k, p in net.named_parameters()}))
    want = jax.tree_util.tree_leaves_with_path(jparams)
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=str(path))


# ---------------------------------------------------------------------------
# the JAX suite's trainer tests, ported


def test_refine_targets_invert_apply_refine_delta(meshes):
    mesh, _ = meshes
    gen = torch.Generator().manual_seed(3)
    gt = tr.sample_scene_poses(gen, 8, TCFG)
    hyp = tr.perturb_poses(gen, gt, 15.0, 0.3, mesh.diameter)
    t_t, rv_t = tr.refine_targets(gt, hyp, mesh.diameter)
    assert float(rv_t.abs().max()) < CFG.rot_normalizer
    rot_raw = torch.atanh(rv_t / CFG.rot_normalizer)
    recovered = transforms.apply_refine_delta(hyp, t_t, rot_raw, mesh.diameter, CFG.rot_normalizer)
    np.testing.assert_allclose(recovered.numpy(), gt.numpy(), atol=1e-4)


def test_perturb_poses_bounded(meshes):
    mesh, _ = meshes
    gen = torch.Generator().manual_seed(4)
    gt = tr.sample_scene_poses(gen, 32, TCFG)
    hyp = tr.perturb_poses(gen, gt, 20.0, 0.25, mesh.diameter)
    t_err = (hyp[:, :3, 3] - gt[:, :3, 3]).abs().numpy()
    assert t_err.max() <= 0.25 * mesh.diameter / 2 + 1e-6
    trace = torch.einsum("nij,nij->n", hyp[:, :3, :3], gt[:, :3, :3]).numpy()
    ang = np.degrees(np.arccos(np.clip((trace - 1) / 2, -1, 1)))
    assert ang.max() <= 20.0 + 1e-3
    tz = gt[:, 2, 3].numpy()
    assert tz.min() >= TCFG.tz_range[0] and tz.max() <= TCFG.tz_range[1]


def test_principal_flip_poses_exact_flips():
    gen = torch.Generator().manual_seed(3)
    gt = tr.sample_scene_poses(gen, 16, tr.SyntheticTrainConfig())
    hyp = tr.principal_flip_poses(gen, gt, 0.1, residual_rot_deg=0.0,
                                  residual_trans_frac=0.0).numpy()
    gt = gt.numpy()
    np.testing.assert_allclose(hyp[:, :3, 3], gt[:, :3, 3], atol=1e-6)
    seen = set()
    for g, h in zip(gt, hyp):
        rel = g[:3, :3].T @ h[:3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))
        assert min(abs(ang - 90), abs(ang - 180)) < 0.1, ang
        seen.add(round(ang / 90) * 90)
        perm = np.abs(rel)
        np.testing.assert_allclose(perm.sum(0), 1.0, atol=1e-5)
        np.testing.assert_allclose(perm.sum(1), 1.0, atol=1e-5)
    assert seen == {90, 180}


def test_refiner_training_reduces_loss(meshes):
    """30 steps at lr 1e-3 after a 2-step warmup: the mean loss of the last
    10 steps is below that of the first 10, and the weights stay finite."""
    mesh, _ = meshes
    losses = []
    tcfg = dataclasses.replace(TCFG, batch=8, lr=1e-3, warmup_steps=2)
    net = tr.train_net(
        "refiner", NET, tr.refiner_source(mesh, K, CFG, tcfg),
        lambda n, b: tr.refiner_loss(n, b, CFG.rot_normalizer), tcfg, 30, 0, "cpu",
        on_step=lambda i, loss: losses.append(float(loss)),
    )
    assert len(losses) == 30
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert all(torch.isfinite(p).all() for p in net.parameters())


def test_scorer_training_runs_and_logs(meshes):
    mesh, _ = meshes
    lines = []
    net = tr.train_scorer(mesh, CFG, NET, TCFG, steps=3, seed=1, log=lines.append)
    assert lines[0] == "rounding steps 3 -> 4 (multiple of steps_per_call=2)"
    assert lines[1].startswith("step 2/4  loss=") and "  top1=" in lines[1]
    assert lines[-1].startswith("step 4/4  loss=") and lines[-1].endswith("steps/s)")
    assert all(torch.isfinite(p).all() for p in net.parameters())


def test_trainers_force_plain_attention(meshes):
    """Whatever attention the caller's NetConfig asks for, the trained net
    runs the plain, differentiable one (the kernels are forward-only)."""
    mesh, _ = meshes
    net = tr.train_refiner(mesh, CFG, NET, TCFG, steps=2, seed=0)
    assert net.cfg.attn_impl == "plain"
    assert all(layer.attn.plain for layer in net.encoder)


def test_scorer_cross_attention_grouping():
    """MultiPair cross-attention stays within a scene's hypothesis group."""
    cfg = dataclasses.replace(NET, cross_attention=True)
    net = networks.init_net("scorer", cfg, 0)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(size=(8, 32, 32, 6)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(8, 32, 32, 6)).astype(np.float32))
    with torch.no_grad():
        grouped = net(a, b, group_size=4)["scores"]
        s0 = net(a[:4], b[:4])["scores"]
        s1 = net(a[4:], b[4:])["scores"]
        np.testing.assert_allclose(grouped.numpy(), torch.cat([s0, s1]).numpy(), atol=1e-5)
        a2 = a.clone()
        a2[0] += 0.5
        pert = net(a2, b, group_size=4)["scores"]
    assert abs(float(pert[1, 0] - grouped[1, 0])) > 1e-6
    np.testing.assert_allclose(pert[4:].numpy(), grouped[4:].numpy(), atol=1e-5)
    # the ungrouped call attends across all 8: scene 1 sees scene 0
    with torch.no_grad():
        whole = net(a, b)["scores"]
    assert float((whole[4:] - grouped[4:]).abs().max()) > 1e-6


def test_multi_bank_training_two_objects():
    """A few steps of both multi trainers on two family objects: finite
    losses, every parameter moved, the scorer with att_cross."""
    bank = multi.build_mesh_bank([family.random_family_asset(s) for s in range(2)], device="cpu")
    init = networks.init_net("refiner", NET, 0)
    before = {k: v.clone() for k, v in init.state_dict().items()}
    losses = []
    tcfg = dataclasses.replace(TCFG, warmup_steps=1)
    net = multi.train_refiner_multi(bank, CFG, NET, tcfg, steps=4, init_params=init.state_dict(),
                                    log=lambda m: losses.append(float(m.split("loss=")[1].split()[0])))
    assert len(losses) == 2 and np.isfinite(losses).all()
    for k, v in net.state_dict().items():
        assert not torch.equal(v, before[k]), k
    scorer = multi.train_scorer_multi(bank, CFG, dataclasses.replace(NET, cross_attention=True),
                                      tcfg, steps=2)
    assert scorer.att_cross is not None
    assert all(torch.isfinite(p).all() for p in scorer.parameters())


def test_refuse_grad_and_plain_attention_gradients():
    """The forward-only guard raises on a tensor that requires a gradient
    under grad mode, not under no_grad; the plain attention carries
    gradients to the first convolution."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_build.refuse_grad(None, x, what="mha_packed_qkv")
    with torch.no_grad():
        cuda_build.refuse_grad(x, what="mha_packed_qkv")
    cuda_build.refuse_grad(torch.zeros(2), None, what="render_views")
    net = networks.init_net("refiner", dataclasses.replace(NET, attn_impl="plain"), 0)
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.uniform(size=(2, 32, 32, 6)).astype(np.float32)) for _ in range(2))
    out = net(a, b)
    (out["trans"].sum() + out["rot"].sum()).backward()
    assert net.encodeA["conv0"].weight.grad.abs().sum() > 0
    assert net.encoder[0].attn.qkv.weight.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="attn_impl"):
        networks.NetConfig(attn_impl="xla")


def test_evaluate_runs_register_and_track(meshes):
    """The tools' evaluate on the CPU at the test sizes: one scene through
    Register and three Track iterations, the JAX tool's keys."""
    from foundationpose_cpp_tpu_torch.tools.train_synthetic import evaluate

    ref = networks.init_net("refiner", NET, 0)
    sc = networks.init_net("scorer", NET, 1)
    r = evaluate(procedural.textured_cube(size=0.1), ref, sc, CFG, TCFG, 1, 0, device="cpu")
    for k in ("register_rot_deg", "register_adds", "tracked_rot_deg", "tracked_adds",
              "register_rot_deg_median", "register_flips", "n_scenes", "register_failures",
              "diameter"):
        assert k in r, k
    assert r["n_scenes"] == 1 and r["register_failures"] == 0
    assert ref.encodeA["conv0"].weight.dtype == torch.float32  # the caller's net is untouched


def test_new_modules_import_without_jax_optax_onnx():
    code = (
        "import sys\n"
        "for m in ('jax', 'optax', 'onnx', 'foundationpose_cpp_tpu'): sys.modules[m] = None\n"
        "import importlib\n"
        "for n in ('models.onnx_reader', 'models.onnx_recover', 'models.torch_ref',\n"
        "          'models.convert', 'models.checkpoint', 'models.convert_jax',\n"
        "          'meshio.family', 'training.synthetic', 'training.multi',\n"
        "          'tools.convert_onnx', 'tools.train_synthetic', 'tools.train_multi'):\n"
        "    importlib.import_module('foundationpose_cpp_tpu_torch.' + n)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and m.split('.')[0] in\n"
        "       ('jax', 'optax', 'onnx', 'foundationpose_cpp_tpu')]\n"
        "assert not bad, bad\n"
    )
    import pathlib

    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
