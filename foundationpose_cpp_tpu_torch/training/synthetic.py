"""Synthetic render-and-compare training for the refiner/scorer nets.

Counterpart of ``foundationpose_cpp_tpu.training.synthetic``. The reference
ships pre-trained engines and no training code; this module trains the exact
published topology (``models/networks.py``) the way the original was
trained: render-and-compare on synthetic pose-perturbed views. The data
generator reuses the inference pipeline's own ops (the render kernel through
``render_branch``, the crop warps, the pointcloud threshold), so the training
distribution is the inference distribution.

Refiner supervision inverts ``apply_refine_delta``: the target is exactly
the (trans, rot) output that moves the hypothesis onto the ground truth.
Scorer supervision is a per-scene listwise softmax over K hypotheses against
soft labels exp(-ADD/tau).

Every random draw comes from an explicit ``torch.Generator``; each batch
builder is a sampler (``sample_refiner_poses``, ``sample_scorer_poses``)
and a builder from given poses (``refiner_batch``, ``scorer_batch``), so the
builders are held against the JAX ones on fixed poses. A step builds its
batch under ``torch.no_grad()`` (JAX's ``stop_gradient``): on the card the
render kernel runs twice a step, once for the observed frames and once for
the hypothesis crops. The nets train in f32 with ``attn_impl="plain"`` (the
attention kernel is forward-only, as the JAX trainers force ``"xla"``),
under ``torch.optim.AdamW`` with optax's warmup-cosine schedule. On the
card the whole step is a captured program (``train_net``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.ops import pointcloud, warp
from foundationpose_cpp_tpu_torch.pipeline.programs import Program
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants, render_branch


@dataclasses.dataclass(frozen=True)
class SyntheticTrainConfig:
    """Knobs of the synthetic data distribution and the optimizer (the JAX
    package's defaults; see its module for why each has its value)."""

    # camera of the synthetic scenes: square frame, object fills ~half of it
    frame_hw: int = 160
    focal: float = 450.0
    tz_range: tuple[float, float] = (0.45, 0.75)
    xy_frac: float = 0.06  # |x/z|, |y/z| <= this (stays in frame)

    # refiner perturbations (hypothesis = perturbed ground truth)
    rot_max_deg: float = 25.0
    trans_frac: float = 0.3  # |t_err| <= frac * diameter/2 per axis

    # scorer hypothesis spread: post-refine residuals, the register grid's
    # nearest-rotation gap and far-off poses (symmetry flips)
    scorer_rot_max_deg: float = 180.0
    scorer_trans_frac: float = 0.5
    # magnitudes u^power * max: power 2 concentrates samples at small errors
    scorer_angle_power: float = 2.0
    # fraction drawn uniformly from [far_min, max] degrees instead
    scorer_far_frac: float = 0.25
    scorer_far_min_deg: float = 90.0
    # fraction replaced by exact principal-axis flips of the ground truth
    scorer_sym_frac: float = 0.15
    hyps_per_scene: int = 8
    score_tau: float = 0.05  # soft-label temperature, units of diameter

    batch: int = 64  # refiner scenes per step (scorer: batch//hyps_per_scene)
    lr: float = 2e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 100
    steps_per_call: int = 10  # steps per log line; steps round up to a multiple
    add_points: int = 256  # mesh-vertex subsample for ADD labels


def default_intrinsics(tcfg: SyntheticTrainConfig) -> np.ndarray:
    s = tcfg.frame_hw
    return np.array(
        [[tcfg.focal, 0.0, s / 2], [0.0, tcfg.focal, s / 2], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


# ---------------------------------------------------------------------------
# pose sampling (on the generator's device)


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _random_rotations(gen: torch.Generator, n: int) -> torch.Tensor:
    """Uniform random rotations via normalized quaternions -> (n, 3, 3)."""
    q = torch.randn((n, 4), generator=gen, device=gen.device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def sample_scene_poses(gen: torch.Generator, n: int, tcfg: SyntheticTrainConfig) -> torch.Tensor:
    """n random object-in-camera ground-truth poses inside the frustum."""
    poses = torch.eye(4, device=gen.device).repeat(n, 1, 1)
    poses[:, :3, :3] = _random_rotations(gen, n)
    tz = _uniform(gen, (n,), *tcfg.tz_range)
    xy = _uniform(gen, (n, 2), -tcfg.xy_frac, tcfg.xy_frac) * tz[:, None]
    poses[:, :2, 3] = xy
    poses[:, 2, 3] = tz
    return poses


def perturb_poses(
    gen: torch.Generator,
    gt_poses: torch.Tensor,
    rot_max_deg: float,
    trans_frac: float,
    diameter: float,
    angle_power: float = 1.0,
    far_frac: float = 0.0,
    far_min_deg: float = 90.0,
) -> torch.Tensor:
    """Hypotheses = ground truth with bounded rotation/translation noise.

    Rotation noise is applied on the LEFT (camera frame), the refiner's
    delta convention R' = dR^T R. angle_power > 1 concentrates magnitudes
    near zero (u^power * max); far_frac replaces that fraction of draws with
    uniform [far_min_deg, rot_max_deg] angles (symmetry-flip negatives).
    """
    n = gt_poses.shape[0]
    axis = torch.randn((n, 3), generator=gen, device=gen.device)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-9)
    u = _uniform(gen, (n, 1))
    ang = (u ** angle_power) * math.radians(rot_max_deg)
    take_far = None
    if far_frac > 0.0:
        far = _uniform(gen, (n, 1), math.radians(far_min_deg), math.radians(rot_max_deg))
        take_far = _uniform(gen, (n, 1)) < far_frac
        ang = torch.where(take_far, far, ang)
    d_rot = transforms.axis_angle_to_matrix(axis * ang)
    t_noise_raw = _uniform(gen, (n, 3), -trans_frac, trans_frac) * (diameter / 2.0)
    t_noise = t_noise_raw
    if angle_power != 1.0:
        t_noise = t_noise * (u ** (angle_power - 1.0))
        # far-angle negatives keep full-range translation error
        if take_far is not None:
            t_noise = torch.where(take_far, t_noise_raw, t_noise)
    hyp = gt_poses.clone()
    hyp[:, :3, :3] = torch.einsum("nij,njk->nik", d_rot, gt_poses[:, :3, :3])
    hyp[:, :3, 3] = gt_poses[:, :3, 3] + t_noise
    return hyp


def principal_flip_poses(
    gen: torch.Generator,
    gt_poses: torch.Tensor,
    diameter: float,
    residual_rot_deg: float = 12.0,
    residual_trans_frac: float = 0.15,
) -> torch.Tensor:
    """Hypotheses at exact 90/180/270-degree OBJECT-frame principal-axis
    flips of the ground truth (right-multiplied, as the reference's symmetry
    transforms), with a small residual perturbation: for boxes these are the
    silhouette-identical flips only the texture tells apart."""
    n = gt_poses.shape[0]
    axes = torch.eye(3, device=gen.device)[torch.randint(0, 3, (n,), generator=gen, device=gen.device)]
    quarter = torch.randint(1, 4, (n, 1), generator=gen, device=gen.device)
    r_flip = transforms.axis_angle_to_matrix(axes * (quarter.float() * (math.pi / 2.0)))
    flipped = gt_poses.clone()
    flipped[:, :3, :3] = torch.einsum("nij,njk->nik", gt_poses[:, :3, :3], r_flip)
    return perturb_poses(gen, flipped, residual_rot_deg, residual_trans_frac, diameter,
                         angle_power=2.0)


def refine_targets(
    gt_poses: torch.Tensor, hyp_poses: torch.Tensor, diameter: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The refiner output that maps hyp -> gt under apply_refine_delta.

    apply_refine_delta does t' = t + trans*(d/2), R' = A(tanh(rot)*c)^T R,
    so A = R_hyp R_gt^T and the rotation target (radians, before the tanh
    squash) is log(R_hyp R_gt^T). Returns (trans (N,3), rotvec (N,3)).
    """
    t_target = (gt_poses[:, :3, 3] - hyp_poses[:, :3, 3]) / (diameter / 2.0)
    a = torch.einsum("nij,nkj->nik", hyp_poses[:, :3, :3], gt_poses[:, :3, :3])
    return t_target, transforms.matrix_to_axis_angle(a)


# ---------------------------------------------------------------------------
# synthetic observations


def render_observed(
    mesh: MeshConstants,
    gt_poses: torch.Tensor,
    K: torch.Tensor,
    h: int,
    w: int,
    cfg: FoundationPoseConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render N observed frames at the gt poses -> (rgb (N,h,w,3) u8, depth
    (N,h,w) f32): the whole frame as the crop window, one render launch.
    Depth comes back from the render's diameter-normalized xyz channels."""
    n = gt_poses.shape[0]
    bbox = transforms._constant((0.0, 0.0, float(w), float(h)), gt_poses.device).expand(n, 4)
    clip = transforms.pose_clip_matrix(gt_poses, bbox, K, h, w, cfg.znear, cfg.zfar)
    out6 = render_branch(mesh, gt_poses, clip, h, w, cfg)
    rgb = torch.round(torch.clamp(out6[..., :3], 0.0, 1.0) * 255.0).to(torch.uint8)
    xyz_ds = out6[..., 3:6]
    fg = torch.any(xyz_ds != 0.0, dim=-1)
    z = xyz_ds[..., 2] * (mesh.diameter / 2.0) + gt_poses[:, 2, 3][:, None, None]
    return rgb, torch.where(fg, z, torch.zeros_like(z))


def _model_inputs(
    mesh: MeshConstants,
    hyp_poses: torch.Tensor,
    rgb_obs: torch.Tensor,
    depth_obs: torch.Tensor,
    K: torch.Tensor,
    crop_ratio: float,
    cfg: FoundationPoseConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(render_input, transf_input) for N (scene, hypothesis) pairs: unlike
    ``render_and_transform`` (one image, N poses) every hypothesis crops its
    OWN observed frame (rgb_obs (N,H,W,3), depth_obs (N,H,W))."""
    ch, cw = cfg.crop_window_h, cfg.crop_window_w
    h, w = rgb_obs.shape[1:3]
    tfs = transforms.compute_crop_window_tf(hyp_poses, K, (ch, cw), crop_ratio, mesh.diameter)
    bbox = transforms.construct_bbox2d(tfs, ch, cw)
    clip = transforms.pose_clip_matrix(hyp_poses, bbox, K, h, w, cfg.znear, cfg.zfar)
    render_in = render_branch(mesh, hyp_poses, clip, ch, cw, cfg)
    xyz = depth_ops.depth_to_xyz(depth_obs, K, cfg.min_depth)
    rc = warp.warp_crop_linear_u8(rgb_obs, tfs, ch, cw)
    xc = warp.warp_crop_nearest_f32(xyz, tfs, ch, cw)
    xc = pointcloud.threshold_and_downscale_pointcloud(
        xc, hyp_poses, mesh.diameter / 2.0, cfg.min_depth, cfg.max_depth
    )
    return render_in, pointcloud.concat_channels(rc, xc)


# ---------------------------------------------------------------------------
# batches


def sample_refiner_poses(
    gen: torch.Generator, tcfg: SyntheticTrainConfig, diameter: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(gt, hyp), each (batch, 4, 4), for one refiner batch."""
    gt = sample_scene_poses(gen, tcfg.batch, tcfg)
    return gt, perturb_poses(gen, gt, tcfg.rot_max_deg, tcfg.trans_frac, diameter)


def refiner_batch(
    mesh: MeshConstants,
    gt: torch.Tensor,
    hyp: torch.Tensor,
    K: torch.Tensor,
    cfg: FoundationPoseConfig,
    tcfg: SyntheticTrainConfig,
) -> dict[str, torch.Tensor]:
    """A refiner batch of (scene, hypothesis) pairs from given poses."""
    rgb_obs, depth_obs = render_observed(mesh, gt, K, tcfg.frame_hw, tcfg.frame_hw, cfg)
    render_in, transf_in = _model_inputs(mesh, hyp, rgb_obs, depth_obs, K,
                                         cfg.refine_crop_ratio, cfg)
    t_t, rv_t = refine_targets(gt, hyp, mesh.diameter)
    return {"render_input": render_in, "transf_input": transf_in,
            "trans_target": t_t, "rotvec_target": rv_t}


def sample_scorer_poses(
    gen: torch.Generator, tcfg: SyntheticTrainConfig, diameter: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(gt (S,4,4), hyp (S*K,4,4)): S = batch // hyps_per_scene scenes of K
    hypotheses, hypothesis j of scene s at row s*K + j."""
    k = tcfg.hyps_per_scene
    s = max(1, tcfg.batch // k)
    gt = sample_scene_poses(gen, s, tcfg)
    gt_rep = gt.repeat_interleave(k, dim=0)
    hyp = perturb_poses(
        gen, gt_rep, tcfg.scorer_rot_max_deg, tcfg.scorer_trans_frac, diameter,
        angle_power=tcfg.scorer_angle_power, far_frac=tcfg.scorer_far_frac,
        far_min_deg=tcfg.scorer_far_min_deg,
    )
    if tcfg.scorer_sym_frac > 0.0:
        # texture-only-distinguishable hard negatives
        sym_hyp = principal_flip_poses(gen, gt_rep, diameter)
        take = _uniform(gen, (gt_rep.shape[0], 1, 1)) < tcfg.scorer_sym_frac
        hyp = torch.where(take, sym_hyp, hyp)
    return gt, hyp


def add_points(mesh: MeshConstants, n: int) -> torch.Tensor:
    """The fixed vertex subsample the ADD labels are measured on."""
    return mesh.vertices[:: max(1, mesh.vertices.shape[0] // n)]


def scorer_batch(
    mesh: MeshConstants,
    gt: torch.Tensor,
    hyp: torch.Tensor,
    K: torch.Tensor,
    cfg: FoundationPoseConfig,
    tcfg: SyntheticTrainConfig,
    pts: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """S scenes x K hypotheses with soft ADD labels, from given poses.
    ``pts``: the ADD points (default ``add_points(mesh, tcfg.add_points)``)."""
    k = tcfg.hyps_per_scene
    s = gt.shape[0]
    rgb_obs, depth_obs = render_observed(mesh, gt, K, tcfg.frame_hw, tcfg.frame_hw, cfg)
    render_in, transf_in = _model_inputs(
        mesh, hyp, rgb_obs.repeat_interleave(k, dim=0), depth_obs.repeat_interleave(k, dim=0),
        K, cfg.score_crop_ratio, cfg,
    )
    if pts is None:
        pts = add_points(mesh, tcfg.add_points)
    gt_rep = gt.repeat_interleave(k, dim=0)
    p_gt = torch.einsum("nij,pj->npi", gt_rep[:, :3, :3], pts) + gt_rep[:, None, :3, 3]
    p_hy = torch.einsum("nij,pj->npi", hyp[:, :3, :3], pts) + hyp[:, None, :3, 3]
    add = torch.linalg.norm(p_hy - p_gt, dim=-1).mean(dim=-1).reshape(s, k)
    labels = torch.softmax(-add / (tcfg.score_tau * mesh.diameter), dim=-1)
    return {"render_input": render_in, "transf_input": transf_in, "labels": labels, "add": add}


@dataclasses.dataclass(frozen=True)
class BatchSource:
    """Where a trainer's batches come from, split where JAX's ``run_chunk``
    splits a step from its keys: ``sample(gen) -> (obj, poses)`` draws on the
    host, from the trainer's CPU generator, the step's object (an index, 0
    for one mesh) and its poses (a tuple of CPU tensors); ``build(obj,
    *poses) -> batch`` builds that object's batch from the poses on the
    device, inside the step's program."""

    sample: Callable[[torch.Generator], tuple[int, tuple[torch.Tensor, ...]]]
    build: Callable[..., dict[str, torch.Tensor]]


def refiner_source(
    mesh: MeshConstants, K: torch.Tensor, cfg: FoundationPoseConfig, tcfg: SyntheticTrainConfig,
) -> BatchSource:
    """Refiner batches of one mesh: JAX's ``make_refiner_batch``, split."""
    return BatchSource(
        lambda gen: (0, sample_refiner_poses(gen, tcfg, mesh.diameter)),
        lambda obj, gt, hyp: refiner_batch(mesh, gt, hyp, K, cfg, tcfg))


def scorer_source(
    mesh: MeshConstants, K: torch.Tensor, cfg: FoundationPoseConfig, tcfg: SyntheticTrainConfig,
) -> BatchSource:
    """Scorer batches of one mesh: JAX's ``make_scorer_batch``, split."""
    return BatchSource(
        lambda gen: (0, sample_scorer_poses(gen, tcfg, mesh.diameter)),
        lambda obj, gt, hyp: scorer_batch(mesh, gt, hyp, K, cfg, tcfg))


# ---------------------------------------------------------------------------
# losses


def refiner_loss(
    net: networks.RefineNet, batch: dict[str, torch.Tensor], rot_normalizer: float,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    out = net(batch["render_input"], batch["transf_input"])
    l_t = torch.mean((out["trans"] - batch["trans_target"]) ** 2)
    # supervise the squashed rotation (what apply_refine_delta consumes);
    # targets beyond the tanh range saturate toward +-1
    rv_unit = torch.clamp(batch["rotvec_target"] / rot_normalizer, -0.999, 0.999)
    l_r = torch.mean((torch.tanh(out["rot"]) - rv_unit) ** 2)
    return l_t + l_r, {"loss_trans": l_t, "loss_rot": l_r}


def scorer_loss(
    net: networks.ScoreNet, batch: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    s, k = batch["labels"].shape
    # MultiPair: attend within each scene's K hypotheses only
    out = net(batch["render_input"], batch["transf_input"],
              group_size=k if net.att_cross is not None else None)
    logits = out["scores"].reshape(s, k)
    ce = -torch.sum(batch["labels"] * F.log_softmax(logits, dim=-1), dim=-1)
    # rank quality: fraction of scenes where argmax(score) = argmin(ADD)
    top1 = torch.mean((logits.argmax(-1) == batch["add"].argmin(-1)).float())
    return ce.mean(), {"top1": top1}


# ---------------------------------------------------------------------------
# optimizer and training loops


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
    decay_steps)``: linear from 0 to lr over warmup_steps, then a cosine to 0
    at decay_steps."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return (0.0 - lr) * (1.0 - step / warmup_steps) + lr
        span = decay_steps - warmup_steps
        count = min(step - warmup_steps, span)
        return lr * (0.5 * (1.0 + math.cos(math.pi * count / span)))

    return schedule


def make_optimizer(net: torch.nn.Module, tcfg: SyntheticTrainConfig) -> torch.optim.AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight
    decay on every parameter, the position table included, as optax decays
    every leaf; the trainer sets the learning rate before each step
    (``set_lr``). On the card it is ``capturable``, its learning rate a 0-d
    device tensor, so that a captured step reads the rate of each replay."""
    device = next(net.parameters()).device
    cuda = device.type == "cuda"
    return torch.optim.AdamW(
        net.parameters(), lr=torch.zeros((), device=device) if cuda else 0.0,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=tcfg.weight_decay, capturable=cuda)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next step: written into a device tensor by a
    fill kernel (no host synchronization), or set as a number."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def _step_body(net, opt, loss_fn, build: Callable, obj: int) -> Callable:
    """One optimizer step on object ``obj`` from its poses: the batch under
    no_grad, the loss, the gradients into the standing ``.grad`` tensors
    and the AdamW update; returns (loss, aux), detached."""

    def step(*poses):
        with torch.no_grad():
            batch = build(obj, *poses)
        loss, aux = loss_fn(net, batch)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def train_net(
    kind: str,
    net_cfg: networks.NetConfig,
    source: BatchSource,
    loss_fn: Callable[[Any, dict[str, torch.Tensor]], tuple[torch.Tensor, dict]],
    tcfg: SyntheticTrainConfig,
    steps: int,
    seed: int,
    device,
    log: Callable[[str], None] | None = None,
    init: dict[str, torch.Tensor] | None = None,
    on_step: Callable[[int, torch.Tensor], None] | None = None,
) -> networks._Backbone:
    """The training loop shared by every trainer: a net of ``kind`` at
    ``net_cfg`` with the plain attention, in f32 on ``device``, from the
    state_dict ``init`` (a fine-tune) or seeded random weights; ``steps``
    rounded up to a multiple of steps_per_call, the schedule over the
    rounded count (as the JAX trainer); a log line per steps_per_call steps.
    ``on_step(i, loss)`` sees every step's loss tensor. Returns the trained
    f32 module.

    The step is a ``Program`` in the shape of JAX's ``run_chunk``. The host
    draws each step's object and poses (``source.sample``, a CPU generator:
    the same stream on every device), and one program a (kind, object) runs
    the batch builder, the loss, the backward pass and the AdamW update. On
    the card a program's first call runs the step once and captures it as a
    CUDA graph (the capture runs nothing), and every later call replays it:
    one step a call. The poses go up as non-blocking copies from pinned
    memory into device buffers that the programs read in place, and the
    learning rate is a device tensor (``make_optimizer``, ``set_lr``), so the
    loop waits for the card only at its log lines. A capture that fails
    raises with the program's key; nothing runs the step eagerly on the
    card. On the CPU the programs run eagerly.

    JAX jits one executable over the family's padded tables; the port
    renders each mesh exactly, so a mesh's face count is part of its
    program, and a multi-object trainer keeps one program for each object,
    all in one memory pool (their replays run in turn on one stream)."""
    cfg_t = dataclasses.replace(net_cfg, attn_impl="plain")
    net = networks.init_net(kind, cfg_t, seed)
    if init is not None:
        net.load_state_dict({k: v.float() for k, v in init.items()}, strict=True)
    device = torch.device(device)
    net = net.to(device).float().train()
    spc = max(1, tcfg.steps_per_call)
    steps_run = -(-steps // spc) * spc
    if steps_run != steps and log is not None:
        log(f"rounding steps {steps} -> {steps_run} (multiple of steps_per_call={spc})")
    steps = steps_run
    schedule = warmup_cosine(tcfg.lr, tcfg.warmup_steps, max(steps, tcfg.warmup_steps + 1))
    opt = make_optimizer(net, tcfg)
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    step_programs: dict[int, Program] = {}
    pose_bufs: list[torch.Tensor] = []  # on the card: the poses of the next step

    def upload(poses: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
        if device.type != "cuda":
            return poses
        if not pose_bufs:
            pose_bufs.extend(torch.empty(p.shape, dtype=p.dtype, device=device) for p in poses)
        for buf, p in zip(pose_bufs, poses):
            # the pinned block is reused only once its copy has run (the
            # host allocator records an event for it)
            buf.copy_(p.pin_memory(), non_blocking=True)
        return tuple(pose_bufs)

    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    for i in range(steps):
        obj, poses = source.sample(gen)
        program = step_programs.get(obj)
        if program is None:
            program = step_programs[obj] = Program(
                _step_body(net, opt, loss_fn, source.build, obj), ("train", kind, obj), device,
                pool=pool, buffers=range(len(poses)))
        set_lr(opt, schedule(i))
        loss, aux = program(*upload(poses))
        if on_step is not None:
            on_step(i, loss)
        if log is not None and (i + 1) % spc == 0:
            aux_s = ", ".join(f"{k}={float(v):.4f}" for k, v in aux.items())
            rate = (i + 1) / (time.perf_counter() - t0)
            log(f"step {i + 1}/{steps}  loss={float(loss):.4f}  {aux_s}  ({rate:.1f} steps/s)")
    return net.eval()


def _intrinsics(K, tcfg: SyntheticTrainConfig, device) -> torch.Tensor:
    return torch.as_tensor(K if K is not None else default_intrinsics(tcfg),
                           dtype=torch.float32, device=device)


def train_refiner(
    mesh: MeshConstants,
    cfg: FoundationPoseConfig,
    net_cfg: networks.NetConfig,
    tcfg: SyntheticTrainConfig,
    steps: int = 2000,
    seed: int = 0,
    K: np.ndarray | None = None,
    log: Callable[[str], None] | None = None,
) -> networks.RefineNet:
    """Train RefineNet on synthetic pairs of ``mesh``, on the mesh's device;
    returns the f32 module."""
    dev = mesh.vertices.device
    Kt = _intrinsics(K, tcfg, dev)
    return train_net(
        "refiner", net_cfg, refiner_source(mesh, Kt, cfg, tcfg),
        lambda net, batch: refiner_loss(net, batch, cfg.rot_normalizer),
        tcfg, steps, seed, dev, log,
    )


def train_scorer(
    mesh: MeshConstants,
    cfg: FoundationPoseConfig,
    net_cfg: networks.NetConfig,
    tcfg: SyntheticTrainConfig,
    steps: int = 2000,
    seed: int = 1,
    K: np.ndarray | None = None,
    log: Callable[[str], None] | None = None,
) -> networks.ScoreNet:
    """Train ScoreNet on synthetic K-way ranking of ``mesh``; returns the f32
    module."""
    dev = mesh.vertices.device
    Kt = _intrinsics(K, tcfg, dev)
    return train_net(
        "scorer", net_cfg, scorer_source(mesh, Kt, cfg, tcfg),
        scorer_loss, tcfg, steps, seed, dev, log,
    )


def save_bf16(net: torch.nn.Module, path: str) -> None:
    """Save a trained module as the training tools do, an npz in the JAX
    package's format: tensors of two or more dimensions (convs, linears,
    heads, the position table) in bf16, the rest f32, as the JAX tools'
    ``to_bf16``."""
    convert_jax.save_npz(
        {k: (v.detach().to(torch.bfloat16) if v.dim() >= 2 else v.detach().float()).cpu()
         for k, v in net.state_dict().items()}, path)
