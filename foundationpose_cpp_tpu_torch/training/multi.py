"""Object-generalizable training: one refiner/scorer across a mesh family.

Counterpart of ``foundationpose_cpp_tpu.training.multi``. The reference's
engines are object-agnostic: one set of weights serves any mesh. This module
trains one refiner or scorer over a bank of family objects
(``meshio/family.py``), drawing one object per optimizer step with the
trainer's generator.

The JAX trainer stacks the family into padded tables of its TPU render
kernel; the port renders every object exactly with the render kernel, so the
bank is a list of per-object ``MeshConstants`` and the trainer keeps one step
program for each object. What the bank keeps of the
JAX one: the common-diameter contract (the whole pipeline is
diameter-normalized, so a common training diameter costs no generality) and
the ADD-label points, drawn from ``np.random.default_rng(0)`` as the JAX bank
draws them, so the labels of one object and one pose agree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.training import synthetic as single
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshBank:
    """The family's objects on the device, with their ADD-label points."""

    meshes: tuple[MeshConstants, ...]
    add_pts: torch.Tensor  # (O, P, 3) centered surface points for ADD labels
    diameter: float  # common family diameter
    names: tuple[str, ...]

    @property
    def n_objects(self) -> int:
        return len(self.meshes)


def build_mesh_bank(
    assets: Sequence[MeshAsset], add_points: int = 256, device=None,
) -> MeshBank:
    """The assets as one bank on ``device`` (None: the card). All assets must
    share one diameter (the family contract)."""
    device = resolve_device(device)
    diam = float(assets[0].diameter)
    for a in assets:
        if abs(float(a.diameter) - diam) > 1e-5:
            raise ValueError(
                f"[MeshBank] asset '{a.name}' diameter {a.diameter} != {diam}; "
                "the bank requires a common family diameter (meshio/family.py)"
            )
    rng = np.random.default_rng(0)
    pts = []
    for a in assets:
        centered = np.asarray(a.vertices) - np.asarray(a.model_center)[None]
        idx = rng.choice(centered.shape[0], size=add_points, replace=True)
        pts.append(centered[idx])
    return MeshBank(
        meshes=tuple(MeshConstants.from_asset(a, device) for a in assets),
        add_pts=torch.as_tensor(np.stack(pts), dtype=torch.float32, device=device),
        diameter=diam,
        names=tuple(a.name for a in assets),
    )


def bank_source(
    bank: MeshBank, K: torch.Tensor, cfg: FoundationPoseConfig,
    tcfg: single.SyntheticTrainConfig, kind: str,
) -> single.BatchSource:
    """Batches of one object a step: the host draws the object's index from
    the generator, then its poses; the step builds a refiner batch of that
    mesh, or a scorer batch labelled on the bank's ADD points. Each object's
    step is a program of its own (``single.train_net``)."""
    sample_poses = single.sample_refiner_poses if kind == "refiner" else single.sample_scorer_poses

    def sample(gen: torch.Generator):
        idx = int(torch.randint(bank.n_objects, (), generator=gen, device=gen.device))
        return idx, sample_poses(gen, tcfg, bank.meshes[idx].diameter)

    def build(idx: int, gt: torch.Tensor, hyp: torch.Tensor):
        mesh = bank.meshes[idx]
        if kind == "refiner":
            return single.refiner_batch(mesh, gt, hyp, K, cfg, tcfg)
        return single.scorer_batch(mesh, gt, hyp, K, cfg, tcfg, pts=bank.add_pts[idx])

    return single.BatchSource(sample, build)


def _train_multi(kind: str, loss: Callable, bank: MeshBank, cfg, net_cfg, tcfg, steps, seed, K,
                 log, init_params, on_step) -> networks._Backbone:
    device = bank.add_pts.device
    Kt = single._intrinsics(K, tcfg, device)
    return single.train_net(
        kind, net_cfg, bank_source(bank, Kt, cfg, tcfg, kind), loss, tcfg,
        steps, seed, device, log, init_params, on_step,
    )


def train_refiner_multi(
    bank: MeshBank,
    cfg: FoundationPoseConfig,
    net_cfg: networks.NetConfig,
    tcfg: single.SyntheticTrainConfig,
    steps: int = 8000,
    seed: int = 0,
    K: np.ndarray | None = None,
    log: Callable[[str], None] | None = None,
    init_params: dict[str, torch.Tensor] | None = None,
    on_step: Callable[[int, torch.Tensor], None] | None = None,
) -> networks.RefineNet:
    """Train ONE RefineNet across the bank; returns the f32 module.
    ``init_params`` (a state_dict of the net) fine-tunes; ``on_step(i, loss)``
    sees every step's loss."""
    return _train_multi(
        "refiner", lambda net, batch: single.refiner_loss(net, batch, cfg.rot_normalizer),
        bank, cfg, net_cfg, tcfg, steps, seed, K, log, init_params, on_step,
    )


def train_scorer_multi(
    bank: MeshBank,
    cfg: FoundationPoseConfig,
    net_cfg: networks.NetConfig,
    tcfg: single.SyntheticTrainConfig,
    steps: int = 5000,
    seed: int = 1,
    K: np.ndarray | None = None,
    log: Callable[[str], None] | None = None,
    init_params: dict[str, torch.Tensor] | None = None,
    on_step: Callable[[int, torch.Tensor], None] | None = None,
) -> networks.ScoreNet:
    """Train ONE ScoreNet(MultiPair) across the bank; returns the f32 module."""
    return _train_multi("scorer", single.scorer_loss, bank, cfg, net_cfg, tcfg, steps, seed, K,
                        log, init_params, on_step)
