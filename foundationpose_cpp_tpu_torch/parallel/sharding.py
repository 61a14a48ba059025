"""Multi-card scale-out: shard the hypothesis axis over the ranks of a
``torch.distributed`` process group, one rank per card.

Counterpart of ``foundationpose_cpp_tpu.parallel.sharding``'s ``shard_map``
path. Every per-hypothesis stage of Register (crop windows, the render
kernel, crops, refiner, scorer) is parallel over the hypotheses; the
per-image front end (depth filters, translation guess) is cheap and runs
replicated on every rank. Each rank renders, refines and scores its own
contiguous shard of the grid through the same kernels as ``register_step``,
and the only traffic between ranks is all-gathers: the scorer's pooled
embeddings for its cross-attention (``networks.all_gather_rows``), then the
refined poses and the scores for the argmax. ``track_batch`` shards its
instances the same way and gathers the refined poses once.

252 is not a multiple of most rank counts, so ``pad_grid`` pads the grid
with identity rotations and a ``valid`` mask; the pad rows score -inf
before the argmax. As in the JAX package they still take part in the
scorer's cross-attention.

JAX jits both builders' functions and retraces them for each new argument
shape. The port does the same where a CUDA graph can hold the whole
function: one rank (W=1), over NCCL on its card, keeps a
``pipeline.programs.Program`` for each argument signature, captured once
with its all-gathers and replayed (on the CPU the programs run eagerly).
With more ranks the builders run eagerly: gloo's collectives cannot be
captured, and NCCL capture needs a card for each rank, which a one-card
host does not have.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.models import networks
from foundationpose_cpp_tpu_torch.models.networks import all_gather_rows
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import (
    prepare_register,
    refine_and_score,
    refine_loop,
)
from foundationpose_cpp_tpu_torch.pipeline.programs import Program
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HypGroup:
    """The ranks that split the hypotheses: ``group`` is the process group,
    ``rank`` this process's place in it, ``size`` the number of ranks and
    ``device`` this rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    def close(self) -> None:
        dist.destroy_process_group(self.group)


def make_hyp_group(
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    device=None,
) -> HypGroup:
    """Join the process group of the hypothesis split (counterpart of
    ``make_hyp_mesh``).

    ``rank`` and ``world_size`` default to the ``RANK`` and ``WORLD_SIZE``
    that ``torchrun`` sets, ``init_method`` to ``env://`` (its
    ``MASTER_ADDR`` and ``MASTER_PORT``). ``device`` None means the card
    ``cuda:{LOCAL_RANK % device_count}`` and raises without one;
    ``device="cpu"`` runs the plain versions on the CPU. The backend is NCCL
    when each rank of the host has a card of its own (``LOCAL_WORLD_SIZE``,
    default the world size, at most the card count), and gloo when ranks
    share a card or run on the CPU: NCCL refuses two ranks on one device.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device is None:
        resolve_device(None)  # raises without a card
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
    device = resolve_device(device)
    own_card = device.type == "cuda" and local_world <= torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return HypGroup(dist.group.WORLD, rank, world_size, device, backend)


def pad_grid(rot_grid: np.ndarray, n_ranks: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad an (M,4,4) grid with identity rotations to a multiple of
    ``n_ranks``; returns (grid, valid), valid False on the pad rows."""
    m = rot_grid.shape[0]
    pad = (-m) % n_ranks
    valid = np.ones((m + pad,), dtype=bool)
    if pad:
        filler = np.tile(np.eye(4, dtype=rot_grid.dtype), (pad, 1, 1))
        rot_grid = np.concatenate([rot_grid, filler], axis=0)
        valid[m:] = False
    return rot_grid, valid


def _shard(group: HypGroup, n: int) -> slice:
    m = n // group.size
    return slice(group.rank * m, (group.rank + 1) * m)


def _programs(group: HypGroup) -> dict | None:
    """A builder's programs, {(nets..., key): Program}, when its function
    runs as programs: one rank over NCCL, or on the CPU (where a Program
    calls its function eagerly); None (eager) for more ranks."""
    if group.size == 1 and (group.backend == "nccl" or group.device.type == "cpu"):
        return {}
    return None


def _call(programs: dict, device, body, nets: tuple, key: tuple, args: tuple):
    """``body(*nets, *args)`` through the program of (nets, key), made on
    first use; the program's closure holds the nets, whose parameters its
    graph reads by address."""
    program = programs.get((*nets, key))
    if program is None:
        program = programs[(*nets, key)] = Program(lambda *a: body(*nets, *a), key, device)
    return program(*args)


def make_sharded_register(
    mesh_consts: MeshConstants,
    group: HypGroup,
    K,
    refine_itr: int,
    cfg: FoundationPoseConfig,
):
    """Register sharded over the hypothesis axis.

    Returns ``fn(refiner, scorer, rgb, depth, mask, rot_grid_padded,
    hyp_valid) -> (best_pose, poses (M,4,4), scores (M,), ok)``, the same on
    every rank; rot_grid_padded and hyp_valid come from
    ``pad_grid(grid, group.size)``. Each rank refines and scores rows
    ``[rank * M / size, (rank + 1) * M / size)``; three all-gathers a
    Register with a cross-attention scorer (pooled embeddings, poses,
    scores), two without.

    At W=1 over NCCL ``fn`` keeps one program for each (refiner, scorer,
    M, frame (h, w)), under the key ``("sharded_register", M, (h, w),
    refine_itr)``: its first call runs the Register and captures it with
    its all-gathers, later calls replay it. ``fn.programs`` holds them
    (None when ``fn`` runs eagerly: W>1, see the module docstring). The mask
    is taken as ``mask > 0``, all that the Register reads of it.
    """
    K = torch.as_tensor(K, dtype=torch.float32, device=group.device)
    programs = _programs(group)

    def register(refiner, scorer, rgb, depth, mask, rot_grid, hyp_valid):
        n = rot_grid.shape[0]
        poses, xyz_map, ok = prepare_register(depth, mask, rot_grid, K, cfg)
        shard = _shard(group, n)
        poses, scores = refine_and_score(
            mesh_consts, refiner, scorer, poses[shard], rgb, xyz_map, K, refine_itr, cfg,
            scorer_group=group.group,
        )
        scores = torch.where(hyp_valid[shard], scores, float("-inf"))
        poses = all_gather_rows(poses, group.group)
        scores = all_gather_rows(scores, group.group)
        best = torch.argmax(scores)
        pose = poses.index_select(0, best.reshape(1))[0]
        best_pose = torch.where(ok, pose, torch.full_like(pose, float("nan")))
        return best_pose, poses, scores, ok

    @torch.inference_mode()
    def fn(refiner: networks.RefineNet, scorer: networks.ScoreNet, rgb, depth, mask, rot_grid,
           hyp_valid):
        n = rot_grid.shape[0]
        if n % group.size or hyp_valid.shape[0] != n:
            raise ValueError(
                f"[sharding] rot_grid ({n}) must be a multiple of the group "
                f"size ({group.size}) with hyp_valid the same length "
                f"({hyp_valid.shape[0]}); use pad_grid(grid, {group.size})"
            )
        args = (rgb, depth, mask > 0, torch.as_tensor(rot_grid, device=rgb.device),
                torch.as_tensor(hyp_valid, device=rgb.device))
        if programs is None:
            return register(refiner, scorer, *args)
        key = ("sharded_register", n, tuple(rgb.shape[:2]), refine_itr)
        return _call(programs, group.device, register, (refiner, scorer), key, args)

    fn.programs = programs
    return fn


def make_sharded_track_batch(
    mesh_consts: MeshConstants,
    group: HypGroup,
    K,
    refine_itr: int,
    cfg: FoundationPoseConfig,
):
    """Multi-instance Track sharded over the instance axis.

    ``fn(refiner, rgb, depth, poses (N,4,4)) -> (N,4,4)``, the same on every
    rank; N must be a multiple of the group size. The refiner has no
    cross-instance term, so the one all-gather assembles the result.

    At W=1 over NCCL ``fn`` keeps one program for each (refiner, N, frame
    (h, w)), under the key ``("sharded_track_batch", N, (h, w),
    refine_itr)``, in ``fn.programs`` (None when ``fn`` runs eagerly: W>1,
    see the module docstring).
    """
    K = torch.as_tensor(K, dtype=torch.float32, device=group.device)
    programs = _programs(group)

    def track(refiner, rgb, depth, poses):
        xyz_map = depth_ops.depth_to_xyz(depth, K, cfg.min_depth)
        local = refine_loop(mesh_consts, refiner, poses[_shard(group, poses.shape[0])], rgb,
                            xyz_map, K, refine_itr, cfg)
        return all_gather_rows(local, group.group)

    @torch.inference_mode()
    def fn(refiner: networks.RefineNet, rgb, depth, poses):
        n = poses.shape[0]
        if n % group.size:
            raise ValueError(
                f"[sharding] instance count ({n}) must be a multiple of the "
                f"group size ({group.size}); pad with identity poses and drop "
                f"the extras"
            )
        if programs is None:
            return track(refiner, rgb, depth, poses)
        key = ("sharded_track_batch", n, tuple(rgb.shape[:2]), refine_itr)
        return _call(programs, group.device, track, (refiner,), key, (rgb, depth, poses))

    fn.programs = programs
    return fn
