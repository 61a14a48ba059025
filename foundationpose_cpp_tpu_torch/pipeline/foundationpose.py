"""FoundationPose: the public Register/Track pipeline on torch tensors.

Counterpart of ``foundationpose_cpp_tpu.pipeline.foundationpose``. Reference
API surface: Base6DofDetectionModel::{Register, Track}
(include/detection_6d_foundationpose/foundationpose.hpp:36-64) and the
orchestration in src/foundationpose.cpp:181-265. Input contracts preserved:
RGB uint8 image, float32 metric depth, uint8 binary mask (Register only),
intrinsics bound to the image geometry, per-mesh registry keyed by target
name, refine_itr (default 1), validation mirroring CheckInputArguments
(:155-179).

Everything after the frame's upload stays on the device: register reads
back only the best pose, and a failed translation guess rides in-band as a
NaN-poisoned pose, so a Register costs one host synchronization.

  register: depth filters -> translation guess -> 252-pose grid ->
            refine_itr x [render+crop -> refiner -> compose delta] ->
            render+crop(1.1) -> scorer -> argmax
  track:    depth_to_xyz -> refine_itr x [render+crop -> refiner -> compose]

Each entry point runs as a compiled program (``pipeline/programs.py``):
captured once as a CUDA graph on the card under the JAX package's cache
key, replayed after, run eagerly on the CPU. With
``FoundationPoseConfig.size_buckets`` a frame is copied into its size
bucket's device buffers (zeros beyond its real extent) and the real (h, w)
rides along as a device ``image_hw``, so one set of buffers and one program
serve every camera size in the bucket (reference README.md:20).
The steps mark their stages (``programs.stage``: front_end, render_crop,
refiner, pose_update, scorer, select; Track's xyz first), which time them
inside the graphs of the public calls' programs (the packed step's graph,
whose events nothing would read, carries none), and the public calls
record their host spans and copies in ``utils.profiling``'s recorder while
it is on.
``make_packed_tracker`` is the deployment fast path: one uint8 buffer in, a
device pose out, nothing read back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.config import DEFAULT_CONFIG, FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import icosphere, transforms
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.pipeline.programs import Program, stage
from foundationpose_cpp_tpu_torch.pipeline.renderer import (
    MeshConstants,
    MeshSet,
    MeshViews,
    render_and_transform,
)
from foundationpose_cpp_tpu_torch.utils import profiling
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


def refine_loop(
    mesh: MeshConstants | MeshViews,
    refiner: networks.RefineNet,
    poses: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    K: torch.Tensor,
    refine_itr: int,
    cfg: FoundationPoseConfig,
    image_hw: tuple | None = None,
) -> torch.Tensor:
    """refine_itr x [render -> refiner -> compose delta]
    (foundationpose.cpp:200-213). image_hw: the real (h, w) of a frame
    padded to a size bucket, numbers or 0-d f32 tensors on the device
    (None: the tensors' shape). ``MeshViews`` refine each pose on its own
    mesh."""
    for _ in range(refine_itr):
        stage("render_crop")
        render_in, transf_in = render_and_transform(
            mesh, poses, rgb, xyz_map, K, cfg.refine_crop_ratio, cfg, image_hw
        )
        stage("refiner")
        out = refiner(render_in, transf_in)
        stage("pose_update")
        poses = transforms.apply_refine_delta(
            poses, out["trans"], out["rot"], mesh.diameter, cfg.rot_normalizer
        )
    return poses


def prepare_register(
    depth: torch.Tensor,
    mask: torch.Tensor,
    rot_grid: torch.Tensor,
    K: torch.Tensor,
    cfg: FoundationPoseConfig,
    image_hw: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register front end: depth filters -> translation guess -> hypothesis
    poses, plus the raw-depth xyz map the crops sample. With image_hw the
    erosion treats pixels beyond the real extent as out of bounds; the
    bilateral filter and the translation guess already skip the padding's
    zero depth and mask.

    Returns (poses0 (M,4,4), xyz_map, ok).
    """
    df = cfg.depth_filter
    extent = None
    if image_hw is not None:
        hh, ww = depth.shape
        rows = torch.arange(hh, device=depth.device)[:, None]
        cols = torch.arange(ww, device=depth.device)[None, :]
        extent = (rows < image_hw[0]) & (cols < image_hw[1])
    eroded = depth_ops.erode_depth(
        depth, df.erode_radius, df.erode_depth_diff_thres, df.erode_ratio_thres, df.zfar,
        valid=extent,
    )
    filtered = depth_ops.bilateral_filter_depth(
        eroded, df.bilateral_radius, df.bilateral_sigma_d, df.bilateral_sigma_r,
        df.zfar, df.bilateral_mean_band,
    )
    center, ok = depth_ops.guess_translation(filtered, mask, K, cfg.min_depth)
    poses = rot_grid.clone()
    poses[:, :3, 3] = center[None, :]
    xyz_map = depth_ops.depth_to_xyz(depth, K, cfg.min_depth)
    return poses, xyz_map, ok


def refine_and_score(
    mesh: MeshConstants,
    refiner: networks.RefineNet,
    scorer: networks.ScoreNet,
    poses: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    K: torch.Tensor,
    refine_itr: int,
    cfg: FoundationPoseConfig,
    image_hw: tuple | None = None,
    scorer_group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Refine loop + score render + scorer: the part of Register that is
    parallel over the hypotheses, but for the scorer's cross-attention,
    which gathers the pooled embeddings over ``scorer_group`` when the
    poses are one rank's shard (``parallel.sharding``).
    Returns (poses (M,4,4), scores (M,))."""
    poses = refine_loop(mesh, refiner, poses, rgb, xyz_map, K, refine_itr, cfg, image_hw)
    stage("render_crop")
    render_in, transf_in = render_and_transform(
        mesh, poses, rgb, xyz_map, K, cfg.score_crop_ratio, cfg, image_hw
    )
    stage("scorer")
    out = scorer(render_in, transf_in, gather=scorer_group)
    return poses, out["scores"][:, 0]


def register_step(
    mesh: MeshConstants,
    refiner: networks.RefineNet,
    scorer: networks.ScoreNet,
    rgb: torch.Tensor,
    depth: torch.Tensor,
    mask: torch.Tensor,
    rot_grid: torch.Tensor,
    K: torch.Tensor,
    refine_itr: int,
    cfg: FoundationPoseConfig,
    image_hw: tuple | None = None,
    hyp_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full Register computation. Returns (best_pose, refined_poses,
    scores, ok); best_pose is NaN when the translation guess failed.
    image_hw: the real (h, w) of a frame padded to a size bucket.
    hyp_valid: (M,) bool, False on the rows that pad the grid
    (``parallel.sharding.pad_grid``); they score -inf before the argmax."""
    stage("front_end")
    poses, xyz_map, ok = prepare_register(depth, mask, rot_grid, K, cfg, image_hw)
    poses, scores = refine_and_score(
        mesh, refiner, scorer, poses, rgb, xyz_map, K, refine_itr, cfg, image_hw
    )
    stage("select")
    if hyp_valid is not None:
        scores = torch.where(hyp_valid, scores, float("-inf"))
    best = torch.argmax(scores)  # getMaxScoreIndex (thrust) equivalent
    # index_select keeps the index on the device (poses[best] reads it back)
    pose = poses.index_select(0, best.reshape(1))[0]
    best_pose = torch.where(ok, pose, torch.full_like(pose, float("nan")))
    return best_pose, poses, scores, ok


def track_step(
    mesh: MeshConstants | MeshViews,
    refiner: networks.RefineNet,
    rgb: torch.Tensor,
    depth: torch.Tensor,
    poses: torch.Tensor,
    K: torch.Tensor,
    refine_itr: int,
    cfg: FoundationPoseConfig,
    image_hw: tuple | None = None,
) -> torch.Tensor:
    """Track for a (N, 4, 4) batch of instances of one mesh (N=1: the
    reference Track), or of ``MeshViews``' meshes, one a pose. image_hw:
    the real (h, w) of a padded frame."""
    stage("xyz")
    xyz_map = depth_ops.depth_to_xyz(depth, K, cfg.min_depth)
    return refine_loop(mesh, refiner, poses, rgb, xyz_map, K, refine_itr, cfg, image_hw)


DEPTH_BYTES = {"u16mm": 2, "f32": 4}

# the target of a track_batch program over the catalog, in its cache key: a
# tuple, so no mesh name can take its place
CATALOG = ("catalog",)


def _check_depth_format(depth_format: str) -> None:
    if depth_format not in DEPTH_BYTES:
        raise ValueError(f"depth_format must be 'u16mm' or 'f32', got {depth_format!r}")


def upsample_rgb_half(small: torch.Tensor) -> torch.Tensor:
    """(h/2, w/2, 3) uint8 -> (h, w, 3) f32 by 2x bilinear upsampling with
    clamped edges: the values of the JAX package's
    ``jax.image.resize(..., method="linear")``."""
    hh, ww = small.shape[:2]
    planes = small.permute(2, 0, 1)[None].to(torch.float32)
    up = F.interpolate(planes, size=(2 * hh, 2 * ww), mode="bilinear", align_corners=False)
    return up[0].permute(1, 2, 0)


def unpack_frame(
    packed: torch.Tensor,
    frame_hw: tuple[int, int],
    depth_format: str = "u16mm",
    rgb_half: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One packed uint8 frame (``FoundationPose.pack_frame``'s layout) ->
    (rgb (h, w, 3) uint8, depth (h, w) f32 meters), on packed's device.

    An rgb_half colour plane is upsampled (``upsample_rgb_half``) and
    truncated to contiguous uint8 (as the crops take it), as the JAX
    package's CPU warp truncates it (``warp_crop_linear_u8``'s
    ``astype(uint32)``). u16mm depth is
    ``mm * 1e-3`` in f32, as in the JAX package.
    """
    h, w = frame_hw
    rgb_n = (h // 2) * (w // 2) * 3 if rgb_half else h * w * 3
    if rgb_half:
        rgb = upsample_rgb_half(packed[:rgb_n].reshape(h // 2, w // 2, 3)).to(
            torch.uint8, memory_format=torch.contiguous_format)
    else:
        rgb = packed[:rgb_n].reshape(h, w, 3)
    raw = packed[rgb_n:]
    if raw.storage_offset() % DEPTH_BYTES[depth_format]:
        # a dtype view needs an offset that is a multiple of the new size
        raw = raw.clone()
    if depth_format == "u16mm":
        mm = raw.view(torch.int16).to(torch.int32) & 0xFFFF
        depth = mm.to(torch.float32) * 1e-3
    else:
        depth = raw.view(torch.float32)
    return rgb, depth.reshape(h, w)


class FoundationPose:
    """Multi-mesh 6-DoF pose estimator (CreateFoundationPoseModel parity).

    refiner / scorer: a ``RefineNet`` / ``ScoreNet`` (which keeps its own
    ``NetConfig``, so narrow nets run unchanged), a state_dict from
    ``convert_jax``, or the path of a ``weights/*_full.npz`` checkpoint.
    device: None means "cuda" and raises RuntimeError when no card is
    present; pass device="cpu" for the plain PyTorch versions on the CPU.

    Register, Track, ``track_batch`` and the packed step run as programs
    (``programs.Program``) held in ``_register_cache`` / ``_track_cache``
    under the JAX package's keys, (kind, target, bucket or (h, w),
    refine_itr, [N,] bucketed), and the packed steps in ``_packed_cache``;
    on the card each is a CUDA graph captured on its first call, in one
    memory pool the model's graphs share. A ``track_batch`` over a sequence
    of names (one a pose) renders out of the model's catalog of every
    registered mesh (``MeshSet``, built on the first such call and kept in
    ``_catalog``; ``meshset_builds`` counts the builds, one a model): its
    key holds ``CATALOG`` in place of a name and N, never the names, which
    ride in as an (N,) int32 tensor of catalog indices. The graphs read
    the nets' parameters, the meshes, the catalog and the model's
    constants by address: ``load_state_dict`` on the nets is safe,
    replacing a net, a mesh or ``_K`` after a capture is not. The programs
    keep static buffers, so a model serves one calling thread at a time.
    """

    def __init__(
        self,
        refiner,
        scorer,
        mesh_assets: list[MeshAsset],
        intrinsic: np.ndarray,
        max_input_image_h: int = 1080,
        max_input_image_w: int = 1920,
        config: FoundationPoseConfig = DEFAULT_CONFIG,
        device=None,
    ) -> None:
        if not mesh_assets:
            raise ValueError("[FoundationPose] need at least one mesh asset")
        self._device = resolve_device(device)
        self._cfg = config
        dtype = torch.bfloat16 if config.use_bf16_models else torch.float32
        self._refiner = convert_jax.as_net(refiner, "refiner", self._device, dtype)
        self._scorer = convert_jax.as_net(scorer, "scorer", self._device, dtype)
        self._K = torch.as_tensor(np.asarray(intrinsic, np.float32), device=self._device)
        self._max_h = max_input_image_h
        self._max_w = max_input_image_w
        self._meshes: dict[str, MeshConstants] = {}
        self._assets: dict[str, MeshAsset] = {}
        for asset in mesh_assets:
            if asset.name in self._meshes:
                raise ValueError(f"[FoundationPose] duplicate mesh name '{asset.name}'")
            self._meshes[asset.name] = MeshConstants.from_asset(asset, self._device)
            self._assets[asset.name] = asset
        self._rot_grid = torch.as_tensor(
            icosphere.make_rotation_grid(config.n_views, config.inplane_step_deg),
            device=self._device,
        )
        # one set of device input buffers per size bucket: {(bh, bw): {name: tensor}}
        self._bucket_buffers: dict[tuple[int, int], dict[str, torch.Tensor]] = {}
        # the real (h, w) of the frame in each bucket, a (2,) f32 device buffer
        self._bucket_extents: dict[tuple[int, int], torch.Tensor] = {}
        self._register_cache: dict[tuple, Program] = {}
        self._track_cache: dict[tuple, Program] = {}
        self._packed_cache: dict[tuple, Program] = {}
        self._catalog: MeshSet | None = None
        self.meshset_builds = 0
        self._graph_pool = (torch.cuda.graph_pool_handle() if self._device.type == "cuda"
                            else None)

    @property
    def device(self) -> torch.device:
        return self._device

    # validation (CheckInputArguments, foundationpose.cpp:155-179)

    def _check_inputs(self, rgb, depth, mask, target_name) -> None:
        if rgb.shape[:2] != depth.shape[:2] or (
            mask is not None and mask.shape[:2] != depth.shape[:2]
        ):
            raise ValueError(
                f"[FoundationPose] rgb/depth/mask size mismatch: "
                f"{rgb.shape[:2]} vs {depth.shape[:2]}"
                + (f" vs {mask.shape[:2]}" if mask is not None else "")
            )
        if rgb.shape[0] > self._max_h or rgb.shape[1] > self._max_w:
            raise ValueError(
                f"[FoundationPose] image {rgb.shape[:2]} exceeds construction "
                f"max ({self._max_h}, {self._max_w})"
            )
        if target_name not in self._meshes:
            raise KeyError(
                f"[FoundationPose] unknown target '{target_name}'; registered: "
                f"{sorted(self._meshes)}"
            )
        if rgb.dtype != np.uint8:
            raise TypeError("[FoundationPose] rgb must be uint8 RGB")
        if depth.dtype != np.float32:
            raise TypeError("[FoundationPose] depth must be float32 meters")

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(a))
        out = src.to(self._device)
        profiling.count_upload(src, out)
        return out

    # size buckets (reference README.md:20 dynamic input sizes)

    def _bucket_for(self, h: int, w: int) -> tuple[int, int] | None:
        """Smallest configured bucket (by area) fitting (h, w); None when
        bucketing is off."""
        buckets = self._cfg.size_buckets
        if buckets is None:
            return None
        for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
            if bh >= h and bw >= w:
                return (int(bh), int(bw))
        raise ValueError(
            f"[FoundationPose] no size bucket fits ({h}, {w}); buckets={buckets}"
        )

    @staticmethod
    def _pad_to(arr: np.ndarray, bh: int, bw: int) -> np.ndarray:
        """Zero-pad an (h, w, ...) array at the bottom and right to (bh, bw, ...)."""
        h, w = arr.shape[:2]
        pad = [(0, bh - h), (0, bw - w)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(np.asarray(arr), pad)

    def _into_bucket(self, bucket: tuple[int, int], name: str, a: np.ndarray) -> torch.Tensor:
        """Copy ``a`` into the bucket's device buffer ``name``: zeros beyond
        its real extent, then the frame (the same tensor as
        ``_pad_to(a, *bucket)`` uploaded)."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        bufs = self._bucket_buffers.setdefault(bucket, {})
        buf = bufs.get(name)
        if buf is None or buf.dtype != src.dtype:
            buf = torch.zeros((*bucket, *src.shape[2:]), dtype=src.dtype, device=self._device)
            bufs[name] = buf
        h, w = src.shape[:2]
        buf[h:].zero_()
        buf[:h, w:].zero_()
        buf[:h, :w].copy_(src)
        profiling.count_upload(src, buf)
        return buf

    def _bucket_hw(self, bucket: tuple[int, int], h: int, w: int) -> torch.Tensor:
        """The bucket's (2,) f32 device buffer holding the real (h, w),
        written by two fills (no upload, no host synchronization)."""
        hw = self._bucket_extents.get(bucket)
        if hw is None:
            hw = self._bucket_extents[bucket] = torch.zeros(2, dtype=torch.float32,
                                                            device=self._device)
        hw[0].fill_(h)
        hw[1].fill_(w)
        return hw

    @torch.inference_mode()
    def _frame(self, *arrays: np.ndarray) -> tuple[list[torch.Tensor], tuple[int, int] | None]:
        """Upload one frame's images: as they are, or into their size
        bucket's buffers together with the real (h, w)."""
        h, w = arrays[0].shape[:2]
        bucket = self._bucket_for(h, w)
        if bucket is None:
            return [self._upload(a) for a in arrays], None
        names = ("rgb", "depth", "mask")
        return [self._into_bucket(bucket, n, a) for n, a in zip(names, arrays)], (h, w)

    @torch.inference_mode()
    def _frame_args(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """One frame as a program's arguments: its images (``_frame``),
        then, in a size bucket, the bucket's device (h, w)."""
        tensors, image_hw = self._frame(*arrays)
        if image_hw is None:
            return tensors
        return [*tensors, self._bucket_hw(self._bucket_for(*image_hw), *image_hw)]

    def _program(self, fn, key: tuple, buffers=(), staged=False) -> Program:
        return Program(fn, key, self._device, pool=self._graph_pool, buffers=buffers,
                       staged=staged)

    # traced program bodies, cached under the JAX package's keys

    def _register_program(self, key: tuple, mesh_name: str, refine_itr: int,
                          bucketed: bool) -> Program:
        # the body holds what it reads, not the model: no reference cycle
        # keeps a dropped model's graphs alive
        mesh, refiner, scorer = self._meshes[mesh_name], self._refiner, self._scorer
        rot_grid, K, cfg = self._rot_grid, self._K, self._cfg

        def program(rgb, depth, mask, hw=None):
            return register_step(
                mesh, refiner, scorer, rgb, depth, mask, rot_grid, K, refine_itr, cfg,
                None if hw is None else (hw[0], hw[1]),
            )

        # in a bucket the graph reads the bucket's buffers and the real (h, w);
        # the public calls read its stage events back
        return self._program(program, key, (0, 1, 2, 3) if bucketed else (), staged=True)

    def _track_program(self, key: tuple, mesh: MeshConstants | MeshSet, refine_itr: int,
                       bucketed: bool, single: bool) -> Program:
        """Track of one (4, 4) pose (``single``) or of an (N, 4, 4) batch, on
        one mesh, or on the catalog's meshes, one a pose, named by the
        program's fourth argument, an (N,) int32 tensor of catalog indices
        (the views' table rows and diameters are gathered in the graph)."""
        refiner, K, cfg = self._refiner, self._K, self._cfg

        def run(views, rgb, depth, poses, hw):
            out = track_step(
                views, refiner, rgb, depth, poses[None] if single else poses, K, refine_itr, cfg,
                None if hw is None else (hw[0], hw[1]),
            )
            return out[0] if single else out

        if isinstance(mesh, MeshSet):
            def program(rgb, depth, poses, idx, hw=None):
                return run(mesh.views(idx), rgb, depth, poses, hw)

            return self._program(program, key, (0, 1, 4) if bucketed else (), staged=True)

        def program(rgb, depth, poses, hw=None):
            return run(mesh, rgb, depth, poses, hw)

        return self._program(program, key, (0, 1, 3) if bucketed else (), staged=True)

    # public API

    @torch.inference_mode()
    def _run_register(self, rgb, depth, mask, target_name, refine_itr):
        """Shared Register plumbing (cache key, bucket, program call);
        returns the (best, poses, scores, ok) device tuple."""
        profiling.step("check")
        self._check_inputs(rgb, depth, mask, target_name)
        profiling.step("mask")
        # the mask is read only as mask > 0 (ops/depth.py): one dtype for any
        # caller's mask, so one program and one bucket buffer serve them all
        mask = (np.asarray(mask) > 0).astype(np.uint8)
        h, w = rgb.shape[:2]
        bucket = self._bucket_for(h, w)
        key = ("register", target_name, bucket or (h, w), int(refine_itr), bucket is not None)
        if key not in self._register_cache:
            self._register_cache[key] = self._register_program(
                key, target_name, int(refine_itr), bucket is not None)
        profiling.step("upload")
        args = self._frame_args(rgb, depth, mask)
        profiling.step("program")
        return self._register_cache[key](*args)

    def _mesh_catalog(self) -> MeshSet:
        """The catalog of every registered mesh, built on its first call."""
        if self._catalog is None:
            self._catalog = MeshSet.build(self._meshes)
            self.meshset_builds += 1
            profiling.RECORDER.meshset_builds += 1
        return self._catalog

    def _check_names(self, names: tuple, n: int) -> None:
        """A name a pose, each registered: ValueError otherwise."""
        if not names:
            raise ValueError("[FoundationPose] no target names")
        if len(names) != n:
            raise ValueError(f"[FoundationPose] {len(names)} target names for {n} poses")
        unknown = sorted({str(name) for name in names if name not in self._meshes})
        if unknown:
            raise ValueError(f"[FoundationPose] unknown targets {unknown}; registered: "
                             f"{sorted(self._meshes)}")

    @torch.inference_mode()
    def _run_track(self, kind: str, rgb, depth, poses: np.ndarray, target, refine_itr):
        """Shared Track plumbing: ``kind`` "track" for one (4, 4) pose,
        "track_batch" for (N, 4, 4) (its key holds N); ``target`` a name, or
        for "track_batch" a tuple of names, one a pose (its key holds
        ``CATALOG``; their catalog indices are uploaded, step ``names``)."""
        with profiling.call(kind):
            profiling.step("check")
            single_mesh = isinstance(target, str)
            if not single_mesh:
                self._check_names(target, int(poses.shape[0]))
            self._check_inputs(rgb, depth, None, target if single_mesh else target[0])
            h, w = rgb.shape[:2]
            bucket = self._bucket_for(h, w)
            n = () if kind == "track" else (int(poses.shape[0]),)
            if single_mesh:
                mesh, names = self._meshes[target], ()
            else:
                profiling.step("names")
                mesh = self._mesh_catalog()
                names = (self._upload(mesh.indices(target)),)
                target = CATALOG
            key = (kind, target, bucket or (h, w), int(refine_itr), *n, bucket is not None)
            if key not in self._track_cache:
                self._track_cache[key] = self._track_program(
                    key, mesh, int(refine_itr), bucket is not None, kind == "track")
            profiling.step("upload")
            frame = self._frame_args(rgb, depth)
            pose = self._upload(poses)
            profiling.step("program")
            out = self._track_cache[key](*frame[:2], pose, *names, *frame[2:])
            return _read_back(out)[0]

    def register(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        mask: np.ndarray,
        target_name: str,
        refine_itr: int = 1,
    ) -> np.ndarray:
        """Cold-start pose estimation; returns a 4x4 pose.

        Mirrors FoundationPose::Register (foundationpose.cpp:181-228).
        Raises RuntimeError when the mask is empty / has no valid depth.
        """
        with profiling.call("register"):
            best, _, _, _ = self._run_register(rgb, depth, mask, target_name, refine_itr)
            out = _read_back(best)[0]  # the one host synchronization
        if np.isnan(out[0, 0]):
            raise RuntimeError(
                "[FoundationPose] translation guess failed: mask is empty or "
                "contains no valid depth"
            )
        return out

    def register_with_scores(
        self, rgb, depth, mask, target_name, refine_itr: int = 1
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Register returning (best_pose, all refined poses, scores)."""
        with profiling.call("register_with_scores"):
            best, poses, scores, _ = self._run_register(
                rgb, depth, mask, target_name, refine_itr
            )
            best, poses, scores = _read_back(best, poses, scores)
        if np.isnan(best[0, 0]):
            raise RuntimeError("[FoundationPose] translation guess failed")
        return best, poses, scores

    def track_batch(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        hyp_poses: np.ndarray,
        target_name: str | Sequence[str],
        refine_itr: int = 1,
    ) -> np.ndarray:
        """Track a (N, 4, 4) batch in one frame (an extension over the
        reference, which tracks one per call): N instances of the mesh
        ``target_name``, one program for each N; or, with a sequence of N
        registered names in any order, repeats allowed, pose i on mesh
        ``target_name[i]``, one program for each N whatever the names, which
        renders all N views in one launch of the render kernel a refinement
        out of the model's catalog of meshes (a new set of names captures
        nothing and builds nothing). Distinct objects are independent in
        Track, so each pose is refined on its own mesh and diameter; it
        equals a call on its mesh alone up to the rounding of the crop
        window's bounds, which may fall a pixel apart between batches of
        different sizes (as Track and a one-mesh track_batch may). Raises
        ValueError, before any upload, on an unknown name or on a count of
        names other than N."""
        poses = np.asarray(hyp_poses, np.float32)
        if not isinstance(target_name, str):
            target_name = tuple(target_name)
        return self._run_track("track_batch", rgb, depth, poses, target_name, refine_itr)

    def track(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        hyp_pose: np.ndarray,
        target_name: str,
        refine_itr: int = 1,
    ) -> np.ndarray:
        """Per-frame pose update (FoundationPose::Track, :230-265)."""
        return self._run_track("track", rgb, depth, np.asarray(hyp_pose, np.float32),
                               target_name, refine_itr)

    def make_packed_tracker(
        self,
        target_name: str,
        frame_hw: tuple[int, int],
        refine_itr: int = 1,
        depth_format: str = "u16mm",
        rgb_half: bool = False,
    ):
        """Deployment fast path for per-frame tracking (``AsyncTracker``).

        Returns ``step(packed, pose) -> pose``: Track on ONE packed uint8
        frame (rgb bytes, then depth bytes: ``pack_frame``'s layout, the
        ``FrameRing`` wire format) from a (4, 4) pose. Either may be a device
        tensor or a numpy array (uploaded once). The result is a (4, 4) f32
        tensor on the model's device and nothing is read back, so calls chain
        with the pose left on the card; the caller reads poses at its own
        cadence. The step is a program over a static frame buffer and a
        static pose buffer, one for each (target, frame_hw, refine_itr,
        depth_format, rgb_half), kept in ``_packed_cache`` and shared by
        every step made for that key; ``step.program`` is it.

        depth_format "u16mm" (default): little-endian uint16 millimeters, the
        camera's native format (h*w*5 bytes a frame, converted to meters on
        the device); "f32": float32 meters (h*w*7 bytes). rgb_half ships the
        colour plane at half resolution, 2x2 box-downsampled by
        ``pack_frame`` and bilinearly upsampled on the device (see
        ``unpack_frame``); it needs even h and w.
        """
        if target_name not in self._meshes:
            raise KeyError(
                f"[FoundationPose] unknown target '{target_name}'; "
                f"registered: {sorted(self._meshes)}"
            )
        _check_depth_format(depth_format)
        h, w = int(frame_hw[0]), int(frame_hw[1])
        if h > self._max_h or w > self._max_w:
            raise ValueError(
                f"[FoundationPose] frame ({h}, {w}) exceeds max ({self._max_h}, {self._max_w})"
            )
        if rgb_half and (h % 2 or w % 2):
            raise ValueError(f"rgb_half requires even frame dims, got ({h}, {w})")
        mesh = self._meshes[target_name]
        nbytes = self.packed_frame_bytes((h, w), depth_format, rgb_half)
        itr = int(refine_itr)
        key = ("packed", target_name, (h, w), itr, depth_format, bool(rgb_half))
        program = self._packed_cache.get(key)
        if program is None:
            refiner, K, cfg = self._refiner, self._K, self._cfg

            def run(packed, pose):
                rgb, depth = unpack_frame(packed, (h, w), depth_format, rgb_half)
                return track_step(mesh, refiner, rgb, depth, pose[None], K, itr, cfg)[0]

            program = self._packed_cache[key] = self._program(run, key)

        @torch.inference_mode()
        def step(packed, pose) -> torch.Tensor:
            packed = torch.as_tensor(packed, device=self._device)
            if packed.dtype != torch.uint8 or packed.numel() != nbytes:
                raise ValueError(
                    f"packed frame must be {nbytes} uint8 bytes, got {packed.dtype} "
                    f"{tuple(packed.shape)}"
                )
            pose = torch.as_tensor(pose, dtype=torch.float32, device=self._device)
            return program(packed.reshape(-1), pose)

        step.program = program
        return step

    @staticmethod
    def packed_frame_bytes(
        frame_hw: tuple[int, int],
        depth_format: str = "u16mm",
        rgb_half: bool = False,
    ) -> int:
        """Byte size of one make_packed_tracker / FrameRing frame."""
        h, w = int(frame_hw[0]), int(frame_hw[1])
        depth_b = h * w * DEPTH_BYTES[depth_format]
        rgb_b = (h // 2) * (w // 2) * 3 if rgb_half else h * w * 3
        return rgb_b + depth_b

    @staticmethod
    def pack_frame(
        rgb: np.ndarray,
        depth: np.ndarray,
        depth_format: str = "u16mm",
        rgb_half: bool = False,
    ) -> np.ndarray:
        """Pack (rgb u8 (H,W,3), depth (H,W)) into one contiguous u8 buffer
        in make_packed_tracker's wire layout (numpy, byte for byte the JAX
        package's).

        For "u16mm", f32-meter depth is quantized to whole millimeters
        (values clip to [0, 65.535] m, NaN to 0); a uint16 array passes
        through unconverted. rgb_half 2x2-box-downsamples the colour plane
        with rounding.
        """
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        if rgb_half:
            hh, ww = rgb.shape[0] // 2, rgb.shape[1] // 2
            rgb = (
                rgb.reshape(hh, 2, ww, 2, 3).astype(np.uint16).sum(axis=(1, 3)) + 2
            ) // 4
            rgb = rgb.astype(np.uint8)
        _check_depth_format(depth_format)
        if depth_format == "u16mm":
            if depth.dtype == np.uint16:
                d = np.ascontiguousarray(depth)
            else:
                d = np.clip(
                    np.nan_to_num(np.asarray(depth, np.float64)) * 1000.0, 0.0, 65535.0,
                ).round().astype(np.uint16)
        else:
            d = np.ascontiguousarray(depth, dtype=np.float32)
        return np.concatenate([rgb.reshape(-1), d.view(np.uint8).reshape(-1)])

    def convert_pose_mesh2bbox(self, pose: np.ndarray, target_name: str) -> np.ndarray:
        """Pose frame change mesh -> oriented bbox (mesh_loader.hpp:75-81)."""
        mesh = self._meshes[target_name]
        return transforms.convert_pose_mesh2bbox(
            torch.as_tensor(np.asarray(pose, np.float32), device=self._device),
            mesh.model_center,
            mesh.orient_bounds,
        ).cpu().numpy()

    def object_dimension(self, target_name: str) -> np.ndarray:
        """Extents of the mesh in its PCA basis (the oriented bbox size)."""
        return self._assets[target_name].dimensions


def _read_back(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The tensors in host memory (waits for the device), then, in a
    recorded call, the device ms of the stages of the graph it replayed."""
    profiling.step("readback")
    out = [t.cpu().numpy() for t in tensors]
    if profiling.counting():
        profiling.count_bytes("readback", sum(t.numel() * t.element_size()
                                              for t in tensors if t.device.type != "cpu"))
        profiling.read_stages()
    return out


def create_foundationpose_model(
    refiner,
    scorer,
    mesh_assets: list[MeshAsset],
    intrinsic: np.ndarray,
    max_input_image_h: int = 1080,
    max_input_image_w: int = 1920,
    **kwargs,
) -> FoundationPose:
    """Factory mirroring CreateFoundationPoseModel (foundationpose.cpp:448-458)."""
    return FoundationPose(
        refiner, scorer, mesh_assets, intrinsic, max_input_image_h,
        max_input_image_w, **kwargs,
    )
