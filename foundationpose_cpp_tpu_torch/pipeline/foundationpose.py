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
"""

from __future__ import annotations

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.config import DEFAULT_CONFIG, FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import icosphere, transforms
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import MeshAsset
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import depth as depth_ops
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants, render_and_transform
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


def refine_loop(
    mesh: MeshConstants,
    refiner: networks.RefineNet,
    poses: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    K: torch.Tensor,
    refine_itr: int,
    cfg: FoundationPoseConfig,
) -> torch.Tensor:
    """refine_itr x [render -> refiner -> compose delta]
    (foundationpose.cpp:200-213)."""
    for _ in range(refine_itr):
        render_in, transf_in = render_and_transform(
            mesh, poses, rgb, xyz_map, K, cfg.refine_crop_ratio, cfg
        )
        out = refiner(render_in, transf_in)
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register front end: depth filters -> translation guess -> hypothesis
    poses, plus the raw-depth xyz map the crops sample.

    Returns (poses0 (M,4,4), xyz_map, ok).
    """
    df = cfg.depth_filter
    eroded = depth_ops.erode_depth(
        depth, df.erode_radius, df.erode_depth_diff_thres, df.erode_ratio_thres, df.zfar
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Refine loop + score render + scorer. Returns (poses (M,4,4), scores (M,))."""
    poses = refine_loop(mesh, refiner, poses, rgb, xyz_map, K, refine_itr, cfg)
    render_in, transf_in = render_and_transform(
        mesh, poses, rgb, xyz_map, K, cfg.score_crop_ratio, cfg
    )
    out = scorer(render_in, transf_in)
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full Register computation. Returns (best_pose, refined_poses,
    scores, ok); best_pose is NaN when the translation guess failed."""
    poses, xyz_map, ok = prepare_register(depth, mask, rot_grid, K, cfg)
    poses, scores = refine_and_score(
        mesh, refiner, scorer, poses, rgb, xyz_map, K, refine_itr, cfg
    )
    best = torch.argmax(scores)  # getMaxScoreIndex (thrust) equivalent
    best_pose = torch.where(ok, poses[best], torch.full_like(poses[best], float("nan")))
    return best_pose, poses, scores, ok


def track_step(
    mesh: MeshConstants,
    refiner: networks.RefineNet,
    rgb: torch.Tensor,
    depth: torch.Tensor,
    poses: torch.Tensor,
    K: torch.Tensor,
    refine_itr: int,
    cfg: FoundationPoseConfig,
) -> torch.Tensor:
    """Track for a (N, 4, 4) batch of instances of one mesh (N=1: the
    reference Track)."""
    xyz_map = depth_ops.depth_to_xyz(depth, K, cfg.min_depth)
    return refine_loop(mesh, refiner, poses, rgb, xyz_map, K, refine_itr, cfg)


def _as_net(net, kind: str, device: torch.device, dtype: torch.dtype):
    """An nn.Module, a converted state_dict, or an npz path -> module on
    device, computing in ``dtype``."""
    if isinstance(net, str):
        net = convert_jax.load_npz(net)
    if isinstance(net, dict):
        net = convert_jax.build_net(net, kind)
    return net.to(device).cast_matmul_weights(dtype).eval()


class FoundationPose:
    """Multi-mesh 6-DoF pose estimator (CreateFoundationPoseModel parity).

    refiner / scorer: a ``RefineNet`` / ``ScoreNet`` (which keeps its own
    ``NetConfig``, so narrow nets run unchanged), a state_dict from
    ``convert_jax``, or the path of a ``weights/*_full.npz`` checkpoint.
    device: None means "cuda" and raises RuntimeError when no card is
    present; pass device="cpu" for the plain PyTorch versions on the CPU.
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
        if config.size_buckets is not None:
            raise NotImplementedError("[FoundationPose] size_buckets is not ported")
        self._device = resolve_device(device)
        self._cfg = config
        dtype = torch.bfloat16 if config.use_bf16_models else torch.float32
        self._refiner = _as_net(refiner, "refiner", self._device, dtype)
        self._scorer = _as_net(scorer, "scorer", self._device, dtype)
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
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    # public API

    @torch.inference_mode()
    def _run_register(self, rgb, depth, mask, target_name, refine_itr):
        self._check_inputs(rgb, depth, mask, target_name)
        return register_step(
            self._meshes[target_name], self._refiner, self._scorer,
            self._upload(rgb), self._upload(depth), self._upload(mask),
            self._rot_grid, self._K, int(refine_itr), self._cfg,
        )

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
        best, _, _, _ = self._run_register(rgb, depth, mask, target_name, refine_itr)
        out = best.cpu().numpy()  # the one host synchronization
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
        best, poses, scores, _ = self._run_register(
            rgb, depth, mask, target_name, refine_itr
        )
        best, poses, scores = (t.cpu().numpy() for t in (best, poses, scores))
        if np.isnan(best[0, 0]):
            raise RuntimeError("[FoundationPose] translation guess failed")
        return best, poses, scores

    @torch.inference_mode()
    def track_batch(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        hyp_poses: np.ndarray,
        target_name: str,
        refine_itr: int = 1,
    ) -> np.ndarray:
        """Track a (N, 4, 4) batch of instances of one mesh in one frame
        (an extension over the reference, which tracks one per call)."""
        self._check_inputs(rgb, depth, None, target_name)
        poses = self._upload(np.asarray(hyp_poses, dtype=np.float32))
        out = track_step(
            self._meshes[target_name], self._refiner, self._upload(rgb),
            self._upload(depth), poses, self._K, int(refine_itr), self._cfg,
        )
        return out.cpu().numpy()

    def track(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        hyp_pose: np.ndarray,
        target_name: str,
        refine_itr: int = 1,
    ) -> np.ndarray:
        """Per-frame pose update (FoundationPose::Track, :230-265)."""
        pose = np.asarray(hyp_pose, dtype=np.float32)[None]
        return self.track_batch(rgb, depth, pose, target_name, refine_itr)[0]

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
