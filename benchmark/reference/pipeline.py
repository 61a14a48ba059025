"""Register and Track of FoundationPose (Wen et al., CVPR 2024) as the
reference deployment orders them (zz990099/foundationpose_cpp,
src/foundationpose.cpp:181-265), in plain float32 PyTorch with TF32 off.

  register: erode -> bilateral -> translation guess -> 252-pose grid ->
            refine_itr x [render + crop (1.2) -> refiner -> compose delta]
            -> render + crop (1.1) -> scorer (att_cross over all poses)
  track:    back-project -> refine_itr x [render + crop -> refiner -> compose]

Nothing here imports the program under test or takes anything it made:
meshes, checkpoints and frames come from the benchmark's own files and
generators. ``quant`` (``nets.fp8_e4m3``) puts the nets' operands in a
lower precision, ``geom`` (``geometry.bf16``) the geometry's results (crop
windows and their boxes, clip matrices, the observed points before
centring, the pose update): the controls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import depth as depth_ops
from benchmark.reference import geometry, nets, render
from benchmark.reference.assets import Mesh

CFG = {  # the deployment's constants (config.py of the reference C++ code)
    "refine_crop_ratio": 1.2, "score_crop_ratio": 1.1, "min_depth": 0.001, "max_depth": 4.0,
    "rot_normalizer": 0.349065850398865, "znear": 0.1, "zfar": 100.0, "w_ambient": 0.8,
    "w_diffuse": 0.5, "erode_radius": 2, "erode_diff": 0.001, "erode_ratio": 0.8,
    "bilateral_radius": 2, "sigma_d": 2.0, "sigma_r": 100000.0, "mean_band": 0.01,
}


@dataclasses.dataclass
class Reference:
    mesh: Mesh
    refiner: dict
    scorer: dict
    K: torch.Tensor
    crop: int
    heads: int = 4
    block: int = 64  # pairs a net sees at once
    quant: object = None
    geom: object = None
    n_views: int = 40
    inplane_step_deg: int = 60

    @property
    def device(self):
        return self.K.device

    def _g(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.geom is None else self.geom(x)

    def crops(self, poses, rgb, xyz, crop_ratio: float, h: int, w: int):
        """The (render, observed) 6-channel crop pair of each pose."""
        g = self._g
        tfs = g(geometry.crop_window_tf(poses, self.K, self.crop, crop_ratio, self.mesh.diameter))
        bbox = g(geometry.crop_bbox(tfs, self.crop))
        clip = g(geometry.clip_matrix(poses, bbox, self.K, h, w, CFG["znear"], CFG["zfar"]))
        rend = torch.cat([render.render_crops(self.mesh, poses[i:i + self.block],
                                              clip[i:i + self.block], self.crop, CFG)
                          for i in range(0, poses.shape[0], self.block)])
        obs_xyz = render.threshold_xyz(g(depth_ops.warp_xyz(xyz, tfs, self.crop)), poses,
                                       self.mesh.diameter / 2.0, CFG["min_depth"],
                                       CFG["max_depth"])
        return rend, torch.cat([depth_ops.warp_rgb(rgb, tfs, self.crop), obs_xyz], dim=-1)

    def refine(self, poses, rgb, xyz, refine_itr: int, h: int, w: int):
        for _ in range(refine_itr):
            a, b = self.crops(poses, rgb, xyz, CFG["refine_crop_ratio"], h, w)
            trans, rot = nets.refine(self.refiner, a, b, self.block, self.heads, self.quant)
            poses = self._g(geometry.apply_delta(poses, trans, rot, self.mesh.diameter,
                                                 CFG["rot_normalizer"]))
        return poses

    def _frame(self, rgb: np.ndarray, depth: np.ndarray):
        rgb_t = torch.as_tensor(np.ascontiguousarray(rgb), device=self.device)
        d = torch.as_tensor(np.ascontiguousarray(depth, np.float32), device=self.device)
        return rgb_t, d, depth_ops.to_xyz(d, self.K, CFG["min_depth"])

    @torch.no_grad()
    def hypotheses(self, depth: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Register's front end: the grid at the guessed translation."""
        d = torch.as_tensor(np.ascontiguousarray(depth, np.float32), device=self.device)
        m = torch.as_tensor(np.ascontiguousarray(mask), device=self.device)
        er = depth_ops.erode(d, CFG["erode_radius"], CFG["erode_diff"], CFG["erode_ratio"],
                             CFG["zfar"])
        bl = depth_ops.bilateral(er, CFG["bilateral_radius"], CFG["sigma_d"], CFG["sigma_r"],
                                 CFG["zfar"], CFG["mean_band"])
        center = depth_ops.guess_translation(bl, m, self.K, CFG["min_depth"])
        poses = torch.as_tensor(geometry.rotation_grid(self.n_views, self.inplane_step_deg),
                                device=self.device)
        poses[:, :3, 3] = center[None]
        return poses

    @torch.no_grad()
    def register(self, rgb, depth, mask, refine_itr: int = 1):
        """-> (refined poses (M, 4, 4), scores (M,)), numpy."""
        rgb_t, _, xyz = self._frame(rgb, depth)
        h, w = depth.shape
        poses = self.refine(self.hypotheses(depth, mask), rgb_t, xyz, refine_itr, h, w)
        scores = self.score(poses, rgb_t, xyz, h, w)
        return poses.cpu().numpy(), scores.cpu().numpy()

    @torch.no_grad()
    def score(self, poses, rgb_t, xyz, h: int, w: int) -> torch.Tensor:
        a, b = self.crops(poses, rgb_t, xyz, CFG["score_crop_ratio"], h, w)
        return nets.score(self.scorer, a, b, self.block, self.heads, self.quant)

    @torch.no_grad()
    def score_poses(self, poses: np.ndarray, rgb, depth) -> np.ndarray:
        """The scorer's logits of given poses in a frame."""
        rgb_t, _, xyz = self._frame(rgb, depth)
        p = torch.as_tensor(np.asarray(poses, np.float32), device=self.device)
        return self.score(p, rgb_t, xyz, *depth.shape).cpu().numpy()

    @torch.no_grad()
    def track(self, rgb, depth, poses: np.ndarray, refine_itr: int = 1) -> np.ndarray:
        """(N, 4, 4) hypotheses -> (N, 4, 4) refined poses, numpy."""
        rgb_t, _, xyz = self._frame(rgb, depth)
        p = torch.as_tensor(np.asarray(poses, np.float32).reshape(-1, 4, 4), device=self.device)
        return self.refine(p, rgb_t, xyz, refine_itr, *depth.shape).cpu().numpy()
