"""track_batch traffic over distinct objects: ``FoundationPose.track_batch``
of every object of a frame in one call, with one mesh name a pose, along
each object's own trajectory; the generator and the check of ``track.py``.

The configuration lists its objects under ``meshes`` ({name, file, faces,
diameter_mm}); object i is ``meshes[i]``. Parameters (the cell's
``params``), as ``track.py`` reads them but for the grid:
  objects     the objects of a frame, as many as the configuration's meshes
  grid        columns of the grid the objects start on
  spacing_m   [between columns, between rows] of the grid, at distance_m
  distance_m  the grid's depth
The frames are rendered at set-up by the reference's multi-object renderer
(``reference/scene_multi.py``), the nearest surface of any object winning,
each object's views of all the frames in one batch.

The check: every pose the window returned, against the reference's
refinement of the same frame from the same hypothesis, each object on its
own mesh alone (``scene_multi.MultiReference``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts_mixed, scene
from benchmark.reference import assets, geometry, scene_multi
from benchmark.reference.pipeline import CFG
from benchmark.traffic import track


class Traffic(track.Traffic):
    batch_call = True

    def __init__(self, wl: dict, config: dict, seed: int, device, root):
        super().__init__(wl, config, seed, device, root)
        self.names = [m["name"] for m in config["meshes"]]
        if self.params["objects"] != len(self.names):
            raise ValueError(f"{self.params['objects']} objects, {len(self.names)} meshes")

    def _starts(self, rng) -> np.ndarray:
        n, cols = self.params["objects"], self.params["grid"]
        rows = n // cols
        col_gap, row_gap = self.params["spacing_m"]
        starts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i in range(n):
            starts[i, :3, :3] = scene.random_rotation(rng)
            starts[i, :3, 3] = [(i % cols - (cols - 1) / 2) * col_gap,
                                (i // cols - (rows - 1) / 2) * row_gap, self.params["distance_m"]]
        return starts

    def _meshes(self) -> list:
        return [assets.load_mesh(scene.repo_path(self.root, m["file"]), self.device)
                for m in self.config["meshes"]]

    def make_inputs(self) -> None:
        rng = np.random.default_rng(self.seed)
        p = self.params
        h, w = self.config["frame_hw"]
        K = np.asarray(self.config["K"], np.float32)
        starts = self._starts(rng)
        n, t = starts.shape[0], p["frames"]
        axes = [scene.unit(rng) for _ in range(n)]
        dirs = [scene.unit(rng) for _ in range(n)]
        self.gts = np.tile(np.eye(4, dtype=np.float32), (t, n, 1, 1))
        for k in range(t):
            s = k - (t - 1) / 2.0  # the trajectory is centred on the start pose
            for i in range(n):
                self.gts[k, i, :3, :3] = scene.axis_angle(axes[i], s * p["step_deg"]) \
                    @ starts[i, :3, :3]
                self.gts[k, i, :3, 3] = starts[i, :3, 3] + s * p["step_mm"] * 1e-3 * dirs[i]
        meshes = self._meshes()
        self.frames = scene_multi.render_frames(meshes, self.gts, K, h, w, CFG)
        del meshes

    def build_model(self):
        """The program as a user builds it: every object's mesh through the
        port's loader, the checkpoints by path."""
        from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
        from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
        from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

        c = self.config
        h, w = c["frame_hw"]
        crop = c["nets"]["crop_hw"]
        cfg = FoundationPoseConfig(
            crop_window_h=crop, crop_window_w=crop, n_views=c["n_views"],
            inplane_step_deg=c["inplane_step_deg"],
            use_bf16_models=c["precision"]["nets"] == "bfloat16",
        )
        meshes = [load_mesh(m["name"], scene.repo_path(self.root, m["file"]))
                  for m in c["meshes"]]
        return FoundationPose(scene.repo_path(self.root, c["refiner"]),
                              scene.repo_path(self.root, c["scorer"]), meshes,
                              np.asarray(c["K"], np.float32), h, w, cfg,
                              device=str(self.device))

    def _track(self, model, f: int, prev: int) -> np.ndarray:
        rgb, depth, _ = self.frames[f]
        return model.track_batch(rgb, depth, self.gts[prev], self.names,
                                 self.config["refine_itr"])

    def reference(self, quant=None, geom=None):
        """The plain float32 reference (TF32 off), or a control with
        ``quant`` or ``geom``: one ``pipeline.Reference`` an object."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.config
        return scene_multi.build(
            self._meshes(), assets.read_params(scene.repo_path(self.root, c["refiner"]),
                                               self.device),
            assets.read_params(scene.repo_path(self.root, c["scorer"]), self.device),
            torch.as_tensor(np.asarray(c["K"], np.float32), device=self.device),
            c["nets"]["crop_hw"], heads=c["nets"]["num_heads"], quant=quant, geom=geom,
            n_views=c["n_views"], inplane_step_deg=c["inplane_step_deg"],
        )

    def work(self, outputs: dict, ref) -> dict:
        """The refiner's operations a call (``track.py``) and K2's bound a
        call (``counts_mixed``): every call renders each object at a frame's
        true pose, so the face-pixel tests are the mean over the frames."""
        out = super().work(outputs, ref)
        h, w = self.config["frame_hw"]
        crop = self.config["nets"]["crop_hw"]
        clips, faces, meshes = [], [], []
        for i, obj in enumerate(ref.objects):
            mesh = obj.mesh
            poses = torch.as_tensor(self.gts[:, i], device=self.device)
            tfs = geometry.crop_window_tf(poses, obj.K, crop, CFG["refine_crop_ratio"],
                                          mesh.diameter)
            clip = geometry.clip_matrix(poses, geometry.crop_bbox(tfs, crop), obj.K, h, w,
                                        CFG["znear"], CFG["zfar"])
            clips.append(geometry.transform_h(clip, mesh.vertices))
            faces.append(mesh.faces)
            meshes.append((mesh.vertices.shape[0], mesh.faces.shape[0],
                           mesh.texture.shape[0] * mesh.texture.shape[1]))
        tests = counts_mixed.tests_needed(clips, faces, crop) / len(self.gts)
        out["k2_mixed_bound_s"] = self.config["refine_itr"] * counts_mixed.render_bound_s(
            len(meshes), crop, meshes, tests)
        return out
