"""Track traffic: ``FoundationPose.track`` back to back along a trajectory,
a closed loop (a control loop waits for each pose).

Parameters (the cell's ``params``):
  frames      frames of the trajectory, rendered at set-up by the reference
              renderer and played forward and back
  objects     instances a frame (1: ``track``; more: ``track_batch``), on a
              grid of ``grid`` columns ``spacing_m`` apart at ``distance_m``
  distance_m  [near, far] range of a single object's depth (a list), or the
              grid's depth (a number)
  offset_m    largest sideways offset of a single object's centre
  step_deg    rotation between two frames, about an axis fixed per object
  step_mm     translation between two frames, along a direction fixed per
              object
Each call's hypothesis is the previous frame's true pose, so a call refines
one frame's motion and takes nothing the program returned before. Every
seed gives the same frames, objects and steps; only the poses differ.

The check: every pose the window returned, against the reference's
refinement of the same frame from the same hypothesis.
"""

from __future__ import annotations

import numpy as np

from benchmark import counts, scene
from benchmark.reference import render
from benchmark.reference.pipeline import CFG


class Traffic:
    batch_call = False  # track (one pose a call) or track_batch

    def __init__(self, wl: dict, config: dict, seed: int, device, root):
        self.wl, self.config, self.seed, self.device, self.root = wl, config, seed, device, root
        self.params = wl["params"]
        self.frames, self.gts, self.window = [], None, []

    def _starts(self, rng) -> np.ndarray:
        n = self.params["objects"]
        starts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i in range(n):
            starts[i, :3, :3] = scene.random_rotation(rng)
            if n == 1:
                near, far = self.params["distance_m"]
                off = self.params["offset_m"]
                starts[i, :3, 3] = [rng.uniform(-off, off), rng.uniform(-off, off),
                                    rng.uniform(near, far)]
            else:
                cols = self.params["grid"]
                rows = n // cols
                gap = self.params["spacing_m"]
                starts[i, :3, 3] = [(i % cols - (cols - 1) / 2) * gap,
                                    (i // cols - (rows - 1) / 2) * gap, self.params["distance_m"]]
        return starts

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
        mesh = scene.reference_mesh(self.config, self.device, self.root)
        self.frames = [render.render_frame(mesh, self.gts[k], K, h, w, CFG) for k in range(t)]
        del mesh

    def frame_of(self, i: int) -> tuple[int, int]:
        """(frame, frame whose true pose is the hypothesis) of call i: the
        trajectory forward, then back, and again."""
        t = len(self.frames)
        period = 2 * (t - 1)

        def at(j):
            j %= period
            return j if j < t else period - j

        return at(i), at(i - 1)

    def build_model(self):
        return scene.build_model(self.config, self.device, self.root)

    def _track(self, model, f: int, prev: int) -> np.ndarray:
        rgb, depth, _ = self.frames[f]
        name, itr = self.config["mesh"]["name"], self.config["refine_itr"]
        if self.batch_call:
            return model.track_batch(rgb, depth, self.gts[prev], name, itr)
        return model.track(rgb, depth, self.gts[prev][0], name, itr)[None]

    def warm_up(self, model) -> None:
        for i in range(2):
            self._track(model, *self.frame_of(i))

    def call(self, model, i: int) -> None:
        f, prev = self.frame_of(i)
        self.window.append((f, prev, self._track(model, f, prev)))

    def program_outputs(self, model) -> dict:
        return {"window": list(self.window)}

    def control_outputs(self, ref) -> dict:
        pairs = sorted({self.frame_of(i) for i in range(2 * (len(self.frames) - 1))})
        return {"window": [(f, prev, ref.track(self.frames[f][0], self.frames[f][1],
                                               self.gts[prev], self.config["refine_itr"]))
                           for f, prev in pairs]}

    def reference(self, quant=None, geom=None):
        return scene.build_reference(self.config, self.device, self.root, quant, geom)

    def work(self, outputs: dict, ref) -> dict:
        nets = self.config["nets"]
        return {"flops": counts.track_flops(
            self.params["objects"], self.config["refine_itr"], crop=nets["crop_hw"],
            width1=nets["width1"], width2=nets["width2"], embed=nets["embed_dim"],
            ffn=nets["ffn_dim"], layers=nets["num_encoder_layers"])}

    def check(self, out: dict, ref) -> dict:
        lim = self.wl["limits"]
        want = {}
        rot, trans = [], []
        for f, prev, pose in out["window"]:
            if (f, prev) not in want:
                rgb, depth, _ = self.frames[f]
                want[f, prev] = ref.track(rgb, depth, self.gts[prev], self.config["refine_itr"])
            rot.append(scene.worst(scene.rot_deg(pose, want[f, prev])))
            trans.append(scene.worst(scene.trans_mm(pose, want[f, prev])))
        return {
            "pose_rot_deg": scene.check_entry(scene.worst(rot) if rot else float("nan"),
                                              lim["pose_rot_deg"]),
            "pose_trans_mm": scene.check_entry(scene.worst(trans) if trans else float("nan"),
                                               lim["pose_trans_mm"]),
        }
