"""Register traffic: ``FoundationPose.register`` back to back, a closed loop
(one caller waits for each pose), cycling over a few frames.

Parameters (the cell's ``params``):
  frames      distinct frames, rendered at set-up by the reference renderer
  distance_m  [near, far] range of the object's depth
  offset_m    largest sideways offset of the object's centre
The object's rotation is uniform over SO(3). Every seed gives the same
number of frames at the same size; only the poses differ.

The check: after the window, each frame once more through
``register_with_scores`` (the same cached program as ``register``) gives
the refined hypotheses and their scores. The reference refines the same
grid from its own front end and scores the program's refined poses; every
pose the window returned is held against the reference's refinement of
the hypothesis the program's scores picked.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts, scene
from benchmark.reference import geometry, render
from benchmark.reference.pipeline import CFG


class Traffic:
    def __init__(self, wl: dict, config: dict, seed: int, device, root):
        self.wl, self.config, self.seed, self.device, self.root = wl, config, seed, device, root
        self.params = wl["params"]
        self.frames, self.gts, self.window = [], [], []

    def make_inputs(self) -> None:
        rng = np.random.default_rng(self.seed)
        h, w = self.config["frame_hw"]
        K = np.asarray(self.config["K"], np.float32)
        near, far = self.params["distance_m"]
        off = self.params["offset_m"]
        mesh = scene.reference_mesh(self.config, self.device, self.root)
        for _ in range(self.params["frames"]):
            gt = np.eye(4, dtype=np.float32)
            gt[:3, :3] = scene.random_rotation(rng)
            gt[:3, 3] = [rng.uniform(-off, off), rng.uniform(-off, off), rng.uniform(near, far)]
            self.gts.append(gt)
            self.frames.append(render.render_frame(mesh, gt, K, h, w, CFG))
        del mesh

    def build_model(self):
        return scene.build_model(self.config, self.device, self.root)

    def _register(self, model, f: int) -> np.ndarray:
        rgb, depth, mask = self.frames[f]
        return model.register(rgb, depth, mask, self.config["mesh"]["name"],
                              self.config["refine_itr"])

    def warm_up(self, model) -> None:
        # the program's first call runs it and captures its graph; the
        # second replays it
        for f in range(2):
            self._register(model, f % len(self.frames))

    def call(self, model, i: int) -> None:
        f = i % len(self.frames)
        self.window.append((f, self._register(model, f)))

    def program_outputs(self, model) -> dict:
        poses, scores = [], []
        for rgb, depth, mask in self.frames:
            _, p, s = model.register_with_scores(rgb, depth, mask, self.config["mesh"]["name"],
                                                 self.config["refine_itr"])
            poses.append(p)
            scores.append(s)
        return {"poses": np.stack(poses), "scores": np.stack(scores), "window": list(self.window)}

    def control_outputs(self, ref) -> dict:
        """The reference in the program's place (the control's outputs)."""
        poses, scores = zip(*(ref.register(*fr, self.config["refine_itr"]) for fr in self.frames))
        poses, scores = np.stack(poses), np.stack(scores)
        best = poses[np.arange(len(poses)), scores.argmax(axis=1)]
        return {"poses": poses, "scores": scores,
                "window": [(f, best[f]) for f in range(len(best))]}

    def reference(self, quant=None, geom=None):
        return scene.build_reference(self.config, self.device, self.root, quant, geom)

    def work(self, outputs: dict, ref) -> dict:
        """Per Register: the nets' operations and K1's and K2's bounds (K2's
        face-pixel tests from ``ref``'s crop windows)."""
        nets = self.config["nets"]
        widths = dict(crop=nets["crop_hw"], width1=nets["width1"], width2=nets["width2"],
                      embed=nets["embed_dim"], ffn=nets["ffn_dim"],
                      layers=nets["num_encoder_layers"])
        m = outputs["poses"].shape[1]
        itr = self.config["refine_itr"]
        tokens = (nets["crop_hw"] // 8) ** 2
        k1 = (itr + 1) * counts.attention_bound_s(m, tokens, nets["embed_dim"], nets["num_heads"]) \
            + counts.attention_bound_s(1, m, nets["embed_dim"], nets["num_heads"])
        mesh, crop = ref.mesh, ref.crop
        h, w = self.config["frame_hw"]
        k2 = []
        for (rgb, depth, mask), refined in zip(self.frames, outputs["poses"]):
            for poses, ratio in ((ref.hypotheses(depth, mask), CFG["refine_crop_ratio"]),
                                 (torch.as_tensor(refined, device=self.device),
                                  CFG["score_crop_ratio"])):
                tfs = geometry.crop_window_tf(poses, ref.K, crop, ratio, mesh.diameter)
                clip = geometry.clip_matrix(poses, geometry.crop_bbox(tfs, crop), ref.K, h, w,
                                            CFG["znear"], CFG["zfar"])
                tests = counts.render_tests_needed(geometry.transform_h(clip, mesh.vertices),
                                                   mesh.faces, crop, crop)
                k2.append(counts.render_bound_s(poses.shape[0], crop, mesh.vertices.shape[0],
                                                mesh.faces.shape[0],
                                                mesh.texture.shape[0] * mesh.texture.shape[1],
                                                tests))
        return {"flops": counts.register_flops(m, itr, **widths), "k1_bound_s": k1,
                "k2_bound_s": float(np.mean(k2)) * 2}

    def check(self, out: dict, ref) -> dict:
        lim = self.wl["limits"]
        rot, trans, gap = [], [], []
        for f, (rgb, depth, mask) in enumerate(self.frames):
            ref_poses, _ = ref.register(rgb, depth, mask, self.config["refine_itr"])
            ref_scores = ref.score_poses(out["poses"][f], rgb, depth)
            pick = int(np.argmax(out["scores"][f]))
            mine = [out["poses"][f]] + [p[None] for g, p in out["window"] if g == f]
            want = [ref_poses] + [ref_poses[pick][None]] * (len(mine) - 1)
            rot.append(scene.worst(scene.rot_deg(np.concatenate(mine), np.concatenate(want))))
            trans.append(scene.worst(scene.trans_mm(np.concatenate(mine), np.concatenate(want))))
            gap.append(scene.worst(np.abs(out["scores"][f] - ref_scores)))
        return {
            "pose_rot_deg": scene.check_entry(scene.worst(rot), lim["pose_rot_deg"]),
            "pose_trans_mm": scene.check_entry(scene.worst(trans), lim["pose_trans_mm"]),
            "score_gap": scene.check_entry(scene.worst(gap), lim["score_gap"]),
        }
