"""track_batch traffic over a changing set of distinct objects: the frames,
grid and trajectories of ``track_batch_mixed.py``, and a multi-object
tracker whose set of tracked objects changes as objects are lost and come
back. Each call is ``FoundationPose.track_batch`` of the objects tracked at
that call, in the order they last joined the set, each from the previous
frame's true pose.

Parameters (the cell's ``params``), as ``track_batch_mixed.py`` reads them,
and:
  lose_p    chance a call that a tracked object is lost (occluded, picked
            up, out of the view): a mean 1 / lose_p calls tracked
  return_p  chance a call that a lost object returns (re-registered): a
            mean 1 / return_p calls lost
The set starts with every object, in the configuration's order, and
follows ``Churn`` from a generator of its own seeded by ``--seed``. The
warm-up makes one call at each N from 1 to the number of objects, with the
first N objects: a deployment warms each batch size it can meet.

The check: an evenly spaced sample of ``CHECK_CALLS`` of the calls after
the warm-up (all of them when fewer), with the first call of each N that
the sample misses added, each held against the reference's refinement of
the same frame from the same hypotheses on the call's own ordered set
(``scene_multi.MultiReference`` of those objects, its geometry batched as
the program batched the call), computed once a distinct (frame, hypothesis
frame, ordered set).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts, counts_mixed, scene
from benchmark.reference import geometry, scene_multi
from benchmark.reference.pipeline import CFG
from benchmark.traffic import track_batch_mixed

CHECK_CALLS = 256


class Churn:
    """The ordered set a tracker tracks, call by call. At each call every
    tracked object is lost with chance ``lose_p`` and every lost object,
    lost at an earlier call, returns with chance ``return_p``; returning
    objects join the end of the set, the one lost longest first. When no
    object would be tracked, the one lost longest returns. The set's mean
    size tends to n * return_p / (lose_p + return_p)."""

    def __init__(self, n: int, lose_p: float, return_p: float, seed: int):
        self.n, self.lose_p, self.return_p = n, lose_p, return_p
        self.rng = np.random.default_rng([seed, 1])  # apart from the frames' generator
        self.tracked = list(range(n))
        self.lost: list[int] = []  # lost objects, the one lost longest first

    def step(self) -> tuple[int, ...]:
        """The next call's ordered set of objects."""
        u = self.rng.random(self.n)
        back = [j for j in self.lost if u[j] < self.return_p]
        gone = [j for j in self.tracked if u[j] < self.lose_p]
        self.lost = [j for j in self.lost if j not in back] + gone
        self.tracked = [j for j in self.tracked if j not in gone] + back
        if not self.tracked:
            self.tracked = [self.lost.pop(0)]
        return tuple(self.tracked)


class Traffic(track_batch_mixed.Traffic):
    def __init__(self, wl: dict, config: dict, seed: int, device, root):
        super().__init__(wl, config, seed, device, root)
        p = self.params
        self.churn = Churn(p["objects"], p["lose_p"], p["return_p"], seed)
        self.sets: list[tuple[int, ...]] = []
        self.captures_after_warm_up = None

    def set_of(self, i: int) -> tuple[int, ...]:
        """The ordered set of objects of call i after the warm-up."""
        while len(self.sets) <= i:
            self.sets.append(self.churn.step())
        return self.sets[i]

    def _track_set(self, model, f: int, prev: int, objects) -> np.ndarray:
        rgb, depth, _ = self.frames[f]
        return model.track_batch(rgb, depth, self.gts[prev][list(objects)],
                                 [self.names[j] for j in objects], self.config["refine_itr"])

    def warm_up(self, model) -> None:
        for n in range(1, self.params["objects"] + 1):
            self._track_set(model, *self.frame_of(n - 1), range(n))
        self.captures_after_warm_up = _captures()

    def call(self, model, i: int) -> None:
        f, prev = self.frame_of(i)
        objects = self.set_of(i)
        self.window.append((f, prev, objects, self._track_set(model, f, prev, objects)))

    def program_outputs(self, model) -> dict:
        """The calls, and the graph captures the program made after the
        warm-up (None where it does not count them)."""
        now = _captures()
        made = None if now is None or self.captures_after_warm_up is None \
            else now - self.captures_after_warm_up
        return {"window": list(self.window), "window_captures": made}

    def control_outputs(self, ref) -> dict:
        itr = self.config["refine_itr"]
        window = []
        for i in range(2 * (len(self.frames) - 1)):
            f, prev = self.frame_of(i)
            objects = self.set_of(i)
            rgb, depth, _ = self.frames[f]
            window.append((f, prev, objects, _subset(ref, objects).track(
                rgb, depth, self.gts[prev][list(objects)], itr)))
        return {"window": window}

    def work(self, outputs: dict, ref) -> dict:
        """The refiner's operations at the calls' mean N; K2's bound
        (``counts_mixed``) on each call's own objects at their hypotheses,
        averaged over the calls; the captures after the warm-up and the
        calls they are counted over."""
        window = outputs["window"]
        nets, itr = self.config["nets"], self.config["refine_itr"]
        mean_n = float(np.mean([len(objects) for _, _, objects, _ in window])) if window else 0.0
        out = {"flops": counts.track_flops(
            mean_n, itr, crop=nets["crop_hw"], width1=nets["width1"], width2=nets["width2"],
            embed=nets["embed_dim"], ffn=nets["ffn_dim"], layers=nets["num_encoder_layers"])}
        if window:
            tests, meshes = self._tests_by_frame(ref)
            bounds = {}
            for _, prev, objects, _ in window:
                if (prev, objects) not in bounds:
                    bounds[prev, objects] = itr * counts_mixed.render_bound_s(
                        len(objects), nets["crop_hw"], [meshes[j] for j in objects],
                        int(sum(tests[prev, j] for j in objects)))
            out["k2_mixed_bound_s"] = float(np.mean([bounds[prev, objects]
                                                     for _, prev, objects, _ in window]))
        if outputs.get("window_captures") is not None:
            out["window_captures"] = outputs["window_captures"]
            out["window_calls"] = len(window)
        return out

    def _tests_by_frame(self, ref):
        """(face-pixel tests of object j rendered at its pose of frame k, by
        (k, j); each object's (vertices, faces, texels))."""
        h, w = self.config["frame_hw"]
        crop = self.config["nets"]["crop_hw"]
        tests, meshes = np.zeros((len(self.gts), len(ref.objects)), np.int64), []
        for j, obj in enumerate(ref.objects):
            mesh = obj.mesh
            poses = torch.as_tensor(self.gts[:, j], device=self.device)
            tfs = geometry.crop_window_tf(poses, obj.K, crop, CFG["refine_crop_ratio"],
                                          mesh.diameter)
            clip = geometry.clip_matrix(poses, geometry.crop_bbox(tfs, crop), obj.K, h, w,
                                        CFG["znear"], CFG["zfar"])
            clips = geometry.transform_h(clip, mesh.vertices)
            for k in range(len(self.gts)):
                tests[k, j] = counts.render_tests_needed(clips[k:k + 1], mesh.faces, crop, crop)
            meshes.append((mesh.vertices.shape[0], mesh.faces.shape[0],
                           mesh.texture.shape[0] * mesh.texture.shape[1]))
        return tests, meshes

    @staticmethod
    def sample(window) -> list[int]:
        """The calls the check compares: ``CHECK_CALLS`` evenly spaced (all
        when fewer), and the first call of each N the sample misses."""
        if not window:
            return []
        picked = set(np.linspace(0, len(window) - 1, min(len(window), CHECK_CALLS))
                     .round().astype(int).tolist())
        sizes = {len(window[i][2]) for i in picked}
        for i, (_, _, objects, _) in enumerate(window):
            if len(objects) not in sizes:
                picked.add(i)
                sizes.add(len(objects))
        return sorted(picked)

    def check(self, out: dict, ref) -> dict:
        lim, itr = self.wl["limits"], self.config["refine_itr"]
        window = out["window"]
        want, rot, trans = {}, [], []
        for i in self.sample(window):
            f, prev, objects, pose = window[i]
            if (f, prev, objects) not in want:
                rgb, depth, _ = self.frames[f]
                want[f, prev, objects] = _subset(ref, objects).track(
                    rgb, depth, self.gts[prev][list(objects)], itr)
            rot.append(scene.worst(scene.rot_deg(pose, want[f, prev, objects])))
            trans.append(scene.worst(scene.trans_mm(pose, want[f, prev, objects])))
        return {
            "pose_rot_deg": scene.check_entry(scene.worst(rot) if rot else float("nan"),
                                              lim["pose_rot_deg"]),
            "pose_trans_mm": scene.check_entry(scene.worst(trans) if trans else float("nan"),
                                               lim["pose_trans_mm"]),
        }


def _subset(ref: scene_multi.MultiReference, objects) -> scene_multi.MultiReference:
    """The reference of ``objects``, in their order: each object's own
    ``pipeline.Reference``."""
    return scene_multi.MultiReference([ref.objects[j] for j in objects])


def _captures() -> int | None:
    """The process's graph captures, as the program counts them, or None."""
    from foundationpose_cpp_tpu_torch.utils import profiling

    recorder = getattr(profiling, "RECORDER", None)
    return getattr(recorder, "captures", None)
