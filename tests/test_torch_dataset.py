"""The port's dataset path against the JAX package's on the CPU: the mini
dataset writer, ``run_dataset`` end to end at the narrow net of
tests/test_demo_dataset.py, the pose metrics and the bbox overlay.

Tolerances: written frames under 1% of pixels off (mask differs, rgb by
more than one level, depth by more than 2 mm), the render budget of
tests/test_torch_render.py (pixels on a face edge); cam_K, GT poses and the
OBJ exact. ``run_dataset``: the same frames and summary keys, per-frame
poses within 1e-4 (tests/test_torch_pipeline.py) up to the cube's 24
rotations (the dataset's mesh is an untextured cube, so symmetric
hypotheses tie in the scorer), f32 nets with the weights
carried across by ``models/convert_jax.py`` and the JAX attention through
its Pallas kernel in interpret mode. Metrics and overlays exactly.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from examples.demo_dataset import run_dataset as j_run_dataset
from foundationpose_cpp_tpu.config import FoundationPoseConfig as JConfig
from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu.utils import metrics as jmetrics
from foundationpose_cpp_tpu.utils import synthetic as jsyn
from foundationpose_cpp_tpu.utils import viz as jviz
from foundationpose_cpp_tpu_torch import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.demo_dataset import run_dataset
from foundationpose_cpp_tpu_torch.geometry import symmetry as tsym
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.ops import rasterize_tiled as rt
from foundationpose_cpp_tpu_torch.utils import io as tio
from foundationpose_cpp_tpu_torch.utils import metrics as tmetrics
from foundationpose_cpp_tpu_torch.utils import synthetic as tsyn
from foundationpose_cpp_tpu_torch.utils import viz as tviz

JCFG = JConfig(crop_window_h=32, crop_window_w=32)
TCFG = FoundationPoseConfig(crop_window_h=32, crop_window_w=32, use_bf16_models=False)
NET = jnet.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
                     dtype=jnp.float32, attn_impl="pallas_interpret")
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    base = tmp_path_factory.mktemp("datasets")
    jsyn.write_mini_dataset(str(base / "jax"), n_frames=3, cfg=JCFG)
    before = rt.rasterize_tiled.launches
    K = tsyn.write_mini_dataset(str(base / "port"), n_frames=3, cfg=TCFG, device="cpu")
    assert rt.rasterize_tiled.launches == before  # the CPU runs the plain version
    return base / "jax", base / "port", K


def test_write_mini_dataset_matches_jax(datasets):
    jroot, troot, K = datasets
    np.testing.assert_array_equal(tio.read_cam_k(str(troot / "cam_K.txt")), K)
    for name in ("cam_K.txt", "mesh/cube.obj", *(f"annotated_poses/{i:06d}.txt" for i in range(3))):
        assert (troot / name).read_text() == (jroot / name).read_text(), name
    assert tio.list_frame_ids(str(troot)) == tio.list_frame_ids(str(jroot)) == ["000000", "000001", "000002"]
    for fid in tio.list_frame_ids(str(troot)):
        t_rgb, t_depth, t_mask = tio.read_frame(str(troot), fid, with_mask=True)
        j_rgb, j_depth, j_mask = tio.read_frame(str(jroot), fid, with_mask=True)
        assert t_rgb.shape == (120, 160, 3) and t_depth.dtype == np.float32
        assert (t_mask > 0).mean() > 0.05
        assert (t_mask != j_mask).mean() < 0.01
        rgb_off = (np.abs(t_rgb.astype(int) - j_rgb.astype(int)) > 1).any(axis=-1)
        assert rgb_off.mean() < 0.01
        assert (np.abs(t_depth - j_depth) > 2e-3).mean() < 0.01


def _port_net(params, kind):
    return convert_jax.build_net(convert_jax.params_from_jax(jax.tree.map(np.asarray, params)), kind)


def test_run_dataset_matches_jax(datasets, tmp_path):
    jroot, _, _ = datasets
    pr, ps = jnet.init_refiner(0, NET), jnet.init_scorer(1, NET)
    want = j_run_dataset(str(jroot), str(tmp_path / "j"), config=JCFG, net_config=NET)
    got = run_dataset(str(jroot), str(tmp_path / "t"), refiner=_port_net(pr, "refiner"),
                      scorer=_port_net(ps, "scorer"), config=TCFG, device="cpu")
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == 3 and got["gt_frames"] == 3
    assert got["register_frame"] == want["register_frame"]
    assert json.loads((tmp_path / "t" / "summary.json").read_text()).keys() == want.keys()
    sym = tsym.box().astype(np.float64)
    for i in range(3):
        t_pose = np.loadtxt(tmp_path / "t" / f"pose_{i:06d}.txt")
        j_pose = np.loadtxt(tmp_path / "j" / f"pose_{i:06d}.txt")
        # the mesh is a gray cube: its 24 rotations render the same, so the
        # Register argmax may pick any of them
        excess = min(np.max(np.abs(t_pose - j_pose @ s) / (POSE_TOL + POSE_TOL * np.abs(j_pose @ s)))
                     for s in sym)
        assert excess <= 1.0, (i, t_pose, j_pose)
        overlay = tio.read_rgb(str(tmp_path / "t" / f"bbox_{i:06d}.png"))
        assert overlay.shape == (120, 160, 3)
    # ADD-S is blind to the cube's symmetry, ADD is not
    np.testing.assert_allclose(got["adds_mean"], want["adds_mean"], rtol=0, atol=POSE_TOL)
    assert got["adds_auc"] == want["adds_auc"]


def test_run_dataset_random_nets_and_video_skip(datasets, tmp_path, monkeypatch, capsys):
    """No nets given: seeded random nets of net_config; no cv2: the video
    step is skipped with the JAX function's message."""
    _, troot, _ = datasets
    monkeypatch.setitem(sys.modules, "cv2", None)
    narrow = dataclasses.asdict(NET)
    narrow.pop("dtype"), narrow.pop("attn_impl")
    from foundationpose_cpp_tpu_torch.models import networks as tnet

    summary = run_dataset(str(troot), str(tmp_path / "o"), max_frames=2, config=TCFG,
                          net_config=tnet.NetConfig(**narrow), video_path=str(tmp_path / "v.mp4"),
                          device="cpu")
    out = capsys.readouterr().out
    assert "RANDOM weights" in out and "cv2 unavailable; skipping video" in out
    assert summary["frames"] == 2 and not (tmp_path / "v.mp4").exists()
    assert np.isfinite(np.loadtxt(tmp_path / "o" / "pose_000001.txt")).all()


def test_run_dataset_missing_mesh_raises(tmp_path):
    root = tmp_path / "empty"
    (root / "rgb").mkdir(parents=True)
    (root / "mesh").mkdir(parents=True)
    np.savetxt(root / "cam_K.txt", np.eye(3), fmt="%.4f")
    with pytest.raises(FileNotFoundError, match="no mesh"):
        run_dataset(str(root), str(tmp_path / "o"), device="cpu")


def _poses(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        p = np.eye(4)
        p[:3, :3], p[:3, 3] = q, rng.normal(scale=0.05, size=3) + [0, 0, 0.5]
        out.append(p)
    return out


@pytest.mark.parametrize("n_pts", [500, 3000])
def test_metrics_equal_jax(n_pts):
    est, gt = _poses(n_pts)
    pts = np.random.default_rng(1).normal(scale=0.05, size=(n_pts, 3))
    for name in ("add_error", "adds_error"):
        assert getattr(tmetrics, name)(est, gt, pts) == getattr(jmetrics, name)(est, gt, pts)
    assert tmetrics.rotation_error_deg(est, gt) == jmetrics.rotation_error_deg(est, gt)
    assert tmetrics.translation_error(est, gt) == jmetrics.translation_error(est, gt)
    errs = np.random.default_rng(2).uniform(0, 0.12, size=50)
    assert tmetrics.add_auc(errs) == jmetrics.add_auc(errs)


def test_bbox_overlay_equals_jax_numpy_drawer(monkeypatch):
    """The port always draws with the numpy line drawer: the JAX overlay
    with cv2 blocked, exactly."""
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
    pose = tsyn.default_pose(0.5).astype(np.float64)
    dim = tproc.textured_house().dimensions
    rgb = np.random.default_rng(0).integers(0, 255, (120, 160, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tviz.project_bbox_corners(K, pose, dim),
                                  jviz.project_bbox_corners(K, pose, dim))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tviz.draw_3d_bbox(rgb, K, pose, dim)
    np.testing.assert_array_equal(got, jviz.draw_3d_bbox(rgb, K, pose, dim))
    assert (got != rgb).any()
