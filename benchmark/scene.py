"""What the traffic generators share: the program built from a configuration,
the reference built from the same files, poses drawn from the seed, and
the pose comparisons of the check."""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from benchmark.reference import assets, pipeline


def repo_path(root: pathlib.Path, rel: str) -> str:
    """A path of a configuration, relative to the checkout's root."""
    return str(root.parent / rel)


def build_model(config: dict, device: torch.device, root: pathlib.Path):
    """The program under test, as a user builds it: the mesh through the
    port's loader, the checkpoints by path."""
    from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
    from foundationpose_cpp_tpu_torch.meshio.mesh_loader import load_mesh
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

    h, w = config["frame_hw"]
    crop = config["nets"]["crop_hw"]
    cfg = FoundationPoseConfig(
        crop_window_h=crop, crop_window_w=crop, n_views=config["n_views"],
        inplane_step_deg=config["inplane_step_deg"],
        use_bf16_models=config["precision"]["nets"] == "bfloat16",
    )
    mesh = load_mesh(config["mesh"]["name"], repo_path(root, config["mesh"]["file"]))
    return FoundationPose(repo_path(root, config["refiner"]), repo_path(root, config["scorer"]),
                          [mesh], np.asarray(config["K"], np.float32), h, w, cfg,
                          device=str(device))


def reference_mesh(config: dict, device, root: pathlib.Path) -> assets.Mesh:
    return assets.load_mesh(repo_path(root, config["mesh"]["file"]), device)


def build_reference(config: dict, device, root: pathlib.Path, quant=None,
                    geom=None) -> pipeline.Reference:
    """The plain float32 reference (TF32 off), or a control with ``quant``
    or ``geom``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return pipeline.Reference(
        reference_mesh(config, device, root),
        assets.read_params(repo_path(root, config["refiner"]), device),
        assets.read_params(repo_path(root, config["scorer"]), device),
        torch.as_tensor(np.asarray(config["K"], np.float32), device=device),
        config["nets"]["crop_hw"], heads=config["nets"]["num_heads"], quant=quant,
        geom=geom, n_views=config["n_views"], inplane_step_deg=config["inplane_step_deg"],
    )


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A rotation uniform over SO(3) (a normalised Gaussian quaternion)."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def axis_angle(axis: np.ndarray, deg: float) -> np.ndarray:
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = math.radians(deg)
    return np.eye(3) + math.sin(a) * kx + (1 - math.cos(a)) * kx @ kx


def unit(rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def rot_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angles in degrees between the rotations of (..., 4, 4) poses."""
    r = np.einsum("...ij,...kj->...ik", np.asarray(a, np.float64)[..., :3, :3],
                  np.asarray(b, np.float64)[..., :3, :3])
    cos = (np.trace(r, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def trans_mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(a, np.float64)[..., :3, 3]
                          - np.asarray(b, np.float64)[..., :3, 3], axis=-1) * 1e3


def worst(x) -> float:
    """The largest value, NaN when any is NaN (a NaN fails every limit)."""
    x = np.asarray(x, np.float64).reshape(-1)
    return float("nan") if np.isnan(x).any() else float(x.max(initial=0.0))


def check_entry(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
