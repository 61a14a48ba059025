"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and skip without one. The file imports neither JAX
nor the JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: attention in bf16 within atol 2**-9 + rtol 2**-6 (4 bf16 ulps at
the outputs' typical size ~0.1, plus 2 ulps of the value), as
``chip_smoke.py`` holds it; in f32 within atol 1e-5 + rtol 1e-5 (f32 sums
of up to 1500 terms in another order); renders under 1% of pixels off by
more than 2e-3, as the CPU tests; the rasterizer with face ids agreeing on
more than 99.5% of pixels and rtol = atol = 1e-4 where they agree, the JAX
suite's floor for its TPU rasterizer (tests/test_rasterize_pallas.py:27-30).
"""

import pathlib

import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu_torch import create_foundationpose_model
from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.ops import attention, probe_grid, rasterize_tiled, render
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants
from foundationpose_cpp_tpu_torch.utils import synthetic

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights"
F32_TOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,heads,hd", [(3, 40, 2, 128), (2, 400, 4, 128), (1, 252, 4, 128),
                                          (2, 77, 4, 64), (1, 1024, 2, 32)])
def test_attention_kernel_matches_plain(card, b, t, heads, hd):
    gen = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn((b, t, 3 * heads * hd), generator=gen, device=card).to(torch.bfloat16)
    before = attention.mha_packed_qkv.launches
    got = attention.mha_packed_qkv(qkv, heads)
    assert attention.mha_packed_qkv.launches == before + 1
    want = attention.mha_packed_qkv_plain(qkv, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-6, atol=2.0**-9)


@pytest.mark.parametrize("b,t,heads,hd", [(3, 40, 2, 128), (2, 400, 4, 128), (1, 252, 4, 128),
                                          (2, 77, 4, 16)])
def test_attention_kernel_f32_matches_plain(card, b, t, heads, hd):
    gen = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn((b, t, 3 * heads * hd), generator=gen, device=card)
    got = attention.mha_packed_qkv(qkv, heads)
    want = attention.mha_packed_qkv_plain(qkv, heads)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,heads,t,hd", [(252, 8, 400, 64), (1, 8, 252, 64), (252, 4, 16, 16),
                                          (3, 2, 1024, 48), (2, 3, 33, 112), (6, 8, 300, 96)])
def test_whole_head_kernel_matches_plain(card, dtype, b, heads, t, hd):
    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((b, heads, t, hd), generator=gen, device=card).to(getattr(torch, dtype))
               for _ in range(3))
    before = attention.mha_whole_head.launches
    got = attention.mha_whole_head(q, k, v)
    assert attention.mha_whole_head.launches == before + 1
    want = attention.mha_whole_head_plain(q, k, v)
    tol = (2.0**-6, 2.0**-9) if dtype == "bfloat16" else (F32_TOL, F32_TOL)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


def test_attention_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="bf16"):
        attention.mha_packed_qkv(torch.zeros((1, 8, 3 * 128), device=card, dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="head_dim"):
        attention.mha_whole_head(*(torch.zeros((1, 1, 8, 24), device=card) for _ in range(3)))
    with pytest.raises(ValueError, match="aligned"):
        attention.mha_packed_qkv(torch.zeros((1, 8, 3 * 128 + 8), device=card,
                                             dtype=torch.bfloat16)[..., 8:], 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["packed", "head_split"])
@pytest.mark.parametrize("t", [63, 65, 399, 1500])
def test_attention_kernel_any_token_count(card, dtype, layout, t):
    """Ragged T around the 64-key tile, and more tokens than a block could keep
    f32 logits for in shared memory; hd > 64 and B * H * ceil(T / 128) >= 132 at
    T >= 128, so the bf16 launches at 399 and 1500 take the two-warpgroup blocks."""
    b, heads, hd = 5, 8, 128
    gen = torch.Generator(device=card).manual_seed(3)
    tol = dict(rtol=2.0**-6, atol=2.0**-9) if dtype == "bfloat16" else dict(rtol=F32_TOL, atol=F32_TOL)
    if layout == "packed":
        qkv = torch.randn((b, t, 3 * heads * hd), generator=gen, device=card).to(getattr(torch, dtype))
        got, want = attention.mha_packed_qkv(qkv, heads), attention.mha_packed_qkv_plain(qkv, heads)
    else:
        q, k, v = (torch.randn((b, heads, t, hd), generator=gen, device=card).to(getattr(torch, dtype))
                   for _ in range(3))
        got, want = attention.mha_whole_head(q, k, v), attention.mha_whole_head_plain(q, k, v)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _random_clip(n, v, seed, card):
    """Random clip-space vertices in front of the camera (w > 0)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(1.0, 3.0, size=(n, v, 1))
    xy = rng.uniform(-1.0, 1.0, size=(n, v, 2)) * w
    z = rng.uniform(-0.9, 0.9, size=(n, v, 1)) * w
    return torch.as_tensor(np.concatenate([xy, z, w], axis=-1), dtype=torch.float32, device=card)


def _small_scan(raw=False):
    """A 3,120-face scanned blob (raw), or the same decimated and subdivided
    as the scanned-mesh chain does (texel-patch metric)."""
    from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
    from foundationpose_cpp_tpu_torch.meshio.subdivide import subdivide_adaptive

    blob = procedural.scanned_blob(seed=3, n_lat=40, n_lon=40, tex_size=64)
    if raw:
        return blob
    return subdivide_adaptive(decimate_vertex_clustering(blob, target_faces=1_500),
                              max_faces=4_096, patch_k=4)[0]


def _scene_clip(asset, h, w, card, n=1):
    mesh = MeshConstants.from_asset(asset, card)
    K = torch.tensor([[600.0 * w / 640, 0, w / 2], [0, 600.0 * h / 480, h / 2], [0, 0, 1]],
                     device=card)
    poses = np.stack([synthetic.default_pose(0.5) for _ in range(n)])
    for i in range(n):
        poses[i, :3, :3] = synthetic.euler_xyz_deg([0.0, 40.0 * i, 0.0]) @ poses[i, :3, :3]
    poses = torch.as_tensor(poses, device=card)
    bbox2d = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=card).expand(n, 4)
    clip_mat = transforms.pose_clip_matrix(poses, bbox2d, K, h, w)
    return transforms.transform_points_homogeneous(clip_mat, mesh.vertices), mesh.faces


@pytest.mark.parametrize("case", ["house_480x640", "sphere_480x640", "random_n4_120x160",
                                  "random_37x53", "behind_camera", "house_n2_123x157",
                                  "cube_160x160", "planted_ties", "one_view_behind_camera",
                                  "scan_480x640"])
def test_rasterize_kernel_matches_plain(card, case):
    """Large faces (house, cube) and small ones (sphere), N = 1 and more,
    ragged sizes, faces and a whole view behind the camera, planted copies of
    faces (equal depth everywhere: the lower id wins). Every case runs a
    second time on plane coefficients handed in from edge_coefficients, where
    the scatter and the resolve must agree with the plain version on every
    pixel."""
    base_faces = None
    if case == "house_480x640":
        (clip, faces), h, w = _scene_clip(procedural.textured_house(), 480, 640, card), 480, 640
    elif case == "sphere_480x640":
        sphere = procedural.textured_uv_sphere(radius=0.05, n_lat=48, n_lon=64)
        (clip, faces), h, w = _scene_clip(sphere, 480, 640, card), 480, 640
    elif case == "house_n2_123x157":
        (clip, faces), h, w = _scene_clip(procedural.textured_house(), 123, 157, card, n=2), 123, 157
    elif case == "scan_480x640":
        (clip, faces), h, w = _scene_clip(_small_scan(raw=True), 480, 640, card), 480, 640
    elif case == "cube_160x160":
        (clip, faces), h, w = _scene_clip(procedural.textured_cube(size=0.1), 160, 160, card), 160, 160
    else:
        n = {"random_n4_120x160": 4, "one_view_behind_camera": 3}.get(case, 1)
        h, w = (120, 160) if n == 4 else (37, 53)
        clip = _random_clip(n, 40, 0, card)
        faces = torch.as_tensor(np.random.default_rng(1).integers(0, 40, (100, 3)),
                                dtype=torch.int32, device=card)
        if case == "behind_camera":
            clip[0, faces[60:, 0].long(), 3] = -0.5
        if case == "one_view_behind_camera":
            clip[1, :, 3] = -clip[1, :, 3]
        if case == "planted_ties":
            base_faces = faces.shape[0]
            faces = torch.cat([faces, faces[:50]])
    # the faces of the first view with a corner behind the camera: they never win
    valid = (clip[0, faces.long(), 3] > 0).all(dim=1)
    before = rasterize_tiled.rasterize_tiled.launches
    got = rasterize_tiled.rasterize_tiled(clip, faces, h, w)
    assert rasterize_tiled.rasterize_tiled.launches == before + 1
    want = rasterize_tiled.rasterize_tiled_plain(clip, faces, h, w)
    agree = got[..., 3] == want[..., 3]
    assert agree.float().mean().item() > 0.995
    torch.testing.assert_close(got[agree], want[agree], rtol=1e-4, atol=1e-4)
    assert (want[..., 3] > 0).float().mean().item() > 0.001
    invalid_ids = (~valid).nonzero()[:, 0] + 1
    assert not torch.isin(got[:1, ..., 3], invalid_ids.float()).any()
    if base_faces is not None:
        assert not (got[..., 3] > base_faces).any()  # a copy never beats its original
    if case == "one_view_behind_camera":
        assert (got[1] == 0).all() and (got[0, ..., 3] > 0).any() and (got[2, ..., 3] > 0).any()
    coeffs, _ = rasterize_tiled.rasterize_prepass(clip, faces, h, w)
    exact = rasterize_tiled.launch_rasterize(clip, faces, h, w, coeffs=coeffs)
    assert rasterize_tiled.rasterize_tiled.launches == before + 1  # only the wrapper counts
    assert torch.equal(exact[..., 3], want[..., 3])
    torch.testing.assert_close(exact, want, rtol=1e-4, atol=1e-4)


def test_raster_kernels_reject_what_they_do_not_take(card):
    clip = _random_clip(1, 12, 0, card)
    faces = torch.zeros((4, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="clip must be"):
        rasterize_tiled.rasterize_tiled(clip.half(), faces, 8, 8)
    with pytest.raises(ValueError, match="clip must be"):
        rasterize_tiled.rasterize_tiled(clip[..., :3], faces, 8, 8)
    with pytest.raises(ValueError, match="faces must be"):
        rasterize_tiled.rasterize_tiled(clip, faces.long(), 8, 8)
    with pytest.raises(ValueError, match="faces must be"):
        rasterize_tiled.rasterize_tiled(clip, faces.cpu(), 8, 8)
    with pytest.raises(ValueError, match="bad shape"):
        rasterize_tiled.rasterize_tiled(clip, faces, 0, 8)
    with pytest.raises(ValueError, match="coeffs must be"):
        rasterize_tiled.launch_rasterize(clip, faces, 8, 8, coeffs=torch.zeros((1, 4, 9), device=card))
    mesh = MeshConstants.from_asset(procedural.textured_cube(size=0.1), card)
    cfg = FoundationPoseConfig()
    poses = torch.eye(4, device=card)[None]
    args = [mesh.vertices, mesh.normals, mesh.texcoords, mesh.faces, mesh.texture, poses,
            poses.clone(), 16, 16, mesh.diameter, cfg.min_depth, cfg.max_depth, cfg.w_ambient,
            cfg.w_diffuse]
    for index, bad, match in ((3, mesh.faces.long(), "faces must be"),
                              (4, mesh.texture[..., :2], "texture must be"),
                              (0, mesh.vertices.double(), "vertices must be"),
                              (6, poses[:, :3], "clip_mat must be"),
                              (1, mesh.normals[:-1], "normals must be")):
        broken = list(args)
        broken[index] = bad
        with pytest.raises(ValueError, match=match):
            render.render_views(*broken)


def test_foundationpose_f32_nets_on_the_card(card):
    """use_bf16_models=False runs the nets, and the attention kernel, in f32."""
    cfg = FoundationPoseConfig(use_bf16_models=False)
    house = procedural.textured_house(name="house")
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
    gt = synthetic.default_pose(0.6)
    rgb, depth, mask = synthetic.render_scene(MeshConstants.from_asset(house, card), gt, K, 480, 640)
    model = create_foundationpose_model(
        str(WEIGHTS / "refiner_multi_full.npz"), str(WEIGHTS / "scorer_multi_full.npz"),
        [house], K, 480, 640, config=cfg)
    before = attention.mha_packed_qkv.launches
    pose = model.register(rgb, depth, mask, "house")
    tracked = model.track(rgb, depth, pose, "house")
    assert attention.mha_packed_qkv.launches == before + 4
    assert np.isfinite(pose).all() and np.isfinite(tracked).all()
    assert np.linalg.norm(pose[:3, 3] - gt[:3, 3]) < 0.1 * house.diameter


def _house_model(card, cfg=FoundationPoseConfig()):
    """The house at 480x640 with the trained weights: (model, gt, rgb, depth, mask)."""
    house = procedural.textured_house(name="house")
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
    gt = synthetic.default_pose(0.6)
    frame = synthetic.render_scene(MeshConstants.from_asset(house, card), gt, K, 480, 640)
    model = create_foundationpose_model(
        str(WEIGHTS / "refiner_multi_full.npz"), str(WEIGHTS / "scorer_multi_full.npz"),
        [house], K, 480, 640, config=cfg)
    return (model, gt, *frame)


def test_bucketed_matches_unbucketed_on_the_card(card):
    """A 480x640 frame in a (480, 640) bucket gives the unbucketed poses and
    scores; a 448x608 crop of it (same intrinsics) shares the bucket's one
    buffer set and still finds the house."""
    off, gt, rgb, depth, mask = _house_model(card)
    on = _house_model(card, FoundationPoseConfig(size_buckets=((480, 640),)))[0]
    for got, want in zip(on.register_with_scores(rgb, depth, mask, "house"),
                         off.register_with_scores(rgb, depth, mask, "house")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pose = off.register(rgb, depth, mask, "house")
    np.testing.assert_allclose(on.track(rgb, depth, pose, "house"),
                               off.track(rgb, depth, pose, "house"), rtol=0, atol=1e-5)
    crop = on.register(rgb[:448, :608], depth[:448, :608], mask[:448, :608], "house")
    assert np.linalg.norm(crop[:3, 3] - gt[:3, 3]) < 0.1 * on._assets["house"].diameter
    assert list(on._bucket_buffers) == [(480, 640)]


@pytest.mark.parametrize("depth_format,rgb_half", [("u16mm", False), ("f32", False),
                                                   ("u16mm", True)])
def test_packed_step_matches_track_on_the_card(card, depth_format, rgb_half):
    """One step on a packed frame already on the card equals track() on the
    frame it decodes, launches the render and the attention kernel once
    each, and returns the pose on the card."""
    from foundationpose_cpp_tpu_torch.pipeline.foundationpose import unpack_frame

    model, gt, rgb, depth, _ = _house_model(card)
    packed = model.pack_frame(rgb, depth, depth_format, rgb_half)
    dev = torch.from_numpy(packed).to(card)
    step = model.make_packed_tracker("house", (480, 640), depth_format=depth_format,
                                     rgb_half=rgb_half)
    before = (render.render_views.launches, attention.mha_packed_qkv.launches)
    got = step(dev, torch.from_numpy(gt).to(card))
    assert (render.render_views.launches, attention.mha_packed_qkv.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.device.type == "cuda" and got.shape == (4, 4)
    rgb_q, depth_q = (t.cpu().numpy() for t in unpack_frame(dev, (480, 640), depth_format,
                                                           rgb_half))
    want = model.track(rgb_q, depth_q, gt, "house")
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-5)
    assert np.degrees(np.arccos(np.clip((np.trace(want[:3, :3] @ gt[:3, :3].T) - 1) / 2,
                                        -1, 1))) < 5.0


def _render_args(mesh, ch, cw, n, card, tz=0.45):
    cfg = FoundationPoseConfig()
    rng = np.random.default_rng(0)
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = [0.01, -0.005, tz]
    poses = torch.as_tensor(poses, device=card)
    K = torch.tensor([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]], device=card)
    tfs = transforms.compute_crop_window_tf(poses, K, (ch, cw), 1.2, mesh.diameter)
    clip_mat = transforms.pose_clip_matrix(poses, transforms.construct_bbox2d(tfs, ch, cw), K, 128, 128)
    return (mesh.vertices, mesh.normals, mesh.texcoords, mesh.faces, mesh.texture, poses,
            clip_mat, ch, cw, mesh.diameter, cfg.min_depth,
            cfg.max_depth, cfg.w_ambient, cfg.w_diffuse)


@pytest.mark.parametrize("name,ch,cw,n", [("cube", 32, 32, 6), ("house", 48, 48, 6),
                                          ("sphere", 160, 160, 6), ("cube", 160, 160, 6),
                                          ("house", 123, 157, 3), ("sphere", 160, 160, 1),
                                          ("house", 160, 160, 140), ("cube", 200, 176, 40),
                                          ("planted_ties", 64, 64, 3), ("scan", 160, 160, 6),
                                          ("scan", 160, 160, 1)])
def test_render_kernel_matches_plain(card, name, ch, cw, n):
    """Large faces (cube, house) and small ones (sphere), one view (the
    32x32 regions of a launch with few blocks) and 140 (whole-crop regions),
    a ragged crop, a crop of four ragged 160x160 regions, faces planted twice, a
    decimated and subdivided scan; and on plane coefficients handed in
    from edge_coefficients, where no pixel may be off."""
    asset = {
        "cube": lambda: procedural.textured_cube(size=0.1),
        "house": lambda: procedural.textured_house(size=0.1),
        "planted_ties": lambda: procedural.textured_house(size=0.1),
        "sphere": lambda: procedural.textured_uv_sphere(radius=0.05, n_lat=24, n_lon=32),
        "scan": _small_scan,
    }[name]()
    mesh = MeshConstants.from_asset(asset, card)
    args = _render_args(mesh, ch, cw, n, card)
    if name == "planted_ties":
        args = args[:3] + (torch.cat([mesh.faces, mesh.faces]),) + args[4:]
    sl = slice(0, min(n, 8))
    part = args[:5] + (args[5][sl], args[6][sl]) + args[7:]
    want = render.render_views_plain(*part)
    assert (want.abs().sum(-1) > 0).float().mean().item() > 0.1
    verts = render.vertex_prepass_plain(args[0], args[1], part[5], part[6])
    coeffs, _, _ = render.render_prepass(*part[:4], part[5], part[6], ch, cw)
    before = render.render_views.launches
    got = render.render_views(*args)
    assert render.render_views.launches == before + 1
    bad = ((got[sl] - want).abs().amax(dim=-1) > 2e-3).float().mean().item()
    assert bad < 0.01
    exact = render.launch_render(verts, args[2], args[3], args[4], part[5], *args[7:],
                                 coeffs=coeffs)
    assert render.render_views.launches == before + 1  # only the wrapper counts
    assert ((exact - want).abs().amax(dim=-1) > 2e-3).sum().item() == 0


def test_render_kernel_view_behind_the_camera_is_zero(card):
    mesh = MeshConstants.from_asset(procedural.textured_cube(size=0.1), card)
    args = list(_render_args(mesh, 48, 48, 3, card))
    args[5] = args[5].clone()
    args[5][1, 2, 3] = -0.45  # the middle view looks away from the cube
    K = torch.tensor([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]], device=card)
    tfs = transforms.compute_crop_window_tf(args[5], K, (48, 48), 1.2, mesh.diameter)
    args[6] = transforms.pose_clip_matrix(args[5], transforms.construct_bbox2d(tfs, 48, 48), K, 128, 128)
    got = render.render_views(*args)
    want = render.render_views_plain(*args)
    assert (got[1] == 0).all() and (want[1] == 0).all()
    assert ((got - want).abs().amax(dim=-1) > 2e-3).float().mean().item() < 0.01
    assert (got[0].abs().sum(-1) > 0).any() and (got[2].abs().sum(-1) > 0).any()


def test_track_and_register_never_wait_for_the_card(card):
    """64 chained packed steps and a register_step on tensors already on the
    card run under set_sync_debug_mode("error"): nothing in them waits for
    the card, so the host queues ahead of it. Their poses equal those of the
    same calls run outside the mode."""
    from foundationpose_cpp_tpu_torch.pipeline import foundationpose as fpp

    model, gt, rgb, depth, mask = _house_model(card)
    step = model.make_packed_tracker("house", (480, 640))
    packed = torch.from_numpy(model.pack_frame(rgb, depth)).to(card)
    frame = [torch.from_numpy(a).to(card) for a in (rgb, depth, mask)]
    pose0 = torch.from_numpy(gt).to(card)

    def run():
        pose = pose0
        for _ in range(64):
            pose = step(packed, pose)
        with torch.inference_mode():
            best = fpp.register_step(model._meshes["house"], model._refiner, model._scorer,
                                     *frame, model._rot_grid, model._K, 1, model._cfg)[0]
        return pose, best

    want = [t.cpu() for t in run()]  # the first calls build the kernels and constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_kernels_refuse_inputs_that_require_grad(card):
    """Each CUDA wrapper writes its output through raw pointers, so autograd
    would lose the gradient: under grad mode an input that requires one
    raises, under no_grad the same call runs (the JAX package's Pallas
    kernels have no VJP either)."""
    gen = torch.Generator(device=card).manual_seed(5)
    qkv = torch.randn((2, 40, 3 * 2 * 128), generator=gen, device=card).requires_grad_()
    with pytest.raises(RuntimeError, match="mha_packed_qkv.*forward-only"):
        attention.mha_packed_qkv(qkv, 2)
    q, k, v = (torch.randn((2, 3, 33, 16), generator=gen, device=card) for _ in range(3))
    with pytest.raises(RuntimeError, match="mha_whole_head.*forward-only"):
        attention.mha_whole_head(q, k.requires_grad_(), v)
    mesh = MeshConstants.from_asset(procedural.textured_cube(size=0.1), card)
    args = list(_render_args(mesh, 32, 32, 2, card))
    args[5] = args[5].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="render_views.*forward-only"):
        render.render_views(*args)
    verts = render.vertex_prepass_plain(args[0], args[1], args[5].detach(), args[6])
    with pytest.raises(RuntimeError, match="launch_render.*forward-only"):
        render.launch_render(verts.requires_grad_(), *args[2:5], args[5], *args[7:])
    with torch.no_grad():
        assert attention.mha_packed_qkv(qkv, 2).shape == (2, 40, 256)
        assert attention.mha_whole_head(q, k, v).shape == q.shape
        assert render.render_views(*args).shape == (2, 32, 32, 6)
        assert render.launch_render(verts, *args[2:5], args[5], *args[7:]).shape == (2, 32, 32, 6)


def test_refiner_step_on_the_card_trains_every_layer(card):
    """One refiner step on the card at a head width of 128 (where the nets
    would take the attention kernel): the trainer's plain attention carries
    gradients to the layers before the attention, and the render kernel
    makes the batch twice."""
    import dataclasses

    from foundationpose_cpp_tpu_torch.models import networks
    from foundationpose_cpp_tpu_torch.training import synthetic as tr

    mesh = MeshConstants.from_asset(procedural.textured_house(size=0.1), card)
    cfg = FoundationPoseConfig(crop_window_h=32, crop_window_w=32)
    tcfg = tr.SyntheticTrainConfig(frame_hw=64, focal=180.0, batch=4, steps_per_call=1,
                                   warmup_steps=1, lr=1e-3)
    net_cfg = networks.NetConfig(width1=8, width2=8, embed_dim=256, num_heads=2, ffn_dim=16,
                                 crop_hw=32)
    before = networks.init_net("refiner", net_cfg, 0).state_dict()  # the trainer's seed-0 start
    counts = (render.render_views.launches, attention.mha_packed_qkv.launches)
    net = tr.train_refiner(mesh, cfg, net_cfg, tcfg, steps=2, seed=0)
    assert render.render_views.launches - counts[0] == 4
    assert attention.mha_packed_qkv.launches == counts[1]
    after = {k: v.cpu() for k, v in net.state_dict().items()}
    for key in ("encodeA.conv0.weight", "encodeAB.res1.conv2.weight", "encoder.0.attn.qkv.weight",
                "pos_embed"):
        assert not torch.equal(after[key], before[key]), key
    # the same net with the default attention refuses to be differentiated
    auto = networks.init_net("refiner", dataclasses.replace(net_cfg, attn_impl="auto"), 0).to(card)
    x = torch.rand((1, 32, 32, 6), device=card)
    with pytest.raises(RuntimeError, match="forward-only"):
        auto(x, x)


def test_sharded_register_on_one_rank_equals_register_step(card, tmp_path):
    """The hypothesis split at one rank over NCCL, in a rank process of its
    own (``parallel.ranks``): the house at full width with the committed
    weights. At one rank the Register is a captured program: its warm-up
    runs it and captures it (three all-gathers each), its counted run is a
    replay under set_sync_debug_mode("error") that issues no collective
    from Python, launches K2, K6 and the padded stem twice, K1 three times
    and K7 (the conv epilogue) 18 times (no other counted wrapper), equals
    the program's function run
    eagerly bit for bit and register_step at atol 1e-6."""
    from foundationpose_cpp_tpu_torch.geometry import icosphere
    from foundationpose_cpp_tpu_torch.parallel import ranks

    house = procedural.textured_house(name="house")
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
    rgb, depth, mask = synthetic.render_scene(MeshConstants.from_asset(house, card),
                                              synthetic.default_pose(0.6), K, 480, 640)
    grid = icosphere.make_rotation_grid()
    job = dict(device=None, mesh=["textured_house", {"name": "house"}], K=K.tolist(), cfg={},
               refiner=str(WEIGHTS / "refiner_multi_full.npz"),
               scorers={"multi": str(WEIGHTS / "scorer_multi_full.npz")},
               tasks=[{"kind": "register", "scorer": "multi"}])
    (out,) = ranks.run(job, dict(rgb=rgb, depth=depth, mask=mask, rot_grid=grid,
                                 hyp_valid=np.ones(252, bool)), 1, tmp_path, timeout=300)
    meta, a = out["meta"], out["arrays"]
    (task,) = meta["tasks"]
    assert meta["backend"] == "nccl" and not meta["jax_imported"]
    assert task["collectives"] == {} and task["warmup_collectives"] == {"all_gather": 6}
    assert [p["key"] for p in task["programs"]] == [["sharded_register", 252, [480, 640], 1]]
    assert task["launches"] == {"render_views": 2, "mha_packed_qkv": 3, "padded_stem": 2,
                                "crop_observed": 2, "conv_epilogue": 18}
    for name in ("best", "poses", "scores", "ok"):
        np.testing.assert_array_equal(a[f"t0_{name}"], a[f"t0_eager_{name}"])
    for name in ("best", "poses", "scores"):
        np.testing.assert_allclose(a[f"t0_{name}"], a[f"t0_ref_{name}"], rtol=0, atol=1e-6)
    assert bool(a["t0_ok"]) and np.isfinite(a["t0_best"]).all()


def test_sharded_track_on_one_rank_is_a_program(card, tmp_path):
    """``make_sharded_track_batch`` at one rank over NCCL, two chained steps
    of two instances of the house: the first call runs the step and
    captures it (one all-gather each), the second and the counted run's
    two are replays that issue none from Python and launch K1, K2, K6 and
    the padded stem once a step and K7 9 times; the poses equal the program's function run eagerly bit for bit
    and track_step's at atol 1e-6."""
    from foundationpose_cpp_tpu_torch.parallel import ranks

    house = procedural.textured_house(name="house")
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
    gt = synthetic.default_pose(0.6)
    rgb, depth, _ = synthetic.render_scene(MeshConstants.from_asset(house, card), gt, K, 480, 640)
    starts = np.stack([gt, gt]).astype(np.float32)
    starts[1, :3, 3] += 0.01
    job = dict(device=None, mesh=["textured_house", {"name": "house"}], K=K.tolist(), cfg={},
               refiner=str(WEIGHTS / "refiner_multi_full.npz"),
               tasks=[{"kind": "track", "steps": 2}])
    (out,) = ranks.run(job, dict(rgb=rgb, depth=depth, track_poses=starts), 1, tmp_path,
                       timeout=300)
    (task,) = out["meta"]["tasks"]
    a = out["arrays"]
    assert task["collectives"] == {} and task["warmup_collectives"] == {"all_gather": 2}
    assert [p["key"] for p in task["programs"]] == [["sharded_track_batch", 2, [480, 640], 1]]
    assert task["launches"] == {"render_views": 2, "mha_packed_qkv": 2, "padded_stem": 2,
                                "crop_observed": 2, "conv_epilogue": 18}
    np.testing.assert_array_equal(a["t0_poses"], a["t0_eager_poses"])
    np.testing.assert_allclose(a["t0_poses"], a["t0_ref_poses"], rtol=0, atol=1e-6)


def test_train_step_programs_equal_eager_steps_on_the_card(card):
    """Four steps of the multi-object scorer trainer on two family objects
    through its step programs (CUDA graphs, one an object) equal the same
    four steps with every program run eagerly, bit for bit in the losses
    and the parameters, under cuDNN's deterministic mode (in its default
    mode two eager runs already differ); K2 launches twice a step."""
    import dataclasses

    from foundationpose_cpp_tpu_torch.meshio import family
    from foundationpose_cpp_tpu_torch.models import networks
    from foundationpose_cpp_tpu_torch.pipeline import programs
    from foundationpose_cpp_tpu_torch.training import multi
    from foundationpose_cpp_tpu_torch.training import synthetic as tr

    bank = multi.build_mesh_bank([family.random_family_asset(s) for s in range(2)], device=card)
    cfg = FoundationPoseConfig(crop_window_h=32, crop_window_w=32)
    tcfg = tr.SyntheticTrainConfig(frame_hw=64, focal=180.0, batch=8, hyps_per_scene=4,
                                   steps_per_call=1, warmup_steps=4, lr=1e-3)
    net_cfg = networks.NetConfig(width1=8, width2=8, embed_dim=256, num_heads=2, ffn_dim=16,
                                 crop_hw=32, cross_attention=True)

    def run():
        losses = []
        net = multi.train_scorer_multi(bank, cfg, net_cfg, tcfg, steps=4, seed=0,
                                       on_step=lambda i, loss: losses.append(loss))
        return net.state_dict(), torch.stack(losses)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = render.render_views.launches
        graphed = run()
        assert render.render_views.launches - before == 8
        with programs.eager():
            eager = run()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(graphed[1], eager[1])
    for key, value in graphed[0].items():
        assert torch.equal(value, eager[0][key]), key


@pytest.mark.parametrize("shape", [probe_grid.NARROW, probe_grid.WIDE, (3, 2, 7, 96),
                                   (1, 1, 1, probe_grid.MAX_LANES)])
def test_probe_grid_kernel_matches_plain_bit_for_bit(card, shape):
    """The grid-overhead probe at the tool's two shapes (the wide one asks
    for 160 KB of shared memory a block), a ragged width and the widest."""
    before = probe_grid.probe_grid.launches
    got = probe_grid.probe_grid(*shape, card)
    assert probe_grid.probe_grid.launches == before + 1
    want = probe_grid.probe_grid_plain(*shape, card)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _tree_max_abs(got, want) -> float:
    """max |got - want| over a tensor, a tuple or a dict of them (bools as 0/1)."""
    if isinstance(got, torch.Tensor):
        return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if isinstance(got, dict):
        return max(_tree_max_abs(got[k], want[k]) for k in want)
    return max(_tree_max_abs(g, w) for g, w in zip(got, want))


def test_track_graph_chain_equals_eager_chain(card):
    """The Track program (a CUDA graph) replayed 64 times, the pose fed
    forward on the card, equals the same 64 calls of its function run
    eagerly, bit for bit; each replay counts one launch of K1 and of K2."""
    model, gt, rgb, depth, _ = _house_model(card)
    model.track(rgb, depth, gt, "house")  # the capture
    program = model._track_cache[("track", "house", (480, 640), 1, False)]
    assert program.captured and program.launches_per_call == {"mha_packed_qkv": 1,
                                                              "render_views": 1,
                                                              "padded_stem": 1,
                                                              "crop_observed": 1,
                                                              "conv_epilogue": 9}
    frame = [torch.from_numpy(a).to(card) for a in (rgb, depth)]
    pose, eager = torch.from_numpy(gt).to(card), torch.from_numpy(gt).to(card)
    before = (render.render_views.launches, attention.mha_packed_qkv.launches)
    got, want = [], []
    with torch.inference_mode():
        for _ in range(64):
            pose = program(*frame, pose)
            got.append(pose)
        assert (render.render_views.launches, attention.mha_packed_qkv.launches) == \
            (before[0] + 64, before[1] + 64)
        for _ in range(64):
            eager = program.fn(*frame, eager)
            want.append(eager)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_register_graph_equals_eager(card):
    """Register through its program, the replay after the capture, equals
    register_step run eagerly on the same frame, bit for bit; outputs of
    two calls do not share memory."""
    model, gt, rgb, depth, mask = _house_model(card)
    first = model._run_register(rgb, depth, mask, "house", 1)  # the capture
    second = model._run_register(rgb, depth, mask, "house", 1)
    program = model._register_cache[("register", "house", (480, 640), 1, False)]
    assert program.captured and program.launches_per_call == {"mha_packed_qkv": 3,
                                                              "render_views": 2,
                                                              "padded_stem": 2,
                                                              "crop_observed": 2,
                                                              "conv_epilogue": 18}
    assert first[1].data_ptr() != second[1].data_ptr()
    frame = [torch.from_numpy(a).to(card) for a in (rgb, depth, mask)]
    with torch.inference_mode():
        want = program.fn(*frame)
    assert _tree_max_abs(second, want) == 0.0
    assert np.linalg.norm(second[0][:3, 3].cpu().numpy() - gt[:3, 3]) < 0.1 * \
        model._assets["house"].diameter


def test_program_replays_make_no_host_sync(card):
    """Replays of the Register, Track, track_batch, bucketed Register and
    inference-core programs on arguments already on the card run under
    set_sync_debug_mode("error") and give the results of the same replays
    outside the mode."""
    from foundationpose_cpp_tpu_torch import create_scorer_core

    model, gt, rgb, depth, mask = _house_model(card)
    bucketed = _house_model(card, FoundationPoseConfig(size_buckets=((480, 640),)))[0]
    poses = np.stack([gt, gt])
    model.register(rgb, depth, mask, "house")
    model.track(rgb, depth, gt, "house")
    model.track_batch(rgb, depth, poses, "house")
    bucketed.register(rgb[:448, :608], depth[:448, :608], mask[:448, :608], "house")
    core = create_scorer_core(str(WEIGHTS / "scorer_multi_full.npz"))
    crops = torch.rand((2, 5, 160, 160, 6), device=card)
    core.infer({"render_input": crops[0], "transf_input": crops[1]})
    frame = [torch.from_numpy(a).to(card) for a in (rgb, depth, mask)]
    pose = torch.from_numpy(gt).to(card)
    calls = [
        (model._register_cache[("register", "house", (480, 640), 1, False)], frame),
        (model._track_cache[("track", "house", (480, 640), 1, False)], [*frame[:2], pose]),
        (model._track_cache[("track_batch", "house", (480, 640), 1, 2, False)],
         [*frame[:2], torch.from_numpy(poses).to(card)]),
        (bucketed._register_cache[("register", "house", (480, 640), 1, True)],
         bucketed._frame_args(rgb[:448, :608], depth[:448, :608], mask[:448, :608])),
        (next(iter(core._programs.values())),
         list(torch.nn.functional.pad(crops, (0, 0, 0, 0, 0, 0, 0, 3)))),
    ]
    with torch.inference_mode():
        want = [program(*args) for program, args in calls]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [program(*args) for program, args in calls]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert _tree_max_abs(g, w) == 0.0


# the nets' bf16 budget for one conv computed another way (chip_smoke.py's
# STEM_BF16_TOL): the padded stem changes only the stem's algorithm
STEM_BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_padded_stem_nets_match_the_direct_stem(card, kind, monkeypatch):
    """The trained bf16 nets at N=252 take the padded stem once a forward
    and give the outputs of the direct stem (the route forced off) within
    the bf16 budget of one conv."""
    net = convert_jax.as_net(str(WEIGHTS / f"{kind}_multi_full.npz"), kind, card, torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(11)
    a, b = (torch.rand((252, 160, 160, 6), generator=gen, device=card) for _ in range(2))
    with torch.inference_mode():
        before = networks.padded_stem.launches
        got = net(a, b)
        assert networks.padded_stem.launches == before + 1
        monkeypatch.setattr(networks, "pads_stem", lambda x, dtype: False)
        want = net(a, b)
        assert networks.padded_stem.launches == before + 1
    for key in want:
        torch.testing.assert_close(got[key], want[key], **STEM_BF16_TOL)


def test_padded_stem_counts_on_every_replay(card):
    """The padded stem's counter reads 2 a Register replay (refiner and
    scorer) and 1 a Track or track_batch replay, as each program's
    launches_per_call says."""
    model, gt, rgb, depth, mask = _house_model(card)
    poses = np.stack([gt, gt])
    model.register(rgb, depth, mask, "house")
    model.track(rgb, depth, gt, "house")
    model.track_batch(rgb, depth, poses, "house")
    calls = [
        (model.register, (rgb, depth, mask, "house"),
         model._register_cache[("register", "house", (480, 640), 1, False)], 2),
        (model.track, (rgb, depth, gt, "house"),
         model._track_cache[("track", "house", (480, 640), 1, False)], 1),
        (model.track_batch, (rgb, depth, poses, "house"),
         model._track_cache[("track_batch", "house", (480, 640), 1, 2, False)], 1),
    ]
    for call, args, program, want in calls:
        assert program.captured and program.launches_per_call["padded_stem"] == want
        before = networks.padded_stem.launches
        call(*args)
        assert networks.padded_stem.launches == before + want


def test_stem_weights_loaded_after_a_capture_reach_the_next_replay(card):
    """The padded stem pads the (64, 6, 7, 7) parameter inside the graph, so
    load_state_dict after the capture changes the next replay's output, and
    loading the old weights back gives the old output bit for bit."""
    model, gt, rgb, depth, _ = _house_model(card)
    model.track(rgb, depth, gt, "house")  # the capture
    first = model.track(rgb, depth, gt, "house")
    key = "encodeA.conv0.weight"
    old = model._refiner.state_dict()[key].clone()
    assert old.shape == (64, 6, 7, 7)
    model._refiner.load_state_dict({key: old.flip(-1)}, strict=False)
    changed = model.track(rgb, depth, gt, "house")
    model._refiner.load_state_dict({key: old}, strict=False)
    again = model.track(rgb, depth, gt, "house")
    assert np.abs(changed - first).max() > 1e-6
    np.testing.assert_array_equal(again, first)
