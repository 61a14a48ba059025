"""The render branch for N views: vertex transform, raster, attributes,
texture, shade, flip, xyz threshold -- two CUDA kernels on the card.

Replaces the Pallas kernel ``_fused_kernel`` / ``render_views_fused`` of
``foundationpose_cpp_tpu/ops/render_fused.py`` with ``csrc/render.cu``. What
it computes is the JAX package's exact unfused ``render_branch``
(pipeline/renderer.py:269-297) with per-pixel bilinear-wrap texturing, which
``render_views_plain`` composes from ``ops/rasterize.py``; the wrapper runs
that plain version for CPU tensors only. The TPU kernel's scheduling choices
(Morton-ordered chunks, one-hot MXU extraction, packed depth keys, corner or
texel-patch texturing) are not carried over: the CUDA kernel scatters faces
into a shared-memory depth buffer of 64-bit keys and builds every per-face
quantity itself (``csrc/raster_tile.cuh``). ``render_prepass`` and
``face_pixel_bbox`` are the plain versions of what it builds; nothing on the
card's path calls them.

One launch may render each view of its own mesh: the meshes concatenated,
a ``ViewTable`` whose row per view selects the view's mesh (its vertices,
faces and texels), and a diameter a view. A view then computes what a
one-mesh launch of its mesh computes for it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from foundationpose_cpp_tpu_torch.geometry import transforms
from foundationpose_cpp_tpu_torch.ops import cuda_build, pointcloud
from foundationpose_cpp_tpu_torch.ops import rasterize as ras


def vertex_attributes(
    poses: torch.Tensor, vertices: torch.Tensor, normals: torch.Tensor,
    texcoords: torch.Tensor,
) -> torch.Tensor:
    """(N, V, 6) per-view vertex attributes: camera-frame xyz, Lambert
    term, uv -- interpolated together in one pass."""
    n = poses.shape[0]
    return torch.cat(
        [
            transforms.transform_points(poses, vertices),
            transforms.diffuse_intensity(poses, normals)[..., None],
            texcoords[None].expand(n, *texcoords.shape),
        ],
        dim=-1,
    )


# the columns of a ViewTable row (csrc/render.cu TABLE_COLS)
TABLE_COLS = ("vertex_first", "vertex_count", "face_first", "face_count", "texel_first",
              "tex_h", "tex_w", "scratch_first")


@functools.cache
def _scratch_first(n: int, vertex_max: int, device: torch.device) -> torch.Tensor:
    """(n, 8) int32, zero but for the scratch column, n * vertex_max in row
    n; built once per (n, vertex_max, device) and kept, as
    ``transforms._constant`` keeps its constants: a captured graph reads it
    by address."""
    with torch.inference_mode(False):
        first = torch.zeros((n, len(TABLE_COLS)), dtype=torch.int32)
        first[:, -1] = torch.arange(n, dtype=torch.int32) * vertex_max  # scratch_first
        return first.to(device)


@dataclasses.dataclass(frozen=True)
class ViewTable:
    """Which mesh each view of a launch renders, out of concatenated meshes:
    ``rows`` (N, 8) int32 on the views' device, one row a view with the
    columns of ``TABLE_COLS`` (the mesh's first vertex and vertex count, its
    first face and face count, its first texel and texture size, the view's
    first slot of the kernel's vertex scratch); ``vertex_max``, a bound on
    a view's vertex count, and ``scratch_vertices``, the scratch's slots,
    as numbers for the launch."""

    rows: torch.Tensor
    vertex_max: int
    scratch_vertices: int

    @staticmethod
    def gather(mesh_rows: torch.Tensor, idx: torch.Tensor, vertex_max: int) -> "ViewTable":
        """View n renders mesh ``idx[n]`` of ``mesh_rows`` ((M, 8) int32, the
        scratch column 0; ``idx`` (N,) int32 on the same device), whose
        vertex counts are at most ``vertex_max``: its row, gathered on the
        device with no host synchronization, and the scratch's slots from
        n * vertex_max on, so the numbers of the launch depend on N alone."""
        n = idx.shape[0]
        rows = mesh_rows.index_select(0, idx) + _scratch_first(n, vertex_max, idx.device)
        return ViewTable(rows, vertex_max, n * vertex_max)


def render_views_plain(
    vertices, normals, texcoords, faces, texture, poses, clip_mat,
    h: int, w: int, diameter, min_depth: float, max_depth: float,
    w_ambient: float, w_diffuse: float, rasterizer=ras.rasterize,
    table: ViewTable | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: the unfused render chain, any device.
    ``rasterizer`` is ``ops.rasterize.rasterize`` or a function with its
    signature and contract (``rasterize_scatter_plain``). With a ``table``
    the mesh tensors concatenate meshes (``texture`` (texels, 3)) and
    ``diameter`` is (N,): each mesh's views are rendered together, on that
    mesh and the diameter of its first view."""
    if table is not None:
        out = torch.empty((poses.shape[0], h, w, 6), dtype=torch.float32, device=poses.device)
        meshes: dict[tuple, list[int]] = {}
        for n, row in enumerate(table.rows.tolist()):
            meshes.setdefault(tuple(row[:7]), []).append(n)
        for (v0, nv, f0, nf, t0, th, tw), views in meshes.items():
            idx = torch.tensor(views, device=poses.device)
            out[idx] = render_views_plain(
                vertices[v0:v0 + nv], normals[v0:v0 + nv], texcoords[v0:v0 + nv],
                faces[f0:f0 + nf], texture[t0:t0 + th * tw].reshape(th, tw, 3), poses[idx],
                clip_mat[idx], h, w, float(diameter[views[0]]), min_depth, max_depth, w_ambient,
                w_diffuse, rasterizer,
            )
        return out
    clip = transforms.transform_points_homogeneous(clip_mat, vertices)
    rast = rasterizer(clip, faces, h, w)
    attrs = vertex_attributes(poses, vertices, normals, texcoords)
    interp = ras.interpolate_attributes(attrs, rast, faces)
    color = ras.texture_bilinear_wrap(texture, interp[..., 4:6])
    color = ras.shade_color(color, interp[..., 3:4], rast, w_ambient, w_diffuse)
    color = ras.flip_vertical(color)
    xyz = ras.flip_vertical(interp[..., 0:3])
    xyz = pointcloud.threshold_and_downscale_pointcloud(
        xyz, poses, diameter / 2.0, min_depth, max_depth
    )
    return pointcloud.concat_channels(color, xyz)


BBOX_MARGIN = 0.0625  # pixels; see face_pixel_bbox


def face_pixel_bbox(
    clip: torch.Tensor, faces: torch.Tensor, valid: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(N, F, 4) int32 inclusive pixel ranges (x0, x1, y0, y1) in raster rows.

    Conservative: the pixel centers inside the projected corners' NDC bbox
    widened by BBOX_MARGIN pixels each way, clamped to the image; empty
    (x0 > x1 or y0 > y1) for culled faces and faces that hold no pixel
    center. With all w > 0 the pixel centers a face covers lie in the
    projected triangle, hence in the corners' bbox; the margin is hundreds
    of times the rounding error of the bbox and of the edge functions at
    image sizes up to thousands of pixels, and costs a sixteenth of a
    column and a row a side.
    """
    tri = clip[:, faces.long()]  # (N, F, 3, 4)
    wv = torch.where(valid[..., None], tri[..., 3], torch.ones_like(tri[..., 3]))
    ndc = torch.nan_to_num(tri[..., :2] / wv[..., None], nan=0.0, posinf=4.0, neginf=-4.0)
    lo = ndc.amin(dim=2)  # (N, F, 2)
    hi = ndc.amax(dim=2)
    size = torch.tensor([w, h], dtype=torch.float32, device=clip.device)
    # pixel-center index of an NDC coordinate u: ((u + 1) * size - 1) / 2
    p_lo = torch.ceil(((lo.clamp(-2.0, 2.0) + 1.0) * size - 1.0) / 2.0 - BBOX_MARGIN)
    p_hi = torch.floor(((hi.clamp(-2.0, 2.0) + 1.0) * size - 1.0) / 2.0 + BBOX_MARGIN)
    p_lo = torch.maximum(p_lo, torch.zeros_like(p_lo))
    p_hi = torch.minimum(p_hi, size - 1.0)
    box = torch.stack([p_lo[..., 0], p_hi[..., 0], p_lo[..., 1], p_hi[..., 1]], dim=-1)
    empty = torch.tensor([1.0, 0.0, 1.0, 0.0], device=clip.device)
    box = torch.where(valid[..., None], box, empty)
    return box.to(torch.int32).contiguous()


def render_prepass(vertices, normals, texcoords, faces, poses, clip_mat, h: int, w: int):
    """What the kernel builds per (view, face) and (view, vertex), computed
    with plain tensor ops: (N, F, 15) plane coefficients, (N, F, 4) pixel
    bboxes, (N, V, 6) vertex attributes."""
    clip = transforms.transform_points_homogeneous(clip_mat, vertices)
    coeffs, valid = ras.edge_coefficients(clip, faces)
    n, f = valid.shape
    bbox = face_pixel_bbox(clip, faces, valid, h, w)
    attrs = vertex_attributes(poses, vertices, normals, texcoords)
    return coeffs.reshape(n, f, 15).contiguous(), bbox, attrs.contiguous()


def face_pixel_tests(bbox: torch.Tensor) -> int:
    """How many face-pixel tests the kernel does: each face that survives
    culling is tested at every pixel center of its bbox, once (the regions
    partition the image)."""
    x0, x1, y0, y1 = bbox.long().unbind(-1)
    return int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).sum())


def vertex_prepass_plain(vertices, normals, poses, clip_mat) -> torch.Tensor:
    """(N, V, 8) per-view vertex data with plain tensor ops, as the kernel's
    first launch writes it: clip coordinates, camera-frame xyz, Lambert
    term."""
    return torch.cat(
        [
            transforms.transform_points_homogeneous(clip_mat, vertices),
            transforms.transform_points(poses, vertices),
            transforms.diffuse_intensity(poses, normals)[..., None],
        ],
        dim=-1,
    ).contiguous()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry point's signature on a build of csrc/render.cu."""
    lib.fp_render_views.restype = ctypes.c_int
    lib.fp_render_views.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float] * 5
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.fp_render_views_table.restype = ctypes.c_int
    lib.fp_render_views_table.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    )
    lib.fp_render_config.restype = None
    lib.fp_render_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, its signature set once."""
    return bind(cuda_build.load("render"))


def kernel_config() -> dict:
    """The regions (of a launch with many views, and of one with fewer blocks
    than ``few_blocks``), block size, small-face threshold and shared memory
    of the loaded build of csrc/render.cu."""
    cfg = (ctypes.c_int * 9)()
    _library().fp_render_config(cfg)
    return dict(zip(("region_w", "region_h", "threads", "small_face", "shared_bytes",
                     "few_region_w", "few_region_h", "few_shared_bytes", "few_blocks"), cfg))


def _check_mesh(vertices, normals, texcoords, faces, texture, poses, texture_dim: int = 3) -> None:
    """Raise on what the kernel does not take (texture_dim 2: a table's
    concatenated texels)."""
    dev = poses.device
    v = texcoords.shape[0]
    for name, t, shape in (("vertices", vertices, (v, 3)), ("normals", normals, (v, 3)),
                           ("texcoords", texcoords, (v, 2)), ("texture", texture, None),
                           ("poses", poses, (poses.shape[0], 4, 4))):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"render kernel: {name} must be f32 on {dev}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"render kernel: {name} must be {shape}, got {tuple(t.shape)}")
    if faces.dtype != torch.int32 or faces.device != dev or faces.dim() != 2 or faces.shape[1] != 3:
        raise ValueError("render kernel: faces must be (F, 3) int32 on the same device")
    if texture.dim() != texture_dim or texture.shape[-1] != 3:
        want = "(Th, Tw, 3)" if texture_dim == 3 else "(texels, 3)"
        raise ValueError(f"render kernel: texture must be {want}, got {tuple(texture.shape)}")


@cuda_build.counted
def render_views(
    vertices, normals, texcoords, faces, texture, poses, clip_mat,
    h: int, w: int, diameter, min_depth: float, max_depth: float,
    w_ambient: float, w_diffuse: float, table: ViewTable | None = None,
) -> torch.Tensor:
    """Render N views into (N, h, w, 6) f32 (shaded rgb | downscaled xyz).

    vertices/normals (V, 3), texcoords (V, 2), faces (F, 3) int32,
    texture (Th, Tw, 3), poses/clip_mat (N, 4, 4), diameter a number.
    With a ``table`` the mesh tensors concatenate several meshes, texture
    is (texels, 3), and diameter is an (N,) f32 tensor on the views'
    device, which the card halves (exactly, so a view's scale is the f32
    that its number's half rounds to).
    CPU tensors go through the plain version. CUDA tensors go through the
    kernel (these checks, two allocations and its two launches, no other
    tensor op), which raises on what it does not take, and on an input that
    requires a gradient under grad mode (the kernel is forward-only).
    """
    args = (vertices, normals, texcoords, faces, texture, poses, clip_mat)
    if poses.device.type == "cpu":
        return render_views_plain(*args, h, w, diameter, min_depth, max_depth,
                                  w_ambient, w_diffuse, table=table)
    if poses.device.type != "cuda":
        raise ValueError(f"unsupported device {poses.device}")
    _check_mesh(vertices, normals, texcoords, faces, texture, poses,
                texture_dim=2 if table is not None else 3)
    cuda_build.refuse_grad(*args, what="render_views")
    if (clip_mat.device != poses.device or clip_mat.dtype != torch.float32
            or clip_mat.shape != poses.shape):
        raise ValueError(f"render kernel: clip_mat must be f32 {tuple(poses.shape)} on {poses.device}")
    n = poses.shape[0]
    if not (1 <= n <= 65535 and h >= 1 and w >= 1):
        raise ValueError(f"render kernel: bad shape n={n} h={h} w={w}")
    if table is not None:
        out = _launch_table(vertices, normals, texcoords, faces, texture, poses, clip_mat,
                            table, diameter, h, w, min_depth, max_depth, w_ambient, w_diffuse)
    else:
        verts = torch.empty((n, vertices.shape[0], 8), dtype=torch.float32, device=poses.device)
        out = _launch(vertices, normals, texcoords, faces, texture, poses, clip_mat, verts, None,
                      h, w, diameter, min_depth, max_depth, w_ambient, w_diffuse)
    render_views.launches += 1
    return out


def launch_render(
    verts, texcoords, faces, texture, poses, h: int, w: int, diameter: float,
    min_depth: float, max_depth: float, w_ambient: float, w_diffuse: float,
    coeffs: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's second launch alone, on an (N, V, 8) vertex buffer that
    the caller filled (``vertex_prepass_plain``), for timing and checks:
    ``render_views`` is the entry point and counts its launches. With
    ``coeffs`` (N, F, 15), as ``render_prepass`` gives them, the kernel reads
    these plane coefficients and builds none: the scatter and the resolve
    alone, which must agree with the plain version exactly."""
    _check_mesh(None, None, texcoords, faces, texture, poses)
    cuda_build.refuse_grad(verts, texcoords, texture, poses, coeffs, what="launch_render")
    n, v = poses.shape[0], texcoords.shape[0]
    for name, t, shape in (("verts", verts, (n, v, 8)), ("coeffs", coeffs, (n, faces.shape[0], 15))):
        if t is not None and (t.device != poses.device or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"render kernel: {name} must be contiguous f32 {shape} on {poses.device}")
    return _launch(None, None, texcoords, faces, texture, poses, None, verts, coeffs,
                   h, w, diameter, min_depth, max_depth, w_ambient, w_diffuse)


def _launch(vertices, normals, texcoords, faces, texture, poses, clip_mat, verts, coeffs, h, w,
            diameter, min_depth, max_depth, w_ambient, w_diffuse) -> torch.Tensor:
    """One call into csrc/render.cu: the vertex kernel when ``vertices`` is
    given, then the render kernel. Returns the (N, h, w, 6) image."""
    transform = vertices is not None
    inputs = [t.contiguous() if t is not None else None
              for t in (vertices, normals, texcoords, faces, texture, poses, clip_mat)]
    n, v = poses.shape[0], texcoords.shape[0]
    out = torch.empty((n, h, w, 6), dtype=torch.float32, device=poses.device)
    for name, t in (("texcoords", inputs[2]), ("verts", verts)):
        if t.data_ptr() % 16:
            raise ValueError(f"render kernel: {name} must be 16-byte aligned")
    fn = _library().fp_render_views
    with torch.cuda.device(poses.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *(None if t is None else t.data_ptr() for t in inputs), verts.data_ptr(),
            None if coeffs is None else coeffs.data_ptr(), out.data_ptr(),
            n, faces.shape[0], v, h, w, texture.shape[0], texture.shape[1],
            diameter / 2.0, min_depth, max_depth, w_ambient, w_diffuse, int(transform), stream,
        )
    cuda_build.check(err, "render_views")
    return out


def _launch_table(vertices, normals, texcoords, faces, texture, poses, clip_mat,
                  table: ViewTable, diameters, h, w, min_depth, max_depth, w_ambient,
                  w_diffuse) -> torch.Tensor:
    """One call into csrc/render.cu's table entry: the vertex kernel over each
    view's own vertices, then the render kernel. Returns (N, h, w, 6)."""
    n = poses.shape[0]
    for name, t, dtype, shape in (("table rows", table.rows, torch.int32, (n, len(TABLE_COLS))),
                                  ("diameters", diameters, torch.float32, (n,))):
        if (not isinstance(t, torch.Tensor) or t.device != poses.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"render kernel: {name} must be contiguous {dtype} {shape} "
                             f"on {poses.device}")
    inputs = [t.contiguous() for t in (vertices, normals, texcoords, faces, texture, poses,
                                       clip_mat)]
    if inputs[2].data_ptr() % 16:
        raise ValueError("render kernel: texcoords must be 16-byte aligned")
    verts = torch.empty((table.scratch_vertices, 8), dtype=torch.float32, device=poses.device)
    out = torch.empty((n, h, w, 6), dtype=torch.float32, device=poses.device)
    fn = _library().fp_render_views_table
    with torch.cuda.device(poses.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *(t.data_ptr() for t in inputs), table.rows.data_ptr(), diameters.data_ptr(),
            verts.data_ptr(), out.data_ptr(), n, table.vertex_max, h, w, min_depth, max_depth,
            w_ambient, w_diffuse, stream,
        )
    cuda_build.check(err, "render_views")
    return out
