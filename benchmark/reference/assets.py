"""The reference's own readers: binary PLY meshes, 8-bit PNG textures and
the nets' npz checkpoints, and the mesh constants the renderer uses.

Plain numpy and PyTorch. Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import struct
import zlib

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_png_u8(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG with rows filtered by None, Sub or Up ->
    (H, W) or (H, W, 3) uint8."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit gray or RGB, non-interlaced PNGs are read")
    ch = 3 if ctype == 2 else 1
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * ch + 1)
    out = np.empty((h, w * ch), np.uint8)
    prior = np.zeros(w * ch, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = cur
        elif kind == 1:
            out[y] = np.cumsum(cur.reshape(-1, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = cur + prior
        else:
            raise ValueError(f"{path}: row filter {kind} is not read")
        prior = out[y]
    return out.reshape(h, w, ch) if ch == 3 else out


def read_ply(path: str) -> dict:
    """A binary little-endian PLY of float x, y, z, nx, ny, nz, u, v vertices
    and triangle faces (uchar count, int indices), as the benchmark's assets
    are written -> {"vertices", "normals", "uvs", "faces", "texture_file"}."""
    data = pathlib.Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n_vert = n_face = 0
    props, texture = [], None
    for line in header:
        parts = line.split()
        if parts[:2] == ["format", "binary_little_endian"]:
            continue
        if parts and parts[0] == "format":
            raise ValueError(f"{path}: only binary_little_endian PLY files are read")
        if parts[:2] == ["comment", "TextureFile"]:
            texture = " ".join(parts[2:])
        elif parts[:2] == ["element", "vertex"]:
            n_vert = int(parts[2])
        elif parts[:2] == ["element", "face"]:
            n_face = int(parts[2])
        elif parts[:2] == ["property", "float"]:
            props.append(parts[2])
    if props != ["x", "y", "z", "nx", "ny", "nz", "u", "v"]:
        raise ValueError(f"{path}: vertex properties {props} are not read")
    verts = np.frombuffer(data, "<f4", count=n_vert * 8, offset=end).reshape(n_vert, 8)
    rec = np.frombuffer(data, [("n", "u1"), ("idx", "<i4", (3,))], count=n_face,
                        offset=end + verts.nbytes)
    if not np.all(rec["n"] == 3):
        raise ValueError(f"{path}: only triangles are read")
    return {
        "vertices": verts[:, 0:3].astype(np.float32),
        "normals": verts[:, 3:6].astype(np.float32),
        "uvs": verts[:, 6:8].astype(np.float32),
        "faces": rec["idx"].astype(np.int64),
        "texture_file": None if texture is None else str(pathlib.Path(path).parent / texture),
    }


def mesh_diameter(vertices: np.ndarray) -> float:
    """The largest distance between two vertices (f64 distances of the f32
    positions), over the convex hull's vertices."""
    from scipy.spatial import ConvexHull
    from scipy.spatial.distance import cdist

    pts = np.asarray(vertices, np.float64)
    hull = pts[np.unique(ConvexHull(pts, qhull_options="QJ").vertices)]
    return float(max(cdist(hull[i:i + 512], hull).max() for i in range(0, len(hull), 512)))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Renderer constants: vertices centred on the bounding box's centre,
    the v coordinate flipped, the texture in [0, 1]."""

    vertices: torch.Tensor  # (V, 3)
    normals: torch.Tensor  # (V, 3)
    uvs: torch.Tensor  # (V, 2), v flipped
    faces: torch.Tensor  # (F, 3) int64
    texture: torch.Tensor  # (Th, Tw, 3)
    diameter: float


def load_mesh(path: str, device) -> Mesh:
    m = read_ply(path)
    v = m["vertices"]
    center = ((v.min(axis=0) + v.max(axis=0)) / 2.0).astype(np.float32)
    tex = read_png_u8(m["texture_file"]).astype(np.float32) / 255.0
    uv = np.stack([m["uvs"][:, 0], 1.0 - m["uvs"][:, 1]], axis=-1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Mesh(t(v - center[None]), t(m["normals"]), t(uv), t(m["faces"], torch.int64), t(tex),
                mesh_diameter(v))


def read_params(path: str, device) -> dict[str, torch.Tensor]:
    """A checkpoint in the '/'-keyed npz format (bf16 leaves stored as their
    uint16 bits, a ``__dtypes__`` JSON map) -> {key: f32 tensor}, every
    leaf widened to float32 exactly."""
    data = np.load(path)
    dtypes = json.loads(bytes(data["__dtypes__"]).decode())
    out = {}
    for key, name in dtypes.items():
        arr = np.asarray(data[key])
        if name == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[key] = torch.as_tensor(np.ascontiguousarray(arr, np.float32), device=device)
    return out
