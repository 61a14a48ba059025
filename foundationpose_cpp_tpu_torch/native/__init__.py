"""Host-side C++: the frame ring and the mesh parsers, built with g++ on
first use and bound with ctypes.

``csrc/ring.cpp`` is the single-producer single-consumer drop-oldest ring
that feeds ``pipeline.async_tracker.AsyncTracker`` (counterpart of the ring
in ``foundationpose_cpp_tpu.native``). ``csrc/mesh.cpp`` holds the OBJ and
PLY parsers and the mesh diameters that ``meshio.mesh_loader`` takes as its
fast paths (counterparts of ``fp_parse_obj``, ``fp_parse_ply``,
``fp_mesh_diameter`` and ``fp_diameter_exact`` there). Each source compiles
into its own ``lib<stem>_<digest>.so`` in the directory the CUDA kernels
build into (``ops.cuda_build.BUILD_DIR``), where the digest covers the
source and the flags. The compiler writes a temporary file that is then
renamed into place, so a process never loads a half-written library.
Nothing is built when the package is imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from foundationpose_cpp_tpu_torch.ops import cuda_build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
RING_SOURCE = CSRC / "ring.cpp"
MESH_SOURCE = CSRC / "mesh.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def library_path(src: pathlib.Path = RING_SOURCE) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return cuda_build.BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(src: pathlib.Path = RING_SOURCE) -> pathlib.Path:
    """Compile ``src`` unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path(src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"g++ could not build {src.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {src.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load(src: pathlib.Path, bind) -> ctypes.CDLL:
    with _lock:
        if src.stem not in _libs:
            _libs[src.stem] = bind(ctypes.CDLL(str(build(src))))
        return _libs[src.stem]


def _bind_ring(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fp_ring_create.restype = ctypes.c_void_p
    lib.fp_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.fp_ring_destroy.restype = None
    lib.fp_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.fp_ring_push.restype = None
    lib.fp_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fp_ring_pop_latest.restype = ctypes.c_int64
    lib.fp_ring_pop_latest.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fp_ring_size.restype = ctypes.c_int64
    lib.fp_ring_size.argtypes = [ctypes.c_void_p]
    lib.fp_ring_dropped.restype = ctypes.c_int64
    lib.fp_ring_dropped.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """The ring library, built on first use, with every entry point typed."""
    return _load(RING_SOURCE, _bind_ring)


class _FpMesh(ctypes.Structure):
    """``struct FpMesh`` of csrc/mesh.cpp."""

    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("num_vertices", ctypes.c_int64),
        ("num_faces", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
        ("has_uvs", ctypes.c_int32),
        ("texture_path", ctypes.c_char * 1024),
    ]


def _bind_mesh(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ("fp_parse_obj", "fp_parse_ply"):
        getattr(lib, name).restype = ctypes.POINTER(_FpMesh)
        getattr(lib, name).argtypes = [ctypes.c_char_p]
    lib.fp_free_mesh.restype = None
    lib.fp_free_mesh.argtypes = [ctypes.POINTER(_FpMesh)]
    for name in ("fp_mesh_diameter", "fp_diameter_exact"):
        getattr(lib, name).restype = ctypes.c_double
        getattr(lib, name).argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    return lib


def load_mesh_library() -> ctypes.CDLL:
    """The mesh library, built on first use, with every entry point typed."""
    return _load(MESH_SOURCE, _bind_mesh)


def parse_obj_native(path: str):
    """Parse an OBJ with the C++ parser.

    Returns (positions (V,3), uvs (V,2)|None, normals (V,3)|None,
    faces (F,3), texture_path|None), or None when the parser does not take
    the file (unreadable, empty, a directory): the caller then uses the
    Python parser."""
    return _parse_native(path, "fp_parse_obj")


def parse_ply_native(path: str):
    """Parse an ascii/binary_little_endian PLY with the C++ parser.

    Same return contract as parse_obj_native; None on shapes it does not
    take (big-endian, list-typed vertex properties), so the caller can fall
    back to the Python parser."""
    return _parse_native(path, "fp_parse_ply")


def _parse_native(path: str, fn_name: str):
    lib = load_mesh_library()
    mp = getattr(lib, fn_name)(os.fsencode(str(path)))
    if not mp:
        return None
    try:
        m = mp.contents
        v, f = int(m.num_vertices), int(m.num_faces)
        pos = np.ctypeslib.as_array(m.positions, shape=(v, 3)).copy()
        nrm = np.ctypeslib.as_array(m.normals, shape=(v, 3)).copy() if m.has_normals else None
        uv = np.ctypeslib.as_array(m.uvs, shape=(v, 2)).copy() if m.has_uvs else None
        faces = np.ctypeslib.as_array(m.faces, shape=(f, 3)).copy()
        tex = m.texture_path.decode() or None
        return pos, uv, nrm, faces, tex
    finally:
        lib.fp_free_mesh(mp)


def _diameter(positions: np.ndarray, fn_name: str) -> float:
    pos = np.ascontiguousarray(positions, dtype=np.float32).reshape(-1, 3)
    fn = getattr(load_mesh_library(), fn_name)
    return float(fn(pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pos.shape[0]))


def mesh_diameter_native(positions: np.ndarray) -> float:
    """Farthest-pair heuristic (fp_mesh_diameter): exact for up to 4096
    points, possibly an underestimate above."""
    return _diameter(positions, "fp_mesh_diameter")


def diameter_exact_native(positions: np.ndarray) -> float:
    """Exact threaded pairwise-max distance (fp_diameter_exact), f64
    distances over the f32 coordinates. Callers pass convex-hull vertices;
    the hull's farthest pair equals the full set's."""
    return _diameter(positions, "fp_diameter_exact")


class FrameRing:
    """SPSC drop-oldest frame queue backed by the C++ ring.

    The async-tracking feeder: a capture thread pushes frames; the tracking
    loop pops the newest, skipping stale frames (real-time tracking policy).
    """

    def __init__(self, frame_shape: tuple, dtype=np.uint8, capacity: int = 4):
        self._shape = tuple(int(s) for s in frame_shape)
        self._dtype = np.dtype(dtype)
        self._bytes = int(np.prod(self._shape)) * self._dtype.itemsize
        if capacity <= 0 or self._bytes <= 0:
            # a zero capacity would be `x % 0` (SIGFPE) on the first push
            raise ValueError(
                f"FrameRing needs a positive capacity and frame size, got "
                f"capacity={capacity}, frame_bytes={self._bytes}"
            )
        self._lib = load()
        self._ring = self._lib.fp_ring_create(self._bytes, int(capacity))
        if not self._ring:
            raise MemoryError(f"fp_ring_create failed for {capacity} x {self._bytes} bytes")

    def _handle(self) -> int:
        if not self._ring:
            raise ValueError("the FrameRing is closed")
        return self._ring

    def push(self, frame: np.ndarray) -> None:
        buf = np.ascontiguousarray(frame, dtype=self._dtype).reshape(self._shape)
        self._lib.fp_ring_push(self._handle(), buf.ctypes.data)

    def pop_latest(self, out: np.ndarray | None = None) -> tuple[np.ndarray, int] | None:
        """Newest frame + number of stale frames skipped, or None if empty.
        ``out`` (optional) receives the frame in place, e.g. a pinned host
        buffer's numpy view."""
        if out is None:
            out = np.empty(self._shape, dtype=self._dtype)
        elif (out.dtype != self._dtype or out.shape != self._shape
              or not (out.flags.c_contiguous and out.flags.writeable)):
            raise ValueError(
                f"out must be a writeable C-contiguous {self._dtype} {self._shape} array, "
                f"got {out.dtype} {out.shape}"
            )
        skipped = self._lib.fp_ring_pop_latest(self._handle(), out.ctypes.data)
        if skipped < 0:
            return None
        return out, int(skipped)

    def __len__(self) -> int:
        return int(self._lib.fp_ring_size(self._handle()))

    @property
    def dropped(self) -> int:
        return int(self._lib.fp_ring_dropped(self._handle()))

    def close(self) -> None:
        if self._ring:
            self._lib.fp_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        # __init__ may have raised before the ring existed
        if getattr(self, "_ring", None):
            self.close()
