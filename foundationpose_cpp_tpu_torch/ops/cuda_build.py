"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and compiles on its
own into ``lib<name>_<digest>.so`` under ``BUILD_DIR`` (the checkout's
``build/fp_torch_kernels``, or a cache directory for an installed package),
where the digest covers the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source never loads a stale library. Nothing is built when the package is imported: a
wrapper builds its library on first use, and ``build`` starts one nvcc per
source, all at once. The wrappers that count their launches register
themselves here (``counted``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Callable

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> pathlib.Path:
    """The checkout's ``build/`` when the package runs from a checkout, else
    ``$TORCH_EXTENSIONS_DIR`` or ``~/.cache/torch_extensions`` (an installed
    package, whose parent directory is site-packages)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "fp_torch_kernels"
    base = os.environ.get("TORCH_EXTENSIONS_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "torch_extensions"
    )
    return pathlib.Path(base) / "fp_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
KERNEL_SOURCES = ("attention", "render", "rasterize", "probe_grid", "crop", "epilogue")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=KERNEL_SOURCES, verbose: bool = False) -> dict[str, str]:
    """Compile every missing library of ``names`` in parallel.

    Returns {name: nvcc's stderr} for the libraries compiled now (with
    ``verbose``, ptxas's register and shared-memory report). Raises
    RuntimeError with the compiler output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        logs[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{stdout}{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        path = library_path(name)
        if not path.exists():
            build([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def refuse_grad(*tensors, what: str) -> None:
    """Raise when autograd would record through a forward-only kernel.

    The kernels write into fresh tensors through raw pointers, so their
    output has no ``grad_fn``: under grad mode, an input that requires a
    gradient would silently get none (the JAX package's Pallas kernels have
    no VJP and raise there). ``None`` entries are skipped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel is forward-only and an input requires a gradient; "
            "call it under torch.no_grad(), or use the plain version (attn_impl='plain')"
        )


# every wrapper that counts the launches of its kernel, and the nets' padded
# stem, which counts the calls that take its route; by name (``counted``)
COUNTERS: dict[str, Callable] = {}


def counted(fn: Callable) -> Callable:
    """Register ``fn``, which adds one to ``fn.launches`` a launch, as a
    counted wrapper. A replay of a captured program runs no wrapper: the
    program reads these counters around its capture and adds each one's
    increase on every replay (``pipeline.programs``)."""
    fn.launches = 0
    COUNTERS[fn.__name__] = fn
    return fn


def launch_counts() -> dict[str, int]:
    """Each counted wrapper's launches so far, by name."""
    return {name: fn.launches for name, fn in COUNTERS.items()}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches of each counted wrapper that launched since
    ``launch_counts()`` returned ``before``, by name; a wrapper registered
    since then counts from 0."""
    since = {name: n - before.get(name, 0) for name, n in launch_counts().items()}
    return {name: d for name, d in since.items() if d}


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")

