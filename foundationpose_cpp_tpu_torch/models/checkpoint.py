"""Read and write the JAX package's npz parameter checkpoints as torch tensors.

The format is ``foundationpose_cpp_tpu.models.checkpoint.save_params``
(checkpoint.py:45-88): one npz entry per pytree leaf, keyed by the
'/'-joined path (list nodes as '#<index>'), bf16 leaves stored as uint16,
and a ``__dtypes__`` entry holding the JSON map of leaf dtypes. numpy has no
bf16, so the uint16 bits go to torch unchanged and are reinterpreted there
with ``Tensor.view(torch.bfloat16)``, and back. A file either package writes
loads in the other bit for bit; ``params_fingerprint`` hashes the same bytes
as the JAX one.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np
import torch

_SEP = "/"


def _listify(node: Any) -> Any:
    """Turn dict nodes whose keys are all '#<i>' back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.startswith("#") for k in node):
        return [node[f"#{i}"] for i in range(len(node))]
    return node


def load_params(path: str) -> Any:
    """npz checkpoint -> nested dict/list tree of CPU torch tensors."""
    data = np.load(path)
    dtypes = json.loads(bytes(data["__dtypes__"]).decode())
    tree: dict = {}
    for key, dtype_name in dtypes.items():
        arr = np.ascontiguousarray(data[key])
        t = torch.from_numpy(arr.copy())
        if dtype_name == "bfloat16":
            t = t.view(torch.bfloat16)
        node = tree
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return _listify(tree)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            k = f"#{i}"
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def _leaf_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A torch leaf -> (array as stored, dtype name): bf16 as its uint16 bits."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_params(params: Any, path: str) -> None:
    """Write a nested dict/list tree of torch leaves as npz, in the JAX
    package's format (bf16 stored as uint16 + the dtype map)."""
    arrays, dtypes = {}, {}
    for k, v in _flatten(params).items():
        arrays[k], dtypes[k] = _leaf_numpy(v)
    arrays["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def params_fingerprint(params: Any) -> str:
    """Stable content hash of a tree, equal to the JAX package's for the same
    leaves (keys sorted, each key then its leaf's raw bytes)."""
    h = hashlib.sha256()
    for k, v in sorted(_flatten(params).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(_leaf_numpy(v)[0]).tobytes())
    return h.hexdigest()[:16]
