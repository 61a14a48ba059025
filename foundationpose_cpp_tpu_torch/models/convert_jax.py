"""Carry the JAX package's network parameters into the port's modules.

The JAX parameter tree (``foundationpose_cpp_tpu.models.networks``) holds
convs as HWIO, linears as (in, out), transformer layers under
``encoder/#i/...`` and ``att_cross/...``, heads as ``head_<name>`` and the
position table as ``pos_embed``. ``params_from_jax`` maps it onto the
``state_dict`` of ``RefineNet`` / ``ScoreNet`` (OIHW convs, (out, in)
linears), keeping every dtype; ``load_npz`` reads a ``weights/*_full.npz``
checkpoint with no JAX, and both routes give identical tensors.
``params_to_jax`` is the inverse, so that ``checkpoint.save_params`` writes
what the port trained or converted as a file the JAX package loads.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.models import checkpoint
from foundationpose_cpp_tpu_torch.models.networks import NetConfig, RefineNet, ScoreNet


def _tensor(leaf: Any) -> torch.Tensor:
    """numpy (ml_dtypes bf16 included) or torch leaf -> CPU torch tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _conv(p: dict, w: str = "w", b: str = "b") -> tuple[torch.Tensor, torch.Tensor]:
    return _tensor(p[w]).permute(3, 2, 0, 1).contiguous(), _tensor(p[b])


def _res(sd: dict, prefix: str, p: dict) -> None:
    for i in (1, 2):
        sd[f"{prefix}.conv{i}.weight"], sd[f"{prefix}.conv{i}.bias"] = _conv(p, f"w{i}", f"b{i}")


def _linear(sd: dict, prefix: str, w: Any, b: Any) -> None:
    sd[f"{prefix}.weight"] = _tensor(w).t().contiguous()
    sd[f"{prefix}.bias"] = _tensor(b)


def _encoder_layer(sd: dict, prefix: str, p: dict) -> None:
    _linear(sd, f"{prefix}.attn.qkv", p["attn"]["qkv_w"], p["attn"]["qkv_b"])
    _linear(sd, f"{prefix}.attn.proj", p["attn"]["proj_w"], p["attn"]["proj_b"])
    for ln in ("ln1", "ln2"):
        sd[f"{prefix}.{ln}.weight"] = _tensor(p[f"{ln}_s"])
        sd[f"{prefix}.{ln}.bias"] = _tensor(p[f"{ln}_b"])
    _linear(sd, f"{prefix}.mlp1", p["mlp_w1"], p["mlp_b1"])
    _linear(sd, f"{prefix}.mlp2", p["mlp_w2"], p["mlp_b2"])


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy or torch leaves) -> port ``state_dict``."""
    sd: dict[str, torch.Tensor] = {}
    a, ab = tree["encodeA"], tree["encodeAB"]
    sd["encodeA.conv0.weight"], sd["encodeA.conv0.bias"] = _conv(a["conv0"])
    sd["encodeA.conv1.weight"], sd["encodeA.conv1.bias"] = _conv(a["conv1"])
    _res(sd, "encodeA.res", a["res"])
    _res(sd, "encodeAB.res0", ab["res0"])
    sd["encodeAB.conv.weight"], sd["encodeAB.conv.bias"] = _conv(ab["conv"])
    _res(sd, "encodeAB.res1", ab["res1"])
    sd["pos_embed"] = _tensor(tree["pos_embed"])
    for i, layer in enumerate(tree["encoder"]):
        _encoder_layer(sd, f"encoder.{i}", layer)
    if "att_cross" in tree:
        _encoder_layer(sd, "att_cross", tree["att_cross"])
    for key, p in tree.items():
        if key.startswith("head_"):
            _linear(sd, f"heads.{key[len('head_'):]}", p["w"], p["b"])
    return sd


def _hwio(sd: dict, key: str) -> torch.Tensor:
    return sd[key].detach().cpu().permute(2, 3, 1, 0).contiguous()


def _t(sd: dict, key: str) -> torch.Tensor:
    return sd[key].detach().cpu().t().contiguous()


def _plain(sd: dict, key: str) -> torch.Tensor:
    return sd[key].detach().cpu()


def _res_to_jax(sd: dict, prefix: str) -> dict:
    return {f"{n}{i}": f(sd, f"{prefix}.conv{i}.{k}") for i in (1, 2)
            for n, f, k in (("w", _hwio, "weight"), ("b", _plain, "bias"))}


def _encoder_layer_to_jax(sd: dict, prefix: str) -> dict:
    return {
        "attn": {"qkv_w": _t(sd, f"{prefix}.attn.qkv.weight"),
                 "qkv_b": _plain(sd, f"{prefix}.attn.qkv.bias"),
                 "proj_w": _t(sd, f"{prefix}.attn.proj.weight"),
                 "proj_b": _plain(sd, f"{prefix}.attn.proj.bias")},
        **{f"{ln}_{jk}": _plain(sd, f"{prefix}.{ln}.{k}")
           for ln in ("ln1", "ln2") for jk, k in (("s", "weight"), ("b", "bias"))},
        **{f"mlp_{jk}{i}": f(sd, f"{prefix}.mlp{i}.{k}")
           for i in (1, 2) for jk, f, k in (("w", _t, "weight"), ("b", _plain, "bias"))},
    }


def params_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """Port ``state_dict`` -> the JAX parameter tree (HWIO convs, (in, out)
    linears, ``encoder`` as a list), CPU torch leaves, every dtype kept: the
    inverse of ``params_from_jax``."""
    tree = {
        "encodeA": {
            "conv0": {"w": _hwio(sd, "encodeA.conv0.weight"), "b": _plain(sd, "encodeA.conv0.bias")},
            "conv1": {"w": _hwio(sd, "encodeA.conv1.weight"), "b": _plain(sd, "encodeA.conv1.bias")},
            "res": _res_to_jax(sd, "encodeA.res"),
        },
        "encodeAB": {
            "res0": _res_to_jax(sd, "encodeAB.res0"),
            "conv": {"w": _hwio(sd, "encodeAB.conv.weight"), "b": _plain(sd, "encodeAB.conv.bias")},
            "res1": _res_to_jax(sd, "encodeAB.res1"),
        },
        "pos_embed": _plain(sd, "pos_embed"),
        "encoder": [_encoder_layer_to_jax(sd, f"encoder.{i}") for i in
                    range(len({k.split(".")[1] for k in sd if k.startswith("encoder.")}))],
    }
    if "att_cross.attn.qkv.weight" in sd:
        tree["att_cross"] = _encoder_layer_to_jax(sd, "att_cross")
    for head in sorted({k.split(".")[1] for k in sd if k.startswith("heads.")}):
        tree[f"head_{head}"] = {"w": _t(sd, f"heads.{head}.weight"),
                                "b": _plain(sd, f"heads.{head}.bias")}
    return tree


def save_npz(sd: dict[str, torch.Tensor], path: str) -> None:
    """Port ``state_dict`` -> a checkpoint in the JAX package's npz format."""
    checkpoint.save_params(params_to_jax(sd), path)


def net_config_from_state_dict(sd: dict[str, torch.Tensor], num_heads: int = 4) -> NetConfig:
    """The NetConfig a converted state_dict was trained with; the checkpoint
    does not record the head count (the published graph has 4)."""
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("encoder.")})
    tokens, embed = sd["pos_embed"].shape
    side = int(round(tokens ** 0.5))
    return NetConfig(
        in_channels=sd["encodeA.conv0.weight"].shape[1],
        width1=sd["encodeA.conv0.weight"].shape[0],
        width2=sd["encodeA.conv1.weight"].shape[0],
        embed_dim=embed,
        num_heads=num_heads,
        ffn_dim=sd["encoder.0.mlp1.weight"].shape[0],
        num_encoder_layers=n_layers,
        crop_hw=side * 8,
        cross_attention=any(k.startswith("att_cross.") for k in sd),
    )


def build_net(sd: dict[str, torch.Tensor], kind: str, num_heads: int = 4):
    """A RefineNet ("refiner") or ScoreNet ("scorer") holding ``sd``."""
    net = {"refiner": RefineNet, "scorer": ScoreNet}[kind](net_config_from_state_dict(sd, num_heads))
    net.load_state_dict(sd, strict=True, assign=True)
    return net.eval()


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """``weights/*_full.npz`` -> port ``state_dict``, without JAX."""
    return params_from_jax(checkpoint.load_params(path))


def as_net(net, kind: str, device: torch.device, dtype: torch.dtype):
    """An nn.Module, a converted state_dict, or an npz path -> the module on
    ``device``, computing in ``dtype``."""
    if isinstance(net, str):
        net = load_npz(net)
    if isinstance(net, dict):
        net = build_net(net, kind)
    return net.to(device).cast_matmul_weights(dtype).eval()
