"""Convert published FoundationPose checkpoints into the port's networks.

The reference consumes the NVlabs FoundationPose refiner/scorer as opaque
ONNX->TensorRT engines (reference tools/cvt_onnx2trt.bash:3-15). The graphs
are exports of ``RefineNet`` / ``ScoreNetMultiPair`` (NVlabs/FoundationPose
``learning/models/{refine_network,score_network}.py``), whose module tree is
``models/torch_ref.py``'s:

    encodeA.0      ConvBNReLU(c_in -> 64, k7, s2)      (conv + BN + ReLU)
    encodeA.1      ConvBNReLU(64 -> 128, k3, s2)
    encodeA.2      ResnetBasicBlock(128)               (conv1 bn1 conv2 bn2)
    encodeAB.0     ResnetBasicBlock(256)
    encodeAB.1     ConvBNReLU(256 -> 512, k3, s2)
    encodeAB.2     ResnetBasicBlock(512)
    pos_embed.pe   sinusoidal buffer (1, 400, 512)
    encoder.layers.{i}.{self_attn,linear1,linear2,norm1,norm2}
    trans_head.0 / rot_head.0 / score_head.0   Linear heads
    att_cross.*    (scorer MultiPair cross-hypothesis layer, optional)

This module maps every tensor of such a state dict BY NAME onto the
``state_dict`` of the port's ``RefineNet`` / ``ScoreNet``
(``models/networks.py``), after ``foundationpose_cpp_tpu.models.convert``:

  * BatchNorm is folded into the preceding conv (w' = w * g/sqrt(v+eps),
    b' = beta + (b - mu) * g/sqrt(v+eps)), in float64, then rounded once to
    f32, so the runtime never normalizes.
  * Convs stay OIHW and linears (out, in), as the port's modules hold them;
    ``in_proj_weight`` (3D, D) becomes ``attn.qkv.weight`` unchanged (torch
    packs q, k, v along dim 0, the order of the port's packed projection).
  * Every tensor stays f32. The cast to the compute dtype happens where a
    net is placed on its device (``convert_jax.as_net``).

Conversion is STRICT: every source tensor must be consumed (except
``num_batches_tracked``), every target must be written exactly once and have
the shape of the target module's tensor, and ``pos_embed`` must be the
sinusoidal table. Anything else raises ``ConversionError`` listing the
offenders. ``convert_jax.params_to_jax`` of the result equals the JAX
converter's f32 tree bit for bit.
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Any, Mapping

import numpy as np
import torch

from foundationpose_cpp_tpu_torch.models import convert_jax, networks

logger = logging.getLogger("foundationpose_cpp_tpu_torch")

Array = np.ndarray


class ConversionError(RuntimeError):
    pass


_BN_EPS = 1e-5  # torch.nn.BatchNorm2d default
_IGNORED = ("num_batches_tracked",)
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _strip_prefixes(sd: Mapping[str, Any]) -> dict[str, Array]:
    out = {}
    for k, v in sd.items():
        for pre in ("module.", "model."):
            while k.startswith(pre):
                k = k[len(pre):]
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _fold_bn(
    w_oihw: Array, b: Array | None, bn: dict[str, Array] | None, where: str
) -> tuple[Array, Array]:
    """Fold an optional BatchNorm into (OIHW f32 weight, f32 bias)."""
    if w_oihw.ndim != 4:
        raise ConversionError(f"{where}: conv weight must be 4-D OIHW, got {w_oihw.shape}")
    o = w_oihw.shape[0]
    bias = np.zeros((o,), np.float64) if b is None else b.astype(np.float64)
    w = w_oihw.astype(np.float64)
    if bn is not None:
        scale = bn["weight"].astype(np.float64) / np.sqrt(
            bn["running_var"].astype(np.float64) + _BN_EPS
        )
        w = w * scale[:, None, None, None]
        bias = bn["bias"].astype(np.float64) + (bias - bn["running_mean"]) * scale
    return w.astype(np.float32), bias.astype(np.float32)


class _Collector:
    """Reads the flat source dict by unit and writes the port's state_dict,
    tracking consumption and writes strictly."""

    def __init__(self, sd: Mapping[str, Array]):
        self.sd = dict(sd)
        self.consumed: set[str] = set()
        self.out: dict[str, Array] = {}

    def take(self, key: str, where: str, optional: bool = False) -> Array | None:
        if key not in self.sd:
            if optional:
                return None
            raise ConversionError(f"{where}: missing tensor '{key}'")
        self.consumed.add(key)
        return self.sd[key]

    def put(self, key: str, value: Array) -> None:
        if key in self.out:
            raise ConversionError(f"target '{key}' written twice")
        self.out[key] = np.array(value, dtype=np.float32)  # a copy: the source may be read-only

    def _bn(self, base: str, name: str) -> dict[str, Array] | None:
        if f"{base}.{name}.running_mean" not in self.sd:
            return None
        return {f: self.take(f"{base}.{name}.{f}", base) for f in _BN_FIELDS}

    def conv_bn(self, base: str, target: str) -> None:
        """A ConvBNReLU unit in either naming style: nn.Sequential children
        ('.0.' conv, '.1.' bn) or attribute children ('.conv.', '.bn.')."""
        for conv_name, bn_name in (("0", "1"), ("conv", "bn")):
            wkey = f"{base}.{conv_name}.weight"
            if wkey in self.sd:
                w = self.take(wkey, base)
                b = self.take(f"{base}.{conv_name}.bias", base, optional=True)
                w, b = _fold_bn(w, b, self._bn(base, bn_name), base)
                self.put(f"{target}.weight", w)
                self.put(f"{target}.bias", b)
                return
        raise ConversionError(
            f"{base}: no conv weight found (tried {base}.0.weight and {base}.conv.weight)"
        )

    def res_block(self, base: str, target: str) -> None:
        """ResnetBasicBlock: conv1(+bn1), conv2(+bn2), identity skip."""
        for i in (1, 2):
            w = self.take(f"{base}.conv{i}.weight", base)
            b = self.take(f"{base}.conv{i}.bias", base, optional=True)
            w, b = _fold_bn(w, b, self._bn(base, f"bn{i}"), f"{base}.conv{i}")
            self.put(f"{target}.conv{i}.weight", w)
            self.put(f"{target}.conv{i}.bias", b)
        if any(k.startswith(f"{base}.downsample") for k in self.sd):
            raise ConversionError(
                f"{base}: downsample branch present; published blocks are "
                "identity-skip (stride 1, equal channels) -- unsupported"
            )

    def encoder_layer(self, base: str, target: str) -> None:
        """torch TransformerEncoderLayer -> the port's EncoderLayer."""
        for src, dst in (("self_attn.in_proj", "attn.qkv"), ("self_attn.out_proj", "attn.proj"),
                         ("norm1", "ln1"), ("norm2", "ln2"),
                         ("linear1", "mlp1"), ("linear2", "mlp2")):
            sep = "_" if src == "self_attn.in_proj" else "."
            self.put(f"{target}.{dst}.weight", self.take(f"{base}.{src}{sep}weight", base))
            self.put(f"{target}.{dst}.bias", self.take(f"{base}.{src}{sep}bias", base))

    def head(self, base: str, target: str) -> None:
        """Linear head, either `head.0.weight` (Sequential) or `head.weight`."""
        for key in (f"{base}.0.weight", f"{base}.weight"):
            if key in self.sd:
                self.put(f"{target}.weight", self.take(key, base))
                self.put(f"{target}.bias", self.take(key[: -len("weight")] + "bias", base))
                return
        raise ConversionError(f"{base}: no head weight found")

    def unconsumed(self) -> list[str]:
        return sorted(k for k in self.sd if k not in self.consumed and not k.endswith(_IGNORED))


def infer_net_config(sd: Mapping[str, Any], crop_hw: int = 160) -> networks.NetConfig:
    """NetConfig dimensions read off the checkpoint itself (4 heads, as
    published: the checkpoint does not record the head count)."""
    sd = _strip_prefixes(sd)

    def conv_out(base):
        for k in (f"{base}.0.weight", f"{base}.conv.weight"):
            if k in sd:
                return sd[k].shape
        raise ConversionError(f"cannot find conv weight under {base}")

    s0 = conv_out("encodeA.0")  # (width1, c_in, 7, 7)
    s1 = conv_out("encodeA.1")  # (width2, width1, 3, 3)
    s2 = conv_out("encodeAB.1")  # (embed_dim, 2*width2, 3, 3)
    n_layers = len({m.group(1) for k in sd if (m := re.match(r"encoder\.layers\.(\d+)\.", k))})
    if "encoder.layers.0.linear1.weight" not in sd:
        raise ConversionError("missing tensor 'encoder.layers.0.linear1.weight'")
    ffn = sd["encoder.layers.0.linear1.weight"].shape[0]
    return networks.NetConfig(
        in_channels=int(s0[1]), width1=int(s0[0]), width2=int(s1[0]),
        embed_dim=int(s2[0]), ffn_dim=int(ffn), num_encoder_layers=max(1, n_layers),
        crop_hw=crop_hw, cross_attention=any(k.startswith("att_cross") for k in sd),
    )


def convert_state_dict(
    sd: Mapping[str, Any], model: str, cfg: networks.NetConfig | None = None,
) -> tuple[dict[str, torch.Tensor], networks.NetConfig]:
    """Map a FoundationPose torch state dict (numpy or torch values) onto the
    port's ``RefineNet`` ("refiner") or ``ScoreNet`` ("scorer") state_dict.

    Returns (state_dict of f32 CPU tensors, cfg). Raises ConversionError on
    ANY unknown, missing, doubly written or mis-shaped tensor.
    """
    if model not in ("refiner", "scorer"):
        raise ValueError(f"model must be 'refiner' or 'scorer', got {model!r}")
    sd = _strip_prefixes(sd)
    if cfg is None:
        cfg = infer_net_config(sd)
    col = _Collector(sd)
    col.conv_bn("encodeA.0", "encodeA.conv0")
    col.conv_bn("encodeA.1", "encodeA.conv1")
    col.res_block("encodeA.2", "encodeA.res")
    col.res_block("encodeAB.0", "encodeAB.res0")
    col.conv_bn("encodeAB.1", "encodeAB.conv")
    col.res_block("encodeAB.2", "encodeAB.res1")
    pe = col.take("pos_embed.pe", "pos_embed", optional=True)
    if pe is None:
        pe = networks.sinusoidal_position_table(cfg.num_tokens, cfg.embed_dim)
    else:
        pe = pe.reshape(pe.shape[-2], pe.shape[-1])  # (1, T, D) -> (T, D)
        ref = networks.sinusoidal_position_table(pe.shape[0], pe.shape[1])
        if not np.allclose(pe, ref, atol=1e-4):
            raise ConversionError(
                "pos_embed.pe does not match the sinusoidal table -- "
                "unexpected positional-embedding variant"
            )
        pe = pe[: cfg.num_tokens]
    col.put("pos_embed", pe)
    for i in range(cfg.num_encoder_layers):
        col.encoder_layer(f"encoder.layers.{i}", f"encoder.{i}")
    if any(k.startswith("att_cross") for k in sd):
        base = ("att_cross.layers.0" if any(k.startswith("att_cross.layers.0") for k in sd)
                else "att_cross")
        col.encoder_layer(base, "att_cross")
    head_map = {"refiner": {"trans": "trans_head", "rot": "rot_head"},
                "scorer": {"scores": "score_head"}}[model]
    for ours, theirs in head_map.items():
        col.head(theirs, f"heads.{ours}")

    leftovers = col.unconsumed()
    if leftovers:
        raise ConversionError(
            f"{len(leftovers)} checkpoint tensors not consumed by the "
            f"mapping (unknown layout?): {leftovers[:20]}"
        )
    skeleton = {"refiner": networks.RefineNet, "scorer": networks.ScoreNet}[model](cfg).state_dict()
    missing, extra = sorted(set(skeleton) - set(col.out)), sorted(set(col.out) - set(skeleton))
    if missing or extra:
        raise ConversionError(f"targets differ from the {model}'s: missing={missing} extra={extra}")
    bad = [f"{k}: shape {col.out[k].shape} != expected {tuple(v.shape)}"
           for k, v in skeleton.items() if tuple(v.shape) != col.out[k].shape]
    if bad:
        raise ConversionError("; ".join(bad))
    return {k: torch.from_numpy(col.out[k]) for k in skeleton}, cfg


# ---------------------------------------------------------------------------
# file front-ends


def load_torch_checkpoint(path: str, allow_pickle: bool = False) -> dict[str, Array]:
    """Load a torch .pth as numpy arrays; pickle only with ``allow_pickle``."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=not allow_pickle)
    except (pickle.UnpicklingError, RuntimeError) as e:
        if allow_pickle:
            raise
        raise ConversionError(
            f"{path}: not loadable with weights_only=True ({e}). Re-run with "
            "--allow-pickle ONLY if you trust this file (pickle executes "
            "arbitrary code)."
        ) from e
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()}


def load_onnx_initializers(path: str) -> dict[str, Array]:
    """Recover a named state dict from an ONNX export of the published modules.

    Parses the protobuf directly (``models/onnx_reader.py``, no ``onnx``
    package) and names parameters by graph traversal
    (``models/onnx_recover.py``): name-preserving exports pass through,
    constant-folded and anonymous ones are renamed from the known structure.
    """
    from foundationpose_cpp_tpu_torch.models import onnx_reader, onnx_recover

    try:
        graph = onnx_reader.parse_model(path)
    except onnx_reader.OnnxParseError as e:
        raise ConversionError(f"{path}: {e}") from e
    try:
        return onnx_recover.recover_state_dict(graph)
    except onnx_recover.RecoveryError as e:
        # a name-preserving export whose graph deviates from the published
        # trunk still carries every parameter by name; convert_state_dict's
        # strict checks then decide
        named = onnx_recover.named_float_initializers(graph)
        if named:
            logger.warning(
                "%s: structural recovery failed (%s); falling back to the "
                "%d named initializers", path, e, len(named),
            )
            return named
        raise ConversionError(
            f"{path}: cannot recover parameter names from this graph "
            f"({e}); convert from the torch .pth checkpoint instead"
        ) from e


def convert_file(
    path: str, model: str, out_path: str | None = None, allow_pickle: bool = False,
    crop_hw: int = 160,
) -> tuple[dict[str, torch.Tensor], networks.NetConfig]:
    """Convert a .pth/.pt/.onnx file; with ``out_path``, also write the f32
    state_dict as an npz in the JAX package's format."""
    if path.endswith(".onnx"):
        sd = load_onnx_initializers(path)
    else:
        sd = load_torch_checkpoint(path, allow_pickle=allow_pickle)
    cfg = infer_net_config(sd, crop_hw=crop_hw)
    out, cfg = convert_state_dict(sd, model, cfg)
    if out_path:
        convert_jax.save_npz(out, out_path)
    return out, cfg
