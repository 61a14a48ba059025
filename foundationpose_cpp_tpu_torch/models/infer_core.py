"""Model-runtime layer: the reference's inference_core as named-blob engines.

Counterpart of ``foundationpose_cpp_tpu.models.infer_core``. The reference
links against EasyDeployTool's ``BaseInferCore`` (API reconstructed in
SURVEY.md SS2.8 from call sites: foundationpose.cpp:126-139, 207, 331-355,
413-436): named blobs in, named blobs out, a dynamic batch served by
TensorRT engines built per shape profile. The pipeline calls the nets
directly; ``TorchInferCore`` keeps the standalone call surface for users who
ran the engines themselves. A batch is zero-padded up to the nearest bucket
and the outputs are sliced back, as in the JAX package.

A scorer with ``att_cross`` (``NetConfig.cross_attention``, the trained
``weights/scorer_multi_full.npz``) attends across the whole batch (at
inference the batch is one scene), so a padded call gives scores that
depend on the zero rows, exactly as the JAX core's do.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.utils.device import resolve_device


class BaseInferCore(Protocol):
    """Named-blob inference interface (BaseInferCore::SyncInfer parity)."""

    def input_names(self) -> tuple[str, ...]: ...

    def output_names(self) -> tuple[str, ...]: ...

    def infer(self, blobs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]: ...


@dataclasses.dataclass
class TorchInferCore:
    """Wraps a RefineNet / ScoreNet as a blob-named engine with batch buckets.

    A batch of n rows is zero-padded up to the smallest bucket >= n (n itself
    above the largest) and the outputs are sliced back to n rows. Blobs may
    be tensors or numpy arrays; they are moved to the net's device.
    """

    net: networks._Backbone
    _input_names: tuple[str, ...] = ("render_input", "transf_input")
    _output_names: tuple[str, ...] = ()
    buckets: tuple[int, ...] = (1, 8, 64, 252)

    def input_names(self) -> tuple[str, ...]:
        return self._input_names

    def output_names(self) -> tuple[str, ...]:
        return self._output_names

    @torch.inference_mode()
    def infer(self, blobs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        for name in self._input_names:
            if name not in blobs:
                raise KeyError(f"[TorchInferCore] missing input blob '{name}'")
        device = self.net.pos_embed.device
        a, b = (torch.as_tensor(blobs[name], dtype=torch.float32, device=device)
                for name in self._input_names)
        n = a.shape[0]
        bucket = next((bk for bk in self.buckets if bk >= n), n)
        if bucket != n:
            pad = (0, 0, 0, 0, 0, 0, 0, bucket - n)  # rows at the end of dim 0
            a, b = F.pad(a, pad), F.pad(b, pad)
        out = self.net(a, b)
        return {k: v[:n] for k, v in out.items()}


def _core(kind: str, net, cfg: networks.NetConfig, seed: int, device, dtype,
          outputs: tuple[str, ...]) -> TorchInferCore:
    device = resolve_device(device)
    if net is None:
        net = networks.init_net(kind, cfg, seed)
    net = convert_jax.as_net(net, kind, device, dtype)
    return TorchInferCore(net=net, _output_names=outputs)


def create_refiner_core(
    net=None,
    cfg: networks.NetConfig = networks.NetConfig(),
    seed: int = 0,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> TorchInferCore:
    """Factory mirroring CreateTrtInferCore for the refiner engine.

    net: a RefineNet, a state_dict from ``convert_jax`` or a
    ``weights/*_full.npz`` path; None builds one from ``seed`` with
    ``networks.init_net``. device: None means the card."""
    return _core("refiner", net, cfg, seed, device, dtype, ("trans", "rot"))


def create_scorer_core(
    net=None,
    cfg: networks.NetConfig = networks.NetConfig(),
    seed: int = 1,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> TorchInferCore:
    """Factory mirroring CreateTrtInferCore for the scorer engine (arguments
    as ``create_refiner_core``)."""
    return _core("scorer", net, cfg, seed, device, dtype, ("scores",))
