"""The published FoundationPose module tree, as the checkpoints name it.

NVlabs FoundationPose ``RefineNet`` / ``ScoreNetMultiPair``
(learning/models/{refine_network,score_network,network_modules}.py), with
BatchNorm layers, ``nn.TransformerEncoder`` over ``nn.MultiheadAttention`` and
the exact state-dict naming of the published .pth checkpoints. It serves two
purposes:

1. converter fixture: its ``state_dict()`` and its ONNX exports name and lay
   out tensors as the published files do, so ``models/convert.py`` and
   ``models/onnx_recover.py`` are held against the true naming scheme;
2. parity oracle: the same weights through this tree and, converted, through
   ``models/networks.py`` must agree.

The port's own copy of ``foundationpose_cpp_tpu.models.torch_ref``, built from
the port's ``NetConfig``; NCHW in, as the published modules take it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from foundationpose_cpp_tpu_torch.models.networks import NetConfig


class ConvBNReLU(nn.Sequential):
    """network_modules.py ConvBNReLU: conv(bias=False) + BN + ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, stride: int = 1):
        super().__init__(
            nn.Conv2d(c_in, c_out, kernel_size, stride, padding=(kernel_size - 1) // 2,
                      bias=False),
            nn.BatchNorm2d(c_out),
            nn.ReLU(inplace=True),
        )


class ResnetBasicBlock(nn.Module):
    """network_modules.py ResnetBasicBlock (biased convs + BN + skip)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, 1, 1, bias=True)
        self.bn1 = nn.BatchNorm2d(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1, bias=True)
        self.bn2 = nn.BatchNorm2d(ch)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + x)


class PositionalEmbedding(nn.Module):
    """network_modules.py PositionalEmbedding: sinusoidal buffer."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        pe = torch.zeros(max_len, d_model).float()
        position = torch.arange(0, max_len).float().unsqueeze(1)
        div_term = (torch.arange(0, d_model, 2).float() * -(math.log(10000.0) / d_model)).exp()
        pe[:, 0::2] = torch.sin(position * div_term)
        pe[:, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe.unsqueeze(0))

    def forward(self, x):
        return x + self.pe[:, : x.size(1)]


def _encoder_layer(cfg: NetConfig) -> nn.TransformerEncoderLayer:
    return nn.TransformerEncoderLayer(
        d_model=cfg.embed_dim, nhead=cfg.num_heads, dim_feedforward=cfg.ffn_dim,
        dropout=0.0, batch_first=True,
    )


class _Backbone(nn.Module):
    """Shared siamese trunk of RefineNet / ScoreNetMultiPair."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        c, w1, w2, d = cfg.in_channels, cfg.width1, cfg.width2, cfg.embed_dim
        self.encodeA = nn.Sequential(
            ConvBNReLU(c, w1, 7, 2), ConvBNReLU(w1, w2, 3, 2), ResnetBasicBlock(w2),
        )
        self.encodeAB = nn.Sequential(
            ResnetBasicBlock(2 * w2), ConvBNReLU(2 * w2, d, 3, 2), ResnetBasicBlock(d),
        )
        self.pos_embed = PositionalEmbedding(d, max_len=cfg.num_tokens)
        self.encoder = nn.TransformerEncoder(_encoder_layer(cfg),
                                             num_layers=cfg.num_encoder_layers)

    def embed(self, a, b):
        bs = len(a)
        x = torch.cat([a, b], dim=0)
        x = self.encodeA(x)
        ab = torch.cat((x[:bs], x[bs:]), dim=1)
        ab = self.encodeAB(ab)
        ab = self.pos_embed(ab.reshape(bs, ab.shape[1], -1).permute(0, 2, 1))
        ab = self.encoder(ab)
        return ab.mean(dim=1)


class RefineNet(_Backbone):
    """refine_network.py RefineNet: trans/rot heads on the trunk."""

    def __init__(self, cfg: NetConfig = NetConfig()):
        super().__init__(cfg)
        self.trans_head = nn.Sequential(nn.Linear(cfg.embed_dim, 3))
        self.rot_head = nn.Sequential(nn.Linear(cfg.embed_dim, 3))

    def forward(self, a, b):
        f = self.embed(a, b)
        return self.trans_head(f), self.rot_head(f)


class ScoreNetMultiPair(_Backbone):
    """score_network.py ScoreNetMultiPair: optional cross-hypothesis
    attention + score head."""

    def __init__(self, cfg: NetConfig = NetConfig()):
        super().__init__(cfg)
        self.cross_attention = cfg.cross_attention
        if cfg.cross_attention:
            self.att_cross = _encoder_layer(cfg)
        self.score_head = nn.Sequential(nn.Linear(cfg.embed_dim, 1))

    def forward(self, a, b):
        f = self.embed(a, b)  # (N, D)
        if self.cross_attention:
            f = self.att_cross(f.unsqueeze(0)).squeeze(0)
        return self.score_head(f)


def build_refine_net(cfg: NetConfig = NetConfig()) -> RefineNet:
    """RefineNet instance in eval mode (the published module tree)."""
    return RefineNet(cfg).eval()


def build_score_net(cfg: NetConfig = NetConfig()) -> ScoreNetMultiPair:
    """ScoreNetMultiPair instance in eval mode."""
    return ScoreNetMultiPair(cfg).eval()


def state_dict_numpy(model: nn.Module) -> dict:
    """Model state_dict as numpy arrays (``convert.convert_state_dict`` input)."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


class TorchRefInferCore:
    """Named-blob engine over a published-structure module: NHWC blobs in,
    named f32 tensors out, on the module's device."""

    def __init__(self, net: nn.Module, output_names: tuple[str, ...]):
        self._net = net
        self._output_names = tuple(output_names)

    def input_names(self) -> tuple[str, ...]:
        return ("render_input", "transf_input")

    def output_names(self) -> tuple[str, ...]:
        return self._output_names

    @torch.no_grad()
    def infer(self, blobs) -> dict[str, torch.Tensor]:
        device = next(self._net.parameters()).device
        a, b = (torch.as_tensor(blobs[name], dtype=torch.float32, device=device).permute(0, 3, 1, 2)
                for name in self.input_names())
        out = self._net(a, b)
        if not isinstance(out, tuple):
            out = (out,)
        return dict(zip(self._output_names, out))


def create_refiner_oracle(cfg: NetConfig = NetConfig()) -> TorchRefInferCore:
    """Refiner oracle on the CPU: blobs -> {trans, rot}."""
    return TorchRefInferCore(build_refine_net(cfg), ("trans", "rot"))


def create_scorer_oracle(cfg: NetConfig = NetConfig()) -> TorchRefInferCore:
    """Scorer oracle on the CPU: blobs -> {scores}."""
    return TorchRefInferCore(build_score_net(cfg), ("scores",))
