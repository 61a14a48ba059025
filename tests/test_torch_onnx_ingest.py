"""The port's ONNX ingest against the exporting torch module and the JAX package.

The counterpart of tests/test_onnx_roundtrip.py: real ``torch.onnx.export``
files of the port's published-structure modules (``models/torch_ref.py``),
name-preserving, constant-folded, at the published-export era's opset 14 and
fully anonymous, go through the port's reader, recovery and strict converter
with no JAX. The port's forward on the converted weights matches the module
that wrote the file at rtol 1e-4 / atol 1e-5 (tests/test_convert.py:93-117);
the port's ``recover_state_dict`` equals the JAX one on the same file array
for array, bitwise, and the converted weights equal the JAX converter's f32
tree bit for bit.

The environment has no ``onnx`` package; the TorchScript exporter serializes
the ModelProto itself and imports ``onnx`` only in a post-pass that the
export helper stubs out (a no-op for these graphs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu.models import convert as jconvert
from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu.models import onnx_reader as jreader
from foundationpose_cpp_tpu.models import onnx_recover as jrecover
from foundationpose_cpp_tpu_torch.models import (
    checkpoint,
    convert,
    convert_jax,
    networks,
    onnx_reader,
    onnx_recover,
    torch_ref,
)

C_IN, W1, W2, D, HEADS, FFN, CROP = 6, 8, 16, 32, 2, 24, 32
N_LAYERS = 2  # >1 so exporter-inlined (Constant-node) layer params occur


def _cfg(cross=False):
    return networks.NetConfig(
        in_channels=C_IN, width1=W1, width2=W2, embed_dim=D, num_heads=HEADS,
        ffn_dim=FFN, num_encoder_layers=N_LAYERS, crop_hw=CROP, cross_attention=cross,
    )


def _jcfg(cross=False):
    return jnet.NetConfig(
        in_channels=C_IN, width1=W1, width2=W2, embed_dim=D, num_heads=HEADS,
        ffn_dim=FFN, num_encoder_layers=N_LAYERS, crop_hw=CROP, cross_attention=cross,
        dtype=jnp.float32,
    )


def _randomize(model, seed):
    """Trained-checkpoint stand-in: every tensor non-trivial and distinct (the
    exporter deduplicates equal initializers); pos_embed stays sinusoidal."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if "num_batches" in k or "pos_embed" in k:
                continue
            if "running_var" in k:
                v.copy_(torch.rand(v.shape, generator=g) * 2 + 0.2)
            else:
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)


def _export(model, path, fold, outputs, opset=None):
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda mb, co: mb
    kw = {} if opset is None else {"opset_version": opset}
    try:
        torch.onnx.export(
            model,
            (torch.randn(2, C_IN, CROP, CROP), torch.randn(2, C_IN, CROP, CROP)),
            path,
            dynamo=False,
            do_constant_folding=fold,
            input_names=["render_input", "transf_input"],
            output_names=list(outputs),
            dynamic_axes={"render_input": {0: "n"}, "transf_input": {0: "n"}},
            **kw,
        )
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def _inputs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, size=(n, CROP, CROP, C_IN)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(n, CROP, CROP, C_IN)).astype(np.float32)
    return a, b


def _torch_out(model, a, b):
    with torch.no_grad():
        out = model(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(b).permute(0, 3, 1, 2))
    return out if isinstance(out, tuple) else (out,)


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _check(kind, sd_src, jsd_src, cross, model, n, seed):
    """Convert with the port and with JAX: the trees equal bit for bit, and
    the port's forward matches the exporting module."""
    sd, cfg = convert.convert_state_dict(sd_src, kind, _cfg(cross))
    jparams, _ = jconvert.convert_state_dict(jsd_src, kind, _jcfg(cross))
    got = jax.tree_util.tree_leaves_with_path(convert_jax.params_to_jax(sd))
    want = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32, path
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w.view(np.uint32), err_msg=str(path))
    net = convert_jax.build_net(sd, kind, num_heads=HEADS)
    a, b = _inputs(n, seed)
    with torch.no_grad():
        out = net(torch.from_numpy(a), torch.from_numpy(b))
    want_out = _torch_out(model, a, b)
    names = ("trans", "rot") if kind == "refiner" else ("scores",)
    for name, t in zip(names, want_out):
        np.testing.assert_allclose(out[name].numpy(), t.numpy(), rtol=1e-4, atol=1e-5)
    return sd, cfg


def _recover_both(path):
    """The port's and the JAX package's recovery of one file, held equal."""
    sd = convert.load_onnx_initializers(path)
    _assert_same_arrays(sd, jconvert.load_onnx_initializers(path))
    return sd


@pytest.mark.parametrize("fold", [False, True], ids=["named", "folded"])
def test_refiner_onnx_roundtrip(tmp_path, fold):
    torch.manual_seed(0)
    model = torch_ref.build_refine_net(_cfg())
    _randomize(model, seed=7)
    path = str(tmp_path / "refiner.onnx")
    _export(model, path, fold, ("trans", "rot"))
    sd = _recover_both(path)
    _check("refiner", sd, sd, False, model, 3, 0)


def test_scorer_onnx_roundtrip_folded(tmp_path):
    """Constant-folded scorer: anonymous conv/matmul names + att_cross."""
    torch.manual_seed(1)
    model = torch_ref.build_score_net(_cfg(cross=True))
    _randomize(model, seed=11)
    path = str(tmp_path / "scorer.onnx")
    _export(model, path, True, ("scores",))
    sd = _recover_both(path)
    assert any(k.startswith("att_cross") for k in sd)
    _check("scorer", sd, sd, True, model, 4, 3)


def test_convert_file_onnx_end_to_end(tmp_path):
    """The tool's path: .onnx in, npz out, NetConfig inferred from the graph;
    the npz loads in the port and in the JAX package to the same bits."""
    from foundationpose_cpp_tpu.models import checkpoint as jckpt

    torch.manual_seed(2)
    model = torch_ref.build_refine_net(_cfg())
    _randomize(model, seed=13)
    path = str(tmp_path / "refiner_hwc.onnx")
    _export(model, path, True, ("trans", "rot"))
    out_npz = str(tmp_path / "refiner.npz")
    sd, cfg = convert.convert_file(path, "refiner", out_path=out_npz, crop_hw=CROP)
    assert (cfg.width1, cfg.width2, cfg.embed_dim, cfg.ffn_dim) == (W1, W2, D, FFN)
    assert cfg.num_encoder_layers == N_LAYERS
    loaded = convert_jax.load_npz(out_npz)
    assert sorted(loaded) == sorted(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    jtree = jckpt.load_params(out_npz)
    assert checkpoint.params_fingerprint(convert_jax.params_to_jax(sd)) == \
        jckpt.params_fingerprint(jtree)
    a, b = _inputs(n=2, seed=5)
    (t_trans, _) = _torch_out(model, a, b)
    # the bf16 inference policy agrees with torch loosely, as in the JAX test
    net = convert_jax.as_net(out_npz, "refiner", torch.device("cpu"), torch.bfloat16)
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))["trans"]
    np.testing.assert_allclose(got.numpy(), t_trans.numpy(), rtol=0.1, atol=0.05)


# --- published-export-era graphs (opset 14): decomposed LayerNorm, MatMul+Add
# linears, unfused attention; BN unfolded or const-folded


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded_bn", "folded"])
def test_refiner_opset14_era_roundtrip(tmp_path, fold):
    torch.manual_seed(3)
    model = torch_ref.build_refine_net(_cfg())
    _randomize(model, seed=17)
    path = str(tmp_path / "refiner_op14.onnx")
    _export(model, path, fold, ("trans", "rot"), opset=14)
    sd = _recover_both(path)
    _check("refiner", sd, sd, False, model, 3, 9)


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded_bn", "folded"])
def test_scorer_opset14_era_roundtrip(tmp_path, fold):
    torch.manual_seed(4)
    model = torch_ref.build_score_net(_cfg(cross=True))
    _randomize(model, seed=19)
    path = str(tmp_path / "scorer_op14.onnx")
    _export(model, path, fold, ("scores",), opset=14)
    sd = _recover_both(path)
    assert any(k.startswith("att_cross") for k in sd)
    _check("scorer", sd, sd, True, model, 4, 21)


def _anonymize(graph):
    """Strip EVERY initializer name to `onnx::T_{i}`: recovery must then be
    fully structural, BN tensors and LN scale/bias included."""
    rename = {n: f"onnx::T_{i}" for i, n in enumerate(graph.initializers)}
    graph.initializers = {rename[n]: a for n, a in graph.initializers.items()}
    for node in graph.nodes:
        node.inputs = [rename.get(i, i) for i in node.inputs]
    return graph


def _recover_anonymous(path):
    sd = onnx_recover.recover_state_dict(_anonymize(onnx_reader.parse_model(path)))
    jsd = jrecover.recover_state_dict(_anonymize(jreader.parse_model(path)))
    _assert_same_arrays(sd, jsd)
    return sd


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded_bn", "folded"])
def test_scorer_opset14_fully_anonymous(tmp_path, fold):
    torch.manual_seed(5)
    model = torch_ref.build_score_net(_cfg(cross=True))
    _randomize(model, seed=23)
    path = str(tmp_path / "scorer_anon.onnx")
    _export(model, path, fold, ("scores",), opset=14)
    sd = _recover_anonymous(path)
    _check("scorer", sd, sd, True, model, 3, 25)


def test_refiner_opset14_fully_anonymous(tmp_path):
    torch.manual_seed(6)
    model = torch_ref.build_refine_net(_cfg())
    _randomize(model, seed=27)
    path = str(tmp_path / "refiner_anon.onnx")
    _export(model, path, True, ("trans", "rot"), opset=14)
    sd = _recover_anonymous(path)
    _check("refiner", sd, sd, False, model, 2, 29)


@pytest.mark.parametrize("junk", [b"\x99" * 64, b"\x0a\x05ab"], ids=["garbage", "truncated"])
def test_corrupted_onnx_rejected(tmp_path, junk):
    path = str(tmp_path / "junk.onnx")
    with open(path, "wb") as f:
        f.write(junk)
    with pytest.raises(convert.ConversionError):
        convert.load_onnx_initializers(path)


def test_negative_int64_initializers_and_attrs_parse():
    """Negative protobuf ints arrive as 10-byte two's-complement varints; the
    reader delivers them signed, as the JAX reader does."""

    def varint(v):
        v &= (1 << 64) - 1
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def field(num, wt, payload):
        tag = varint(num << 3 | wt)
        if wt == 2:
            return tag + varint(len(payload)) + payload
        return tag + payload

    tensor = (field(1, 0, varint(2)) + field(2, 0, varint(7))
              + field(7, 2, varint(-1) + varint(512)) + field(8, 2, b"shape_const"))
    attr = field(1, 2, b"axis") + field(3, 0, varint(-1))
    node = field(4, 2, b"Slice") + field(5, 2, attr)
    model = field(7, 2, field(5, 2, tensor) + field(1, 2, node))

    g = onnx_reader.parse_model(model)
    np.testing.assert_array_equal(g.initializers["shape_const"], np.asarray([-1, 512], np.int64))
    assert g.nodes[0].attrs["axis"] == -1
    jg = jreader.parse_model(model)
    np.testing.assert_array_equal(g.initializers["shape_const"], jg.initializers["shape_const"])
