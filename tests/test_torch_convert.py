"""The port's strict converter and checkpoint writer against torch and JAX.

The counterpart of tests/test_convert.py: the port's published-structure
modules (``models/torch_ref.py``, NVlabs names, BatchNorm with non-trivial
statistics) are converted by the port's ``models/convert.py`` with no JAX,
and the port's forward on the result matches the module at rtol 1e-4 /
atol 1e-5 (tests/test_convert.py:93-117). Besides: the converted weights,
taken to the JAX layout by ``params_to_jax``, equal the JAX converter's f32
tree bit for bit; unknown, missing and mis-shaped tensors and a
non-sinusoidal ``pos_embed`` raise; ``save_params`` files load in the JAX
package and JAX's in the port, bit for bit, committed weights included; the
.pth front end and the port's ``tools/convert_onnx.py``.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from foundationpose_cpp_tpu.models import checkpoint as jckpt
from foundationpose_cpp_tpu.models import convert as jconvert
from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu_torch.models import (
    checkpoint,
    convert,
    convert_jax,
    infer_core,
    networks,
    torch_ref,
)

WDIR = pathlib.Path(__file__).resolve().parents[1] / "weights"
# toy dims (same graph, CPU-fast): crop 32 -> 4x4 = 16 tokens
C_IN, W1, W2, D, HEADS, FFN, CROP = 6, 8, 16, 32, 2, 24, 32


def _cfg(cross=False):
    return networks.NetConfig(
        in_channels=C_IN, width1=W1, width2=W2, embed_dim=D, num_heads=HEADS,
        ffn_dim=FFN, crop_hw=CROP, cross_attention=cross,
    )


def _jcfg(cross=False):
    return jnet.NetConfig(
        in_channels=C_IN, width1=W1, width2=W2, embed_dim=D, num_heads=HEADS,
        ffn_dim=FFN, crop_hw=CROP, cross_attention=cross, dtype=jnp.float32,
    )


def _randomize_bn(model, seed=0):
    """Non-trivial BN running stats and affine terms, so folding is tested."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.3)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) * 2 + 0.2)
            with torch.no_grad():
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.2)


def _refiner(seed=0, bn=True):
    torch.manual_seed(seed)
    model = torch_ref.build_refine_net(_cfg())
    if bn:
        _randomize_bn(model, seed)
    return model


def _inputs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, size=(n, CROP, CROP, C_IN)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(n, CROP, CROP, C_IN)).astype(np.float32)
    return a, b


def _port(sd, kind, a, b):
    net = convert_jax.build_net(sd, kind, num_heads=HEADS)
    with torch.no_grad():
        return net(torch.from_numpy(a), torch.from_numpy(b))


def _torch(model, a, b):
    with torch.no_grad():
        out = model(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(b).permute(0, 3, 1, 2))
    return out if isinstance(out, tuple) else (out,)


def test_refiner_roundtrip_matches_torch():
    model = _refiner()
    sd, _ = convert.convert_state_dict(torch_ref.state_dict_numpy(model), "refiner", _cfg())
    a, b = _inputs()
    out = _port(sd, "refiner", a, b)
    t_trans, t_rot = _torch(model, a, b)
    np.testing.assert_allclose(out["trans"].numpy(), t_trans.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["rot"].numpy(), t_rot.numpy(), rtol=1e-4, atol=1e-5)


def test_scorer_roundtrip_with_cross_attention():
    torch.manual_seed(1)
    model = torch_ref.build_score_net(_cfg(cross=True))
    _randomize_bn(model, seed=1)
    sd, _ = convert.convert_state_dict(model.state_dict(), "scorer", _cfg(cross=True))
    assert "att_cross.attn.qkv.weight" in sd
    a, b = _inputs(n=5, seed=2)
    (t_scores,) = _torch(model, a, b)
    np.testing.assert_allclose(_port(sd, "scorer", a, b)["scores"].numpy(), t_scores.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_convert_matches_jax_converter_bitwise(kind):
    """Port convert_state_dict then params_to_jax == JAX convert_state_dict
    in f32, leaf for leaf and bit for bit."""
    torch.manual_seed(2)
    cross = kind == "scorer"
    model = (torch_ref.build_refine_net(_cfg()) if kind == "refiner"
             else torch_ref.build_score_net(_cfg(cross=True)))
    _randomize_bn(model, seed=2)
    src = torch_ref.state_dict_numpy(model)
    sd, _ = convert.convert_state_dict(src, kind, _cfg(cross))
    jparams, _ = jconvert.convert_state_dict(src, kind, _jcfg(cross))
    got = jax.tree_util.tree_leaves_with_path(convert_jax.params_to_jax(sd))
    want = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32),
                                      err_msg=str(path))


def test_infer_net_config_from_checkpoint():
    torch.manual_seed(0)
    sd = torch_ref.state_dict_numpy(torch_ref.build_score_net(_cfg(cross=True)))
    cfg = convert.infer_net_config(sd, crop_hw=CROP)
    assert (cfg.width1, cfg.width2, cfg.embed_dim) == (W1, W2, D)
    assert cfg.ffn_dim == FFN and cfg.num_encoder_layers == 1
    assert cfg.cross_attention is True


def test_attr_style_convbnrelu_names():
    """ConvBNReLU written with .conv/.bn attribute children maps to the same
    tensors as the nn.Sequential naming."""
    sd = torch_ref.state_dict_numpy(_refiner())
    renamed = {}
    for k, v in sd.items():
        k2 = k
        for blk in ("encodeA.0", "encodeA.1", "encodeAB.1"):
            k2 = k2.replace(f"{blk}.0.", f"{blk}.conv.").replace(f"{blk}.1.", f"{blk}.bn.")
        renamed[k2] = v
    assert renamed != sd
    got, _ = convert.convert_state_dict(renamed, "refiner", _cfg())
    want, _ = convert.convert_state_dict(sd, "refiner", _cfg())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_module_prefix_stripped_and_npz_roundtrip(tmp_path):
    model = _refiner(bn=False)
    sd, _ = convert.convert_state_dict(
        {f"module.{k}": v for k, v in torch_ref.state_dict_numpy(model).items()}, "refiner", _cfg())
    path = str(tmp_path / "r.npz")
    convert_jax.save_npz(sd, path)
    loaded = convert_jax.load_npz(path)
    a, b = _inputs(n=1)
    o1, o2 = _port(sd, "refiner", a, b), _port(loaded, "refiner", a, b)
    np.testing.assert_array_equal(o1["trans"].numpy(), o2["trans"].numpy())


def test_unknown_tensor_rejected():
    sd = torch_ref.state_dict_numpy(_refiner(bn=False))
    sd["mystery.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(convert.ConversionError, match="not consumed"):
        convert.convert_state_dict(sd, "refiner", _cfg())


def test_missing_tensor_rejected():
    sd = torch_ref.state_dict_numpy(_refiner(bn=False))
    del sd["encoder.layers.0.linear1.weight"]
    with pytest.raises(convert.ConversionError, match="missing tensor"):
        convert.convert_state_dict(sd, "refiner", _cfg())


def test_wrong_shape_rejected():
    sd = torch_ref.state_dict_numpy(_refiner(bn=False))
    sd["trans_head.0.weight"] = np.zeros((4, D), np.float32)
    with pytest.raises(convert.ConversionError, match="shape"):
        convert.convert_state_dict(sd, "refiner", _cfg())


def test_nonstandard_pos_embed_rejected():
    sd = torch_ref.state_dict_numpy(_refiner(bn=False))
    sd["pos_embed.pe"] = np.random.default_rng(0).normal(size=sd["pos_embed.pe"].shape).astype(np.float32)
    with pytest.raises(convert.ConversionError, match="sinusoidal"):
        convert.convert_state_dict(sd, "refiner", _cfg())


def test_converted_params_run_in_bf16_pipeline_dtype():
    """The converter keeps f32; the placement casts the matmul weights (not
    LayerNorm, heads or the position table) to bf16."""
    sd, _ = convert.convert_state_dict(torch_ref.state_dict_numpy(_refiner(bn=False)), "refiner",
                                       _cfg())
    assert all(t.dtype == torch.float32 for t in sd.values())
    net = convert_jax.as_net(convert_jax.build_net(sd, "refiner", num_heads=HEADS), "refiner",
                             torch.device("cpu"), torch.bfloat16)
    assert net.encodeA["conv0"].weight.dtype == torch.bfloat16
    assert net.encoder[0].attn.qkv.weight.dtype == torch.bfloat16
    assert net.encoder[0].ln1.weight.dtype == torch.float32
    assert net.heads["trans"].weight.dtype == torch.float32
    a, b = _inputs(n=2)
    with torch.no_grad():
        out = net(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isfinite(out["trans"]).all()


def test_torch_oracle_infer_core_matches_torch_infer_core():
    """The published-structure engine (TorchRefInferCore) and the port's
    TorchInferCore agree on identical weights."""
    torch.manual_seed(3)
    oracle = torch_ref.create_refiner_oracle(_cfg())
    sd, _ = convert.convert_state_dict(torch_ref.state_dict_numpy(oracle._net), "refiner", _cfg())
    core = infer_core.create_refiner_core(convert_jax.build_net(sd, "refiner", num_heads=HEADS),
                                          device="cpu", dtype=torch.float32)
    a, b = _inputs(n=2, seed=7)
    blobs = {"render_input": a, "transf_input": b}
    got, want = core.infer(blobs), oracle.infer(blobs)
    assert oracle.output_names() == core.output_names() == ("trans", "rot")
    for k in ("trans", "rot"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5)


# --- checkpoint format: both ways with the JAX package


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(port_tree, jax_tree):
    got = jax.tree_util.tree_leaves_with_path(port_tree)
    want = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        g_np = checkpoint._leaf_numpy(g)[0]
        assert (w.dtype.name == "bfloat16") == (g.dtype == torch.bfloat16), path
        np.testing.assert_array_equal(g_np, _bits(w), err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_params_roundtrips_with_jax(tmp_path, dtype):
    """A port file loads in the JAX package and a JAX file in the port, bit
    for bit, with equal fingerprints; bf16 rides as its uint16 bits."""
    cfg = jnet.NetConfig(width1=8, width2=16, embed_dim=32, num_heads=2, ffn_dim=24, crop_hw=32,
                         cross_attention=True, dtype=getattr(jnp, dtype))
    jparams = jnet.init_scorer(3, cfg)
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_params(jparams, j_path)
    port_tree = checkpoint.load_params(j_path)
    _assert_trees_equal(port_tree, jparams)
    checkpoint.save_params(port_tree, p_path)
    _assert_trees_equal(port_tree, jckpt.load_params(p_path))
    assert checkpoint.params_fingerprint(port_tree) == jckpt.params_fingerprint(jparams)
    sd = convert_jax.params_from_jax(port_tree)
    assert checkpoint.params_fingerprint(convert_jax.params_to_jax(sd)) == \
        jckpt.params_fingerprint(jparams)


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_committed_weights_roundtrip(tmp_path, kind):
    """weights/<kind>_multi_full.npz -> port state_dict -> save_npz gives the
    same arrays, dtype map and fingerprint as the file itself."""
    src = WDIR / f"{kind}_multi_full.npz"
    path = str(tmp_path / "copy.npz")
    convert_jax.save_npz(convert_jax.load_npz(str(src)), path)
    a, b = np.load(src), np.load(path)
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        if f == "__dtypes__":
            assert json.loads(bytes(a[f])) == json.loads(bytes(b[f]))
        else:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert checkpoint.params_fingerprint(checkpoint.load_params(path)) == \
        jckpt.params_fingerprint(jckpt.load_params(str(src)))


# --- file front ends and the tool


def test_pth_checkpoint_and_pickle_refusal(tmp_path):
    """A .pth state dict converts like the in-memory one; a checkpoint that
    needs pickle is refused unless allowed."""
    model = _refiner(seed=4)
    pth = str(tmp_path / "model_best.pth")
    torch.save({"model": model.state_dict()}, pth)
    sd, cfg = convert.convert_file(pth, "refiner", crop_hw=CROP)
    want, _ = convert.convert_state_dict(model.state_dict(), "refiner", _cfg())
    assert (cfg.width1, cfg.embed_dim, cfg.ffn_dim) == (W1, D, FFN)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    legacy = str(tmp_path / "legacy.pth")
    torch.save({"state_dict": model.state_dict(), "meta": _Meta()}, legacy)
    with pytest.raises(convert.ConversionError, match="allow-pickle"):
        convert.load_torch_checkpoint(legacy)


class _Meta:
    """A training-time object that only pickle can restore."""


def test_convert_onnx_tool(tmp_path, capsys):
    from foundationpose_cpp_tpu_torch.tools import convert_onnx

    model = _refiner(seed=5)
    pth = str(tmp_path / "r.pth")
    torch.save(model.state_dict(), pth)
    convert_onnx.main(["--torch", pth, "--net", "refiner", "--list"])
    assert "encodeA.0.1.running_var" in capsys.readouterr().out
    out = str(tmp_path / "r.npz")
    convert_onnx.main(["--torch", pth, "--net", "refiner", "--out", out, "--crop-hw", str(CROP)])
    a, b = _inputs(n=2, seed=6)
    t_trans, _ = _torch(model, a, b)
    got = _port(convert_jax.load_npz(out), "refiner", a, b)
    np.testing.assert_allclose(got["trans"].numpy(), t_trans.numpy(), rtol=1e-4, atol=1e-5)
    bad = str(tmp_path / "bad.pth")
    torch.save({**model.state_dict(), "mystery.weight": torch.zeros(3)}, bad)
    with pytest.raises(SystemExit, match="not consumed"):
        convert_onnx.main(["--torch", bad, "--out", str(tmp_path / "x.npz"), "--crop-hw", "32"])
