"""The port's perf harnesses on the CPU, against the JAX package's.

- ``networks.conv0_s2d`` against JAX ``networks._conv0_s2d`` on the same
  seeded numpy inputs and against the port's direct 7x7/s2 conv, atol 1e-4
  (as ``tests/test_training.py``'s s2d test);
- ``tools/bench_stem.py``'s as-served, channel-padded, s2d, polyphase and
  blocked stems against the direct stem in f32, atol 1e-4 (the as-served
  stem ends in the nets' ReLU, so its case shifts the bias until every sum
  is positive);
- ``tools/bench_attn.py``'s split-weight encodeAB against its concat form,
  and the concat form against the JAX ``_res_block`` / ``_conv_relu`` chain
  on parameters carried across by ``models/convert_jax``, atol 1e-4 (f32);
- its attention variants (b) and (c) against the same arithmetic written in
  ``jax.numpy`` after the JAX tool (tools/bench_attn.py:59-80) on bf16
  inputs, rtol 2e-2 and atol 2e-2 (bf16 keeps 8 bits: the two frameworks
  round the logits, the softmax and the outputs at other places, 1-2 ulps
  of LayerNorm outputs of size ~2);
- each tool's ``run(device="cpu")`` at crop 32, narrow nets, n=2, 1
  iteration: its keys are the labels of the JAX tool (read from its source
  with ``ast``) and the extras its docstring names, its times finite and
  positive, its nulls the documented ones;
- each tool's ``main`` raises without a card unless ``--device cpu``.
"""

import ast
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import convert_jax, networks
from foundationpose_cpp_tpu_torch.tools import (
    bench_attn, bench_stem, probe_grid_overhead, profile_nets, profile_register,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NARROW = dict(width1=8, width2=16, embed_dim=32, num_heads=4, ffn_dim=32, crop_hw=32)


def to_nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def stem_inputs(seed: int, n: int, h: int, w: int, cout: int):
    """x (N, H, W, 6), w (7, 7, 6, cout) HWIO, b: numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, 6)).astype(np.float32),
            rng.normal(size=(7, 7, 6, cout)).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 32, 32, 16), (1, 24, 40, 8)])
def test_conv0_s2d_matches_jax_and_the_direct_conv(shape):
    x, w, b = stem_inputs(9, *shape)
    want = np.asarray(jnet._conv0_s2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xt, wt = to_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = networks.conv0_s2d(xt, wt, torch.from_numpy(b))
    np.testing.assert_allclose(to_nhwc(got), want, atol=1e-4)
    np.testing.assert_allclose(to_nhwc(got), to_nhwc(F.conv2d(xt, wt, torch.from_numpy(b), 2, 3)),
                               atol=1e-4)


@pytest.mark.parametrize("label", sorted(set(bench_stem.variants(
    torch.zeros(16, 6, 7, 7), torch.zeros(16))) - {"direct 7x7 s2"}))
def test_stem_variants_match_the_direct_stem(label):
    x, w, b = stem_inputs(4, 2, 32, 32, 16)
    wt, bt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b)
    xt = to_nchw(x).contiguous(memory_format=torch.channels_last)
    if label == "as served":
        # networks.stem ends in the nets' ReLU: a bias that puts every sum at
        # 1 or more makes it the identity, so every output is compared
        bt = bt + (1.0 - F.conv2d(xt, wt, bt, 2, 3).amin())
    prepare, stem = bench_stem.variants(wt, bt)[label]
    got = stem(xt if prepare is None else prepare(xt))
    want = F.conv2d(xt, wt, bt, 2, 3)
    if label == "as served":
        assert want.amin() > 0.5
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert bench_stem.excess(wt, bt, xt)[label] <= 1e-4


@pytest.fixture(scope="module")
def narrow_refiner():
    """JAX f32 refiner parameters at narrow widths and the port's refiner
    holding them."""
    cfg = jnet.NetConfig(**NARROW, dtype=jnp.float32)
    params = jnet.init_refiner(3, cfg)
    net = convert_jax.build_net(convert_jax.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "refiner")
    return params, net


def test_encode_ab_forms_match_jax(narrow_refiner):
    params, net = narrow_refiner
    rng = np.random.default_rng(5)
    s2, c = NARROW["crop_hw"] // 4, NARROW["width2"]
    fa, fb = (rng.uniform(size=(2, s2, s2, c)).astype(np.float32) for _ in range(2))
    q = params["encodeAB"]
    ab = jnp.concatenate([jnp.asarray(fa), jnp.asarray(fb)], axis=-1)
    ab = jnet._res_block(ab, q["res0"])
    ab = jnet._conv_relu(ab, q["conv"], stride=2)
    want = np.asarray(jnet._res_block(ab, q["res1"]))
    with torch.no_grad():
        concat = bench_attn.encode_ab_concat(net.encodeAB, to_nchw(fa), to_nchw(fb))
        split = bench_attn.encode_ab_split(net.encodeAB, to_nchw(fa), to_nchw(fb))
    np.testing.assert_allclose(to_nhwc(concat), want, atol=1e-4)
    np.testing.assert_allclose(to_nhwc(split), to_nhwc(concat), atol=1e-4)


def jax_layer_variant(layer, x, num_heads, logits_dtype, softmax_f32):
    """tools/bench_attn.py:59-80 (attn_core) and its full_layer, on a JAX layer."""
    p = layer["attn"]
    n, t, d = x.shape
    hd = d // num_heads
    qkv = jnet._linear(x, p["qkv_w"], p["qkv_b"])
    q, k, v = (a.reshape(n, t, num_heads, hd).transpose(0, 2, 1, 3)
               for a in jnp.split(qkv, 3, axis=-1))
    q = q / math.sqrt(hd)
    logits = jnp.einsum("nhqd,nhkd->nhqk", q, k, preferred_element_type=logits_dtype)
    attn = jax.nn.softmax(logits.astype(jnp.float32) if softmax_f32 else logits, axis=-1)
    out = jnp.einsum("nhqk,nhkd->nhqd", attn.astype(x.dtype), v,
                     preferred_element_type=jnp.float32)
    out = jnet._linear(out.transpose(0, 2, 1, 3).reshape(n, t, d).astype(x.dtype),
                       p["proj_w"], p["proj_b"])
    x = jnet._layer_norm(x + out, layer["ln1_s"], layer["ln1_b"])
    h = jax.nn.relu(jnet._linear(x, layer["mlp_w1"], layer["mlp_b1"]))
    h = jnet._linear(h, layer["mlp_w2"], layer["mlp_b2"])
    return jnet._layer_norm(x + h, layer["ln2_s"], layer["ln2_b"])


@pytest.mark.parametrize("label", ["(b) bf16 logits + bf16 softmax",
                                   "(c) bf16 logits + f32 softmax"])
def test_attention_variants_match_jax(narrow_refiner, label):
    params, net = narrow_refiner
    logits_dtype, softmax_f32 = bench_attn.VARIANTS[label]
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, (NARROW["crop_hw"] // 8) ** 2, NARROW["embed_dim"]))
    x = x.astype(np.float32)
    want = jax_layer_variant(params["encoder"][0], jnp.asarray(x, jnp.bfloat16),
                             NARROW["num_heads"], jnp.bfloat16, softmax_f32)
    with torch.no_grad():
        got = bench_attn.layer_variant(net.encoder[0], torch.from_numpy(x).to(torch.bfloat16),
                                       (logits_dtype, softmax_f32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def jax_labels(path: str, fn_name: str = "timed", arg: int = 0,
               scope: str | None = None) -> list[re.Pattern]:
    """The labels a JAX tool prints: the string (or f-string, as a pattern)
    at position ``arg`` of every call of ``fn_name`` (within the function
    ``scope``, if given), stripped."""
    tree = ast.parse((ROOT / "tools" / path).read_text())
    if scope is not None:
        (tree,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == scope]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == fn_name:
            label = node.args[arg]
            if isinstance(label, ast.Constant):
                out.append(re.compile(re.escape(label.value.strip())))
            else:
                out.append(re.compile("".join(
                    re.escape(part.value) if isinstance(part, ast.Constant) else ".+"
                    for part in label.values)))
    return out


def narrow_cfg(**extra) -> networks.NetConfig:
    return networks.NetConfig(**NARROW, **extra)


def small_probe(mp):
    """The probe's two shapes at 2 views (their grids' other dimensions and
    widths unchanged)."""
    shapes = {k: (2, *v[1:]) for k, v in probe_grid_overhead.SHAPES.items()}
    mp.setattr(probe_grid_overhead, "SHAPES", shapes)
    return probe_grid_overhead.run("cpu", iters=1)


def small_register(mp):
    """profile_register on an 80-face sphere in place of the 6016-face one,
    so that the plain render takes milliseconds."""
    sphere = procedural.textured_uv_sphere
    mp.setattr(profile_register.procedural, "textured_uv_sphere",
               lambda **kw: sphere(radius=kw["radius"], n_lat=8, n_lon=8))
    return profile_register.run("cpu", iters=1, n=2, crop=32, hw=(120, 160),
                                net_cfg=narrow_cfg())


TOOLS = {  # name -> (run, the JAX tool's labels, extra keys, keys that are null on the CPU)
    "probe_grid_overhead": (
        small_probe, jax_labels("probe_grid_overhead.py", "make", 2), {"us_per_block"}, set()),
    "profile_nets": (
        lambda mp: profile_nets.run("cpu", iters=1, n=2, net_cfg=narrow_cfg()),
        jax_labels("profile_nets.py"), {"GMAC per forward", "FULL refiner TFLOP/s"}, set()),
    "bench_stem": (
        lambda mp: bench_stem.run("cpu", iters=1, n=2, net_cfg=narrow_cfg())["ms"],
        jax_labels("bench_stem.py"), {"as served"}, set()),
    "bench_attn": (
        lambda mp: bench_attn.run("cpu", iters=1, n=2, net_cfg=narrow_cfg()),
        jax_labels("bench_attn.py", scope="main"),
        {"sum-output rel diff (b vs a)", "max abs diff (b vs a)"}, set()),
    "bench_attn --encode-ab": (
        lambda mp: bench_attn.run_encode_ab("cpu", iters=1, n=2, net_cfg=narrow_cfg()),
        jax_labels("bench_attn.py", scope="bench_encode_ab"),
        {"sum-diff (f32 inputs)", "max abs diff (f32 inputs)"}, set()),
    "profile_register": (
        small_register, jax_labels("profile_register.py"),
        {"render kernel alone (K2)", "FULL register kernel ms", "FULL register busy share"},
        {"fused prepass+phase1", "fused prepass only", "FULL register kernel ms",
         "FULL register busy share"}),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu_with_the_jax_tools_labels(name, monkeypatch):
    run, labels, extra, nullable = TOOLS[name]
    out = run(monkeypatch)
    assert len(labels) >= 2
    keys = set(out) - extra
    for pattern in labels:
        assert any(pattern.fullmatch(k) for k in keys), (pattern.pattern, sorted(keys))
    for key in keys:
        assert any(p.fullmatch(key) for p in labels), key
    assert extra <= set(out)
    for key, value in out.items():
        if key in nullable:
            assert value is None, key
            continue
        if isinstance(value, dict):  # the probe's shapes
            assert value["ms"] > 0 and math.isfinite(value["ms"]), key
            continue
        assert math.isfinite(value), key
        if "diff" not in key and key != "us_per_block":
            assert value > 0, key


@pytest.mark.parametrize("tool", [probe_grid_overhead, profile_nets, bench_stem, bench_attn,
                                  profile_register])
def test_tool_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--iters", "1"])
