"""The port's named-blob inference cores against the JAX package's.

``create_refiner_core`` / ``create_scorer_core`` wrap a net as an engine
with named blobs and batch buckets: a batch is zero-padded up to the nearest
bucket and the outputs are sliced back (tests/test_models.py:71-88). The
scorer's att_cross layer attends across the whole padded batch, so its
scores depend on the zero rows -- in the JAX package as in the port, which
keeps that behaviour. Small f32 nets as in tests/test_torch_pipeline.py.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_cpp_tpu import networks as jnet
from foundationpose_cpp_tpu.models import infer_core as jcore
from foundationpose_cpp_tpu_torch import create_refiner_core, create_scorer_core
from foundationpose_cpp_tpu_torch.models import convert_jax, networks

NET = jnet.NetConfig(
    width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32,
    dtype=jnp.float32, attn_impl="xla",
)
NET_S = dataclasses.replace(NET, cross_attention=True)
TOL = 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(size=(n, 32, 32, 6)).astype(np.float32) for _ in range(2))


def _cores(kind, buckets):
    """(JAX core, port core) holding the same seeded f32 weights."""
    if kind == "refiner":
        params = jnet.init_refiner(0, NET)
        j = jcore.create_refiner_core(params, cfg=NET)
        make = create_refiner_core
    else:
        params = jnet.init_scorer(1, NET_S)
        j = jcore.create_scorer_core(params, cfg=NET_S)
        make = create_scorer_core
    sd = convert_jax.params_from_jax(jax.tree.map(np.asarray, params))
    t = make(sd, device="cpu", dtype=torch.float32)
    j.buckets = t.buckets = buckets
    return j, t


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
@pytest.mark.parametrize("n,buckets", [(3, (2, 4)), (4, (2, 4)), (5, (2, 4)), (1, (1, 8))])
def test_core_matches_jax(kind, n, buckets):
    j, t = _cores(kind, buckets)
    a, b = _inputs(n, seed=n)
    want = j.infer({"render_input": jnp.asarray(a), "transf_input": jnp.asarray(b)})
    got = t.infer({"render_input": torch.from_numpy(a), "transf_input": b})
    assert t.input_names() == j.input_names() == ("render_input", "transf_input")
    assert t.output_names() == j.output_names()
    assert set(got) == set(want) == set(t.output_names())
    for name in got:
        assert got[name].shape == (n, want[name].shape[1]) and got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_missing_blob_raises(kind):
    _, t = _cores(kind, (2, 4))
    a, _ = _inputs(1, seed=0)
    with pytest.raises(KeyError, match="transf_input"):
        t.infer({"render_input": a})


def test_scorer_scores_depend_on_padding_rows():
    """n=3 in bucket 4: the scorer core equals the net on the zero-padded
    batch, not on the three rows alone, and the JAX core does the same; the
    refiner has no cross-row layer, so its core equals the net on the rows."""
    j, t = _cores("scorer", (4,))
    a, b = _inputs(3, seed=7)
    got = t.infer({"render_input": a, "transf_input": b})["scores"].numpy()
    pad = ((0, 1), (0, 0), (0, 0), (0, 0))
    with torch.inference_mode():
        padded = t.net(torch.from_numpy(np.pad(a, pad)), torch.from_numpy(np.pad(b, pad)))
        alone = t.net(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got, padded["scores"][:3].numpy(), rtol=0, atol=1e-6)
    moved = np.abs(got - alone["scores"].numpy()).max()
    assert moved > 1e-3, f"padding rows moved the scores by only {moved}"
    j_alone = np.asarray(jnet.apply_scorer(j.params, jnp.asarray(a), jnp.asarray(b), NET_S)["scores"])
    j_core = np.asarray(j.infer({"render_input": jnp.asarray(a), "transf_input": jnp.asarray(b)})["scores"])
    np.testing.assert_allclose(np.abs(j_core - j_alone).max(), moved, rtol=1e-2)

    _, r = _cores("refiner", (4,))
    got = r.infer({"render_input": a, "transf_input": b})
    with torch.inference_mode():
        alone = r.net(torch.from_numpy(a), torch.from_numpy(b))
    for name in ("trans", "rot"):
        np.testing.assert_allclose(got[name].numpy(), alone[name].numpy(), rtol=1e-5, atol=1e-6)


def test_factories_build_seeded_or_load_weights(monkeypatch):
    """No net: the port's seeded ``init_net`` at the published widths; a path:
    the npz checkpoint; no device: the card, which raises without one."""
    core = create_scorer_core(device="cpu")
    want = networks.init_net("scorer", networks.NetConfig(), seed=1)
    assert isinstance(core.net, networks.ScoreNet) and core.net.att_cross is None
    assert core.buckets == (1, 8, 64, 252) and core.output_names() == ("scores",)
    for (name, p), q in zip(core.net.state_dict().items(), want.state_dict().values()):
        np.testing.assert_array_equal(p.float().numpy(), q.to(p.dtype).float().numpy(), err_msg=name)
    assert core.net.encodeA["conv0"].weight.dtype == torch.bfloat16

    core = create_refiner_core(str(ROOT / "weights" / "refiner_multi_full.npz"), device="cpu")
    assert isinstance(core.net, networks.RefineNet) and core.output_names() == ("trans", "rot")
    assert core.net.cfg.embed_dim == 512

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_refiner_core()
