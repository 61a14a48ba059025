"""The port's bench on the CPU at crop 32, against the keys of the JAX package's bench.py.

``foundationpose_cpp_tpu_torch.bench`` must print the JSON line that
``bench.py`` prints: the same keys at every level where ``bench.py`` writes a
dict literal (read from its source with ``ast``; importing it would start
JAX's backend), plus the two the port adds (``details.card``; the pinned
upload beside the pageable one in ``h2d``, which ``chip_smoke.py`` checks
on the card, where the block is filled). The ``sharded`` block has the
keys of the line that the JAX package's ``tools/bench_sharded.py`` prints
(read with ``ast`` too), which the port's tool of that name prints. On the
CPU every number it measures must be finite, and the blocks that only the
card measures are null. The run uses narrow nets, a 1 iteration loop, an 80-face sphere in
place of the 6016-face one and a small scan, so that the plain render's 252
views take seconds. ``count_params`` and ``flops_per_pair`` equal the JAX
package's on the committed weights and configurations.
"""

import ast
import math
import pathlib

import jax.numpy as jnp
import pytest

from foundationpose_cpp_tpu.models import checkpoint
from foundationpose_cpp_tpu.models import networks as jnet
from foundationpose_cpp_tpu_torch import bench
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.models import convert_jax, networks

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_ONLY = {("details", "card"), ("details", "h2d", "pinned_ms_per_frame"),
             ("details", "h2d", "pinned_gib_per_s")}
CARD_ONLY = {("details", "h2d"), ("details", "hbm_peak_gb"), ("details", "memory"),
             ("details", "card"), ("details", "track_fps_pipelined_projected")}
NULL = {("details", "stage_ms", "render_252_corner")}
# dicts whose keys depend on the run: the memory block, the collectives by name
OPAQUE = {("details", "memory"), ("details", "sharded", "collectives_fused")}


def bench_py_keys() -> set[tuple[str, ...]]:
    """Key paths of the dict literal bench.py prints, with those of the
    sharded block from the line tools/bench_sharded.py prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    (result,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "result" for t in n.targets)]
    paths = set()

    def walk(node, prefix):
        for key, value in zip(node.keys, node.values):
            paths.add(prefix + (key.value,))
            if isinstance(value, ast.Dict):
                walk(value, prefix + (key.value,))

    walk(result, ())
    tool = ast.parse((ROOT / "tools" / "bench_sharded.py").read_text())
    (line,) = [n.args[0] for n in ast.walk(tool) if isinstance(n, ast.Call)
               and getattr(n.func, "attr", None) == "dumps" and isinstance(n.args[0], ast.Dict)]
    return paths | {("details", "sharded", key.value) for key in line.keys}


def key_paths(d: dict, prefix=()) -> set[tuple[str, ...]]:
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict) and prefix + (k,) not in OPAQUE:
            out |= key_paths(v, prefix + (k,))
    return out


@pytest.fixture(scope="module")
def result():
    sphere = tproc.textured_uv_sphere
    mp = pytest.MonkeyPatch()
    mp.setattr(bench.procedural, "textured_uv_sphere",
               lambda **kw: sphere(radius=0.05, n_lat=6, n_lon=8))
    try:
        net = networks.NetConfig(width1=8, width2=16, embed_dim=64, num_heads=4, ffn_dim=64,
                                 crop_hw=32)
        scan = dict(blob=dict(seed=3, n_lat=12, n_lon=12, tex_size=32), target_faces=150,
                    max_faces=512, patch_k=4)
        return bench.run("cpu", (120, 160), 32, {k: 1 for k in bench.ITERS}, net, scan)
    finally:
        mp.undo()


def test_bench_keys_equal_bench_py(result):
    """Every key path of bench.py's line, down to the blocks only the card
    fills (h2d, memory), which are null here."""
    want = {p for p in bench_py_keys()
            if not (len(p) > 2 and p[:2] in (("details", "h2d"), ("details", "memory")))}
    assert key_paths(result) - PORT_ONLY == want


def test_bench_values_finite_on_the_cpu(result):
    d = result["details"]
    for path in CARD_ONLY | NULL:
        node = result
        for k in path:
            node = node[k]
        assert node is None, path
    assert d["platform"] == "cpu" and d["hypotheses"] == 252 and d["image"] == [120, 160]
    numbers = [result["value"], result["vs_baseline"]] + [
        v for k, v in d.items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    numbers += [v for v in d["stage_ms"].values() if v is not None]
    numbers += list(d["scan"].values())
    assert all(math.isfinite(v) and v > 0 for v in numbers), numbers
    scan = d["scan"]
    assert scan["faces_raw"] == tproc.scanned_blob(seed=3, n_lat=12, n_lon=12,
                                                   tex_size=32).num_faces
    assert scan["faces_decimated"] <= 150 <= scan["faces_raw"]
    assert result["vs_baseline"] == result["value"] / 2.8
    assert d["track_vs_baseline"] == d["track_fps"] / 220.0
    sharded = d["sharded"]
    assert "error" not in sharded, sharded
    assert sharded["n_devices"] == 8 and sharded["platform"] == "cpu"
    assert sharded["collectives_fused"] == {"all_gather": 2}
    times = [sharded[k] for k in ("register_ms_single", "register_ms_sharded", "speedup")]
    assert all(math.isfinite(v) and v > 0 for v in times), sharded


def test_bench_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_count_params_equals_jax_on_the_committed_weights(kind):
    path = str(ROOT / "weights" / f"{kind}_multi_full.npz")
    net = convert_jax.build_net(convert_jax.load_npz(path), kind)
    assert networks.count_params(net) == jnet.count_params(checkpoint.load_params(path))


@pytest.mark.parametrize("cfg", [
    {},
    dict(width1=8, width2=16, embed_dim=64, num_heads=4, crop_hw=32),
    dict(width1=32, width2=64, embed_dim=256, ffn_dim=256, num_encoder_layers=2),
])
def test_flops_per_pair_equals_jax(cfg):
    got = networks.flops_per_pair(networks.NetConfig(**cfg))
    assert got == jnet.flops_per_pair(jnet.NetConfig(**cfg, dtype=jnp.float32))
