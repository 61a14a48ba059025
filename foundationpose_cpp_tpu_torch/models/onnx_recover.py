"""Recover a named torch state dict from a FoundationPose ONNX graph.

Real ``torch.onnx.export`` outputs of the published refiner/scorer nets
(reference README.md:72, converted by tools/cvt_onnx2trt.bash) do NOT carry
a clean parameter->initializer mapping:

  * constant folding (the export default) bakes BatchNorm into conv
    weights and renames them positionally (``onnx::Conv_514``), and
    transposes linear weights into anonymous MatMul operands
    (``onnx::MatMul_553``);
  * tensors the exporter chose to inline (BN running stats, whole encoder
    layers) live in ``Constant`` nodes or behind ``Identity`` chains, not
    in ``graph.initializer`` at all.

models/convert.py is deliberately strict-by-name, so this module bridges
the gap by GRAPH TRAVERSAL: it walks the ops in topological order and
assigns canonical torch names from the known forward structure of
``RefineNet`` / ``ScoreNetMultiPair`` (models/torch_ref.py, mirroring
NVlabs learning/models/*):

  * the 9-conv trunk in execution order (encodeA.0/1/2, encodeAB.0/1/2),
    with any following BatchNormalization claiming that conv's bn name;
  * the sinusoidal table: a 3-D float constant consumed by Add/Slice;
  * transformer layers: LayerNormalization number j is norm{j%2+1} of
    layer j//2, and those LN anchors also place the constant-operand
    MatMul/Gemm stream -- a parameterized matmul encountered while
    ln_idx//2 == g belongs to layer g (in_proj fires before the group's
    first LN, out_proj/linear1/linear2 between them), where it claims
    the first still-unassigned parameter of the group whose expected
    shape matches (in_proj (3D, D) -> out_proj (D, D) -> linear1 (*, D)
    -> linear2 (D, *)); QK^T and attn@V have no constant operand and are
    skipped. Layer groups that begin after the token-mean ReduceMean are
    the scorer's ``att_cross`` block;
  * (1|3)-row matmuls after the ReduceMean are the heads, in output
    order (trans, rot / scores).

Already-named tensors keep their names (a name-preserving export passes
through unchanged); recovered names never overwrite them. MatMul operands
are transposed back to torch (out, in) layout; Gemm honors transB. The
result feeds convert.convert_state_dict, whose strict shape/structure
checks reject any wrong guess loudly.

LayerNorm anchors are recognized in BOTH exporter forms: fused
``LayerNormalization`` nodes (opset >= 17) and the decomposed
ReduceMean/Sub/Pow/ReduceMean/Add/Sqrt/Div/Mul/Add chain that every
opset <= 16 export carries (the published-export era: torch 1.x/2.0 at
opset 11-14 -- reference tools/cvt_onnx2trt.bash). Decomposed-LN
ReduceMeans are excluded from the token-mean-pool detection that
separates the encoder stack from the scorer's att_cross block.

The port's own copy of ``foundationpose_cpp_tpu.models.onnx_recover`` over
the port's ``onnx_reader``; the names it gives are those of
``models/convert.py``'s input, the published state-dict names.
"""

from __future__ import annotations

import re

import numpy as np

from foundationpose_cpp_tpu_torch.models.onnx_reader import OnnxGraph, OnnxNode

_ANON = re.compile(r"^(onnx::|/)|^\d+$")

# trunk convs in _Backbone.embed execution order (torch_ref.py:103-142);
# value = the BN module that follows each conv in the unfolded graph
_CONV_CHAIN = [
    ("encodeA.0.0", "encodeA.0.1"),
    ("encodeA.1.0", "encodeA.1.1"),
    ("encodeA.2.conv1", "encodeA.2.bn1"),
    ("encodeA.2.conv2", "encodeA.2.bn2"),
    ("encodeAB.0.conv1", "encodeAB.0.bn1"),
    ("encodeAB.0.conv2", "encodeAB.0.bn2"),
    ("encodeAB.1.0", "encodeAB.1.1"),
    ("encodeAB.2.conv1", "encodeAB.2.bn1"),
    ("encodeAB.2.conv2", "encodeAB.2.bn2"),
]

class RecoveryError(RuntimeError):
    pass


def _is_named(name: str) -> bool:
    return bool(name) and not _ANON.match(name)


class _Graph:
    """Constant resolution + simple dataflow queries over an OnnxGraph."""

    def __init__(self, g: OnnxGraph):
        self.g = g
        self.producer: dict[str, OnnxNode] = {}
        for node in g.nodes:
            for o in node.outputs:
                self.producer[o] = node
        self.consumers: dict[str, list[OnnxNode]] = {}
        for node in g.nodes:
            for i in node.inputs:
                self.consumers.setdefault(i, []).append(node)

    def const(self, name: str) -> tuple[np.ndarray, str] | None:
        """Resolve `name` to (array, source_name) through Identity/Constant
        chains; source_name is the initializer's own name ('' for inlined
        Constants)."""
        seen = 0
        while True:
            if name in self.g.initializers:
                return self.g.initializers[name], name
            node = self.producer.get(name)
            if node is None:
                return None
            if node.op_type == "Constant":
                val = node.attrs.get("value")
                if isinstance(val, np.ndarray):
                    return val, ""
                return None
            if node.op_type in ("Identity", "Cast"):
                name = node.inputs[0]
                seen += 1
                if seen > 32:
                    return None
                continue
            if node.op_type == "Transpose":
                inner = self.const(node.inputs[0])
                if inner is None:
                    return None
                arr = inner[0]
                perm = node.attrs.get(
                    "perm", list(range(arr.ndim))[::-1]
                )
                # the value is layout-rewritten, so the source name no
                # longer describes it -- consumers restore torch layout
                # from THEIR orientation and use the structural name
                return np.transpose(arr, perm), ""
            return None

    def bias_of(self, out_name: str) -> tuple[np.ndarray, str] | None:
        """If `out_name`'s sole consumer is Add with a constant operand,
        return that constant (a MatMul-pattern linear bias)."""
        cons = self.consumers.get(out_name, [])
        if len(cons) != 1 or cons[0].op_type != "Add":
            return None
        add = cons[0]
        for i in add.inputs:
            if i == out_name:
                continue
            c = self.const(i)
            if c is not None and c[0].ndim == 1:
                return c
        return None


def _find_decomposed_ln(
    G: "_Graph", graph: OnnxGraph
) -> tuple[dict[int, tuple], set[int]]:
    """Locate opset<=16 decomposed LayerNorm chains.

    torch decomposes ``F.layer_norm`` below opset 17 into

        m  = ReduceMean(x)            s  = Sub(x, m)
        v  = ReduceMean(Pow(s, 2))    sd = Sqrt(Add(v, eps))
        y  = Add(Mul(Div(s, sd), scale), bias)

    (older exporters sometimes square via ``Mul(s, s)``). Returns

      * ``finishers``: id(Div node) -> ((scale, src), (bias, src)) --
        the Div is the anchor; it sits at the same topological position
        as a fused LayerNormalization node would;
      * ``internal_rm``: ids of the two ReduceMeans inside each chain,
        so the token-mean-pool detector ignores them.
    """
    finishers: dict[int, tuple] = {}
    internal_rm: set[int] = set()
    for node in graph.nodes:
        if node.op_type != "Div" or len(node.inputs) != 2:
            continue
        sub = G.producer.get(node.inputs[0])
        sqrt = G.producer.get(node.inputs[1])
        if (
            sub is None or sqrt is None
            or sub.op_type != "Sub" or sqrt.op_type != "Sqrt"
        ):
            continue
        rm1 = G.producer.get(sub.inputs[1])
        if (
            rm1 is None or rm1.op_type != "ReduceMean"
            or rm1.inputs[0] != sub.inputs[0]
        ):
            continue
        addeps = G.producer.get(sqrt.inputs[0])
        if addeps is None or addeps.op_type != "Add":
            continue
        rm2 = next(
            (p for i in addeps.inputs
             if (p := G.producer.get(i)) is not None
             and p.op_type == "ReduceMean"),
            None,
        )
        if rm2 is None:
            continue
        sq = G.producer.get(rm2.inputs[0])
        if sq is None:
            continue
        if sq.op_type == "Pow":
            squared = sq.inputs[0]
        elif sq.op_type == "Mul" and sq.inputs[0] == sq.inputs[1]:
            squared = sq.inputs[0]
        else:
            continue
        if squared != node.inputs[0]:  # must square the same (x - mean)
            continue
        # affine tail: Mul(div, scale) -> Add(mul, bias), both 1-D consts
        cons = G.consumers.get(node.outputs[0], [])
        if len(cons) != 1 or cons[0].op_type != "Mul":
            continue
        mul = cons[0]
        scale = next(
            (c for i in mul.inputs if i != node.outputs[0]
             and (c := G.const(i)) is not None and c[0].ndim == 1),
            None,
        )
        bias = G.bias_of(mul.outputs[0])
        if scale is None or bias is None:
            continue
        finishers[id(node)] = (scale, bias)
        internal_rm.add(id(rm1))
        internal_rm.add(id(rm2))
    return finishers, internal_rm


def named_float_initializers(graph: OnnxGraph) -> dict[str, np.ndarray]:
    """The properly-named float tensors of a (partially) name-preserving
    export. Callers use this as the fallback when structural recovery
    rejects the graph shape: a fully-named export needs no traversal at
    all, and convert_state_dict's strict name/shape checks still reject
    incomplete sets loudly."""
    return {
        n: a for n, a in graph.initializers.items()
        if _is_named(n) and np.issubdtype(a.dtype, np.floating)
    }


def recover_state_dict(graph: OnnxGraph) -> dict[str, np.ndarray]:
    """Named torch-layout state dict from an ONNX graph (see module doc)."""
    G = _Graph(graph)
    out: dict[str, np.ndarray] = {}

    def put(name: str, arr: np.ndarray, src: str) -> None:
        # a name-preserving export wins over the structural guess
        key = src if _is_named(src) else name
        if key in out and not np.array_equal(out[key], arr):
            raise RecoveryError(
                f"two different tensors recovered for '{key}'"
            )
        out[key] = np.asarray(arr)

    # a name-preserving export: merge every properly-named float
    # initializer wholesale (traversal then only fills the gaps, e.g.
    # tensors the exporter inlined as Constants)
    for name, arr in graph.initializers.items():
        if _is_named(name) and np.issubdtype(arr.dtype, np.floating):
            out[name] = arr

    ln_finishers, ln_internal_rm = _find_decomposed_ln(G, graph)

    conv_idx = -1
    reduce_mean_seen = False
    ln_idx = 0  # LayerNormalization counter; ln_idx//2 = current layer group
    group_base: dict[int, str] = {}  # layer group -> name base
    # group -> ordered [(param, bias, shape_pred)] still unassigned
    group_remaining: dict[int, list] = {}
    n_conv = len(_CONV_CHAIN)
    heads: list[tuple[np.ndarray, tuple | None, str]] = []
    embed_dim: int | None = None

    def base_for(group: int) -> str:
        if group not in group_base:
            group_base[group] = (
                "att_cross" if reduce_mean_seen
                else f"encoder.layers.{group}"
            )
        return group_base[group]

    def remaining_for(group: int) -> list:
        if group not in group_remaining:
            d = embed_dim
            group_remaining[group] = [
                ("self_attn.in_proj_weight", "self_attn.in_proj_bias",
                 lambda s: s == (3 * d, d)),
                ("self_attn.out_proj.weight", "self_attn.out_proj.bias",
                 lambda s: s == (d, d)),
                ("linear1.weight", "linear1.bias",
                 lambda s: s[1] == d),
                ("linear2.weight", "linear2.bias",
                 lambda s: s[0] == d),
            ]
        return group_remaining[group]

    for node in graph.nodes:
        op = node.op_type
        if op == "Conv":
            conv_idx += 1
            if conv_idx >= n_conv:
                raise RecoveryError(
                    f"more than {n_conv} Conv nodes -- not the published "
                    "trunk; cannot assign names structurally"
                )
            base = _CONV_CHAIN[conv_idx][0]
            w = G.const(node.inputs[1])
            if w is None:
                raise RecoveryError(f"{base}: conv weight is not constant")
            put(f"{base}.weight", w[0], w[1])
            if len(node.inputs) > 2:
                b = G.const(node.inputs[2])
                if b is not None:
                    put(f"{base}.bias", b[0], b[1])
        elif op == "BatchNormalization":
            if conv_idx < 0:
                raise RecoveryError("BatchNormalization before any Conv")
            bn = _CONV_CHAIN[conv_idx][1]
            for slot, field in zip(
                node.inputs[1:5],
                ("weight", "bias", "running_mean", "running_var"),
            ):
                c = G.const(slot)
                if c is None:
                    raise RecoveryError(f"{bn}.{field}: not constant")
                put(f"{bn}.{field}", c[0], c[1])
        elif op == "ReduceMean":
            # the token mean-pool ends the encoder stack; layer groups
            # starting after it belong to the scorer's att_cross block.
            # ReduceMeans inside decomposed-LN chains are excluded above.
            if id(node) not in ln_internal_rm:
                reduce_mean_seen = True
        elif op == "LayerNormalization":
            base = base_for(ln_idx // 2)
            norm = f"norm{ln_idx % 2 + 1}"
            ln_idx += 1
            s = G.const(node.inputs[1])
            b = G.const(node.inputs[2]) if len(node.inputs) > 2 else None
            if s is None or b is None:
                raise RecoveryError(f"{base}.{norm}: params not constant")
            put(f"{base}.{norm}.weight", s[0], s[1])
            put(f"{base}.{norm}.bias", b[0], b[1])
        elif id(node) in ln_finishers:
            # decomposed LayerNorm (opset <= 16); the Div anchors exactly
            # where a fused LayerNormalization node would sit
            base = base_for(ln_idx // 2)
            norm = f"norm{ln_idx % 2 + 1}"
            ln_idx += 1
            (s, s_src), (b, b_src) = ln_finishers[id(node)]
            put(f"{base}.{norm}.weight", s, s_src)
            put(f"{base}.{norm}.bias", b, b_src)
        elif op in ("MatMul", "Gemm"):
            wb = G.const(node.inputs[1]) if len(node.inputs) > 1 else None
            if wb is None:
                continue  # activation x activation (QK^T / attn@V)
            w, src = wb
            if w.ndim != 2:
                continue
            if embed_dim is None:
                # trunk must precede the transformer; embed_dim = out
                # channels of the encodeAB.1 conv (torch_ref.py:116-120)
                key = f"{_CONV_CHAIN[6][0]}.weight"
                if key not in out:
                    raise RecoveryError(
                        "constant matmul before the trunk completed"
                    )
                embed_dim = int(out[key].shape[0])
            if op == "MatMul":
                w_t = np.ascontiguousarray(w.T)  # (in, out) -> torch (out, in)
                bias = G.bias_of(node.outputs[0])
            else:  # Gemm: attrs transB; C operand is the bias
                w_t = (
                    w if node.attrs.get("transB", 0)
                    else np.ascontiguousarray(w.T)
                )
                bias = (
                    G.const(node.inputs[2])
                    if len(node.inputs) > 2 else None
                )
            if w_t.shape[0] in (1, 3) and reduce_mean_seen:
                heads.append((w_t, bias, src))
                continue
            group = ln_idx // 2
            base = base_for(group)
            rem = remaining_for(group)
            hit = next(
                (i for i, (_, _, pred) in enumerate(rem)
                 if pred(w_t.shape)), None,
            )
            if hit is None:
                raise RecoveryError(
                    f"{base}: no unassigned parameter matches a "
                    f"{w_t.shape} constant matmul operand"
                )
            pname, bname, _ = rem.pop(hit)
            put(f"{base}.{pname}", w_t, src)
            if bias is not None:
                put(f"{base}.{bname}", bias[0], bias[1])

    if conv_idx + 1 != n_conv:
        raise RecoveryError(
            f"found {conv_idx + 1} Conv nodes, expected {n_conv}"
        )

    # ---- pos_embed: 3-D float constant consumed by Add/Slice -------------
    if "pos_embed.pe" not in out:
        for node in graph.nodes:
            if node.op_type not in ("Add", "Slice"):
                continue
            for i in node.inputs[:2]:
                c = G.const(i)
                if c is not None and c[0].ndim == 3 and c[0].shape[0] == 1 \
                        and np.issubdtype(c[0].dtype, np.floating):
                    put("pos_embed.pe", c[0], c[1])
                    break
            if "pos_embed.pe" in out:
                break

    # ---- heads: output order trans, rot (refiner) / scores (scorer) ------
    for (w, bias, src), hname in zip(heads, _head_names(heads)):
        put(f"{hname}.0.weight", w, src)
        if bias is not None:
            if hname == "?" and not _is_named(bias[1]):
                # '?' is the names-pass-through path (every head WEIGHT
                # source is named, so the structural head name is unknown);
                # an anonymous bias here has no recoverable key -- storing
                # it under the junk '?.0.bias' would fail strict checks
                # downstream with a misleading message.
                raise RecoveryError(
                    f"head weight '{src}' is named but its bias constant "
                    "is anonymous; cannot infer the bias parameter name"
                )
            bsrc = bias[1] if _is_named(bias[1]) else ""
            put(f"{hname}.0.bias", bias[0], bsrc)
    return out


def _head_names(heads) -> list[str]:
    """trans/rot for a 2-head 3-dim net, score for a 1-head 1-dim net."""
    dims = [w.shape[0] for w, _, _ in heads]
    if dims == [3, 3]:
        return ["trans_head", "rot_head"]
    if dims == [1]:
        return ["score_head"]
    if all(_is_named(s) for _, _, s in heads):
        return ["?"] * len(heads)  # names pass through `src` anyway
    raise RecoveryError(f"unrecognized head output dims {dims}")
