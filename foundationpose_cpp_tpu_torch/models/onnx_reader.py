"""Minimal pure-Python ONNX (protobuf) reader: initializers + graph nodes.

The reference pipeline ingests the published FoundationPose refiner/scorer
as ONNX files (reference tools/cvt_onnx2trt.bash:3-15, README.md:72). This
environment has no `onnx` package, so models/convert.py needs a way to read
the weight tensors (and, for constant-folded exports, the op graph that
names them) out of a .onnx file directly. ONNX models are protobuf
messages with a stable, frozen wire format; this module hand-decodes the
subset the converter needs:

    ModelProto.graph                        (field 7)
      GraphProto.node[]                     (field 1)  -> OnnxNode
      GraphProto.initializer[]              (field 5)  -> numpy arrays
      GraphProto.input[]/output[]           (11 / 12)  -> names
      NodeProto.input[]/output[]/op_type    (1 / 2 / 4)
      TensorProto dims/data_type/raw_data/..(1 / 2 / 9 / 4 / 7)

No dependency beyond numpy; unknown fields are skipped per protobuf rules,
so files written by any exporter parse as long as they are valid protobuf.

The port's own copy of ``foundationpose_cpp_tpu.models.onnx_reader``, the
wire parsing unchanged, so that ingest needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# TensorProto.DataType -> numpy dtype (little-endian raw_data layout)
_DTYPES = {
    1: np.dtype("<f4"),  # FLOAT
    2: np.dtype("u1"),  # UINT8
    3: np.dtype("i1"),  # INT8
    4: np.dtype("<u2"),  # UINT16
    5: np.dtype("<i2"),  # INT16
    6: np.dtype("<i4"),  # INT32
    7: np.dtype("<i8"),  # INT64
    9: np.dtype("?"),  # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    12: np.dtype("<u4"),  # UINT32
    13: np.dtype("<u8"),  # UINT64
}


class OnnxParseError(RuntimeError):
    pass


def _varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise OnnxParseError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise OnnxParseError("varint too long")


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) triples of one message.

    wire type 0 -> int, 1 -> 8 raw bytes, 5 -> 4 raw bytes,
    2 -> bytes (length-delimited: submessage / string / packed repeated).
    """
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _varint(data, pos)
        elif wt == 2:
            ln, pos = _varint(data, pos)
            if pos + ln > n:
                raise OnnxParseError(f"truncated field {field}")
            val = data[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = data[pos : pos + 4]
            pos += 4
        elif wt == 1:
            val = data[pos : pos + 8]
            pos += 8
        else:  # groups (3/4) never occur in onnx.proto
            raise OnnxParseError(f"unsupported wire type {wt}")
        yield field, wt, val


def _signed64(v: int) -> int:
    """Two's-complement re-interpretation of a raw uint64 varint.

    Negative int64/int32 protobuf values arrive as 10-byte varints whose
    unsigned value is v + 2**64 (e.g. -1 -> 2**64 - 1); without this,
    shape constants like [-1, 512] overflow np.int64 construction."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_int64(val: bytes, wt: int) -> list[int]:
    """Repeated int64 field: packed (wt 2) or a single varint (wt 0)."""
    if wt == 0:
        return [_signed64(val)]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _varint(val, pos)
        out.append(_signed64(v))
    return out


@dataclasses.dataclass
class OnnxTensor:
    name: str
    array: np.ndarray


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, object]


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]  # graph inputs EXCLUDING initializers
    outputs: list[str]


def _parse_tensor(data: bytes) -> OnnxTensor:
    dims: list[int] = []
    data_type = 1
    raw = None
    name = ""
    f32s: list[bytes] = []
    i64s: list[int] = []
    i32s: list[int] = []
    f64s: list[bytes] = []
    for field, wt, val in _fields(data):
        if field == 1:
            dims.extend(_packed_int64(val, wt))
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data (packed f32; torch never unpacks it)
            f32s.append(val)
        elif field == 5:  # int32_data
            i32s.extend(_packed_int64(val, wt))
        elif field == 7:  # int64_data
            i64s.extend(_packed_int64(val, wt))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 10:  # double_data
            f64s.append(val)
        elif field == 13:
            raise OnnxParseError(
                f"initializer '{name}': external data is not supported "
                "by the minimal reader"
            )
    if data_type not in _DTYPES:
        raise OnnxParseError(f"initializer '{name}': data_type {data_type}")
    dt = _DTYPES[data_type]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt)
    elif f32s:
        arr = np.frombuffer(b"".join(f32s), dtype="<f4")
    elif f64s:
        arr = np.frombuffer(b"".join(f64s), dtype="<f8")
    elif i64s:
        # _packed_int64 already re-interpreted negative two's-complement
        # varints, so shape constants like [-1, 512] construct cleanly
        arr = np.asarray(i64s, dtype=np.int64)
    elif i32s:
        arr = np.asarray(i32s, dtype=np.int64).astype(np.int32)
    else:
        arr = np.zeros((0,), dtype=dt)
    n_expect = int(np.prod(dims)) if dims else arr.size
    if arr.size != n_expect:
        raise OnnxParseError(
            f"initializer '{name}': {arr.size} elements for dims {dims}"
        )
    return OnnxTensor(name, arr.reshape(dims))


def _parse_attr(data: bytes) -> tuple[str, object]:
    name = ""
    value: object = None
    ints: list[int] = []
    for field, wt, val in _fields(data):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:  # f (fixed32)
            value = float(np.frombuffer(val, "<f4")[0])
        elif field == 3:  # i (signed: axis=-1 etc. arrive as 10-byte varints)
            value = _signed64(val)
        elif field == 4:  # s
            value = val.decode("utf-8", errors="replace")
        elif field == 5:  # t (TensorProto)
            value = _parse_tensor(val).array
        elif field == 7:  # floats
            value = np.frombuffer(val, "<f4").tolist() if wt == 2 else val
        elif field == 8:  # ints
            ints.extend(_packed_int64(val, wt))
    if ints:
        value = ints
    return name, value


def _parse_node(data: bytes) -> OnnxNode:
    inputs: list[str] = []
    outputs: list[str] = []
    name = ""
    op_type = ""
    attrs: dict[str, object] = {}
    for field, wt, val in _fields(data):
        if field == 1:
            inputs.append(val.decode("utf-8"))
        elif field == 2:
            outputs.append(val.decode("utf-8"))
        elif field == 3:
            name = val.decode("utf-8")
        elif field == 4:
            op_type = val.decode("utf-8")
        elif field == 5:
            k, v = _parse_attr(val)
            attrs[k] = v
    return OnnxNode(op_type, name, inputs, outputs, attrs)


def _value_info_name(data: bytes) -> str:
    for field, wt, val in _fields(data):
        if field == 1:
            return val.decode("utf-8")
    return ""


def _parse_graph(data: bytes) -> OnnxGraph:
    nodes: list[OnnxNode] = []
    inits: dict[str, np.ndarray] = {}
    g_in: list[str] = []
    g_out: list[str] = []
    for field, wt, val in _fields(data):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 5:
            t = _parse_tensor(val)
            inits[t.name] = t.array
        elif field == 11:
            g_in.append(_value_info_name(val))
        elif field == 12:
            g_out.append(_value_info_name(val))
    g_in = [n for n in g_in if n not in inits]
    return OnnxGraph(nodes, inits, g_in, g_out)


def parse_model(path_or_bytes: str | bytes) -> OnnxGraph:
    """Parse a .onnx file (or its bytes) into an OnnxGraph."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    graph = None
    try:
        for field, wt, val in _fields(data):
            if field == 7:  # ModelProto.graph
                graph = _parse_graph(val)
    except OnnxParseError:
        raise
    except Exception as e:  # corrupted / not protobuf
        raise OnnxParseError(f"not a parseable ONNX file: {e}") from e
    if graph is None:
        raise OnnxParseError("no GraphProto found (not an ONNX ModelProto?)")
    return graph
