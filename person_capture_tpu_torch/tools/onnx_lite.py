"""Minimal dependency-free ONNX reader/writer (protobuf wire format).

The conversion path for the reference's checkpoints (scrfd_*_bnkps.onnx,
w600k_r50.onnx — face_embedder.py:55-83) needs the graph *initializers*
(name → ndarray); the graph executor (tools/onnx_exec.py) additionally
needs the full graph: nodes with attributes, input/output value infos and
the opset version. The `onnx` package is not a dependency, so this module
parses the protobuf wire format directly:
ModelProto(7: GraphProto, 8: opset_import) → GraphProto(1: node,
5: initializer, 11: input, 12: output) → NodeProto{1: input, 2: output,
3: name, 4: op_type, 5: attribute} / TensorProto{1: dims, 2: data_type,
8: name, 9: raw_data, 4/5/6/7/10/11: typed repeated fields} /
AttributeProto{1: name, 2: f, 3: i, 4: s, 5: t, 7: floats, 8: ints,
9: strings}.

Unknown fields are skipped per the protobuf spec, so any valid ONNX file
parses. A writer for the same subset exists so tests can author ONNX
files without the `onnx` package.

Copied from ``person_capture_tpu/tools/onnx_lite.py`` (numpy only).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ONNX TensorProto.DataType → numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _s64(v: int) -> int:
    """Sign-extend a decoded varint to int64 (protobuf encodes negative
    int32/int64 as 10-byte two's-complement varints)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(buf: memoryview) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_s64(v))
    return out


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = b""
    floats: List[float] = []
    ints32: List[int] = []
    ints64: List[int] = []
    doubles: List[float] = []
    for field, wire, val in _fields(buf):
        if field == 1:   # dims (repeated int64; packed or not)
            if wire == 0:
                dims.append(int(val))
            else:
                dims.extend(_packed_varints(val))
        elif field == 2 and wire == 0:
            dtype_code = int(val)
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 4:   # float_data
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            elif wire == 2:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 5:   # int32_data
            if wire == 0:
                ints32.append(_s64(int(val)))
            elif wire == 2:
                ints32.extend(_packed_varints(val))
        elif field == 7:   # int64_data
            if wire == 0:
                ints64.append(_s64(int(val)))
            elif wire == 2:
                ints64.extend(_packed_varints(val))
        elif field == 10:  # double_data
            if wire == 1:
                doubles.append(struct.unpack("<d", val)[0])
            elif wire == 2:
                doubles.extend(np.frombuffer(bytes(val), "<f8").tolist())
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"unsupported tensor dtype {dtype_code} ({name})")
    shape = tuple(dims)
    if raw:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
    elif floats and dtype == np.float32:
        arr = np.asarray(floats, np.float32)
    elif doubles and dtype == np.float64:
        arr = np.asarray(doubles, np.float64)
    elif ints64 and dtype == np.int64:
        arr = np.asarray(ints64, np.int64)
    elif ints32:
        if dtype == np.float16:
            # TensorProto stores float16 in int32_data as raw uint16 bit
            # patterns (ONNX spec), not numeric values
            arr = np.asarray(ints32, np.uint16).view(np.float16)
        else:
            arr = np.asarray(ints32, np.int64).astype(dtype)
    else:
        arr = np.zeros(shape, dtype)
    # always reshape: scalar tensors (dims == ()) must come back 0-d
    return name, arr.reshape(shape)


def onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """name → ndarray for every graph initializer in an .onnx file."""
    with open(path, "rb") as fh:
        model = memoryview(fh.read())
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:           # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if name:
                        out[name] = arr
    return out


# ---------------------------------------------------------------------------
# Full-graph parsing (for tools/onnx_exec.py)
# ---------------------------------------------------------------------------


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Any] = dc_field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    # graph inputs that are NOT initializers, in declaration order
    input_names: List[str]
    input_shapes: Dict[str, Tuple[Optional[int], ...]]
    output_names: List[str]
    opset: int = 11


def _parse_attr(buf: memoryview) -> Tuple[str, Any]:
    """AttributeProto → (name, python value). The value type is inferred
    from which fields are populated (f/i/s/t/floats/ints/strings)."""
    name = ""
    f_val = None
    i_val = None
    s_val = None
    t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    has_i = False
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field == 2 and wire == 5:
            f_val = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:
            i_val = _s64(int(val))
            has_i = True
        elif field == 4 and wire == 2:
            s_val = bytes(val)
        elif field == 5 and wire == 2:
            _, t_val = _parse_tensor(val)
        elif field == 7:  # floats
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            elif wire == 2:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 8:  # ints
            if wire == 0:
                ints.append(_s64(int(val)))
            elif wire == 2:
                ints.extend(_packed_varints(val))
        elif field == 9 and wire == 2:
            strings.append(bytes(val))
    if t_val is not None:
        value: Any = t_val
    elif ints:
        value = ints
    elif floats:
        value = floats
    elif strings:
        value = strings
    elif s_val is not None:
        value = s_val
    elif f_val is not None:
        value = f_val
    elif has_i:
        value = i_val
    else:
        # empty repeated field (e.g. Squeeze with axes=[]) — default to []
        value = []
    return name, value


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif field == 2 and wire == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif field == 3 and wire == 2:
            node.name = bytes(val).decode("utf-8", errors="replace")
        elif field == 4 and wire == 2:
            node.op_type = bytes(val).decode("utf-8")
        elif field == 5 and wire == 2:
            aname, avalue = _parse_attr(val)
            node.attrs[aname] = avalue
    return node


def _parse_value_info(buf: memoryview) -> Tuple[str, Tuple[Optional[int], ...]]:
    """ValueInfoProto → (name, shape with None for symbolic dims)."""
    name = ""
    shape: List[Optional[int]] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field == 2 and wire == 2:          # TypeProto
            for tf, tw, tv in _fields(val):
                if tf == 1 and tw == 2:         # tensor_type
                    for ttf, ttw, ttv in _fields(tv):
                        if ttf == 2 and ttw == 2:   # TensorShapeProto
                            for sf, sw, sv in _fields(ttv):
                                if sf == 1 and sw == 2:  # Dimension
                                    dim: Optional[int] = None
                                    for df, dw, dv in _fields(sv):
                                        if df == 1 and dw == 0:
                                            dim = _s64(int(dv))
                                    shape.append(dim)
    return name, tuple(shape)


def parse_onnx(path: str) -> OnnxGraph:
    """Parse an .onnx file into nodes + initializers + graph IO."""
    with open(path, "rb") as fh:
        model = memoryview(fh.read())
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    in_names: List[str] = []
    in_shapes: Dict[str, Tuple[Optional[int], ...]] = {}
    out_names: List[str] = []
    opset = 11
    for field, wire, val in _fields(model):
        if field == 8 and wire == 2:            # opset_import
            domain, version = "", None
            for of, ow, ov in _fields(val):
                if of == 1 and ow == 2:
                    domain = bytes(ov).decode("utf-8", errors="replace")
                elif of == 2 and ow == 0:
                    version = int(ov)
            # "ai.onnx" is spec-equivalent to the default "" domain
            if domain in ("", "ai.onnx") and version is not None:
                opset = version
        elif field == 7 and wire == 2:          # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 1 and gwire == 2:      # node
                    nodes.append(_parse_node(gval))
                elif gfield == 5 and gwire == 2:    # initializer
                    name, arr = _parse_tensor(gval)
                    if name:
                        inits[name] = arr
                elif gfield == 11 and gwire == 2:   # input
                    name, shape = _parse_value_info(gval)
                    in_names.append(name)
                    in_shapes[name] = shape
                elif gfield == 12 and gwire == 2:   # output
                    name, _ = _parse_value_info(gval)
                    out_names.append(name)
    # graph inputs that are initializers are weights, not runtime inputs
    runtime_inputs = [n for n in in_names if n not in inits]
    return OnnxGraph(nodes=nodes, initializers=inits,
                     input_names=runtime_inputs,
                     input_shapes={n: in_shapes[n] for n in runtime_inputs},
                     output_names=out_names, opset=opset)


# ---------------------------------------------------------------------------
# Writer (tests author ONNX files without the onnx package)
# ---------------------------------------------------------------------------

_NP2CODE = {np.dtype(np.float32): 1, np.dtype(np.float16): 10,
            np.dtype(np.int64): 7, np.dtype(np.int32): 6,
            np.dtype(np.uint8): 2, np.dtype(np.bool_): 9,
            np.dtype(np.float64): 11}


def _w_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _w_field(num: int, wire: int, payload: bytes) -> bytes:
    return _w_varint((num << 3) | wire) + payload


def _w_ld(num: int, payload: bytes) -> bytes:
    return _w_field(num, 2, _w_varint(len(payload)) + payload)


def _w_tensor(name: str, arr: np.ndarray) -> bytes:
    t = b""
    for d in arr.shape:
        t += _w_field(1, 0, _w_varint(int(d)))
    t += _w_field(2, 0, _w_varint(_NP2CODE[arr.dtype]))
    if name:
        t += _w_ld(8, name.encode("utf-8"))
    t += _w_ld(9, np.ascontiguousarray(arr).tobytes())
    return t


def _w_attr(name: str, value: Any) -> bytes:
    a = _w_ld(1, name.encode("utf-8"))
    if isinstance(value, np.ndarray):
        a += _w_ld(5, _w_tensor("", value))
        a += _w_field(20, 0, _w_varint(4))          # type = TENSOR
    elif isinstance(value, bytes):
        a += _w_ld(4, value)
        a += _w_field(20, 0, _w_varint(3))          # STRING
    elif isinstance(value, str):
        a += _w_ld(4, value.encode("utf-8"))
        a += _w_field(20, 0, _w_varint(3))
    elif isinstance(value, bool):
        a += _w_field(3, 0, _w_varint(int(value)))
        a += _w_field(20, 0, _w_varint(2))          # INT
    elif isinstance(value, int):
        a += _w_field(3, 0, _w_varint(value))
        a += _w_field(20, 0, _w_varint(2))
    elif isinstance(value, float):
        a += _w_field(2, 5, struct.pack("<f", value))
        a += _w_field(20, 0, _w_varint(1))          # FLOAT
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            for v in value:
                a += _w_field(8, 0, _w_varint(int(v)))
            a += _w_field(20, 0, _w_varint(7))      # INTS
        elif all(isinstance(v, float) for v in value):
            for v in value:
                a += _w_field(7, 5, struct.pack("<f", float(v)))
            a += _w_field(20, 0, _w_varint(6))      # FLOATS
        else:
            raise TypeError(f"unsupported attr list {name}={value!r}")
    else:
        raise TypeError(f"unsupported attr {name}={value!r}")
    return a


def _w_value_info(name: str, shape: Sequence[Optional[int]],
                  elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        dim = b"" if d is None else _w_field(1, 0, _w_varint(int(d)))
        dims += _w_ld(1, dim)
    tensor_type = _w_field(1, 0, _w_varint(elem_type)) + _w_ld(2, dims)
    type_proto = _w_ld(1, tensor_type)
    return _w_ld(1, name.encode("utf-8")) + _w_ld(2, type_proto)


def write_onnx(path: str, *, nodes: Sequence[OnnxNode] = (),
               initializers: Dict[str, np.ndarray] | None = None,
               inputs: Dict[str, Sequence[Optional[int]]] | None = None,
               outputs: Sequence[str] = (), opset: int = 11) -> None:
    """Write a valid ONNX ModelProto covering the subset parse_onnx reads."""
    graph = b""
    for node in nodes:
        n = b""
        for i in node.inputs:
            n += _w_ld(1, i.encode("utf-8"))
        for o in node.outputs:
            n += _w_ld(2, o.encode("utf-8"))
        if node.name:
            n += _w_ld(3, node.name.encode("utf-8"))
        n += _w_ld(4, node.op_type.encode("utf-8"))
        for aname, avalue in node.attrs.items():
            n += _w_ld(5, _w_attr(aname, avalue))
        graph += _w_ld(1, n)
    for name, arr in (initializers or {}).items():
        graph += _w_ld(5, _w_tensor(name, arr))
    for name, shape in (inputs or {}).items():
        graph += _w_ld(11, _w_value_info(name, shape))
    for name in outputs:
        graph += _w_ld(12, _w_value_info(name, ()))
    model = _w_field(1, 0, _w_varint(8))            # ir_version
    opset_b = _w_ld(1, b"") + _w_field(2, 0, _w_varint(opset))
    model += _w_ld(8, opset_b)
    model += _w_ld(7, graph)
    with open(path, "wb") as fh:
        fh.write(model)


def write_minimal_onnx(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Produce a minimal valid ONNX file carrying only initializers —
    round-trip oracle for :func:`onnx_initializers` (no onnx dependency)."""
    write_onnx(path, initializers=tensors)
