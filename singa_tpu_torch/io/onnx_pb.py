"""Minimal pure-Python ONNX protobuf codec (a copy of
``singa_tpu/io/onnx_pb.py``, which the port may not import; it needs only
``struct``, ``dataclasses`` and numpy).

There is no ``onnx`` wheel to depend on, so the stable subset of
onnx.proto3 needed for model import/export is implemented directly over
the protobuf wire format: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto, TypeProto,
OperatorSetIdProto.  For a given ``ModelProto`` it writes the same bytes
as the JAX package's codec, so files move between the two packages
unchanged.

Wire format: each field is a varint key ``(field_number << 3) | wire_type``
with wire types 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.
Field numbers below are from the public onnx.proto3 (stable across ONNX
releases; the IR is forward-compatible by design).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# -- ONNX TensorProto.DataType enum ----------------------------------------
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
FLOAT16, DOUBLE, UINT32, UINT64, COMPLEX64, COMPLEX128, BFLOAT16 = range(10, 17)

DTYPE_TO_NP = {
    FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8, UINT16: np.uint16,
    INT16: np.int16, INT32: np.int32, INT64: np.int64, BOOL: np.bool_,
    FLOAT16: np.float16, DOUBLE: np.float64, UINT32: np.uint32,
    UINT64: np.uint64,
}
NP_TO_DTYPE = {np.dtype(v): k for k, v in DTYPE_TO_NP.items()}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# wire-level primitives
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out, value):
    if value < 0:
        value += 1 << 64  # two's complement for negative int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed(value):
    """Interpret a 64-bit varint as signed int64."""
    return value - (1 << 64) if value >= (1 << 63) else value


def _fields(buf):
    """Iterate (field_number, wire_type, value) over a message buffer."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _emit(out, fnum, wtype, payload):
    _write_varint(out, (fnum << 3) | wtype)
    if wtype == 0:
        _write_varint(out, payload)
    elif wtype == 2:
        _write_varint(out, len(payload))
        out.extend(payload)
    else:
        out.extend(payload)


def _packed_or_repeated_varints(buf, wtype, val, signed=True):
    """Handle repeated int64 fields that may arrive packed (wtype 2)."""
    if wtype == 0:
        return [_signed(val) if signed else val]
    vals, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        vals.append(_signed(v) if signed else v)
    return vals


# ---------------------------------------------------------------------------
# message dataclasses (subset mirroring onnx.proto3)
# ---------------------------------------------------------------------------

@dataclass
class TensorProto:
    name: str = ""
    dims: list = field(default_factory=list)
    data_type: int = FLOAT
    raw_data: bytes = b""
    float_data: list = field(default_factory=list)
    int32_data: list = field(default_factory=list)
    int64_data: list = field(default_factory=list)

    # field numbers: dims=1 data_type=2 float_data=4 int32_data=5
    # string_data=6 int64_data=7 name=8 raw_data=9
    @classmethod
    def parse(cls, buf):
        t = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                t.dims.extend(_packed_or_repeated_varints(buf, wtype, val))
            elif fnum == 2:
                t.data_type = val
            elif fnum == 4:
                if wtype == 5:
                    t.float_data.append(struct.unpack("<f", val)[0])
                else:
                    t.float_data.extend(
                        struct.unpack(f"<{len(val) // 4}f", val))
            elif fnum == 5:
                t.int32_data.extend(_packed_or_repeated_varints(buf, wtype, val))
            elif fnum == 7:
                t.int64_data.extend(_packed_or_repeated_varints(buf, wtype, val))
            elif fnum == 8:
                t.name = val.decode()
            elif fnum == 9:
                t.raw_data = bytes(val)
        return t

    def serialize(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            _emit(out, 1, 0, int(d))
        _emit(out, 2, 0, self.data_type)
        if self.name:
            _emit(out, 8, 2, self.name.encode())
        if self.raw_data:
            _emit(out, 9, 2, self.raw_data)
        return bytes(out)

    def to_numpy(self) -> np.ndarray:
        np_dtype = DTYPE_TO_NP[self.data_type]
        shape = tuple(self.dims)
        if self.raw_data:
            return np.frombuffer(self.raw_data, dtype=np_dtype).reshape(shape).copy()
        if self.float_data:
            return np.asarray(self.float_data, np.float32).reshape(shape)
        if self.int64_data:
            return np.asarray(self.int64_data, np.int64).reshape(shape)
        if self.int32_data:
            return np.asarray(self.int32_data, np_dtype).reshape(shape)
        return np.zeros(shape, np_dtype)

    @classmethod
    def from_numpy(cls, arr: np.ndarray, name=""):
        arr = np.asarray(arr)
        # NB: ascontiguousarray promotes 0-d to (1,) — keep the true
        # shape for dims (scalar initializers matter: a Gather with a
        # 0-d index drops the axis, with a (1,) index it doesn't)
        data = np.ascontiguousarray(arr)
        return cls(name=name, dims=list(arr.shape),
                   data_type=NP_TO_DTYPE[arr.dtype], raw_data=data.tobytes())


@dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: "TensorProto | None" = None
    g: "GraphProto | None" = None  # If/Loop/Scan subgraph bodies
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)
    strings: list = field(default_factory=list)

    # name=1 f=2 i=3 s=4 t=5 g=6 floats=7 ints=8 strings=9 type=20
    @classmethod
    def parse(cls, buf):
        a = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                a.name = val.decode()
            elif fnum == 2:
                a.f = struct.unpack("<f", val)[0]
            elif fnum == 3:
                a.i = _signed(val)
            elif fnum == 4:
                a.s = bytes(val)
            elif fnum == 5:
                a.t = TensorProto.parse(val)
            elif fnum == 6:
                a.g = GraphProto.parse(val)
            elif fnum == 7:
                if wtype == 5:
                    a.floats.append(struct.unpack("<f", val)[0])
                else:
                    a.floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            elif fnum == 8:
                a.ints.extend(_packed_or_repeated_varints(buf, wtype, val))
            elif fnum == 9:
                a.strings.append(bytes(val))
            elif fnum == 20:
                a.type = val
        return a

    def serialize(self) -> bytes:
        out = bytearray()
        _emit(out, 1, 2, self.name.encode())
        if self.type == ATTR_FLOAT:
            _emit(out, 2, 5, struct.pack("<f", self.f))
        elif self.type == ATTR_INT:
            _emit(out, 3, 0, self.i)
        elif self.type == ATTR_STRING:
            _emit(out, 4, 2, self.s)
        elif self.type == ATTR_TENSOR:
            _emit(out, 5, 2, self.t.serialize())
        elif self.type == ATTR_GRAPH:
            _emit(out, 6, 2, self.g.serialize())
        elif self.type == ATTR_FLOATS:
            for v in self.floats:
                _emit(out, 7, 5, struct.pack("<f", v))
        elif self.type == ATTR_INTS:
            for v in self.ints:
                _emit(out, 8, 0, int(v))
        elif self.type == ATTR_STRINGS:
            for v in self.strings:
                _emit(out, 9, 2, v)
        _emit(out, 20, 0, self.type)
        return bytes(out)

    def value(self):
        return {
            ATTR_FLOAT: self.f, ATTR_INT: self.i, ATTR_STRING: self.s.decode(),
            ATTR_TENSOR: self.t, ATTR_GRAPH: self.g,
            ATTR_FLOATS: list(self.floats),
            ATTR_INTS: list(self.ints),
            ATTR_STRINGS: [s.decode() for s in self.strings],
        }.get(self.type)

    @classmethod
    def make(cls, name, value):
        a = cls(name=name)
        if isinstance(value, float):
            a.type, a.f = ATTR_FLOAT, value
        elif isinstance(value, bool):
            a.type, a.i = ATTR_INT, int(value)
        elif isinstance(value, int):
            a.type, a.i = ATTR_INT, value
        elif isinstance(value, str):
            a.type, a.s = ATTR_STRING, value.encode()
        elif isinstance(value, TensorProto):
            a.type, a.t = ATTR_TENSOR, value
        elif isinstance(value, GraphProto):
            a.type, a.g = ATTR_GRAPH, value
        elif isinstance(value, (list, tuple)):
            if value and isinstance(value[0], float):
                a.type, a.floats = ATTR_FLOATS, list(value)
            elif value and isinstance(value[0], str):
                a.type, a.strings = ATTR_STRINGS, [s.encode() for s in value]
            else:
                a.type, a.ints = ATTR_INTS, [int(v) for v in value]
        else:
            raise TypeError(f"unsupported attribute value {value!r}")
        return a


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    input: list = field(default_factory=list)
    output: list = field(default_factory=list)
    attribute: list = field(default_factory=list)
    domain: str = ""

    # input=1 output=2 name=3 op_type=4 attribute=5 domain=7
    @classmethod
    def parse(cls, buf):
        n = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                n.input.append(val.decode())
            elif fnum == 2:
                n.output.append(val.decode())
            elif fnum == 3:
                n.name = val.decode()
            elif fnum == 4:
                n.op_type = val.decode()
            elif fnum == 5:
                n.attribute.append(AttributeProto.parse(val))
            elif fnum == 7:
                n.domain = val.decode()
        return n

    def serialize(self) -> bytes:
        out = bytearray()
        for s in self.input:
            _emit(out, 1, 2, s.encode())
        for s in self.output:
            _emit(out, 2, 2, s.encode())
        if self.name:
            _emit(out, 3, 2, self.name.encode())
        _emit(out, 4, 2, self.op_type.encode())
        for a in self.attribute:
            _emit(out, 5, 2, a.serialize())
        return bytes(out)

    def attrs(self) -> dict:
        return {a.name: a.value() for a in self.attribute}


@dataclass
class Dimension:
    dim_value: int = -1
    dim_param: str = ""

    @classmethod
    def parse(cls, buf):
        d = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                d.dim_value = _signed(val)
            elif fnum == 2:
                d.dim_param = val.decode()
        return d

    def serialize(self):
        out = bytearray()
        if self.dim_param:
            _emit(out, 2, 2, self.dim_param.encode())
        else:
            _emit(out, 1, 0, int(self.dim_value))
        return bytes(out)


@dataclass
class ValueInfoProto:
    name: str = ""
    elem_type: int = FLOAT
    shape: list = field(default_factory=list)  # list[int|str]

    # ValueInfoProto: name=1 type=2; TypeProto: tensor_type=1;
    # TypeProto.Tensor: elem_type=1 shape=2; TensorShapeProto: dim=1
    @classmethod
    def parse(cls, buf):
        v = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                v.name = val.decode()
            elif fnum == 2:
                for f2, _, val2 in _fields(val):           # TypeProto
                    if f2 == 1:                             # tensor_type
                        for f3, _, val3 in _fields(val2):
                            if f3 == 1:
                                v.elem_type = val3
                            elif f3 == 2:                   # shape
                                for f4, _, val4 in _fields(val3):
                                    if f4 == 1:
                                        d = Dimension.parse(val4)
                                        v.shape.append(
                                            d.dim_param or d.dim_value)
        return v

    def serialize(self) -> bytes:
        shape_buf = bytearray()
        for d in self.shape:
            dim = Dimension(dim_param=d) if isinstance(d, str) else \
                Dimension(dim_value=int(d))
            _emit(shape_buf, 1, 2, dim.serialize())
        tensor_buf = bytearray()
        _emit(tensor_buf, 1, 0, self.elem_type)
        _emit(tensor_buf, 2, 2, bytes(shape_buf))
        type_buf = bytearray()
        _emit(type_buf, 1, 2, bytes(tensor_buf))
        out = bytearray()
        _emit(out, 1, 2, self.name.encode())
        _emit(out, 2, 2, bytes(type_buf))
        return bytes(out)


@dataclass
class GraphProto:
    name: str = ""
    node: list = field(default_factory=list)
    initializer: list = field(default_factory=list)
    input: list = field(default_factory=list)
    output: list = field(default_factory=list)
    value_info: list = field(default_factory=list)

    # node=1 name=2 initializer=5 input=11 output=12 value_info=13
    @classmethod
    def parse(cls, buf):
        g = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                g.node.append(NodeProto.parse(val))
            elif fnum == 2:
                g.name = val.decode()
            elif fnum == 5:
                g.initializer.append(TensorProto.parse(val))
            elif fnum == 11:
                g.input.append(ValueInfoProto.parse(val))
            elif fnum == 12:
                g.output.append(ValueInfoProto.parse(val))
            elif fnum == 13:
                g.value_info.append(ValueInfoProto.parse(val))
        return g

    def serialize(self) -> bytes:
        out = bytearray()
        for n in self.node:
            _emit(out, 1, 2, n.serialize())
        _emit(out, 2, 2, self.name.encode())
        for t in self.initializer:
            _emit(out, 5, 2, t.serialize())
        for v in self.input:
            _emit(out, 11, 2, v.serialize())
        for v in self.output:
            _emit(out, 12, 2, v.serialize())
        return bytes(out)


@dataclass
class OperatorSetIdProto:
    domain: str = ""
    version: int = 17

    @classmethod
    def parse(cls, buf):
        o = cls()
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                o.domain = val.decode()
            elif fnum == 2:
                o.version = _signed(val)
        return o

    def serialize(self):
        out = bytearray()
        if self.domain:
            _emit(out, 1, 2, self.domain.encode())
        _emit(out, 2, 0, self.version)
        return bytes(out)


@dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = "singa_tpu"
    producer_version: str = "0.1.0"
    graph: "GraphProto | None" = None
    opset_import: list = field(default_factory=lambda: [OperatorSetIdProto()])

    # ir_version=1 producer_name=2 producer_version=3 model_version=5
    # graph=7 opset_import=8
    @classmethod
    def parse(cls, buf):
        m = cls(opset_import=[])
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                m.ir_version = _signed(val)
            elif fnum == 2:
                m.producer_name = val.decode()
            elif fnum == 3:
                m.producer_version = val.decode()
            elif fnum == 7:
                m.graph = GraphProto.parse(val)
            elif fnum == 8:
                m.opset_import.append(OperatorSetIdProto.parse(val))
        return m

    def serialize(self) -> bytes:
        out = bytearray()
        _emit(out, 1, 0, self.ir_version)
        _emit(out, 2, 2, self.producer_name.encode())
        _emit(out, 3, 2, self.producer_version.encode())
        _emit(out, 7, 2, self.graph.serialize())
        for o in self.opset_import:
            _emit(out, 8, 2, o.serialize())
        return bytes(out)


def load_model(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return ModelProto.parse(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return ModelProto.parse(f.read())


def save_model(model: ModelProto, path: str):
    with open(path, "wb") as f:
        f.write(model.serialize())
