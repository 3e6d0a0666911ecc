"""A pure-Python protobuf wire codec for the ONNX messages the frontend reads.

Counterpart of the JAX package's `convert/onnx_pb2.py`, which protoc
generated from `onnx.proto` and which needs `google.protobuf`. The card's
machine has neither `google.protobuf` nor `onnx`, so this module reads and
writes the same bytes itself: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto, TypeProto, TensorShapeProto
and OperatorSetIdProto, with the field names and numbers of the public ONNX
schema and the enum constants as class attributes.

The API is the subset of generated protobuf classes that the frontend and
its tests use: attribute access (a message field is made on first access
and counts as present once anything in it is set), repeated fields with
`append`, `extend`, `add()`, indexing and `del`, `CopyFrom`,
`SerializeToString`, `FromString`, `HasField`, `WhichOneof` and `==`.

Wire format (proto3):
* varints for int32, int64, uint64, bool and enums; a negative int32 or
  int64 is the ten-byte varint of its 64-bit two's complement (no zigzag);
* fixed32 for float, fixed64 for double, length-delimited for strings,
  bytes, messages and packed repeated scalars;
* repeated numeric fields are written packed (proto3's default) and read
  packed or unpacked; unknown fields are skipped by their wire type;
* fields are written in field-number order and a scalar at its default is
  not written, as protobuf's own serializer does, so a message gives the
  bytes `google.protobuf` gives for it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_WIRE = {"int32": _VARINT, "int64": _VARINT, "uint64": _VARINT, "bool": _VARINT,
         "enum": _VARINT, "float": _I32, "double": _I64, "string": _LEN,
         "bytes": _LEN, "message": _LEN}
_DEFAULT = {"int32": 0, "int64": 0, "uint64": 0, "bool": False, "enum": 0,
            "float": 0.0, "double": 0.0, "string": "", "bytes": b""}


# -- scalars -----------------------------------------------------------------

def _f32(v) -> float:
    """A Python float rounded to float32, as protobuf stores a float field."""
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


def _coerce(kind: str, v):
    if kind in ("int32", "int64", "enum"):
        if isinstance(v, float) or isinstance(v, (str, bytes)):
            raise TypeError(f"{v!r} has type {type(v).__name__}, but expected an integer")
        v = int(v)
        bits = 32 if kind in ("int32", "enum") else 64
        if not -(1 << (bits - 1)) <= v < (1 << (bits - 1)):
            raise ValueError(f"value out of range for {kind}: {v}")
        return v
    if kind == "uint64":
        v = int(v)
        if not 0 <= v < (1 << 64):
            raise ValueError(f"value out of range for uint64: {v}")
        return v
    if kind == "bool":
        return bool(v)
    if kind == "float":
        return _f32(v)
    if kind == "double":
        return float(v)
    if kind == "string":
        if isinstance(v, bytes):
            return v.decode()
        if not isinstance(v, str):
            raise TypeError(f"{v!r} has type {type(v).__name__}, but expected str")
        return v
    if kind == "bytes":
        if isinstance(v, str):
            return v.encode()
        return bytes(v)
    raise TypeError(kind)


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _encode_scalar(kind: str, v) -> bytes:
    if kind in ("int32", "int64", "enum"):
        return _varint(v)
    if kind in ("uint64", "bool"):
        return _varint(int(v))
    if kind == "float":
        return struct.pack("<f", v)
    if kind == "double":
        return struct.pack("<d", v)
    data = v.encode() if kind == "string" else v
    return _varint(len(data)) + data


def _decode_scalar(kind: str, raw):
    """A field's value from its varint (int) or its fixed bytes."""
    if kind in ("int32", "enum"):
        return _signed(raw, 32)
    if kind == "int64":
        return _signed(raw, 64)
    if kind == "uint64":
        return raw & ((1 << 64) - 1)
    if kind == "bool":
        return bool(raw)
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    if kind == "double":
        return struct.unpack("<d", raw)[0]
    if kind == "string":
        return bytes(raw).decode()
    return bytes(raw)


# -- repeated fields ---------------------------------------------------------

class _Repeated:
    """Base of the two repeated containers: a list owned by a message."""

    def __init__(self, owner: "Message"):
        self._owner = owner
        self._items: List[Any] = []

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __delitem__(self, i):
        del self._items[i]
        self._owner._mark()

    def __eq__(self, other):
        return list(self._items) == list(other)

    def __repr__(self):
        return repr(self._items)


class RepeatedScalar(_Repeated):
    def __init__(self, owner, kind: str):
        super().__init__(owner)
        self._kind = kind

    def append(self, v):
        self._items.append(_coerce(self._kind, v))
        self._owner._mark()

    def extend(self, vs):
        self._items.extend(_coerce(self._kind, v) for v in vs)
        self._owner._mark()

    def __setitem__(self, i, v):
        self._items[i] = _coerce(self._kind, v)
        self._owner._mark()


class RepeatedMessage(_Repeated):
    def __init__(self, owner, cls):
        super().__init__(owner)
        self._cls = cls

    def add(self, **fields) -> "Message":
        m = self._cls(**fields)
        m._parent = self._owner
        self._items.append(m)
        self._owner._mark()
        return m

    def append(self, m: "Message"):
        self.add().CopyFrom(m)

    def extend(self, ms):
        for m in ms:
            self.append(m)


# -- messages ----------------------------------------------------------------

class Message:
    """A proto3 message. Subclasses list their fields in FIELDS as
    name -> (number, kind, repeated, message class name or None, oneof)."""

    FIELDS: Dict[str, Tuple[int, str, bool, Any, Any]] = {}
    _BY_NUMBER: Dict[int, str] = {}

    def __init__(self, **fields):
        self._values, self._parent, self._present = {}, None, False
        for k, v in fields.items():
            setattr(self, k, v)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NUMBER = {spec[0]: name for name, spec in cls.FIELDS.items()}

    # presence: a message field counts as set once anything in it is set
    def _mark(self):
        m = self
        while m is not None and not m._present:
            m._present = True
            m = m._parent

    def _spec(self, name):
        spec = type(self).FIELDS.get(name)
        if spec is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        return spec

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        num, kind, repeated, cls, _ = self._spec(name)
        vals = self._values
        if name in vals:
            return vals[name]
        if repeated:
            v = RepeatedMessage(self, _cls(cls)) if kind == "message" else RepeatedScalar(self, kind)
        elif kind == "message":
            v = _cls(cls)()
            v._parent = self
        else:
            return _DEFAULT[kind]
        vals[name] = v
        return v

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        num, kind, repeated, cls, oneof = self._spec(name)
        if repeated or kind == "message":
            raise AttributeError(
                f"assignment not allowed to field {name!r} of {type(self).__name__}: "
                "use CopyFrom, append or extend")
        if oneof:
            for other, spec in type(self).FIELDS.items():
                if spec[4] == oneof and other != name:
                    self._values.pop(other, None)
        self._values[name] = _coerce(kind, value)
        self._mark()

    def HasField(self, name) -> bool:
        num, kind, repeated, cls, oneof = self._spec(name)
        if repeated:
            raise ValueError(f"{name} is repeated")
        v = self._values.get(name)
        if kind == "message":
            return v is not None and v._present
        if oneof:
            return name in self._values
        return v is not None and v != _DEFAULT[kind]

    def WhichOneof(self, group):
        for name, spec in type(self).FIELDS.items():
            if spec[4] == group and self.HasField(name):
                return name
        return None

    def CopyFrom(self, other: "Message"):
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom: {type(other).__name__} into {type(self).__name__}")
        if other is self:
            return
        self._values.clear()
        self.MergeFromString(other.SerializeToString())
        if other._present:
            self._mark()

    # -- writing ------------------------------------------------------------
    def SerializeToString(self, **_) -> bytes:
        out = bytearray()
        for name, (num, kind, repeated, cls, oneof) in sorted(
                type(self).FIELDS.items(), key=lambda kv: kv[1][0]):
            v = self._values.get(name)
            if v is None:
                continue
            if repeated:
                if not len(v):
                    continue
                if kind == "message":
                    for m in v:
                        data = m.SerializeToString()
                        out += _varint(num << 3 | _LEN) + _varint(len(data)) + data
                elif kind in ("string", "bytes"):
                    for s in v:
                        out += _varint(num << 3 | _LEN) + _encode_scalar(kind, s)
                else:           # packed
                    data = b"".join(_encode_scalar(kind, s) for s in v)
                    out += _varint(num << 3 | _LEN) + _varint(len(data)) + data
            elif kind == "message":
                if v._present:
                    data = v.SerializeToString()
                    out += _varint(num << 3 | _LEN) + _varint(len(data)) + data
            elif oneof or v != _DEFAULT[kind] or (kind in ("float", "double")
                                                  and struct.pack("<d", v) != bytes(8)):
                out += _varint(num << 3 | _WIRE[kind]) + _encode_scalar(kind, v)
        return bytes(out)

    # -- reading ------------------------------------------------------------
    def MergeFromString(self, data) -> int:
        buf = memoryview(bytes(data))
        pos, end = 0, len(buf)
        fields = type(self).FIELDS
        while pos < end:
            key, pos = _read_varint(buf, pos)
            num, wire = key >> 3, key & 7
            name = type(self)._BY_NUMBER.get(num)
            if wire == _VARINT:
                raw, pos = _read_varint(buf, pos)
            elif wire == _I64:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wire == _I32:
                raw, pos = buf[pos:pos + 4], pos + 4
            elif wire == _LEN:
                n, pos = _read_varint(buf, pos)
                raw, pos = buf[pos:pos + n], pos + n
            else:
                raise ValueError(f"unsupported wire type {wire} in {type(self).__name__}")
            if pos > end:
                raise ValueError(f"truncated {type(self).__name__}")
            if name is None:
                continue                        # an unknown field
            _, kind, repeated, cls, oneof = fields[name]
            if kind == "message":
                if repeated:
                    getattr(self, name).add().MergeFromString(raw)
                else:
                    sub = getattr(self, name)
                    sub.MergeFromString(raw)
                    sub._mark()
            elif repeated:
                target = getattr(self, name)
                if wire == _LEN and kind not in ("string", "bytes"):
                    target._items.extend(_unpack(kind, raw))   # packed
                else:
                    target._items.append(_decode_scalar(kind, raw))
                self._mark()
            else:
                setattr(self, name, _decode_scalar(kind, raw))
        self._mark()
        return len(buf)

    @classmethod
    def FromString(cls, data) -> "Message":
        m = cls()
        m.MergeFromString(data)
        return m

    def _as_dict(self):
        out = {}
        for name, (num, kind, repeated, cls, oneof) in type(self).FIELDS.items():
            v = self._values.get(name)
            if v is None:
                continue
            if kind == "message":
                if repeated:
                    if len(v):
                        out[name] = [m._as_dict() for m in v]
                elif v._present:
                    out[name] = v._as_dict()
            elif repeated:
                if len(v):
                    out[name] = list(v)
            elif oneof or v != _DEFAULT[kind]:
                out[name] = v
        return out

    def __eq__(self, other):
        return type(other) is type(self) and self._as_dict() == other._as_dict()

    def __repr__(self):
        return f"{type(self).__name__}({self._as_dict()!r})"


def _unpack(kind: str, raw) -> list:
    if kind in ("float", "double"):
        width, fmt = (4, "<f") if kind == "float" else (8, "<d")
        if len(raw) % width:
            raise ValueError(f"packed {kind} of {len(raw)} bytes")
        return [v[0] for v in struct.iter_unpack(fmt, raw)]
    out, pos = [], 0
    while pos < len(raw):
        v, pos = _read_varint(raw, pos)
        out.append(_decode_scalar(kind, v))
    return out


def _cls(name):
    return name if isinstance(name, type) else globals()[name]


# -- the ONNX messages (field numbers of the public onnx.proto) ----------------

def _f(num, kind, repeated=False, cls=None, oneof=None):
    return (num, kind, repeated, cls, oneof)


class TensorProto(Message):
    UNDEFINED, FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = range(8)
    STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64, COMPLEX64 = range(8, 15)
    COMPLEX128, BFLOAT16 = 15, 16
    FIELDS = {
        "dims": _f(1, "int64", True),
        "data_type": _f(2, "int32"),
        "float_data": _f(4, "float", True),
        "int32_data": _f(5, "int32", True),
        "string_data": _f(6, "bytes", True),
        "int64_data": _f(7, "int64", True),
        "name": _f(8, "string"),
        "raw_data": _f(9, "bytes"),
        "double_data": _f(10, "double", True),
        "uint64_data": _f(11, "uint64", True),
    }


class TensorShapeProto(Message):
    class Dimension(Message):
        FIELDS = {"dim_value": _f(1, "int64", oneof="value"),
                  "dim_param": _f(2, "string", oneof="value")}

    FIELDS = {"dim": _f(1, "message", True, Dimension)}


class TypeProto(Message):
    class Tensor(Message):
        FIELDS = {"elem_type": _f(1, "int32"),
                  "shape": _f(2, "message", False, TensorShapeProto)}

    FIELDS = {"tensor_type": _f(1, "message", False, Tensor, "value")}


class ValueInfoProto(Message):
    FIELDS = {"name": _f(1, "string"), "type": _f(2, "message", False, TypeProto)}


class AttributeProto(Message):
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = range(6)
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = range(6, 11)
    FIELDS = {
        "name": _f(1, "string"),
        "f": _f(2, "float"),
        "i": _f(3, "int64"),
        "s": _f(4, "bytes"),
        "t": _f(5, "message", False, TensorProto),
        "g": _f(6, "message", False, "GraphProto"),
        "floats": _f(7, "float", True),
        "ints": _f(8, "int64", True),
        "strings": _f(9, "bytes", True),
        "tensors": _f(10, "message", True, TensorProto),
        "graphs": _f(11, "message", True, "GraphProto"),
        "type": _f(20, "enum"),
    }


class NodeProto(Message):
    FIELDS = {
        "input": _f(1, "string", True),
        "output": _f(2, "string", True),
        "name": _f(3, "string"),
        "op_type": _f(4, "string"),
        "attribute": _f(5, "message", True, AttributeProto),
        "doc_string": _f(6, "string"),
        "domain": _f(7, "string"),
    }


class GraphProto(Message):
    FIELDS = {
        "node": _f(1, "message", True, NodeProto),
        "name": _f(2, "string"),
        "initializer": _f(5, "message", True, TensorProto),
        "doc_string": _f(10, "string"),
        "input": _f(11, "message", True, ValueInfoProto),
        "output": _f(12, "message", True, ValueInfoProto),
        "value_info": _f(13, "message", True, ValueInfoProto),
    }


class OperatorSetIdProto(Message):
    FIELDS = {"domain": _f(1, "string"), "version": _f(2, "int64")}


class ModelProto(Message):
    FIELDS = {
        "ir_version": _f(1, "int64"),
        "producer_name": _f(2, "string"),
        "producer_version": _f(3, "string"),
        "domain": _f(4, "string"),
        "model_version": _f(5, "int64"),
        "doc_string": _f(6, "string"),
        "graph": _f(7, "message", False, GraphProto),
        "opset_import": _f(8, "message", True, OperatorSetIdProto),
    }
