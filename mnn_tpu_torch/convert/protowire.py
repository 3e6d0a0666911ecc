"""A pure-Python protobuf wire codec: the machinery shared by the port's
message modules (`onnx_pb2`, `caffe_pb2`, `graphdef_pb2`).

The card's machine has no `google.protobuf`, so the port reads and writes
the bytes itself. A message module declares each message as a `Message`
subclass with a FIELDS table (`field(...)` entries: number, kind, repeated,
message class, oneof, proto2 default, packed) and its enum constants as
class attributes. The API is the subset of generated protobuf classes that
the frontends and their tests use: attribute access (a message field is
made on first access and counts as present once anything in it is set),
repeated fields with `append`, `extend`, `add()`, indexing and `del`, map
fields as dicts (`node.attr["T"]`), `CopyFrom`, `SerializeToString`,
`FromString`, `MergeFromString`, `HasField`, `WhichOneof`, `SetInParent`
and `==`.

Wire format:
* varints for int32, int64, uint32, uint64, bool and enums; a negative
  int32 or int64 is the ten-byte varint of its 64-bit two's complement
  (no zigzag);
* fixed32 for float, fixed64 for double, length-delimited for strings,
  bytes, messages, map entries and packed repeated scalars;
* unknown fields are skipped by their wire type; repeated scalars are read
  packed or unpacked, whatever the declaration;
* fields are written in field-number order, map entries sorted by key with
  both key and value written (protobuf's deterministic order), so a message
  gives the bytes `google.protobuf` gives for it.

The two syntaxes differ where protobuf's do:
* proto3 (`SYNTAX = "proto3"`, the default): a scalar at its default is not
  written and has no presence (except in a oneof); repeated numeric fields
  are written packed unless declared `packed=False`;
* proto2 (`SYNTAX = "proto2"`): a scalar has presence (`HasField` is true
  once set, to any value, and a set field is written even at its default),
  reads as its `[default = ...]` when unset, and repeated numeric fields
  are written unpacked unless declared `packed=True`.

Packed float and double fields decode in bulk (`np.frombuffer`) into a
numpy array that the repeated field keeps (`np.asarray(field)` is then
free), and `extend` with a numpy array keeps it as one: a caffemodel of
hundreds of MB reads and writes in seconds.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

VARINT, I64, LEN, I32 = 0, 1, 2, 5
_WIRE = {"int32": VARINT, "int64": VARINT, "uint32": VARINT, "uint64": VARINT,
         "bool": VARINT, "enum": VARINT, "float": I32, "double": I64, "string": LEN,
         "bytes": LEN, "message": LEN}
_DEFAULT = {"int32": 0, "int64": 0, "uint32": 0, "uint64": 0, "bool": False, "enum": 0,
            "float": 0.0, "double": 0.0, "string": "", "bytes": b""}
_NP = {"float": np.dtype("<f4"), "double": np.dtype("<f8"), "int32": np.int32,
       "int64": np.int64, "uint32": np.uint32, "uint64": np.uint64, "bool": np.bool_,
       "enum": np.int32}


class Field(NamedTuple):
    num: int
    kind: str                   # a scalar kind, "message" or "map"
    repeated: bool = False
    cls: Any = None             # message (or map entry) class or its name; enum: name -> value
    oneof: Optional[str] = None
    default: Any = None         # proto2 [default = ...]; None: the kind's default
    packed: Optional[bool] = None


def field(num, kind, repeated=False, cls=None, oneof=None, default=None, packed=None) -> Field:
    return Field(num, kind, repeated, cls, oneof, default, packed)


# -- scalars -----------------------------------------------------------------

def f32(v) -> float:
    """A Python float rounded to float32, as protobuf stores a float field."""
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


_INT_RANGE = {"int32": (-(1 << 31), 1 << 31), "enum": (-(1 << 31), 1 << 31),
              "int64": (-(1 << 63), 1 << 63), "uint32": (0, 1 << 32), "uint64": (0, 1 << 64)}


def coerce(kind: str, v):
    if kind in _INT_RANGE:
        if isinstance(v, (float, str, bytes)):
            raise TypeError(f"{v!r} has type {type(v).__name__}, but expected an integer")
        v = int(v)
        lo, hi = _INT_RANGE[kind]
        if not lo <= v < hi:
            raise ValueError(f"value out of range for {kind}: {v}")
        return v
    if kind == "bool":
        return bool(v)
    if kind == "float":
        return f32(v)
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


def varint(v: int) -> bytes:
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


def read_varint(buf, pos: int) -> Tuple[int, int]:
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


def encode_scalar(kind: str, v) -> bytes:
    if kind in ("int32", "int64", "enum"):
        return varint(v)
    if kind in ("uint32", "uint64", "bool"):
        return varint(int(v))
    if kind == "float":
        return struct.pack("<f", v)
    if kind == "double":
        return struct.pack("<d", v)
    data = v.encode() if kind == "string" else v
    return varint(len(data)) + data


def decode_scalar(kind: str, raw):
    """A field's value from its varint (int) or its fixed bytes."""
    if kind in ("int32", "enum"):
        return _signed(raw, 32)
    if kind == "int64":
        return _signed(raw, 64)
    if kind == "uint32":
        return raw & 0xFFFFFFFF
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


def _unpack(kind: str, raw):
    """A packed run of scalars: a numpy array for float / double, a list
    otherwise."""
    if kind in ("float", "double"):
        dt = _NP[kind]
        if len(raw) % dt.itemsize:
            raise ValueError(f"packed {kind} of {len(raw)} bytes")
        return np.frombuffer(bytes(raw), dt).astype(dt.newbyteorder("="))
    out, pos = [], 0
    while pos < len(raw):
        v, pos = read_varint(raw, pos)
        out.append(decode_scalar(kind, v))
    return out


def _pack(kind: str, items) -> bytes:
    if kind in ("float", "double"):
        return np.asarray(items, _NP[kind]).tobytes()
    return b"".join(encode_scalar(kind, s) for s in items)


# -- repeated and map fields ------------------------------------------------

class _Repeated:
    """Base of the repeated containers: a list owned by a message."""

    def __init__(self, owner: "Message"):
        self._owner = owner
        self._items: Any = []

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        items = self._items
        return iter(items.tolist() if isinstance(items, np.ndarray) else items)

    def __getitem__(self, i):
        items = self._items
        if isinstance(items, np.ndarray):
            return items[i].tolist()
        return items[i]

    def __delitem__(self, i):
        self._as_list()
        del self._items[i]
        self._owner._mark()

    def _as_list(self):
        if isinstance(self._items, np.ndarray):
            self._items = self._items.tolist()

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return repr(list(self))


class RepeatedScalar(_Repeated):
    def __init__(self, owner, kind: str):
        super().__init__(owner)
        self._kind = kind

    def append(self, v):
        self._as_list()
        self._items.append(coerce(self._kind, v))
        self._owner._mark()

    def extend(self, vs):
        if isinstance(vs, np.ndarray) and self._kind in ("float", "double"):
            arr = np.ascontiguousarray(vs, _NP[self._kind].newbyteorder("=")).reshape(-1)
            self._items = arr if not len(self._items) else np.concatenate(
                [np.asarray(self._items, arr.dtype), arr])
        else:
            self._as_list()
            self._items.extend(coerce(self._kind, v) for v in vs)
        self._owner._mark()

    def __setitem__(self, i, v):
        self._as_list()
        self._items[i] = coerce(self._kind, v)
        self._owner._mark()

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._items, _NP.get(self._kind))
        return a if dtype is None else a.astype(dtype)


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


class MapField:
    """map<key, value>: a dict owned by a message. A message value is made
    on first access (`node.attr["T"].type = 1`), as protobuf makes it; on the
    wire, one entry message (key = 1, value = 2) a key."""

    def __init__(self, owner: "Message", entry):
        self._owner = owner
        self._entry = entry
        self._key = entry.FIELDS["key"]
        self._val = entry.FIELDS["value"]
        self._items: Dict[Any, Any] = {}

    def __getitem__(self, key):
        key = coerce(self._key.kind, key)
        if key not in self._items:
            if self._val.kind != "message":
                raise KeyError(key)
            m = cls_of(self._val.cls)()
            m._parent = self._owner
            self._items[key] = m
            self._owner._mark()
        return self._items[key]

    def __setitem__(self, key, value):
        if self._val.kind == "message":
            raise ValueError("assignment to a message map value: use CopyFrom")
        self._items[coerce(self._key.kind, key)] = coerce(self._val.kind, value)
        self._owner._mark()

    def __contains__(self, key):
        return key in self._items

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __delitem__(self, key):
        del self._items[key]

    def get(self, key, default=None):
        return self._items.get(key, default)

    def keys(self):
        return self._items.keys()

    def values(self):
        return self._items.values()

    def items(self):
        return self._items.items()

    def _entries(self):
        """Entry messages in key order."""
        for k in sorted(self._items):
            e = self._entry()
            e.key = k
            v = self._items[k]
            if self._val.kind == "message":
                e.value.CopyFrom(v)
                e.value._mark()
            else:
                e.value = v
            yield e

    def __eq__(self, other):
        return dict(self._items) == dict(other)

    def __repr__(self):
        return repr(self._items)


# -- messages ----------------------------------------------------------------

class Message:
    """A protobuf message. Subclasses list their fields in FIELDS as
    name -> Field."""

    SYNTAX = "proto3"
    FIELDS: Dict[str, Field] = {}
    _BY_NUMBER: Dict[int, str] = {}

    def __init__(self, **fields):
        self._values, self._parent, self._present = {}, None, False
        for k, v in fields.items():
            setattr(self, k, v)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NUMBER = {spec.num: name for name, spec in cls.FIELDS.items()}
        cls._ORDER = sorted(cls.FIELDS.items(), key=lambda kv: kv[1].num)

    # presence: a message field counts as set once anything in it is set
    def _mark(self):
        m = self
        while m is not None and not m._present:
            m._present = True
            m = m._parent

    def _spec(self, name) -> Field:
        spec = type(self).FIELDS.get(name)
        if spec is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        return spec

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        spec = self._spec(name)
        vals = self._values
        if name in vals:
            return vals[name]
        if spec.kind == "map":
            v = MapField(self, cls_of(spec.cls))
        elif spec.repeated:
            v = (RepeatedMessage(self, cls_of(spec.cls)) if spec.kind == "message"
                 else RepeatedScalar(self, spec.kind))
        elif spec.kind == "message":
            v = cls_of(spec.cls)()
            v._parent = self
        else:
            return _DEFAULT[spec.kind] if spec.default is None else spec.default
        vals[name] = v
        return v

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        spec = self._spec(name)
        if spec.repeated or spec.kind in ("message", "map"):
            raise AttributeError(
                f"assignment not allowed to field {name!r} of {type(self).__name__}: "
                "use CopyFrom, append or extend")
        if spec.oneof:
            for other, s in type(self).FIELDS.items():
                if s.oneof == spec.oneof and other != name:
                    self._values.pop(other, None)
        self._values[name] = coerce(spec.kind, value)
        self._mark()

    def _scalar_written(self, name, spec, v) -> bool:
        """Whether a set scalar goes on the wire (and into `==`)."""
        if self.SYNTAX == "proto2" or spec.oneof:
            return True
        return v != _DEFAULT[spec.kind] or (spec.kind in ("float", "double")
                                            and struct.pack("<d", v) != bytes(8))

    def HasField(self, name) -> bool:
        spec = self._spec(name)
        if spec.repeated or spec.kind == "map":
            raise ValueError(f"{name} is repeated")
        v = self._values.get(name)
        if spec.kind == "message":
            return v is not None and v._present
        if v is None:
            return False
        return self._scalar_written(name, spec, v)

    def SetInParent(self):
        """Mark this (empty) sub-message present, as protobuf's does."""
        self._mark()

    def ClearField(self, name):
        self._spec(name)
        self._values.pop(name, None)

    def WhichOneof(self, group):
        for name, spec in type(self).FIELDS.items():
            if spec.oneof == group and self.HasField(name):
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
        proto2 = self.SYNTAX == "proto2"
        for name, spec in type(self)._ORDER:
            v = self._values.get(name)
            if v is None:
                continue
            num, kind = spec.num, spec.kind
            if kind == "map":
                for e in v._entries():
                    data = e.SerializeToString()
                    out += varint(num << 3 | LEN) + varint(len(data)) + data
            elif spec.repeated:
                if not len(v):
                    continue
                if kind == "message":
                    for m in v:
                        data = m.SerializeToString()
                        out += varint(num << 3 | LEN) + varint(len(data)) + data
                elif kind in ("string", "bytes"):
                    for s in v:
                        out += varint(num << 3 | LEN) + encode_scalar(kind, s)
                elif spec.packed if spec.packed is not None else not proto2:
                    data = _pack(kind, v._items)
                    out += varint(num << 3 | LEN) + varint(len(data)) + data
                else:
                    tag = varint(num << 3 | _WIRE[kind])
                    if kind in ("float", "double"):
                        width = _NP[kind].itemsize
                        data = _pack(kind, v._items)
                        out += b"".join(tag + data[i:i + width]
                                        for i in range(0, len(data), width))
                    else:
                        for s in v:
                            out += tag + encode_scalar(kind, s)
            elif kind == "message":
                if v._present:
                    data = v.SerializeToString()
                    out += varint(num << 3 | LEN) + varint(len(data)) + data
            elif self._scalar_written(name, spec, v):
                out += varint(num << 3 | _WIRE[kind]) + encode_scalar(kind, v)
        return bytes(out)

    # -- reading ------------------------------------------------------------
    def MergeFromString(self, data) -> int:
        buf = memoryview(data if isinstance(data, (bytes, bytearray, memoryview))
                         else bytes(data))
        pos, end = 0, len(buf)
        cls = type(self)
        fields = cls.FIELDS
        while pos < end:
            key, pos = read_varint(buf, pos)
            num, wire = key >> 3, key & 7
            name = cls._BY_NUMBER.get(num)
            if wire == VARINT:
                raw, pos = read_varint(buf, pos)
            elif wire == I64:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wire == I32:
                raw, pos = buf[pos:pos + 4], pos + 4
            elif wire == LEN:
                n, pos = read_varint(buf, pos)
                raw, pos = buf[pos:pos + n], pos + n
            else:
                raise ValueError(f"unsupported wire type {wire} in {cls.__name__}")
            if pos > end:
                raise ValueError(f"truncated {cls.__name__}")
            if name is None:
                continue                        # an unknown field
            spec = fields[name]
            kind = spec.kind
            if kind == "map":
                e = cls_of(spec.cls).FromString(raw)
                target = getattr(self, name)
                if target._val.kind == "message":
                    target[e.key].MergeFromString(e.value.SerializeToString())
                else:
                    target._items[e.key] = e.value
                self._mark()
            elif kind == "message":
                if spec.repeated:
                    getattr(self, name).add().MergeFromString(raw)
                else:
                    sub = getattr(self, name)
                    sub.MergeFromString(raw)
                    sub._mark()
            elif spec.repeated:
                target = getattr(self, name)
                if wire == LEN and kind not in ("string", "bytes"):
                    vals = _unpack(kind, raw)                  # packed
                    if isinstance(vals, np.ndarray) and not len(target._items):
                        target._items = vals
                    else:
                        target._as_list()
                        target._items.extend(vals.tolist() if isinstance(vals, np.ndarray)
                                             else vals)
                else:
                    target._as_list()
                    target._items.append(decode_scalar(kind, raw))
                self._mark()
            else:
                setattr(self, name, decode_scalar(kind, raw))
        self._mark()
        return len(buf)

    ParseFromString = MergeFromString

    @classmethod
    def FromString(cls, data) -> "Message":
        m = cls()
        m.MergeFromString(data)
        return m

    def _as_dict(self):
        out = {}
        for name, spec in type(self).FIELDS.items():
            v = self._values.get(name)
            if v is None:
                continue
            if spec.kind == "map":
                if len(v):
                    out[name] = {k: (x._as_dict() if isinstance(x, Message) else x)
                                 for k, x in v.items()}
            elif spec.kind == "message":
                if spec.repeated:
                    if len(v):
                        out[name] = [m._as_dict() for m in v]
                elif v._present:
                    out[name] = v._as_dict()
            elif spec.repeated:
                if len(v):
                    out[name] = list(v)
            elif self._scalar_written(name, spec, v):
                out[name] = v
        return out

    def __eq__(self, other):
        return type(other) is type(self) and self._as_dict() == other._as_dict()

    def __repr__(self):
        return f"{type(self).__name__}({self._as_dict()!r})"


class MapEntry(Message):
    """A map's entry message (key = 1, value = 2): protobuf writes both
    fields of an entry even at their defaults."""

    def _scalar_written(self, name, spec, v) -> bool:
        return True


def cls_of(cls):
    """A field's message class (a name was resolved by `register`)."""
    if isinstance(cls, type):
        return cls
    raise TypeError(f"unresolved message class {cls!r}: list it in the module's register()")


def register(*classes):
    """Resolve the forward references (message classes named by a string in
    FIELDS) of one module's message classes against those classes."""
    by_name = {c.__name__: c for c in classes}
    for c in classes:
        for name, spec in c.FIELDS.items():
            if isinstance(spec.cls, str) and spec.kind in ("message", "map"):
                c.FIELDS[name] = spec._replace(cls=by_name[spec.cls])


# -- text format (prototxt) --------------------------------------------------

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b", "f": "\f", "v": "\v",
            "\\": "\\", "'": "'", '"': '"', "?": "?"}


class _Tokens:
    """The tokens of protobuf's text format: identifiers, numbers, quoted
    strings (adjacent ones joined), and the symbols { } < > [ ] : , ;
    Comments run from # to the end of the line."""

    def __init__(self, text: str):
        self.toks: List[Tuple[str, Any]] = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if c in " \t\r\n\f\v":
                i += 1
            elif c == "#":
                j = text.find("\n", i)
                i = n if j < 0 else j + 1
            elif c in "{}<>[]:,;":
                self.toks.append(("sym", c))
                i += 1
            elif c in "\"'":
                s, i = self._string(text, i)
                if self.toks and self.toks[-1][0] == "str":
                    self.toks[-1] = ("str", self.toks[-1][1] + s)
                else:
                    self.toks.append(("str", s))
            else:
                j = i
                while j < n and (text[j].isalnum() or text[j] in "_.+-"):
                    j += 1
                if j == i:
                    raise ValueError(f"text format: unexpected {c!r} at {i}")
                self.toks.append(("word", text[i:j]))
                i = j
        self.pos = 0

    @staticmethod
    def _string(text, i):
        quote, i, out = text[i], i + 1, bytearray()
        while True:
            if i >= len(text):
                raise ValueError("text format: unterminated string")
            c = text[i]
            if c == quote:
                return bytes(out), i + 1
            if c == "\\":
                e = text[i + 1]
                if e in _ESCAPES:
                    out += _ESCAPES[e].encode()
                    i += 2
                elif e in "01234567":
                    j = i + 1
                    while j < i + 4 and j < len(text) and text[j] in "01234567":
                        j += 1
                    out.append(int(text[i + 1:j], 8) & 0xFF)
                    i = j
                elif e in "xX":
                    j = i + 2
                    while j < i + 4 and j < len(text) and text[j] in "0123456789abcdefABCDEF":
                        j += 1
                    out.append(int(text[i + 2:j], 16))
                    i = j
                elif e in "uU":
                    width = 4 if e == "u" else 8
                    out += chr(int(text[i + 2:i + 2 + width], 16)).encode()
                    i += 2 + width
                else:
                    raise ValueError(f"text format: unknown escape \\{e}")
            else:
                out += c.encode()
                i += 1

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def take(self, sym) -> bool:
        if self.peek() == ("sym", sym):
            self.pos += 1
            return True
        return False

    def expect(self, sym):
        if not self.take(sym):
            raise ValueError(f"text format: expected {sym!r}, got {self.peek()[1]!r}")


def _text_int(word: str) -> int:
    w = word.lower()
    neg = w.startswith("-")
    w = w.lstrip("+-")
    if w.startswith("0x"):
        v = int(w, 16)
    elif len(w) > 1 and w.startswith("0") and w.isdigit():
        v = int(w, 8)
    else:
        v = int(w)
    return -v if neg else v


def _text_float(word: str) -> float:
    w = word.lower()
    if w.lstrip("+-") in ("inf", "infinity", "nan"):
        return float(w)
    if w.endswith("f") and not w.lstrip("+-").startswith("0x"):
        w = w[:-1]
    return float(w)


def _text_scalar(spec: Field, tok):
    kind_t, val = tok
    kind = spec.kind
    if kind in ("string", "bytes"):
        if kind_t != "str":
            raise ValueError(f"text format: expected a string, got {val!r}")
        return val.decode() if kind == "string" else val
    if kind_t != "word":
        raise ValueError(f"text format: expected a value, got {val!r}")
    if kind == "bool":
        if val in ("true", "True", "t", "1"):
            return True
        if val in ("false", "False", "f", "0"):
            return False
        raise ValueError(f"text format: not a bool: {val!r}")
    if kind in ("float", "double"):
        return _text_float(val)
    if kind == "enum":
        if val.lstrip("-").isdigit():
            return int(val)
        names = spec.cls or {}
        if val not in names:
            raise ValueError(f"text format: unknown enum value {val!r}")
        return names[val]
    return _text_int(val)


def _skip_value(toks: _Tokens):
    """Skip an unknown field's value: a nested block, a list or a scalar."""
    if toks.take("{") or toks.take("<"):
        depth = 1
        while depth:
            kind, v = toks.next()
            if kind is None:
                raise ValueError("text format: unterminated block")
            if kind == "sym" and v in "{<":
                depth += 1
            elif kind == "sym" and v in "}>":
                depth -= 1
        return
    if toks.take("["):
        while not toks.take("]"):
            toks.next()
        return
    toks.next()


def _parse_fields(toks: _Tokens, msg: "Message", close: Optional[str],
                  allow_unknown: bool):
    fields = type(msg).FIELDS
    while True:
        if close is not None and toks.take(close):
            return
        kind, name = toks.next()
        if kind is None:
            if close is not None:
                raise ValueError("text format: unterminated message")
            return
        if kind == "sym" and name == "[":           # an extension or Any: skip
            while not toks.take("]"):
                toks.next()
            toks.take(":")
            _skip_value(toks)
        elif kind != "word":
            raise ValueError(f"text format: expected a field name, got {name!r}")
        elif name not in fields:
            if not allow_unknown:
                raise ValueError(f"text format: {type(msg).__name__} has no field {name!r}")
            toks.take(":")
            _skip_value(toks)
        else:
            spec = fields[name]
            colon = toks.take(":")
            if spec.kind in ("message", "map"):
                values = [None]
                if colon and toks.take("["):
                    values = []
                    while not toks.take("]"):
                        values.append(None)
                        _parse_message_value(toks, msg, name, spec, allow_unknown)
                        toks.take(",")
                else:
                    _parse_message_value(toks, msg, name, spec, allow_unknown)
            else:
                if not colon:
                    raise ValueError(f"text format: expected ':' after {name!r}")
                if toks.take("["):
                    vals = []
                    while not toks.take("]"):
                        vals.append(_text_scalar(spec, toks.next()))
                        toks.take(",")
                else:
                    vals = [_text_scalar(spec, toks.next())]
                if spec.repeated:
                    getattr(msg, name).extend(vals)
                else:
                    for v in vals:
                        setattr(msg, name, v)
        if not toks.take(","):
            toks.take(";")


def _parse_message_value(toks, msg, name, spec, allow_unknown):
    if toks.take("{"):
        close = "}"
    else:
        toks.expect("<")
        close = ">"
    if spec.kind == "map":
        e = cls_of(spec.cls)()
        _parse_fields(toks, e, close, allow_unknown)
        target = getattr(msg, name)
        if target._val.kind == "message":
            target[e.key].CopyFrom(e.value)
        else:
            target[e.key] = e.value
        return
    sub = getattr(msg, name).add() if spec.repeated else getattr(msg, name)
    _parse_fields(toks, sub, close, allow_unknown)
    sub._mark()


def parse_text(text: str, msg: "Message", allow_unknown_field: bool = False) -> "Message":
    """Merge protobuf text format into `msg` (what `text_format.Parse` takes:
    `#` comments, `field: value` and `field { ... }` with or without the
    colon, `<...>` blocks, quoted strings with C escapes, enum names,
    floats such as `1e-5`, `inf` and `nan`, repeated fields given one by one
    or as a `[...]` list). With `allow_unknown_field`, unknown fields and
    whole unknown blocks are skipped."""
    if isinstance(text, bytes):
        text = text.decode()
    _parse_fields(_Tokens(text), msg, None, allow_unknown_field)
    return msg
