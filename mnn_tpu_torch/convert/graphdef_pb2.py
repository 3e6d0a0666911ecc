"""TensorFlow's GraphDef messages, on the port's own wire codec.

The JAX package reads a GraphDef through the `tensorflow` package
(`tensor_util.MakeNdarray`, `dtypes`); the card's machine has neither
TensorFlow nor `google.protobuf`. These classes sit on `protowire` with the
field names and numbers of TensorFlow's public protos (proto3): GraphDef,
NodeDef (its `attr` a map<string, AttrValue>), AttrValue (the `value`
oneof) with its ListValue and NameAttrList, TensorProto, TensorShapeProto,
VersionDef, and the DataType enum. A message gives the bytes
`google.protobuf` gives for it (map entries in key order, as its
deterministic serialization writes them); fields outside this subset
(function libraries, debug info) are skipped on reading.

`make_ndarray` is TensorFlow's `tensor_util.MakeNdarray`: `tensor_content`
as raw little-endian bytes, else the typed `*_val` field (`half_val` holds
fp16 / bf16 bit patterns in int32s), a short list repeating its last value
over the shape. bf16 comes out as float32 (exact; numpy has no bf16).
"""

from __future__ import annotations

import numpy as np

from mnn_tpu_torch.convert.protowire import MapEntry, Message, field as _f, register

# DataType (tensorflow/core/framework/types.proto)
DT_INVALID, DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8, DT_STRING = range(8)
DT_COMPLEX64, DT_INT64, DT_BOOL, DT_QINT8, DT_QUINT8, DT_QINT32, DT_BFLOAT16 = range(8, 15)
DT_QINT16, DT_QUINT16, DT_UINT16, DT_COMPLEX128, DT_HALF, DT_RESOURCE = range(15, 21)
DT_VARIANT, DT_UINT32, DT_UINT64 = 21, 22, 23

# numpy dtype of each DataType a frozen inference graph holds
NP_DTYPES = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
             DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8, DT_INT64: np.int64,
             DT_BOOL: np.bool_, DT_UINT16: np.uint16, DT_HALF: np.float16,
             DT_UINT32: np.uint32, DT_UINT64: np.uint64, DT_COMPLEX64: np.complex64,
             DT_COMPLEX128: np.complex128, DT_BFLOAT16: np.float32}


class TensorShapeProto(Message):
    class Dim(Message):
        FIELDS = {"size": _f(1, "int64"), "name": _f(2, "string")}

    FIELDS = {"dim": _f(2, "message", True, Dim), "unknown_rank": _f(3, "bool")}


class TensorProto(Message):
    FIELDS = {
        "dtype": _f(1, "enum"),
        "tensor_shape": _f(2, "message", False, TensorShapeProto),
        "version_number": _f(3, "int32"),
        "tensor_content": _f(4, "bytes"),
        "float_val": _f(5, "float", True),
        "double_val": _f(6, "double", True),
        "int_val": _f(7, "int32", True),
        "string_val": _f(8, "bytes", True),
        "scomplex_val": _f(9, "float", True),
        "int64_val": _f(10, "int64", True),
        "bool_val": _f(11, "bool", True),
        "dcomplex_val": _f(12, "double", True),
        "half_val": _f(13, "int32", True),
        "uint32_val": _f(16, "uint32", True),
        "uint64_val": _f(17, "uint64", True),
    }


class AttrValue(Message):
    class ListValue(Message):
        FIELDS = {
            "s": _f(2, "bytes", True),
            "i": _f(3, "int64", True),
            "f": _f(4, "float", True),
            "b": _f(5, "bool", True),
            "type": _f(6, "enum", True),
            "shape": _f(7, "message", True, TensorShapeProto),
            "tensor": _f(8, "message", True, TensorProto),
            "func": _f(9, "message", True, "NameAttrList"),
        }

    FIELDS = {
        "list": _f(1, "message", False, ListValue, "value"),
        "s": _f(2, "bytes", oneof="value"),
        "i": _f(3, "int64", oneof="value"),
        "f": _f(4, "float", oneof="value"),
        "b": _f(5, "bool", oneof="value"),
        "type": _f(6, "enum", oneof="value"),
        "shape": _f(7, "message", False, TensorShapeProto, "value"),
        "tensor": _f(8, "message", False, TensorProto, "value"),
        "placeholder": _f(9, "string", oneof="value"),
        "func": _f(10, "message", False, "NameAttrList", "value"),
    }


class _AttrEntry(MapEntry):
    FIELDS = {"key": _f(1, "string"), "value": _f(2, "message", False, AttrValue)}


class NameAttrList(Message):
    FIELDS = {"name": _f(1, "string"), "attr": _f(2, "map", cls=_AttrEntry)}


class NodeDef(Message):
    FIELDS = {
        "name": _f(1, "string"),
        "op": _f(2, "string"),
        "input": _f(3, "string", True),
        "device": _f(4, "string"),
        "attr": _f(5, "map", cls=_AttrEntry),
    }


class VersionDef(Message):
    FIELDS = {"producer": _f(1, "int32"), "min_consumer": _f(2, "int32"),
              "bad_consumers": _f(3, "int32", True)}


class GraphDef(Message):
    FIELDS = {
        "node": _f(1, "message", True, NodeDef),
        "version": _f(3, "int32"),
        "versions": _f(4, "message", False, VersionDef),
    }


register(TensorShapeProto, TensorProto, AttrValue.ListValue, AttrValue, _AttrEntry,
         NameAttrList, NodeDef, VersionDef, GraphDef)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def make_ndarray(t: TensorProto) -> np.ndarray:
    """TensorFlow's `tensor_util.MakeNdarray` for the numeric DataTypes."""
    shape = tuple(int(d.size) for d in t.tensor_shape.dim)
    n = int(np.prod(shape, dtype=np.int64))
    if t.dtype not in NP_DTYPES:
        raise NotImplementedError(f"tf tensor dtype {t.dtype}")
    dt = np.dtype(NP_DTYPES[t.dtype])
    if t.tensor_content:
        if t.dtype == DT_BFLOAT16:
            return _bf16_bits_to_f32(np.frombuffer(t.tensor_content, "<u2")).reshape(shape)
        return np.frombuffer(t.tensor_content, dt.newbyteorder("<")).astype(dt).reshape(shape)
    if t.dtype == DT_HALF:
        vals = np.asarray(t.half_val, np.int32).astype(np.uint16).view(np.float16)
    elif t.dtype == DT_BFLOAT16:
        vals = _bf16_bits_to_f32(np.asarray(t.half_val, np.int32).astype(np.uint16))
    elif t.dtype in (DT_COMPLEX64, DT_COMPLEX128):
        raw = np.asarray(t.scomplex_val if t.dtype == DT_COMPLEX64 else t.dcomplex_val)
        vals = (raw[0::2] + 1j * raw[1::2]).astype(dt)
    else:
        src = {DT_FLOAT: t.float_val, DT_DOUBLE: t.double_val, DT_INT64: t.int64_val,
               DT_BOOL: t.bool_val, DT_UINT32: t.uint32_val,
               DT_UINT64: t.uint64_val}.get(t.dtype, t.int_val)
        vals = np.asarray(list(src) if t.dtype in (DT_BOOL, DT_UINT64) else src).astype(dt)
    if vals.size == n:
        return vals.reshape(shape)
    if n and not vals.size:
        return np.zeros(shape, dt)
    if vals.size > n:
        raise ValueError(f"tf tensor: {vals.size} values for shape {shape}")
    return np.concatenate([vals, np.repeat(vals[-1:], n - vals.size)]).reshape(shape)
