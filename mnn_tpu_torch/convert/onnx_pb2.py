"""The ONNX messages the frontend reads, on the port's own wire codec.

Counterpart of the JAX package's `convert/onnx_pb2.py`, which protoc
generated from `onnx.proto` and which needs `google.protobuf`. The card's
machine has neither `google.protobuf` nor `onnx`, so these classes sit on
`protowire` (the codec the Caffe and TF message modules share): ModelProto,
GraphProto, NodeProto, AttributeProto, TensorProto, ValueInfoProto,
TypeProto, TensorShapeProto and OperatorSetIdProto, with the field names
and numbers of the public ONNX schema (proto3) and the enum constants as
class attributes. A message gives the bytes `google.protobuf` gives for it.
"""

from __future__ import annotations

from mnn_tpu_torch.convert.protowire import Message, field as _f, register


# -- the ONNX messages (field numbers of the public onnx.proto) ----------------

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


register(TensorProto, TensorShapeProto, TypeProto, ValueInfoProto, AttributeProto, NodeProto,
         GraphProto, OperatorSetIdProto, ModelProto)
