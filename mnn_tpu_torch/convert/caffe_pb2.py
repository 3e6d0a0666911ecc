"""The Caffe messages the frontend reads, on the port's own wire codec.

Counterpart of the JAX package's `convert/caffe_pb2.py`, which protoc
generated from `caffe.proto` and which needs `google.protobuf`. The card's
machine has no `google.protobuf`, so these classes sit on `protowire`: the
messages, fields, numbers, defaults and enum values of `caffe.proto` beside
this file (proto2: a field has presence and reads as its `[default = ...]`
when unset; repeated scalars go unpacked unless `[packed = true]`). A
message gives the bytes `google.protobuf` gives for it.

A caffemodel's weights are packed floats (`BlobProto.data`), decoded in
bulk into a numpy array (`np.asarray(blob.data)` is then free).
`load_prototxt` reads a deploy prototxt (protobuf text format) as
`text_format.Parse(..., allow_unknown_field=True)` reads it.
"""

from __future__ import annotations

from mnn_tpu_torch.convert.protowire import Message, field as _f, parse_text, register


class _Proto2(Message):
    SYNTAX = "proto2"


class BlobShape(_Proto2):
    FIELDS = {"dim": _f(1, "int64", True, packed=True)}


class BlobProto(_Proto2):
    FIELDS = {
        "shape": _f(7, "message", False, BlobShape),
        "data": _f(5, "float", True, packed=True),
        "num": _f(1, "int32", default=0),
        "channels": _f(2, "int32", default=0),
        "height": _f(3, "int32", default=0),
        "width": _f(4, "int32", default=0),
    }


class InputParameter(_Proto2):
    FIELDS = {"shape": _f(1, "message", True, BlobShape)}


class ConvolutionParameter(_Proto2):
    FIELDS = {
        "num_output": _f(1, "uint32"),
        "bias_term": _f(2, "bool", default=True),
        "pad": _f(3, "uint32", True),
        "kernel_size": _f(4, "uint32", True),
        "group": _f(5, "uint32", default=1),
        "stride": _f(6, "uint32", True),
        "pad_h": _f(9, "uint32", default=0),
        "pad_w": _f(10, "uint32", default=0),
        "kernel_h": _f(11, "uint32"),
        "kernel_w": _f(12, "uint32"),
        "stride_h": _f(13, "uint32"),
        "stride_w": _f(14, "uint32"),
        "dilation": _f(18, "uint32", True),
    }


class PoolingParameter(_Proto2):
    MAX, AVE, STOCHASTIC = 0, 1, 2           # PoolMethod
    CEIL, FLOOR = 0, 1                       # RoundMode
    _METHOD = {"MAX": 0, "AVE": 1, "STOCHASTIC": 2}
    _ROUND = {"CEIL": 0, "FLOOR": 1}
    FIELDS = {
        "pool": _f(1, "enum", cls=_METHOD, default=MAX),
        "kernel_size": _f(2, "uint32"),
        "stride": _f(3, "uint32", default=1),
        "pad": _f(4, "uint32", default=0),
        "kernel_h": _f(5, "uint32"),
        "kernel_w": _f(6, "uint32"),
        "stride_h": _f(7, "uint32"),
        "stride_w": _f(8, "uint32"),
        "pad_h": _f(9, "uint32", default=0),
        "pad_w": _f(10, "uint32", default=0),
        "global_pooling": _f(12, "bool", default=False),
        "round_mode": _f(13, "enum", cls=_ROUND, default=CEIL),
    }


class InnerProductParameter(_Proto2):
    FIELDS = {
        "num_output": _f(1, "uint32"),
        "bias_term": _f(2, "bool", default=True),
        "axis": _f(5, "int32", default=1),
        "transpose": _f(6, "bool", default=False),
    }


class ReLUParameter(_Proto2):
    FIELDS = {"negative_slope": _f(1, "float", default=0.0)}


class ELUParameter(_Proto2):
    FIELDS = {"alpha": _f(1, "float", default=1.0)}


class SoftmaxParameter(_Proto2):
    FIELDS = {"axis": _f(2, "int32", default=1)}


class BatchNormParameter(_Proto2):
    FIELDS = {
        "use_global_stats": _f(1, "bool"),
        "moving_average_fraction": _f(2, "float", default=0.9990000128746033),   # f32(0.999)
        "eps": _f(3, "float", default=9.999999747378752e-06),                     # f32(1e-5)
    }


class ScaleParameter(_Proto2):
    FIELDS = {
        "axis": _f(1, "int32", default=1),
        "num_axes": _f(2, "int32", default=1),
        "bias_term": _f(4, "bool", default=False),
    }


class EltwiseParameter(_Proto2):
    PROD, SUM, MAX = 0, 1, 2                 # EltwiseOp
    FIELDS = {
        "operation": _f(1, "enum", cls={"PROD": 0, "SUM": 1, "MAX": 2}, default=SUM),
        "coeff": _f(2, "float", True),
    }


class ConcatParameter(_Proto2):
    FIELDS = {
        "concat_dim": _f(1, "uint32", default=1),
        "axis": _f(2, "int32", default=1),
    }


class DropoutParameter(_Proto2):
    FIELDS = {"dropout_ratio": _f(1, "float", default=0.5)}


class ReshapeParameter(_Proto2):
    FIELDS = {
        "shape": _f(1, "message", False, BlobShape),
        "axis": _f(2, "int32", default=0),
        "num_axes": _f(3, "int32", default=-1),
    }


class FlattenParameter(_Proto2):
    FIELDS = {
        "axis": _f(1, "int32", default=1),
        "end_axis": _f(2, "int32", default=-1),
    }


class PowerParameter(_Proto2):
    FIELDS = {
        "power": _f(1, "float", default=1.0),
        "scale": _f(2, "float", default=1.0),
        "shift": _f(3, "float", default=0.0),
    }


class LRNParameter(_Proto2):
    ACROSS_CHANNELS, WITHIN_CHANNEL = 0, 1   # NormRegion
    FIELDS = {
        "local_size": _f(1, "uint32", default=5),
        "alpha": _f(2, "float", default=1.0),
        "beta": _f(3, "float", default=0.75),
        "norm_region": _f(4, "enum", cls={"ACROSS_CHANNELS": 0, "WITHIN_CHANNEL": 1},
                          default=ACROSS_CHANNELS),
        "k": _f(5, "float", default=1.0),
    }


class SliceParameter(_Proto2):
    FIELDS = {
        "slice_dim": _f(1, "uint32", default=1),
        "slice_point": _f(2, "uint32", True),
        "axis": _f(3, "int32", default=1),
    }


class ArgMaxParameter(_Proto2):
    FIELDS = {
        "out_max_val": _f(1, "bool", default=False),
        "top_k": _f(2, "uint32", default=1),
        "axis": _f(3, "int32"),
    }


class LayerParameter(_Proto2):
    FIELDS = {
        "name": _f(1, "string"),
        "type": _f(2, "string"),
        "bottom": _f(3, "string", True),
        "top": _f(4, "string", True),
        "blobs": _f(7, "message", True, BlobProto),
        "argmax_param": _f(103, "message", False, ArgMaxParameter),
        "batch_norm_param": _f(139, "message", False, BatchNormParameter),
        "concat_param": _f(104, "message", False, ConcatParameter),
        "convolution_param": _f(106, "message", False, ConvolutionParameter),
        "dropout_param": _f(108, "message", False, DropoutParameter),
        "eltwise_param": _f(110, "message", False, EltwiseParameter),
        "elu_param": _f(140, "message", False, ELUParameter),
        "flatten_param": _f(135, "message", False, FlattenParameter),
        "inner_product_param": _f(117, "message", False, InnerProductParameter),
        "input_param": _f(143, "message", False, InputParameter),
        "lrn_param": _f(118, "message", False, LRNParameter),
        "pooling_param": _f(121, "message", False, PoolingParameter),
        "power_param": _f(122, "message", False, PowerParameter),
        "relu_param": _f(123, "message", False, ReLUParameter),
        "reshape_param": _f(133, "message", False, ReshapeParameter),
        "scale_param": _f(142, "message", False, ScaleParameter),
        "slice_param": _f(126, "message", False, SliceParameter),
        "softmax_param": _f(125, "message", False, SoftmaxParameter),
    }


class NetParameter(_Proto2):
    FIELDS = {
        "name": _f(1, "string"),
        "input": _f(3, "string", True),
        "input_dim": _f(4, "int32", True),
        "input_shape": _f(8, "message", True, BlobShape),
        "layer": _f(100, "message", True, LayerParameter),
    }


register(BlobShape, BlobProto, InputParameter, ConvolutionParameter, PoolingParameter,
         InnerProductParameter, ReLUParameter, ELUParameter, SoftmaxParameter,
         BatchNormParameter, ScaleParameter, EltwiseParameter, ConcatParameter,
         DropoutParameter, ReshapeParameter, FlattenParameter, PowerParameter, LRNParameter,
         SliceParameter, ArgMaxParameter, LayerParameter, NetParameter)


def load_prototxt(text) -> NetParameter:
    """A deploy prototxt (text format) as a NetParameter; unknown fields and
    blocks (fillers, phases, include rules) skipped."""
    return parse_text(text, NetParameter(), allow_unknown_field=True)
