"""Public custom-op (plugin) registration.

Counterpart of the JAX package's `plugin.py`: a user registers a converter
for an op a frontend does not know, or, with `override=True`, replaces a
built-in one. The converter returns tensors; the "kernel" half is whatever
it calls: PyTorch ops, or a CUDA kernel of one's own, as
`kernels/softshrink.py` backs the example op `MnnTpuSoftShrink` (README,
"Custom ops"). Converter signatures, as in the built-in tables (the JAX
tables' with the port's context in front):

    def my_op(ctx, node, *inputs):           # onnx, tf, tflite
        ...
        return output            # or a tuple for multi-output ops

    def my_layer(ctx, layer, blobs, *inputs):   # caffe
        ...

`node` is the frontend's node object: an `onnx_pb2.NodeProto`, a
`graphdef_pb2.NodeDef` (its `attr` a dict of AttrValue), the TFLite
frontend's operator record (`op.code`, `op.opt_i(field)` and the other
option readers), or a `caffe_pb2.LayerParameter` with its weight blobs as
tensors. Tables are keyed by op type, NodeDef op, builtin operator code
(an int) and layer type. `ctx.device` is the device the converted function
runs on and `ctx.t(v)` puts a value there. Registrations apply process
wide, before conversion.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

_FRONTENDS = ("onnx", "tf", "tflite", "caffe")


def _table(frontend: str) -> Dict:
    if frontend == "onnx":
        from mnn_tpu_torch.convert import onnx_frontend as m
    elif frontend == "tf":
        from mnn_tpu_torch.convert import tf_frontend as m
    elif frontend == "tflite":
        from mnn_tpu_torch.convert import tflite_frontend as m
    elif frontend == "caffe":
        from mnn_tpu_torch.convert import caffe_frontend as m

        return m._LAYERS
    else:
        raise ValueError(f"unknown frontend {frontend!r}; one of {_FRONTENDS}")
    return m._OPS


def register_op(op_type: Union[str, int], fn: Callable, *, frontend: str = "onnx",
                override: bool = False) -> None:
    """Register `fn` as the converter for `op_type` in a frontend. Refuses
    to shadow a built-in converter unless `override=True`."""
    table = _table(frontend)
    if op_type in table and not override:
        raise ValueError(
            f"{frontend} op {op_type!r} already registered; pass "
            "override=True to replace the built-in converter")
    table[op_type] = fn


def unregister_op(op_type: Union[str, int], *, frontend: str = "onnx") -> None:
    _table(frontend).pop(op_type, None)


def registered_ops(frontend: str = "onnx") -> List[Union[str, int]]:
    """Sorted op names the frontend currently converts (built-in + plugins)."""
    return sorted(_table(frontend))
