"""Public custom-op (plugin) registration.

Counterpart of the JAX package's `plugin.py`: a user registers a converter
for an op a frontend does not know, or, with `override=True`, replaces a
built-in one. The converter returns tensors; the "kernel" half is whatever
it calls: PyTorch ops, or a CUDA kernel of one's own, as
`kernels/softshrink.py` backs the example op `MnnTpuSoftShrink` (README,
"Custom ops"). Converter signature, as in the built-in tables:

    def my_op(ctx, node, *inputs):
        ...
        return output            # or a tuple for multi-output ops

`node` is the frontend's node object (an `onnx_pb2.NodeProto`); `ctx.device`
is the device the converted function runs on. Registrations apply process
wide, before conversion. Only the ONNX frontend is ported: the TF, TFLite
and Caffe tables raise `NotImplementedError` until ROADMAP Q1.12b.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_FRONTENDS = ("onnx", "tf", "tflite", "caffe")


def _table(frontend: str) -> Dict[str, Callable]:
    if frontend == "onnx":
        from mnn_tpu_torch.convert import onnx_frontend as m

        return m._OPS
    if frontend in ("tf", "tflite", "caffe"):
        raise NotImplementedError(
            f"the {frontend} frontend is not ported yet (ROADMAP Q1.12b: TF, TFLite "
            "and Caffe); only 'onnx' takes plugins")
    raise ValueError(f"unknown frontend {frontend!r}; one of {_FRONTENDS}")


def register_op(op_type: str, fn: Callable, *, frontend: str = "onnx",
                override: bool = False) -> None:
    """Register `fn` as the converter for `op_type` in a frontend. Refuses
    to shadow a built-in converter unless `override=True`."""
    table = _table(frontend)
    if op_type in table and not override:
        raise ValueError(
            f"{frontend} op {op_type!r} already registered; pass "
            "override=True to replace the built-in converter")
    table[op_type] = fn


def unregister_op(op_type: str, *, frontend: str = "onnx") -> None:
    _table(frontend).pop(op_type, None)


def registered_ops(frontend: str = "onnx") -> List[str]:
    """Sorted op names the frontend currently converts (built-in + plugins)."""
    return sorted(_table(frontend))
