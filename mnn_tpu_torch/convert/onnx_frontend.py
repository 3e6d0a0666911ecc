"""ONNX -> function graph converter.

Counterpart of the JAX package's `convert/onnx_frontend.py`: parses a
ModelProto with the port's own wire codec (`onnx_pb2`, no `google.protobuf`)
and lowers the graph through an op table (`_OPS`, the same 129 names) onto
PyTorch and `ops/nn_ops.py`, giving `fn(params, *inputs)` and `params`.

Static and dynamic values, as in the JAX package: integer initializers,
`Constant`s and `Shape` chains stay numpy on the host and fold to concrete
values (`_is_static`, `_static_ints`), so Reshape / Slice / Expand / Pad
read their shapes with no device round trip. Float initializers are the
`params` tensors on the device; graph inputs are tensors (a numpy input
stays static). Where a static value meets a tensor it moves to the tensor's
device as JAX holds it without 64-bit mode: float64 as f32, int64 as int32
(`_Ctx.t`). Values that JAX computes on the device come out in JAX's dtypes:
ArgMax / ArgMin / TopK indices and `Cast` to INT64 as int32, `Cast` to
DOUBLE as f32. NonMaxSuppression returns its [K, 3] int64 selection as
numpy, as the JAX frontend does (its length depends on the data).

Control flow. `If` with a static condition runs one branch; with a tensor
condition (JAX's `lax.cond`) it reads the scalar condition to the host once
and runs the chosen branch eagerly. `Loop` takes a static trip count only
(a tensor or a body-computed condition raises, as in JAX) and stacks the
scan outputs; `Scan` loops over axis 0 of its scan inputs in the given
directions. `GridSample` and `RoiAlign` keep the JAX package's own bilinear
gather (`_bilinear_gather`); `Resize` / `Upsample` go through
`nn_ops.resize_*` (`jax.image.resize`'s weights); `QuantizeLinear` divides
by the scale (a device tensor, so the card divides and does not multiply
by a reciprocal).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.convert import onnx_pb2 as O
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.ops import nn_ops as N

_DTYPES = {
    O.TensorProto.FLOAT: np.float32,
    O.TensorProto.UINT8: np.uint8,
    O.TensorProto.INT8: np.int8,
    O.TensorProto.INT16: np.int16,
    O.TensorProto.INT32: np.int32,
    O.TensorProto.INT64: np.int64,
    O.TensorProto.BOOL: np.bool_,
    O.TensorProto.FLOAT16: np.float16,
    O.TensorProto.DOUBLE: np.float64,
    O.TensorProto.UINT32: np.uint32,
    O.TensorProto.UINT64: np.uint64,
}
# a value on the device, as JAX holds it without 64-bit mode
_NARROW = {np.dtype(np.float64): np.dtype(np.float32), np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32)}
_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
          np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
          np.dtype(np.bool_): torch.bool, np.dtype(np.uint32): torch.uint32}


def tensor_to_np(t: "O.TensorProto") -> np.ndarray:
    """Decode a TensorProto (raw_data or typed repeated fields)."""
    if t.data_type == O.TensorProto.BFLOAT16:
        import ml_dtypes

        raw = np.frombuffer(t.raw_data, dtype=np.uint16)
        return raw.view(ml_dtypes.bfloat16).reshape(tuple(t.dims)).copy()
    dt = _DTYPES.get(t.data_type)
    if dt is None:
        raise NotImplementedError(f"onnx tensor dtype {t.data_type}")
    shape = tuple(t.dims)
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dt).reshape(shape).copy()
    field = {
        np.float32: t.float_data, np.float64: t.double_data,
        np.int64: t.int64_data, np.uint64: t.uint64_data,
    }.get(dt, t.int32_data)
    return np.asarray(list(field), dtype=dt).reshape(shape)


def _torch_dtype(dt) -> torch.dtype:
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return torch.bfloat16
    return _TORCH[_NARROW.get(dt, dt)]


def _to_torch(a, device) -> torch.Tensor:
    """A static value as a tensor on `device`, narrowed as JAX narrows it."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, dtype=_NARROW.get(a.dtype, a.dtype))).to(device)


def _np(v) -> np.ndarray:
    """A value on the host (a tensor is read back), for attributes that
    the JAX frontend reads with np.asarray."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16 \
            else v.detach().cpu().numpy()
    return np.asarray(v)


def _attrs(node: "O.NodeProto") -> Dict[str, Any]:
    out = {}
    for a in node.attribute:
        if a.type == O.AttributeProto.FLOAT:
            out[a.name] = a.f
        elif a.type == O.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == O.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == O.AttributeProto.TENSOR:
            out[a.name] = tensor_to_np(a.t)
        elif a.type == O.AttributeProto.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == O.AttributeProto.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == O.AttributeProto.STRINGS:
            out[a.name] = [s.decode() for s in a.strings]
        elif a.type == O.AttributeProto.GRAPH:
            out[a.name] = a.g
        elif a.type == O.AttributeProto.GRAPHS:
            out[a.name] = list(a.graphs)
        else:
            out[a.name] = None
    return out


def _is_static(v) -> bool:
    if isinstance(v, (list, tuple)):
        return all(_is_static(x) for x in v)
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _static_ints(v, what: str) -> np.ndarray:
    if not _is_static(v):
        raise NotImplementedError(
            f"onnx frontend: {what} must be statically known (shape-compute "
            "chains fold to numpy; a runtime-data-dependent value reached it)")
    return np.asarray(v).astype(np.int64)


def _dims(x, axes) -> tuple:
    return tuple(range(x.dim())) if axes is None else tuple(a % x.dim() for a in axes)


def _permute(x, axes):
    return x.transpose(axes) if isinstance(x, np.ndarray) else x.permute(axes)


# -- op table ----------------------------------------------------------------

_OPS: Dict[str, Callable] = {}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _binary(fn):
    """numpy when both operands are static (shape-compute folding), else
    tensors on the device."""
    def impl(ctx, node, a, b):
        if _is_static(a) and _is_static(b):
            return fn(a, b)
        return fn(ctx.t(a), ctx.t(b))
    return impl


def _fold(fn_np, fn_t):
    """A variadic op (Min, Max, Sum): numpy over static operands, else a
    left fold over tensors."""
    def impl(ctx, node, *xs):
        if all(_is_static(v) for v in xs):
            return functools.reduce(fn_np, xs)
        return functools.reduce(fn_t, [ctx.t(v) for v in xs])
    return impl


_OPS["Add"] = _binary(lambda a, b: a + b)
_OPS["Sub"] = _binary(lambda a, b: a - b)
_OPS["Mul"] = _binary(lambda a, b: a * b)
_OPS["Div"] = _binary(lambda a, b: a / b)
_OPS["Pow"] = _binary(lambda a, b: a ** b)
_OPS["Greater"] = _binary(lambda a, b: a > b)
_OPS["Less"] = _binary(lambda a, b: a < b)
_OPS["Equal"] = _binary(lambda a, b: a == b)
_OPS["Min"] = _fold(np.minimum, torch.minimum)
_OPS["Max"] = _fold(np.maximum, torch.maximum)
_OPS["And"] = _binary(lambda a, b: a & b)
_OPS["Or"] = _binary(lambda a, b: a | b)


def _unary(f):
    """A JAX `jnp` function: its result is on the device even for a static
    input."""
    return lambda ctx, node, x: f(ctx.t(x))


for name, f in {
    "Relu": F.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
    "Exp": torch.exp, "Log": torch.log, "Sqrt": torch.sqrt,
    "Abs": torch.abs, "Floor": torch.floor, "Ceil": torch.ceil,
    "Erf": torch.special.erf, "Softplus": N.softplus,
    "Not": torch.logical_not, "Round": torch.round, "Sin": torch.sin,
    "Cos": torch.cos, "Sign": torch.sign,
    "Mish": lambda x: x * torch.tanh(N.softplus(x)),
}.items():
    _OPS[name] = _unary(f)
# Python operators in the JAX frontend: a static input stays static
_OPS["Neg"] = lambda ctx, node, x: -x
_OPS["Identity"] = lambda ctx, node, x: x
_OPS["Reciprocal"] = lambda ctx, node, x: 1.0 / x


@op("Gelu")
def _gelu(ctx, node, x):
    return N.gelu(ctx.t(x), approximate=_attrs(node).get("approximate") == "tanh")


@op("LeakyRelu")
def _leaky(ctx, node, x):
    return F.leaky_relu(ctx.t(x), _attrs(node).get("alpha", 0.01))


@op("Elu")
def _elu(ctx, node, x):
    return F.elu(ctx.t(x), _attrs(node).get("alpha", 1.0))


@op("HardSigmoid")
def _hardsigmoid(ctx, node, x):
    a = _attrs(node)
    return torch.clamp(ctx.t(x) * a.get("alpha", 0.2) + a.get("beta", 0.5), 0, 1)


@op("HardSwish")
def _hardswish(ctx, node, x):
    return F.hardswish(ctx.t(x))


@op("PRelu")
def _prelu(ctx, node, x, slope):
    x = ctx.t(x)
    return torch.where(x >= 0, x, x * ctx.t(slope))


@op("Clip")
def _clip(ctx, node, x, lo=None, hi=None):
    a = _attrs(node)
    lo = a.get("min") if lo is None else lo
    hi = a.get("max") if hi is None else hi
    x = ctx.t(x)
    if lo is not None:
        x = torch.maximum(x, ctx.t(lo) if not isinstance(lo, float)
                          else torch.tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, ctx.t(hi) if not isinstance(hi, float)
                          else torch.tensor(hi, dtype=x.dtype, device=x.device))
    return x


@op("Softmax")
def _softmax(ctx, node, x):
    return torch.softmax(ctx.t(x), dim=_attrs(node).get("axis", -1))


@op("LogSoftmax")
def _logsoftmax(ctx, node, x):
    return torch.log_softmax(ctx.t(x), dim=_attrs(node).get("axis", -1))


@op("MatMul")
def _matmul(ctx, node, a, b):
    return torch.matmul(ctx.t(a), ctx.t(b))


@op("Gemm")
def _gemm(ctx, node, a, b, c=None):
    at = _attrs(node)
    a, b = ctx.t(a), ctx.t(b)
    if at.get("transA"):
        a = a.T
    if at.get("transB"):
        b = b.T
    y = torch.matmul(a, b) * at.get("alpha", 1.0)
    if c is not None:
        y = y + ctx.t(c) * at.get("beta", 1.0)
    return y


@op("Einsum")
def _einsum(ctx, node, *xs):
    return torch.einsum(_attrs(node)["equation"], *[ctx.t(x) for x in xs])


def _conv_prepad(x, pads, auto_pad, kshape, strides, dilations):
    """Resolve onnx pads / auto_pad; returns (x, symmetric pad tuple). An
    asymmetric or SAME pad is applied here with zeros, as the JAX frontend
    applies it."""
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        in_h, in_w = x.shape[2], x.shape[3]
        pad = []
        for i, dim in enumerate((in_h, in_w)):
            out = -(-dim // strides[i])
            eff = (kshape[i] - 1) * dilations[i] + 1
            total = max(0, (out - 1) * strides[i] + eff - dim)
            lo = total // 2 if auto_pad == "SAME_UPPER" else total - total // 2
            pad.append((lo, total - lo))
        return F.pad(x, (*pad[1], *pad[0])), (0, 0)
    if pads is None:
        return x, (0, 0)
    ph0, pw0, ph1, pw1 = (list(pads) + [0] * 4)[:4]
    if ph0 == ph1 and pw0 == pw1:
        return x, (ph0, pw0)
    return F.pad(x, (pw0, pw1, ph0, ph1)), (0, 0)


@op("Conv")
def _conv(ctx, node, x, w, b=None):
    at = _attrs(node)
    strides = at.get("strides", [1, 1])
    dilations = at.get("dilations", [1, 1])
    kshape = at.get("kernel_shape", list(w.shape[2:]))
    if len(kshape) == 1:  # Conv1d via 2d
        y = _conv(ctx, _node1d_to_2d(node), x[..., None], w[..., None], b)
        return y[..., 0]
    x, pad = _conv_prepad(ctx.t(x), at.get("pads"), at.get("auto_pad", "NOTSET"),
                          kshape, strides, dilations)
    return N.conv2d(x, ctx.t(w), None if b is None else ctx.t(b), stride=tuple(strides),
                    padding=pad, dilation=tuple(dilations), groups=at.get("group", 1))


def _node1d_to_2d(node):
    n = O.NodeProto()
    n.CopyFrom(node)
    for a in n.attribute:
        if a.name in ("strides", "dilations", "kernel_shape"):
            a.ints.append(1)
        elif a.name == "pads" and len(a.ints) == 2:
            p = list(a.ints)
            del a.ints[:]
            a.ints.extend([p[0], 0, p[1], 0])
    return n


def conv_transpose2d_nchw(x, w, *, strides=(1, 1), pads=(0, 0, 0, 0),
                          output_padding=(0, 0), groups=1, dilation=(1, 1)):
    """Exact ConvTranspose (torch/onnx/caffe semantics), any pads: the
    unpadded transposed convolution, cropped by (pad begin, pad end) and
    extended by output_padding (zeros past the full result).

    x [N, Cin, H, W]; w [Cin, Cout/groups, kH, kW]. out = (in-1)*s - p0 - p1
    + d*(k-1) + 1 + opad."""
    y = F.conv_transpose2d(x, w, stride=tuple(strides), groups=groups, dilation=tuple(dilation))
    ph0, pw0, ph1, pw1 = (list(pads) + [0] * 4)[:4]
    h_full, w_full = y.shape[2], y.shape[3]
    h_end = h_full - ph1 + output_padding[0]
    w_end = w_full - pw1 + output_padding[1]
    y = y[:, :, ph0:min(h_end, h_full), pw0:min(w_end, w_full)]
    if h_end > h_full or w_end > w_full:
        y = F.pad(y, (0, max(w_end - w_full, 0), 0, max(h_end - h_full, 0)))
    return y


@op("ConvTranspose")
def _conv_transpose(ctx, node, x, w, b=None):
    at = _attrs(node)
    y = conv_transpose2d_nchw(
        ctx.t(x), ctx.t(w),
        strides=tuple(at.get("strides", [1, 1])),
        pads=tuple(at.get("pads", [0, 0, 0, 0])),
        output_padding=tuple(at.get("output_padding", [0, 0])),
        groups=at.get("group", 1),
        dilation=tuple(at.get("dilations", [1, 1])),
    )
    if b is not None:
        y = y + ctx.t(b)[None, :, None, None]
    return y


@op("MaxPool")
def _maxpool(ctx, node, x):
    at = _attrs(node)
    ks = at["kernel_shape"]
    x, pad = _conv_prepad(ctx.t(x), at.get("pads"), at.get("auto_pad", "NOTSET"),
                          ks, at.get("strides", ks), [1, 1])
    return N.max_pool2d(x, tuple(ks), tuple(at.get("strides", ks)), pad,
                        ceil_mode=bool(at.get("ceil_mode", 0)))


@op("AveragePool")
def _avgpool(ctx, node, x):
    at = _attrs(node)
    ks = at["kernel_shape"]
    x, pad = _conv_prepad(ctx.t(x), at.get("pads"), at.get("auto_pad", "NOTSET"),
                          ks, at.get("strides", ks), [1, 1])
    return N.avg_pool2d(x, tuple(ks), tuple(at.get("strides", ks)), pad)


@op("GlobalAveragePool")
def _gap(ctx, node, x):
    return N.global_avg_pool(ctx.t(x))


@op("GlobalMaxPool")
def _gmp(ctx, node, x):
    return torch.amax(ctx.t(x), dim=(2, 3), keepdim=True)


@op("BatchNormalization")
def _bn(ctx, node, x, scale, bias, mean, var):
    return N.batch_norm(ctx.t(x), ctx.t(mean), ctx.t(var), ctx.t(scale), ctx.t(bias),
                        eps=_attrs(node).get("epsilon", 1e-5))


def _normalize(x, axes, eps):
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


@op("LayerNormalization")
def _ln(ctx, node, x, scale, bias=None):
    at = _attrs(node)
    x = ctx.t(x)
    axes = tuple(range(at.get("axis", -1) % x.dim(), x.dim()))
    y = _normalize(x, axes, at.get("epsilon", 1e-5)) * ctx.t(scale)
    return y + ctx.t(bias) if bias is not None else y


@op("InstanceNormalization")
def _in(ctx, node, x, scale, bias):
    x = ctx.t(x)
    sh = (1, -1) + (1,) * (x.dim() - 2)
    y = _normalize(x, tuple(range(2, x.dim())), _attrs(node).get("epsilon", 1e-5))
    return y * ctx.t(scale).reshape(sh) + ctx.t(bias).reshape(sh)


@op("Reshape")
def _reshape(ctx, node, x, shape=None):
    shape = _static_ints(shape if shape is not None else _attrs(node)["shape"], "Reshape shape")
    tgt = [x.shape[i] if s == 0 else s for i, s in enumerate(shape.tolist())]
    return x.reshape(tuple(tgt))


@op("Flatten")
def _flatten(ctx, node, x):
    x = ctx.t(x)
    ax = _attrs(node).get("axis", 1) % (x.dim() + 1)
    lead = int(np.prod(x.shape[:ax])) if ax else 1
    return x.reshape(lead, -1)


@op("Transpose")
def _transpose(ctx, node, x):
    x = ctx.t(x)
    return x.permute(_attrs(node).get("perm") or list(range(x.dim()))[::-1])


@op("Concat")
def _concat(ctx, node, *xs):
    axis = _attrs(node)["axis"]
    if all(_is_static(v) for v in xs):
        return np.concatenate(xs, axis=axis)
    return torch.cat([ctx.t(v) for v in xs], dim=axis)


@op("Split")
def _split(ctx, node, x, split=None):
    at = _attrs(node)
    axis = at.get("axis", 0)
    split = split if split is not None else at.get("split")
    x = ctx.t(x)
    if split is None:
        return tuple(torch.tensor_split(x, len(node.output), dim=axis))
    sizes = _static_ints(split, "Split sizes").tolist()
    return tuple(torch.tensor_split(x, np.cumsum(sizes)[:-1].tolist(), dim=axis))


@op("Slice")
def _slice(ctx, node, x, starts=None, ends=None, axes=None, steps=None):
    at = _attrs(node)
    starts = _static_ints(starts if starts is not None else at["starts"], "Slice starts").tolist()
    ends = _static_ints(ends if ends is not None else at["ends"], "Slice ends").tolist()
    axes = (_static_ints(axes, "Slice axes").tolist() if axes is not None
            else at.get("axes") or list(range(len(starts))))
    steps = (_static_ints(steps, "Slice steps").tolist() if steps is not None
             else [1] * len(starts))
    if isinstance(x, np.ndarray) or not any(st < 0 for st in steps):
        sl = [slice(None)] * x.ndim
        for s, e, a, st in zip(starts, ends, axes, steps):
            sl[a % x.ndim] = slice(int(s), int(e), int(st))
        return x[tuple(sl)]
    for s, e, a, st in zip(starts, ends, axes, steps):   # a negative step: gather
        a = a % x.dim()
        idx = range(*slice(int(s), int(e), int(st)).indices(x.shape[a]))
        x = x.index_select(a, torch.tensor(list(idx), dtype=torch.long, device=x.device))
    return x


@op("Squeeze")
def _squeeze(ctx, node, x, axes=None):
    axes = axes if axes is not None else _attrs(node).get("axes")
    if axes is None:
        return x.squeeze()
    axes = tuple(int(a) for a in _static_ints(axes, "Squeeze axes"))
    return np.squeeze(x, axis=axes) if isinstance(x, np.ndarray) else x.squeeze(axes)


@op("Unsqueeze")
def _unsqueeze(ctx, node, x, axes=None):
    axes = _static_ints(axes if axes is not None else _attrs(node)["axes"], "Unsqueeze axes")
    for a in sorted(int(v) for v in axes):
        x = np.expand_dims(x, a) if _is_static(x) else x.unsqueeze(a)
    return x


def _index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Indices as int64 with negative ones counted from the end."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx)


@op("Gather")
def _gather(ctx, node, x, idx):
    axis = _attrs(node).get("axis", 0)
    if _is_static(x) and _is_static(idx):
        return np.take(x, idx, axis=axis)
    x, idx = ctx.t(x), ctx.t(idx)
    axis %= x.dim()
    flat = _index(idx, x.shape[axis]).reshape(-1)
    return x.index_select(axis, flat).reshape(
        tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))


@op("GatherElements")
def _gather_elements(ctx, node, x, idx):
    x = ctx.t(x)
    axis = _attrs(node).get("axis", 0) % x.dim()
    return torch.gather(x, axis, _index(ctx.t(idx), x.shape[axis]))


@op("Shape")
def _shape(ctx, node, x):
    return np.asarray(tuple(x.shape), np.int64)


@op("Size")
def _size(ctx, node, x):
    return np.asarray(int(np.prod(tuple(x.shape))), np.int64)


@op("Cast")
def _cast(ctx, node, x):
    to = _DTYPES[_attrs(node)["to"]]
    if _is_static(x):
        return np.asarray(x).astype(to)
    return x.to(_torch_dtype(to))


@op("Constant")
def _constant(ctx, node):
    at = _attrs(node)
    if "value" in at:
        return at["value"]
    for k in ("value_float", "value_int"):
        if k in at:
            return np.asarray(at[k])
    if "value_floats" in at:
        return np.asarray(at["value_floats"], np.float32)
    if "value_ints" in at:
        return np.asarray(at["value_ints"], np.int64)
    raise NotImplementedError("Constant without value")


@op("ConstantOfShape")
def _const_of_shape(ctx, node, shape):
    val = _attrs(node).get("value")
    fill = val.reshape(-1)[0] if val is not None else np.float32(0)
    return np.full(tuple(_static_ints(shape, "ConstantOfShape")), fill)


@op("Range")
def _range(ctx, node, start, limit, delta):
    if all(_is_static(v) for v in (start, limit, delta)):
        return np.arange(int(start), int(limit), int(delta), np.int64)
    start = ctx.t(start)
    return torch.arange(start.item(), _np(limit).item(), _np(delta).item(),
                        dtype=start.dtype, device=start.device)


@op("Expand")
def _expand(ctx, node, x, shape):
    tgt = _static_ints(shape, "Expand shape").tolist()
    # onnx Expand uses numpy broadcasting with 1s allowed on either side
    full = list(x.shape)
    while len(full) < len(tgt):
        full.insert(0, 1)
    out = [max(a, b) for a, b in zip(full, tgt)]
    if _is_static(x):
        return np.broadcast_to(np.reshape(x, full), out)
    return x.reshape(full).expand(out)


@op("Tile")
def _tile(ctx, node, x, reps):
    reps = tuple(_static_ints(reps, "Tile reps").tolist())
    return np.tile(x, reps) if _is_static(x) else torch.tile(x, reps)


@op("Where")
def _where(ctx, node, c, a, b):
    if all(_is_static(v) for v in (c, a, b)):
        return np.where(c, a, b)
    return torch.where(ctx.t(c).bool(), ctx.t(a), ctx.t(b))


@op("Pad")
def _pad(ctx, node, x, pads=None, value=None):
    at = _attrs(node)
    pads = _static_ints(pads if pads is not None else at["pads"], "Pad pads").tolist()
    mode = at.get("mode", "constant")
    x = ctx.t(x)
    n = x.dim()
    cfg = [(pads[i], pads[i + n]) for i in range(n)]
    if mode == "constant":
        cv = float(_np(value).reshape(-1)[0]) if value is not None else at.get("value", 0.0)
        return F.pad(x, [p for lo_hi in reversed(cfg) for p in lo_hi], value=cv)
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for a, (lo, hi) in enumerate(cfg):     # numpy's index map of the mode, axis by axis
        if lo or hi:
            idx = np.pad(np.arange(x.shape[a]), (lo, hi), mode=np_mode)
            x = x.index_select(a, torch.from_numpy(idx).to(x.device))
    return x


def _int_sum(x, dims, keep):
    """jnp.sum's dtype: an integer (or bool) sum stays int32, not int64."""
    dt = x.dtype if not x.is_floating_point() and x.dtype != torch.bool else None
    return torch.sum(x, dim=dims, keepdim=keep, dtype=torch.int32 if x.dtype == torch.bool
                     else dt)


def _prod(x, dims, keep):
    dt = None if x.is_floating_point() else (torch.int32 if x.dtype == torch.bool else x.dtype)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep, dtype=dt)
    return x


def _mean(x, dims, keep):
    return torch.mean(x if x.is_floating_point() else x.float(), dim=dims, keepdim=keep)


def _reduce(fn):
    def impl(ctx, node, x, axes=None):
        at = _attrs(node)
        if axes is None:
            axes = at.get("axes")
        if axes is not None:
            axes = tuple(int(a) for a in _static_ints(axes, "Reduce axes"))
        keep = bool(at.get("keepdims", 1))
        x = ctx.t(x)
        dims = _dims(x, axes)
        if not dims:      # jnp reduces over no axis: each element alone
            x, dims, keep = x.unsqueeze(-1), (x.dim(),), False
        return fn(x, dims, keep)
    return impl


_OPS["ReduceMean"] = _reduce(_mean)
_OPS["ReduceSum"] = _reduce(_int_sum)
_OPS["ReduceMax"] = _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_OPS["ReduceMin"] = _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_OPS["ReduceProd"] = _reduce(_prod)
_OPS["ReduceL2"] = _reduce(lambda x, d, k: torch.sqrt(_int_sum(x * x, d, k)))


def _arg(fn):
    def impl(ctx, node, x):
        at = _attrs(node)
        axis = at.get("axis", 0)
        y = fn(ctx.t(x), dim=axis)
        if at.get("keepdims", 1):
            y = y.unsqueeze(axis)
        return y.to(torch.int32)            # JAX's int64 without 64-bit mode
    return impl


_OPS["ArgMax"] = _arg(torch.argmax)


@op("TopK")
def _topk(ctx, node, x, k):
    kk = int(_static_ints(k, "TopK k").reshape(-1)[0])
    x = ctx.t(x)
    if _attrs(node).get("axis", -1) not in (-1, x.dim() - 1):
        raise NotImplementedError("TopK on non-last axis")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)   # ties: lower index first
    return vals[..., :kk], idx[..., :kk].to(torch.int32)


@op("Resize")
def _resize(ctx, node, x, roi=None, scales=None, sizes=None):
    at = _attrs(node)
    mode = at.get("mode", "nearest")
    x = ctx.t(x)
    if sizes is not None and np.size(_np(sizes)):
        hw = _static_ints(sizes, "Resize sizes").tolist()[2:]
    else:
        sc = _np(scales).astype(np.float64).reshape(-1)
        hw = [int(round(x.shape[2] * sc[2])), int(round(x.shape[3] * sc[3]))]
    if mode == "nearest":
        return N.resize_nearest(x, tuple(hw))
    align = at.get("coordinate_transformation_mode", "half_pixel") == "align_corners"
    return N.resize_bilinear(x, tuple(hw), align_corners=align)


@op("Dropout")
def _dropout(ctx, node, x, *rest):
    return x  # inference


@op("Upsample")
def _upsample(ctx, node, x, scales=None):
    at = _attrs(node)
    sc = _np(scales if scales is not None else at["scales"]).astype(np.float64).reshape(-1)
    x = ctx.t(x)
    hw = (int(x.shape[2] * sc[2]), int(x.shape[3] * sc[3]))
    if at.get("mode", "nearest") == "nearest":
        return N.resize_nearest(x, hw)
    return N.resize_bilinear(x, hw)


# -- breadth ops -------------------------------------------------------------

for name, f in {
    "Tan": torch.tan, "Atan": torch.atan, "Asin": torch.asin,
    "Acos": torch.acos, "Sinh": torch.sinh, "Cosh": torch.cosh,
    "Asinh": torch.asinh, "Acosh": torch.acosh, "Atanh": torch.atanh,
    "IsNaN": torch.isnan, "Softsign": lambda x: x / (torch.abs(x) + 1),
}.items():
    _OPS[name] = _unary(f)

_OPS["Mod"] = _binary(lambda a, b: a % b)
_OPS["Xor"] = _binary(lambda a, b: a ^ b)
_OPS["Sum"] = _fold(lambda a, b: a + b, lambda a, b: a + b)


@op("Mean")
def _mean_op(ctx, node, *xs):
    return _OPS["Sum"](ctx, node, *xs) / len(xs)


_OPS["ReduceL1"] = _reduce(lambda x, d, k: _int_sum(torch.abs(x), d, k))
_OPS["ReduceSumSquare"] = _reduce(lambda x, d, k: _int_sum(x * x, d, k))
_OPS["ReduceLogSum"] = _reduce(lambda x, d, k: torch.log(_int_sum(x, d, k)))
_OPS["ReduceLogSumExp"] = _reduce(lambda x, d, k: torch.logsumexp(x, dim=d, keepdim=k))


@op("Selu")
def _selu(ctx, node, x):
    at = _attrs(node)
    a = at.get("alpha", 1.6732632)
    g = at.get("gamma", 1.050701)
    x = ctx.t(x)
    return g * torch.where(x > 0, x, a * (torch.exp(x) - 1.0))


@op("Celu")
def _celu(ctx, node, x):
    a = _attrs(node).get("alpha", 1.0)
    x = ctx.t(x)
    return torch.clamp(x, min=0) + torch.clamp(a * (torch.exp(x / a) - 1.0), max=0)


@op("ThresholdedRelu")
def _thresholded_relu(ctx, node, x):
    a = _attrs(node).get("alpha", 1.0)
    x = ctx.t(x)
    return torch.where(x > a, x, torch.zeros_like(x))


@op("Shrink")
def _shrink(ctx, node, x):
    at = _attrs(node)
    lam = at.get("lambd", 0.5)
    bias = at.get("bias", 0.0)
    x = ctx.t(x)
    return torch.where(x < -lam, x + bias, torch.where(x > lam, x - bias, torch.zeros_like(x)))


@op("Hardmax")
def _hardmax(ctx, node, x):
    x = ctx.t(x)
    ax = _attrs(node).get("axis", -1) % x.dim()
    oh = F.one_hot(torch.argmax(x, dim=ax), x.shape[ax]).to(x.dtype)
    return oh.movedim(-1, ax)


_OPS["ArgMin"] = _arg(torch.argmin)


@op("CumSum")
def _cumsum(ctx, node, x, axis):
    ax = int(_static_ints(axis, "CumSum axis").reshape(-1)[0])
    at = _attrs(node)
    x = ctx.t(x)
    dt = x.dtype if x.is_floating_point() else torch.int32
    y = torch.cumsum(torch.flip(x, (ax,)) if at.get("reverse") else x, dim=ax, dtype=dt)
    if at.get("exclusive"):
        y = torch.roll(y, 1, dims=ax)
        idx = [slice(None)] * y.dim()
        idx[ax] = 0
        y[tuple(idx)] = 0
    return torch.flip(y, (ax,)) if at.get("reverse") else y


@op("DepthToSpace")
def _depth_to_space(ctx, node, x):
    at = _attrs(node)
    bs = int(at["blocksize"])
    n, c, h, w = x.shape
    if at.get("mode", "DCR") == "DCR":
        y = _permute(x.reshape(n, bs, bs, c // (bs * bs), h, w), (0, 3, 4, 1, 5, 2))
    else:  # CRD
        y = _permute(x.reshape(n, c // (bs * bs), bs, bs, h, w), (0, 1, 4, 2, 5, 3))
    return y.reshape(n, c // (bs * bs), h * bs, w * bs)


@op("SpaceToDepth")
def _space_to_depth(ctx, node, x):
    bs = int(_attrs(node)["blocksize"])
    n, c, h, w = x.shape
    y = _permute(x.reshape(n, c, h // bs, bs, w // bs, bs), (0, 3, 5, 1, 2, 4))
    return y.reshape(n, c * bs * bs, h // bs, w // bs)


@op("LRN")
def _lrn(ctx, node, x):
    at = _attrs(node)
    size = int(at["size"])
    alpha = at.get("alpha", 1e-4)
    beta = at.get("beta", 0.75)
    bias = at.get("bias", 1.0)
    x = ctx.t(x)
    half = size // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    acc = sum(pad[:, i:i + x.shape[1]] for i in range(size))
    return x / (bias + (alpha / size) * acc) ** beta


@op("EyeLike")
def _eyelike(ctx, node, x):
    k = _attrs(node).get("k", 0)
    x = ctx.t(x)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    return (cols - rows == k).to(x.dtype)


@op("OneHot")
def _onehot(ctx, node, indices, depth, values):
    ax = _attrs(node).get("axis", -1)
    d = int(_static_ints(depth, "OneHot depth").reshape(-1)[0])
    vals = ctx.t(values)
    oh = F.one_hot(torch.remainder(ctx.t(indices).long(), d), d).to(torch.float32)
    oh = oh.movedim(-1, ax)
    return oh * (vals[1] - vals[0]) + vals[0]


@op("Trilu")
def _trilu(ctx, node, x, k=None):
    kk = int(_static_ints(k, "Trilu k").reshape(-1)[0]) if k is not None else 0
    x = ctx.t(x)
    return torch.triu(x, kk) if _attrs(node).get("upper", 1) else torch.tril(x, kk)


@op("GatherND")
def _gather_nd(ctx, node, data, indices):
    if _attrs(node).get("batch_dims", 0):
        raise NotImplementedError("GatherND batch_dims > 0")
    data, idx = ctx.t(data), ctx.t(indices)
    m = idx.shape[-1]
    flat = idx.reshape(-1, m)
    out = data[tuple(_index(flat[:, i], data.shape[i]) for i in range(m))]
    return out.reshape(tuple(idx.shape[:-1]) + tuple(data.shape[m:]))


@op("ScatterND")
def _scatter_nd(ctx, node, data, indices, updates):
    data, idx, upd = ctx.t(data), ctx.t(indices), ctx.t(updates)
    m = idx.shape[-1]
    flat = idx.reshape(-1, m)
    out = data.clone()
    out[tuple(_index(flat[:, i], data.shape[i]) for i in range(m))] = \
        upd.reshape((flat.shape[0],) + tuple(data.shape[m:])).to(data.dtype)
    return out


@op("ScatterElements")
def _scatter_elements(ctx, node, data, indices, updates):
    data, upd = ctx.t(data), ctx.t(updates).to(ctx.t(data).dtype)
    ax = _attrs(node).get("axis", 0) % data.dim()
    idx = _index(ctx.t(indices), data.shape[ax])
    red = _attrs(node).get("reduction", "none")
    if red == "none":
        return data.scatter(ax, idx, upd)
    reduce = {"add": "sum", "mul": "prod", "max": "amax", "min": "amin"}[red]
    return data.scatter_reduce(ax, idx, upd, reduce, include_self=True)


@op("GroupNormalization")
def _group_norm(ctx, node, x, scale, bias):
    at = _attrs(node)
    g = int(at["num_groups"])
    x = ctx.t(x)
    n, c = x.shape[:2]
    xg = x.reshape(n, g, c // g, *x.shape[2:])
    y = _normalize(xg, tuple(range(2, xg.dim())), at.get("epsilon", 1e-5)).reshape(x.shape)
    shp = (1, c) + (1,) * (x.dim() - 2)
    return y * ctx.t(scale).reshape(shp) + ctx.t(bias).reshape(shp)


@op("NonMaxSuppression")
def _nms_op(ctx, node, boxes, scores, max_out=None, iou_th=None, score_th=None):
    """ops/nms.py per class on the device; the ONNX [num_selected, 3]
    (batch, class, box) layout as numpy, padded slots dropped on the host."""
    from mnn_tpu_torch.ops.nms import nms

    b = _np(boxes)   # [1, N, 4]
    s = _np(scores)  # [1, C, N]
    mo = int(_static_ints(max_out, "nms max_out").reshape(-1)[0]) \
        if max_out is not None else b.shape[1]
    iou = float(_np(iou_th).reshape(-1)[0]) if iou_th is not None else 0.5
    sth = float(_np(score_th).reshape(-1)[0]) if score_th is not None else 0.0
    out = []
    for ci in range(s.shape[1]):
        idx, valid = nms(_to_torch(b[0], ctx.device), _to_torch(s[0, ci], ctx.device),
                         iou_threshold=iou, score_threshold=sth, max_outputs=mo)
        idx = idx[valid].cpu().numpy()
        out.extend((0, ci, int(i)) for i in idx)
    return np.asarray(out, np.int64).reshape(-1, 3)


def _per_axis(v: torch.Tensor, ndim: int, ax: int) -> torch.Tensor:
    shp = [1] * ndim
    shp[ax] = -1
    return v.reshape(shp)


@op("DequantizeLinear")
def _dequantize_linear(ctx, node, x, scale, zero=None):
    ax = _attrs(node).get("axis", 1)
    x = ctx.t(x).to(torch.int32)
    z = ctx.t(zero).to(torch.int32) if zero is not None else 0
    s = ctx.t(scale).float()
    if s.dim():  # per-axis
        s = _per_axis(s, x.dim(), ax)
        if zero is not None:
            z = _per_axis(z, x.dim(), ax)
    return (x - z).float() * s


@op("QuantizeLinear")
def _quantize_linear(ctx, node, x, scale, zero=None):
    ax = _attrs(node).get("axis", 1)
    x = ctx.t(x).float()
    s = ctx.t(scale).float()
    z = ctx.t(zero).to(torch.int32) if zero is not None else 0
    if s.dim():
        s = _per_axis(s, x.dim(), ax)
        if zero is not None:
            z = _per_axis(z, x.dim(), ax)
    zdt = ctx.t(zero).dtype if zero is not None else torch.uint8
    info = torch.iinfo(zdt)
    return torch.clamp(torch.round(x / s) + z, info.min, info.max).to(zdt)


# -- control flow + sampling tail ---------------------------------------------

@op("CastLike")
def _cast_like(ctx, node, a, b):
    if _is_static(a) and _is_static(b):
        return np.asarray(a).astype(np.asarray(b).dtype)
    return ctx.t(a).to(ctx.t(b).dtype)


@op("If")
def _if_op(ctx, node, cond):
    """A static condition picks its branch; a tensor condition is read to
    the host once (JAX traces both branches into `lax.cond`; eager PyTorch
    runs the one taken) and the outputs come back as tensors."""
    at = _attrs(node)
    tb, eb = at["then_branch"], at["else_branch"]
    if _is_static(cond):
        outs = ctx.run_graph(tb if bool(np.asarray(cond).reshape(())) else eb, {})
    else:
        taken = bool(ctx.t(cond).reshape(()).item())
        outs = tuple(ctx.t(v) for v in ctx.run_graph(tb if taken else eb, {}))
    return outs if len(outs) > 1 else outs[0]


@op("Loop")
def _loop(ctx, node, m=None, cond=None, *carried):
    """For-loop semantics: a STATIC trip count M, the iteration number and
    the condition fed to the body as tensors (as JAX's `lax.scan` feeds
    them), the scan outputs stacked. A tensor or body-computed early exit is
    refused, as in the JAX frontend."""
    body = _attrs(node)["body"]
    if m is None:
        raise NotImplementedError("Loop without trip count (while-style)")
    if cond is not None and not (_is_static(cond) and bool(np.asarray(cond).reshape(()))):
        if _is_static(cond):
            return tuple(ctx.t(v) for v in carried)  # cond false
        raise NotImplementedError("Loop with a traced condition")
    trip = int(_static_ints(m, "Loop trip count").reshape(()))
    names = [vi.name for vi in body.input]
    n_carry = len(carried)
    n_scan = len(body.output) - 1 - n_carry
    carry = tuple(ctx.t(v) for v in carried)
    ys = []
    for i in range(trip):
        bound = {names[0]: torch.tensor(i, dtype=torch.int32, device=ctx.device),
                 names[1]: torch.tensor(True, device=ctx.device)}
        bound.update(zip(names[2:], carry))
        vals = tuple(ctx.t(v) for v in ctx.run_graph(body, bound))
        carry = vals[1:1 + n_carry]
        ys.append(vals[1 + n_carry:])
    out = tuple(carry) + tuple(torch.stack(col) for col in zip(*ys))[:n_scan]
    return out if len(out) > 1 else out[0]


@op("Scan")
def _scan_op(ctx, node, *args):
    at = _attrs(node)
    body = at["body"]
    k = at["num_scan_inputs"]
    n_state = len(args) - k
    carry = tuple(ctx.t(a) for a in args[:n_state])
    in_dirs = at.get("scan_input_directions") or [0] * k
    xs = tuple(torch.flip(ctx.t(x), (0,)) if d else ctx.t(x)
               for x, d in zip(args[n_state:], in_dirs))
    names = [vi.name for vi in body.input]
    ys = []
    for i in range(xs[0].shape[0]):
        bound = dict(zip(names, list(carry) + [x[i] for x in xs]))
        vals = tuple(ctx.t(v) for v in ctx.run_graph(body, bound))
        carry = vals[:n_state]
        ys.append(vals[n_state:])
    n_sout = len(body.output) - n_state
    out_dirs = at.get("scan_output_directions") or [0] * n_sout
    ys = tuple(torch.flip(torch.stack(col), (0,)) if d else torch.stack(col)
               for col, d in zip(zip(*ys), out_dirs))
    out = tuple(carry) + ys
    return out if len(out) > 1 else out[0]


def _bilinear_gather(x, b, ix, iy, border):
    """x [N, C, H, W]; b (batch index, broadcast to ix), ix / iy [S...]
    sample coords -> [S..., C]. zeros or border padding. The JAX package's
    four taps in its order, vmapped there, a batch index here."""
    h, w = x.shape[2], x.shape[3]
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            xc = torch.clamp(xi, 0, w - 1).long()
            yc = torch.clamp(yi, 0, h - 1).long()
            v = x[b, :, yc, xc]                      # [S..., C]
            if not border:  # zeros padding: mask out-of-range taps
                ok = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).to(x.dtype)
                v = v * ok[..., None]
            out = out + v * wgt.to(x.dtype)[..., None]
    return out


@op("GridSample")
def _grid_sample(ctx, node, x, grid):
    """2D bilinear/nearest; padding zeros|border; align_corners."""
    at = _attrs(node)
    mode = at.get("mode", "bilinear")
    padding = at.get("padding_mode", "zeros")
    align = bool(at.get("align_corners", 0))
    if mode not in ("bilinear", "linear", "nearest"):
        raise NotImplementedError(f"GridSample mode {mode}")
    if padding not in ("zeros", "border"):
        raise NotImplementedError(f"GridSample padding {padding}")
    x = ctx.t(x)
    grid = ctx.t(grid).float()
    n, ch, h, w = x.shape
    gx = grid[..., 0]
    gy = grid[..., 1]
    if align:
        ix = (gx + 1) * (w - 1) / 2
        iy = (gy + 1) * (h - 1) / 2
    else:
        ix = ((gx + 1) * w - 1) / 2
        iy = ((gy + 1) * h - 1) / 2
    b = torch.arange(n, device=x.device).reshape(n, *([1] * (ix.dim() - 1)))
    if mode == "nearest":
        xi = torch.round(ix)
        yi = torch.round(iy)
        v = x[b, :, torch.clamp(yi, 0, h - 1).long(), torch.clamp(xi, 0, w - 1).long()]
        if padding == "zeros":
            ok = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).to(x.dtype)
            v = v * ok[..., None]
    else:
        v = _bilinear_gather(x, b, ix, iy, padding == "border")
    return v.movedim(-1, 1)


@op("RoiAlign")
def _roi_align(ctx, node, x, rois, batch_indices):
    """avg/max RoiAlign. sampling_ratio=0 (the spec's adaptive grid) is 2
    samples per bin, as in the JAX frontend."""
    at = _attrs(node)
    oh = at.get("output_height", 1)
    ow = at.get("output_width", 1)
    sr = at.get("sampling_ratio", 0) or 2
    scale = at.get("spatial_scale", 1.0)
    mode = at.get("mode", "avg")
    half = at.get("coordinate_transformation_mode", "half_pixel") == "half_pixel"
    x = ctx.t(x)
    rois = ctx.t(rois).float()
    bi = ctx.t(batch_indices).long()
    off = 0.5 if half else 0.0
    x1 = rois[:, 0] * scale - off
    y1 = rois[:, 1] * scale - off
    x2 = rois[:, 2] * scale - off
    y2 = rois[:, 3] * scale - off
    rw = x2 - x1
    rh = y2 - y1
    if not half:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bw = rw / ow
    bh = rh / oh
    # sample grid: (oh*sr) x (ow*sr) bilinear taps per roi, reduced per bin
    ar_y = torch.arange(oh * sr, device=x.device).float() + 0.5
    ar_x = torch.arange(ow * sr, device=x.device).float() + 0.5
    sy = y1[:, None] + ar_y[None, :] * bh[:, None] / sr
    sx = x1[:, None] + ar_x[None, :] * bw[:, None] / sr
    iy = sy[:, :, None].expand(-1, -1, ow * sr)
    ix = sx[:, None, :].expand(-1, oh * sr, -1)
    v = _bilinear_gather(x, bi[:, None, None], ix, iy, border=True).movedim(-1, 1)
    v = v.reshape(v.shape[0], v.shape[1], oh, sr, ow, sr)
    if mode == "max":
        return torch.amax(v, dim=(3, 5))
    return v.mean(dim=(3, 5))


# -- running a graph ---------------------------------------------------------

def load_onnx(path) -> "O.ModelProto":
    with open(path, "rb") as f:
        return O.ModelProto.FromString(f.read())


class _Ctx:
    """Execution context handed to converters: the live env (for control-flow
    subgraphs' lexical outer-scope captures), the device the function runs
    on, and a subgraph runner. Regular ops use only `t`."""

    __slots__ = ("env", "device")

    def __init__(self, env, device):
        self.env = env
        self.device = device

    def t(self, v) -> torch.Tensor:
        """`v` as a tensor: a static value moves to the device."""
        return v if isinstance(v, torch.Tensor) else _to_torch(v, self.device)

    def run_graph(self, graph, bound):
        """Run a GraphProto with `bound` mapping its formal inputs; outer
        names resolve from the calling env (ONNX lexical scoping). Returns
        the subgraph's output values (tuple)."""
        sub = dict(self.env)
        for t in graph.initializer:
            sub[t.name] = tensor_to_np(t)
        sub.update(bound)
        outs = [vi.name for vi in graph.output]
        _run_nodes(list(graph.node), sub, self.device, keep=set(outs))
        return tuple(sub[name] for name in outs)


def _names_used(node) -> set:
    """The names a node reads: its inputs and, for If / Loop / Scan, every
    outer name its bodies read (ONNX lexical scoping)."""
    used = set(node.input)
    for a in node.attribute:
        for g in ([a.g] if a.type == O.AttributeProto.GRAPH else
                  a.graphs if a.type == O.AttributeProto.GRAPHS else ()):
            inner = {vi.name for vi in g.input} | {t.name for t in g.initializer}
            for n in g.node:
                used |= _names_used(n) - inner
                inner |= set(n.output)
    return used


def _run_nodes(nodes, env, device, keep=()):
    """Run `nodes` over `env`. A value not in `keep` is dropped after the
    last node that reads it (an eager run would otherwise hold every
    activation to the end; XLA plans the JAX function's buffers)."""
    ctx = _Ctx(env, device)
    last = {}
    for i, node in enumerate(nodes):
        for name in _names_used(node):
            last[name] = i
    free = [[] for _ in nodes]
    for name, i in last.items():
        if name and name not in keep:
            free[i].append(name)
    for i, node in enumerate(nodes):
        args = [env[n] if n else None for n in node.input]
        # drop trailing optional Nones (onnx encodes absent optionals as
        # empty-string inputs)
        while args and args[-1] is None:
            args.pop()
        out = _OPS[node.op_type](ctx, node, *args)
        if isinstance(out, tuple):
            for nm, v in zip(node.output, out):
                env[nm] = v
        else:
            env[node.output[0]] = out
        for name in free[i]:
            env.pop(name, None)
    return env


def convert_onnx(model, device=None):
    """ModelProto (or a path) -> (fn(params, *inputs) -> output(s), params).

    Float initializers become `params`, tensors on `device` (the card when
    None; raises when there is none); integer initializers stay numpy so
    shape chains fold. Inputs are tensors on that device, or numpy arrays
    that stay static."""
    if isinstance(model, (str, os.PathLike)):
        model = load_onnx(model)
    dev = resolve_device(device)
    g = model.graph

    consts: Dict[str, np.ndarray] = {}
    params: Dict[str, torch.Tensor] = {}
    for t in g.initializer:
        arr = tensor_to_np(t)
        if arr.dtype in (np.int64, np.int32, np.bool_):
            consts[t.name] = arr
        else:
            params[t.name] = _to_torch(arr, dev)

    input_names = [vi.name for vi in g.input if vi.name not in consts
                   and vi.name not in params]
    output_names = [vi.name for vi in g.output]

    def all_ops(graph):  # recurse into If/Loop/Scan subgraphs
        for n in graph.node:
            yield n.op_type
            for a in n.attribute:
                if a.type == O.AttributeProto.GRAPH:
                    yield from all_ops(a.g)
                elif a.type == O.AttributeProto.GRAPHS:
                    for sub in a.graphs:
                        yield from all_ops(sub)

    unsupported = sorted({t for t in all_ops(g) if t not in _OPS})
    if unsupported:
        raise NotImplementedError(
            f"onnx ops not supported by the frontend: {unsupported} "
            "(extend mnn_tpu_torch.convert.onnx_frontend._OPS, or register a "
            "plugin via mnn_tpu_torch.plugin.register_op)")

    nodes = list(g.node)

    def fn(params, *inputs):
        env: Dict[str, Any] = dict(consts)
        env.update(params)
        env[""] = None  # optional inputs
        for name, val in zip(input_names, inputs):
            env[name] = val
        _run_nodes(nodes, env, dev, keep=set(output_names))
        outs = tuple(env[n] for n in output_names)
        return outs[0] if len(outs) == 1 else outs

    fn.input_names = input_names
    fn.output_names = output_names
    return fn, params
