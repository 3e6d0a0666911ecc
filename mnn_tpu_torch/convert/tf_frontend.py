"""TensorFlow GraphDef -> function graph converter.

Counterpart of the JAX package's `convert/tf_frontend.py`: reads a frozen
GraphDef with the port's own codec (`graphdef_pb2`, no `tensorflow`, no
`google.protobuf`) and lowers the NodeDefs through an op table (`_OPS`, the
JAX table's 101 names) onto PyTorch and `ops/nn_ops.py`, giving
`fn(params, *inputs)` and `params`. A converter is the JAX table's with the
port's context in front, `fn(ctx, node, *inputs)` (`ctx.device`,
`ctx.t(value)`), so a plugin can place what it makes.

Static and dynamic values, as in the JAX package: integer Consts stay numpy
on the host, so shape chains (Shape, Rank, Size, Range, Reshape and
StridedSlice of them) fold with no device round trip; float Consts are the
`params` tensors on the device (f16, f64 and bf16 as f32); everything an op
computes with `jnp` is a tensor on the device, narrowed as JAX narrows it
without 64-bit mode (int64 -> int32, f64 -> f32).

Layout. TensorFlow graphs are NHWC, and `nn_ops` / cuDNN's convolutions take
NCHW. Each convolution and pooling sees its input through
`x.permute(0, 3, 1, 2)`, a view with channels-last strides, and hands back
`y.permute(0, 2, 3, 1)`, again a view: no activation is copied for the
layout (cuDNN runs channels-last). A Const filter is laid out once, at
conversion, as OIHW in channels-last memory, the layout cuDNN takes with
channels-last activations; a filter computed in the graph is laid out at
each call. SAME padding puts the odd pixel bottom / right, as TF and
`lax.conv_general_dilated` do; pools pad with -inf (max) and count only
real pixels (avg).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.convert import graphdef_pb2 as G
from mnn_tpu_torch.convert.onnx_frontend import _Ctx, _np, _torch_dtype
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.ops import nn_ops as N

_OPS: Dict[str, Callable] = {}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


# -- attr helpers -----------------------------------------------------------

def _a(node, name, default=None):
    if name not in node.attr:
        return default
    v = node.attr[name]
    kind = v.WhichOneof("value")
    if kind == "i":
        return int(v.i)
    if kind == "f":
        return float(v.f)
    if kind == "b":
        return bool(v.b)
    if kind == "s":
        return v.s.decode()
    if kind == "type":
        return int(v.type)
    if kind == "list":
        lst = v.list
        for fld in ("i", "f", "b", "s"):
            vals = list(getattr(lst, fld))
            if vals:
                return vals
        return []
    return default


def _nhwc(node):
    fmt = _a(node, "data_format", "NHWC")
    if fmt not in (None, "NHWC"):
        raise NotImplementedError(f"{node.op}: data_format {fmt} (NHWC only)")


def _pad_attr(node):
    p = _a(node, "padding", "SAME")
    if p == "EXPLICIT":
        ep = _a(node, "explicit_paddings", [])
        return [(int(ep[2 * i]), int(ep[2 * i + 1])) for i in (1, 2)]
    return p


def same_pads(size: int, k: int, s: int, d: int = 1):
    """TF / lax SAME padding of one spatial dim: (low, high), the odd pixel high."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads2(pad, x_hw, k, s, d=(1, 1)):
    """((top, bottom), (left, right)) of a SAME / VALID / explicit padding."""
    if pad == "VALID":
        return (0, 0), (0, 0)
    if pad == "SAME":
        return tuple(same_pads(x_hw[i], k[i], s[i], d[i]) for i in range(2))
    return tuple(tuple(p) for p in pad)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc_of(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv_nhwc(x, w_oihw, strides, pads, dilation=(1, 1), groups=1):
    """A convolution of an NHWC tensor with OIHW weights and
    ((top, bottom), (left, right)) zero padding; NHWC out."""
    xn = _nchw(x)
    (pt, pb), (pl, pr) = pads
    if pt != pb or pl != pr:
        xn = F.pad(xn, (pl, pr, pt, pb))
        pt = pl = 0
    return _nhwc_of(N.conv2d(xn, w_oihw, None, strides, (pt, pl), dilation, groups))


def pool_nhwc(x, kind, k, s, pads):
    """Max (-inf padding) or average (real pixels counted) pooling of an
    NHWC tensor; NHWC out."""
    xn = _nchw(x)
    (pt, pb), (pl, pr) = pads
    if kind == "max":
        return _nhwc_of(F.max_pool2d(F.pad(xn, (pl, pr, pt, pb), value=float("-inf")), k, s))
    s_ = F.avg_pool2d(F.pad(xn, (pl, pr, pt, pb)), k, s) * (k[0] * k[1])
    ones = F.pad(torch.ones_like(xn[:1, :1]), (pl, pr, pt, pb))
    cnt = F.avg_pool2d(ones, k, s) * (k[0] * k[1])
    return _nhwc_of(s_ / cnt)


def conv_transpose_lax(x_nchw, w_fwd, strides, padding):
    """`lax.conv_transpose(..., transpose_kernel=True)` with SAME / VALID
    padding: the gradient of a forward convolution whose weights are
    `w_fwd` [C_x, C_out, kh, kw], cropped (or zero-extended) to lax's pads."""
    y = F.conv_transpose2d(x_nchw, w_fwd, stride=tuple(strides))
    crop = []
    for k, s in zip(w_fwd.shape[2:], strides):
        if padding == "SAME":
            pad_len = k + s - 2
            pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        else:
            pad_len = k + s - 2 + max(k - s, 0)
            pad_a = k - 1
        crop.append((k - 1 - pad_a, k - 1 - (pad_len - pad_a)))
    (h0, h1), (w0, w1) = crop
    return F.pad(y, (-w0, -w1, -h0, -h1))


def mirror_pad(x: torch.Tensor, pads, mode: str, value=0.0) -> torch.Tensor:
    """`jnp.pad` with ((lo, hi), ...) a dim: constant, reflect or symmetric."""
    if mode == "constant":
        flat = [int(v) for lo_hi in reversed(pads) for v in lo_hi]
        return F.pad(x, flat, value=value)
    for dim, (lo, hi) in enumerate(pads):
        n = x.shape[dim]
        if not lo and not hi:
            continue
        idx = np.arange(-lo, n + hi)
        if mode == "reflect":
            period = 2 * (n - 1) if n > 1 else 1
            idx = np.abs(idx) % period
            idx = np.where(idx >= n, period - idx, idx)
        else:                       # symmetric: the edge repeats
            period = 2 * n
            idx = idx % period
            idx = np.where(idx >= n, period - 1 - idx, idx)
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def strided_index(x, idx):
    """x[idx] for a tuple of ints, slices (any step) and None; numpy stays
    numpy, a tensor takes negative steps through an index."""
    if not isinstance(x, torch.Tensor):
        return x[tuple(idx)]
    out, dim = x, 0
    for it in idx:
        if it is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(it, slice):
            start, stop, step = it.indices(out.shape[dim])
            if step > 0:
                out = out[(slice(None),) * dim + (it,)]
            else:
                sel = torch.arange(start, stop, step, device=out.device)
                out = out.index_select(dim, sel)
            dim += 1
        else:
            out = out.select(dim, int(it))
    return out


def take(x: torch.Tensor, idx, axis: int) -> torch.Tensor:
    """`jnp.take(x, idx, axis)` for in-range indices (negative ones wrap)."""
    axis %= x.dim()
    it = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(np.asarray(idx))
    it = it.to(x.device).long() % x.shape[axis]
    out = x.movedim(axis, 0)[it]
    return out.movedim(list(range(it.dim())), list(range(axis, axis + it.dim())))


# -- math / activations -----------------------------------------------------

def _sign(x):
    """`jnp.sign`: sign(+-0.0) is +-0.0 and NaN stays NaN (torch.sign gives 0)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _elem(f):
    return lambda ctx, node, *xs: f(*[ctx.t(x) for x in xs])


for tf_name, f in {
    "AddV2": torch.add, "Add": torch.add, "Sub": torch.sub,
    "Mul": torch.mul, "RealDiv": torch.true_divide, "Div": torch.true_divide,
    "Maximum": torch.maximum, "Minimum": torch.minimum, "Pow": torch.pow,
    "SquaredDifference": lambda a, b: torch.square(a - b),
    "FloorDiv": torch.floor_divide, "FloorMod": torch.remainder,
    "Relu": F.relu, "Relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "Sigmoid": torch.sigmoid, "Tanh": torch.tanh, "Elu": F.elu,
    "Selu": F.selu, "Softplus": N.softplus,
    "Softsign": lambda x: x / (1 + torch.abs(x)),
    "Exp": torch.exp, "Log": torch.log, "Sqrt": torch.sqrt,
    "Rsqrt": torch.rsqrt, "Neg": torch.neg, "Abs": torch.abs,
    "Square": torch.square, "Erf": torch.special.erf, "Floor": torch.floor,
    "Ceil": torch.ceil, "Round": torch.round, "Sign": _sign,
    "Sin": torch.sin, "Cos": torch.cos,
    "Reciprocal": torch.reciprocal,
    "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
    "LogicalNot": torch.logical_not,
    "Equal": torch.eq, "NotEqual": torch.ne, "Less": torch.lt,
    "LessEqual": torch.le, "Greater": torch.gt,
    "GreaterEqual": torch.ge,
    "Select": lambda c, a, b: torch.where(c.bool(), a, b),
    "SelectV2": lambda c, a, b: torch.where(c.bool(), a, b),
    "ZerosLike": torch.zeros_like, "OnesLike": torch.ones_like,
}.items():
    _OPS[tf_name] = _elem(f)
_OPS["Identity"] = _OPS["StopGradient"] = lambda ctx, node, x: x


@op("BiasAdd")
def _bias_add(ctx, node, x, bias):
    # bias broadcasts over the CHANNEL axis; NCHW would silently broadcast
    # over W with a plain add, so reject it like the conv lowerings do
    _nhwc(node)
    return ctx.t(x) + ctx.t(bias)


@op("LeakyRelu")
def _leaky(ctx, node, x):
    x = ctx.t(x)
    return torch.where(x >= 0, x, x * _a(node, "alpha", 0.2))


@op("Softmax")
def _softmax(ctx, node, x):
    return torch.softmax(ctx.t(x), dim=-1)


@op("LogSoftmax")
def _log_softmax(ctx, node, x):
    return torch.log_softmax(ctx.t(x), dim=-1)


# -- matmul / conv / pool ---------------------------------------------------

@op("MatMul")
def _matmul(ctx, node, a, b):
    a, b = ctx.t(a), ctx.t(b)
    if _a(node, "transpose_a", False):
        a = a.T
    if _a(node, "transpose_b", False):
        b = b.T
    return torch.matmul(a, b)


@op("BatchMatMulV2", "BatchMatMul", "BatchMatMulV3")
def _batch_matmul(ctx, node, a, b):
    a, b = ctx.t(a), ctx.t(b)
    if _a(node, "adj_x", False):
        a = a.transpose(-1, -2)
    if _a(node, "adj_y", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _filter_oihw(w: torch.Tensor) -> torch.Tensor:
    """A Conv2D filter, HWIO, as OIHW."""
    return w.permute(3, 2, 0, 1)


def _dw_filter_oihw(w: torch.Tensor) -> torch.Tensor:
    """A depthwise filter [kh, kw, c, m] as OIHW [c * m, 1, kh, kw]."""
    kh, kw, c, m = w.shape
    return w.reshape(kh, kw, 1, c * m).permute(3, 2, 0, 1)


def _conv2d_oihw(ctx, node, x, w):
    _nhwc(node)
    x = ctx.t(x)
    s = _a(node, "strides", [1, 1, 1, 1])
    d = _a(node, "dilations", [1, 1, 1, 1])
    st, dil = (int(s[1]), int(s[2])), (int(d[1]), int(d[2]))
    pads = _pads2(_pad_attr(node), x.shape[1:3], w.shape[2:], st, dil)
    return conv_nhwc(x, w, st, pads, dil)


def _dwconv_oihw(ctx, node, x, w):
    _nhwc(node)
    x = ctx.t(x)
    s = _a(node, "strides", [1, 1, 1, 1])
    st = (int(s[1]), int(s[2]))
    pads = _pads2(_pad_attr(node), x.shape[1:3], w.shape[2:], st)
    return conv_nhwc(x, w, st, pads, groups=x.shape[3])


@op("Conv2D")
def _conv2d(ctx, node, x, w):
    return _conv2d_oihw(ctx, node, x, _filter_oihw(ctx.t(w)))


@op("DepthwiseConv2dNative")
def _dwconv(ctx, node, x, w):
    return _dwconv_oihw(ctx, node, x, _dw_filter_oihw(ctx.t(w)))


# op -> (its built-in converter, the filter's layout, the converter of a
# filter laid out at conversion)
_PREPARED = {"Conv2D": (_conv2d, _filter_oihw, _conv2d_oihw),
             "DepthwiseConv2dNative": (_dwconv, _dw_filter_oihw, _dwconv_oihw)}


def _prepare_filters(compute, params, outputs) -> set:
    """Lay out once, in `params`, each float Const that is read only as the
    filter (input 1) of built-in Conv2D / DepthwiseConv2dNative converters
    of one kind, and is no graph output: OIHW in channels-last memory, the
    layout cuDNN takes with channels-last activations, so no call copies it.
    Returns the names of the nodes that read a filter laid out so."""
    readers: Dict[str, list] = {}
    for n in compute:
        for slot, inp in enumerate(i for i in n.input if not i.startswith("^")):
            readers.setdefault(inp.split(":")[0], []).append((n, slot))
    prepared = set()
    for name in params:
        ops = {n.op for n, _ in readers.get(name, ())}
        if name in outputs or len(ops) != 1 or any(slot != 1 for _, slot in readers[name]):
            continue
        kind = ops.pop()
        if kind not in _PREPARED or _OPS.get(kind) is not _PREPARED[kind][0]:
            continue
        params[name] = _PREPARED[kind][1](params[name]).contiguous(
            memory_format=torch.channels_last)
        prepared.update(n.name for n, _ in readers[name])
    return prepared


@op("Conv2DBackpropInput")
def _deconv(ctx, node, out_shape, w, x):
    _nhwc(node)
    s = _a(node, "strides", [1, 1, 1, 1])
    pad = _pad_attr(node)
    if pad not in ("SAME", "VALID"):
        raise NotImplementedError(f"Conv2DBackpropInput: padding {pad}")
    # filter HWIO of the forward convolution (I = this op's output channels)
    out = _nhwc_of(conv_transpose_lax(_nchw(ctx.t(x)), ctx.t(w).permute(3, 2, 0, 1),
                                      (int(s[1]), int(s[2])), pad))
    # TF derives SAME padding from the requested output shape (input 0);
    # crop symmetrically when conv_transpose over-produces (odd sizes)
    oh, ow = int(_np(out_shape)[1]), int(_np(out_shape)[2])
    if out.shape[1] < oh or out.shape[2] < ow:
        raise NotImplementedError(
            f"Conv2DBackpropInput: produced {tuple(out.shape[1:3])}, requested {(oh, ow)}")
    top = (out.shape[1] - oh) // 2
    left = (out.shape[2] - ow) // 2
    return out[:, top: top + oh, left: left + ow]


def _pool(kind):
    def run(ctx, node, x):
        _nhwc(node)
        x = ctx.t(x)
        k = tuple(int(v) for v in _a(node, "ksize", [1, 1, 1, 1]))
        s = tuple(int(v) for v in _a(node, "strides", [1, 1, 1, 1]))
        pad = _pad_attr(node)
        if k[0] != 1 or k[3] != 1 or s[0] != 1 or s[3] != 1 or pad not in ("SAME", "VALID"):
            raise NotImplementedError(f"{node.op}: ksize {k}, strides {s}, padding {pad}")
        pads = _pads2(pad, x.shape[1:3], k[1:3], s[1:3])
        return pool_nhwc(x, kind, k[1:3], s[1:3], pads)
    return run


_OPS["MaxPool"] = _pool("max")
_OPS["AvgPool"] = _pool("avg")


@op("FusedBatchNormV3", "FusedBatchNorm", "FusedBatchNormV2")
def _fused_bn(ctx, node, x, scale, offset, mean, var):
    eps = _a(node, "epsilon", 1e-3)
    x, scale, offset, mean, var = (ctx.t(v) for v in (x, scale, offset, mean, var))
    y = (x - mean) * torch.rsqrt(var + eps) * scale + offset
    return (y,)  # TF emits 5-6 outputs; only y is consumed in inference


# -- shape / layout ---------------------------------------------------------

@op("Reshape")
def _reshape(ctx, node, x, shape):
    return x.reshape([int(d) for d in _np(shape).reshape(-1)])


@op("Transpose")
def _transpose(ctx, node, x, perm):
    return ctx.t(x).permute(tuple(int(p) for p in _np(perm)))


@op("ConcatV2")
def _concat(ctx, node, *args):
    return torch.cat([ctx.t(a) for a in args[:-1]], dim=int(_np(args[-1])))


@op("Split")
def _split(ctx, node, axis, x):
    return tuple(torch.tensor_split(ctx.t(x), _a(node, "num_split"), dim=int(_np(axis))))


@op("SplitV")
def _splitv(ctx, node, x, sizes, axis):
    pts = np.cumsum(_np(sizes))[:-1]
    return tuple(torch.tensor_split(ctx.t(x), [int(p) for p in pts], dim=int(_np(axis))))


@op("Pad", "PadV2", "MirrorPad")
def _padop(ctx, node, x, pads, value=None):
    pads = [tuple(int(v) for v in p) for p in _np(pads)]
    if node.op == "MirrorPad":
        return mirror_pad(ctx.t(x), pads, _a(node, "mode", "REFLECT").lower())
    return mirror_pad(ctx.t(x), pads, "constant",
                      float(_np(value)) if value is not None else 0.0)


@op("Squeeze")
def _squeeze(ctx, node, x):
    dims = _a(node, "squeeze_dims", []) or _a(node, "axis", [])
    x = ctx.t(x)
    return x.squeeze(tuple(int(d) for d in dims)) if dims else x.squeeze()


@op("ExpandDims")
def _expand_dims(ctx, node, x, axis):
    return ctx.t(x).unsqueeze(int(_np(axis)))


@op("StridedSlice")
def _strided_slice(ctx, node, x, begin, end, strides):
    begin, end, strides = (_np(v) for v in (begin, end, strides))
    bm, em = _a(node, "begin_mask", 0), _a(node, "end_mask", 0)
    sm = _a(node, "shrink_axis_mask", 0)
    nm = _a(node, "new_axis_mask", 0)
    idx: List[Any] = []
    for d in range(len(begin)):
        if (nm >> d) & 1:
            idx.append(None)
        elif (sm >> d) & 1:
            idx.append(int(begin[d]))
        else:
            b = None if (bm >> d) & 1 else int(begin[d])
            e = None if (em >> d) & 1 else int(end[d])
            idx.append(slice(b, e, int(strides[d])))
    return strided_index(x, idx)


@op("Slice")
def _slice(ctx, node, x, begin, size):
    x = ctx.t(x)
    begin, size = _np(begin), _np(size)
    out = x
    for d, (b, sz) in enumerate(zip(begin, size)):
        b = int(b)
        sz = int(sz) if sz != -1 else x.shape[d] - b
        b = min(max(b, 0), x.shape[d] - sz)          # lax.dynamic_slice clamps
        out = out.narrow(d, b, sz)
    return out


@op("Pack")
def _pack(ctx, node, *xs):
    return torch.stack([ctx.t(x) for x in xs], dim=_a(node, "axis", 0))


@op("Unpack")
def _unpack(ctx, node, x):
    ax = _a(node, "axis", 0)
    return tuple(s.squeeze(ax) for s in torch.tensor_split(ctx.t(x), _a(node, "num"), dim=ax))


@op("GatherV2", "Gather")
def _gather(ctx, node, x, idx, axis=None):
    return take(ctx.t(x), idx, int(_np(axis)) if axis is not None else 0)


@op("GatherNd")
def _gather_nd(ctx, node, x, idx):
    it = ctx.t(idx).long()
    return ctx.t(x)[tuple(it.unbind(-1))]


@op("Tile")
def _tile(ctx, node, x, reps):
    return torch.tile(ctx.t(x), tuple(int(v) for v in _np(reps)))


@op("Fill")
def _fill(ctx, node, shape, value):
    v = np.asarray(_np(value))
    return torch.full([int(d) for d in _np(shape)], v.item(), dtype=_torch_dtype(v.dtype),
                      device=ctx.device)


@op("Shape")
def _shape(ctx, node, x):
    return np.asarray(x.shape, np.int32)


@op("Rank")
def _rank(ctx, node, x):
    return np.int32(len(x.shape))


@op("Size")
def _size(ctx, node, x):
    return np.int32(int(np.prod(x.shape)))


@op("Range")
def _range(ctx, node, start, limit, delta):
    return np.arange(int(_np(start)), int(_np(limit)), int(_np(delta)), np.int32)


@op("Cast")
def _cast(ctx, node, x):
    dt = G.NP_DTYPES.get(_a(node, "DstT"))
    if dt is None:
        raise NotImplementedError(f"Cast to tf dtype {_a(node, 'DstT')}")
    return ctx.t(x).to(_torch_dtype(dt))


# -- reductions -------------------------------------------------------------

def _reduce_over(f, x, axes, keep):
    for a in sorted(axes, reverse=True):
        x = f(x, a, keep)
    return x


def _reduce(kind):
    def run(ctx, node, x, axes):
        x = ctx.t(x)
        ax = tuple(int(a) % max(x.dim(), 1) for a in np.atleast_1d(_np(axes)))
        keep = _a(node, "keep_dims", False)
        if not ax:
            return x
        if kind == "mean":
            return torch.mean(x if x.is_floating_point() else x.float(), dim=ax, keepdim=keep)
        if kind == "sum":
            dt = torch.int32 if x.dtype == torch.bool else x.dtype
            return torch.sum(x, dim=ax, keepdim=keep).to(dt)
        if kind == "max":
            return torch.amax(x, dim=ax, keepdim=keep)
        if kind == "min":
            return torch.amin(x, dim=ax, keepdim=keep)
        if kind == "prod":
            dt = torch.int32 if x.dtype == torch.bool else x.dtype
            return _reduce_over(lambda v, a, k: torch.prod(v, a, keepdim=k), x, ax, keep).to(dt)
        f = torch.all if kind == "all" else torch.any
        return _reduce_over(lambda v, a, k: f(v, dim=a, keepdim=k), x.bool(), ax, keep)
    return run


for _name, _kind in (("Mean", "mean"), ("Sum", "sum"), ("Max", "max"), ("Min", "min"),
                     ("Prod", "prod"), ("All", "all"), ("Any", "any")):
    _OPS[_name] = _reduce(_kind)


@op("ArgMax")
def _argmax(ctx, node, x, axis):
    # int32 result (JAX without x64; consumers cast as needed)
    return torch.argmax(ctx.t(x), dim=int(_np(axis))).to(torch.int32)


@op("ArgMin")
def _argmin(ctx, node, x, axis):
    return torch.argmin(ctx.t(x), dim=int(_np(axis))).to(torch.int32)


def _check_resize_attrs(node):
    """jax.image.resize implements half_pixel_centers semantics; TF's
    legacy align_corners grid differs at every interior pixel — refuse it
    rather than silently resampling on the wrong grid."""
    if _a(node, "align_corners", False):
        raise NotImplementedError(f"{node.op}: align_corners=True")


@op("ResizeBilinear")
def _resize_bl(ctx, node, x, size):
    _check_resize_attrs(node)
    h, w = (int(v) for v in _np(size))
    return _nhwc_of(N.resize_bilinear(_nchw(ctx.t(x)), (h, w)))


@op("ResizeNearestNeighbor")
def _resize_nn(ctx, node, x, size):
    _check_resize_attrs(node)
    h, w = (int(v) for v in _np(size))
    return _nhwc_of(N.resize_nearest(_nchw(ctx.t(x)), (h, w)))


# ---------------------------------------------------------------------------

def convert_graphdef(graph_def, outputs: Optional[List[str]] = None,
                     inputs: Optional[List[str]] = None, device=None):
    """GraphDef -> (fn(params, *inputs) -> output(s), params).

    `graph_def`: bytes of a frozen GraphDef, a path to a `.pb`, a
    `graphdef_pb2.GraphDef`, or any object with `SerializeToString()` (a
    GraphDef of a TensorFlow install) or `.graph.as_graph_def()` / a
    `get_concrete_function()` (a tf.function): duck-typed, TensorFlow is
    never imported. Float Consts become `params`, tensors on `device` (the
    card when None; raises when there is none), a convolution's filter laid
    out once as OIHW (`_prepare_filters`); integer Consts stay numpy so
    shape chains fold. `inputs` defaults to the graph's Placeholders in
    definition order; `outputs` defaults to sink nodes."""
    graph_def = as_graph_def(graph_def)
    dev = resolve_device(device)

    nodes = [n for n in graph_def.node if n.op != "NoOp"]
    consts: Dict[str, np.ndarray] = {}
    params: Dict[str, torch.Tensor] = {}
    placeholders: List[str] = []
    compute = []
    for n in nodes:
        if n.op == "Const":
            arr = G.make_ndarray(n.attr["value"].tensor)
            if arr.dtype in (np.float32, np.float16, np.float64):
                params[n.name] = torch.from_numpy(arr.astype(np.float32)).to(dev)
            else:
                consts[n.name] = arr
        elif n.op in ("Placeholder", "PlaceholderWithDefault"):
            placeholders.append(n.name)
        else:
            if n.op not in _OPS:
                raise NotImplementedError(
                    f"tf op not supported by the frontend: {n.op} "
                    "(extend mnn_tpu_torch.convert.tf_frontend._OPS, or register a plugin "
                    "via mnn_tpu_torch.plugin.register_op(..., frontend='tf'))")
            compute.append(n)

    input_names = list(inputs) if inputs is not None else placeholders
    if outputs is None:
        consumed = {inp.split(":")[0].lstrip("^") for n in compute for inp in n.input}
        outputs = [n.name for n in compute if n.name not in consumed]
    output_refs = [o if ":" in o else o + ":0" for o in outputs]
    prepared = _prepare_filters(compute, params, {r.split(":")[0] for r in output_refs})

    # the last node to read each value: an eager run drops it there
    keep = {r.split(":")[0] for r in output_refs}
    last: Dict[str, int] = {}
    for i, n in enumerate(compute):
        for inp in n.input:
            if not inp.startswith("^"):
                last[inp.split(":")[0]] = i
    free = [[] for _ in compute]
    for name, i in last.items():
        if name not in keep and name not in consts and name not in params:
            free[i].append(name)

    def fn(params, *args):
        env: Dict[str, Any] = {k: (v,) for k, v in consts.items()}
        env.update({k: (v,) for k, v in params.items()})
        for name, val in zip(input_names, args):
            env[name] = (val,)
        ctx = _Ctx(env, dev)

        def resolve(ref):
            ref = ref.split(":")
            vals = env[ref[0]]
            return vals[int(ref[1]) if len(ref) > 1 else 0]

        for i, n in enumerate(compute):
            ins = [resolve(r) for r in n.input if not r.startswith("^")]
            out = (_PREPARED[n.op][2] if n.name in prepared else _OPS[n.op])(ctx, n, *ins)
            env[n.name] = out if isinstance(out, tuple) else (out,)
            for name in free[i]:
                env.pop(name, None)
        outs = tuple(resolve(r) for r in output_refs)
        return outs[0] if len(outs) == 1 else outs

    fn.input_names = input_names
    fn.output_names = outputs
    return fn, params


def as_graph_def(g) -> G.GraphDef:
    """A GraphDef of the port's codec from bytes, a path, or a TensorFlow
    object (duck-typed: `get_concrete_function`, `.graph.as_graph_def()`,
    `SerializeToString()`)."""
    if isinstance(g, G.GraphDef):
        return g
    if isinstance(g, (bytes, bytearray, memoryview)):
        return G.GraphDef.FromString(g)
    if isinstance(g, (str, os.PathLike)):
        with open(g, "rb") as f:
            return G.GraphDef.FromString(f.read())
    if hasattr(g, "get_concrete_function"):     # tf.function
        g = g.get_concrete_function()
    if hasattr(g, "graph") and hasattr(g.graph, "as_graph_def"):   # concrete function
        g = g.graph.as_graph_def()
    if hasattr(g, "SerializeToString"):
        return G.GraphDef.FromString(g.SerializeToString())
    raise TypeError(f"cannot extract GraphDef from {type(g)}")
