"""Caffe -> function graph converter.

Counterpart of the JAX package's `convert/caffe_frontend.py`: reads a
deploy `.prototxt` (text format) and a `.caffemodel` (a binary NetParameter
carrying the weight blobs) with the port's own codec (`caffe_pb2`, no
`google.protobuf`), and lowers the layers through a table (`_LAYERS`, the
JAX table's 27 types) onto PyTorch and `ops/nn_ops.py`, giving
`fn(params, *inputs)` and `params`: the weight blobs as tensors on the
device, keyed "layer_name.N". A converter is the JAX table's with the
port's context in front, `fn(ctx, layer, blobs, *inputs)` (`ctx.device`,
`ctx.t(value)`), so a plugin can place what it makes.

Caffe's semantics, as the JAX frontend keeps them: NCHW; grouped
convolutions; Deconvolution's [in, out / group, kh, kw] weights through the
exact transposed convolution; CEIL pooling extents with Caffe's clipping of
a last window that starts in the padding (`_pool_extent`), and AVE pooling's
count that takes the pad positions but not the ceil overhang; across-channel
LRN; BatchNorm's third blob as the scale factor of the stored mean and
variance; InnerProduct's `axis` and `transpose`; Slice points (or an even
split over the tops); PReLU per channel or `channel_shared`; in-place layers
(bottom == top) and Split's aliased tops.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.convert import caffe_pb2 as C
from mnn_tpu_torch.convert.onnx_frontend import _Ctx, conv_transpose2d_nchw
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.ops import nn_ops as N


def _blob_np(b) -> np.ndarray:
    if b.shape.dim:
        shape = tuple(int(d) for d in b.shape.dim)
    else:
        legacy = [b.num, b.channels, b.height, b.width]
        shape = tuple(d for d in legacy if d) or (len(b.data),)
    return np.asarray(b.data, np.float32).reshape(shape)


def _hw(param, name, default):
    """Resolve caffe's (repeated `name` | `name_h`/`name_w`) conventions."""
    h = getattr(param, name + "_h", 0)
    w = getattr(param, name + "_w", 0)
    if h or w:
        return int(h or default), int(w or default)
    rep = getattr(param, name, [])
    if isinstance(rep, int):  # pooling uses scalar fields, conv repeated
        rep = [rep] if rep else []
    rep = list(rep)
    if len(rep) == 0:
        return default, default
    if len(rep) == 1:
        return int(rep[0]), int(rep[0])
    return int(rep[0]), int(rep[1])


# ---------------------------------------------------------------------------
# layer implementations (x is NCHW)

def _conv(ctx, layer, blobs, x, transposed=False):
    p = layer.convolution_param
    sh, sw = _hw(p, "stride", 1)
    ph, pw = _hw(p, "pad", 0)
    dil = list(p.dilation) or [1]
    d = (int(dil[0]), int(dil[-1]))
    w = blobs[0]
    if transposed:      # weights [in, out / group, kh, kw]
        out = conv_transpose2d_nchw(x, w, strides=(sh, sw), pads=(ph, pw, ph, pw),
                                    groups=int(p.group), dilation=d)
    else:
        out = N.conv2d(x, w, None, (sh, sw), (ph, pw), d, int(p.group))
    if p.bias_term and len(blobs) > 1:
        out = out + blobs[1][None, :, None, None]
    return out


def _pool_extent(n, k, s, p, ceil_mode):
    rnd = math.ceil if ceil_mode else math.floor
    out = int(rnd((n + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= n + p:  # caffe clips the last window
        out -= 1
    return out


def _pool(ctx, layer, blobs, x):
    p = layer.pooling_param
    n, c, h, w = x.shape
    if p.global_pooling:
        if p.pool == C.PoolingParameter.MAX:
            return torch.amax(x, dim=(2, 3), keepdim=True)
        return torch.mean(x, dim=(2, 3), keepdim=True)
    kh, kw = _hw(p, "kernel", int(p.kernel_size))
    sh, sw = _hw(p, "stride", int(p.stride))
    ph, pw = _hw(p, "pad", int(p.pad))
    ceil_mode = p.round_mode == C.PoolingParameter.CEIL
    oh = _pool_extent(h, kh, sh, ph, ceil_mode)
    ow = _pool_extent(w, kw, sw, pw, ceil_mode)
    # right padding may exceed `pad` under CEIL rounding
    eh = max(0, (oh - 1) * sh + kh - h - ph)
    ew = max(0, (ow - 1) * sw + kw - w - pw)
    if p.pool == C.PoolingParameter.MAX:
        xp = F.pad(x, (pw, ew, ph, eh), value=float("-inf"))
        return F.max_pool2d(xp, (kh, kw), (sh, sw))
    # AVE: zero-pad; the count is window ∩ padded image (pad positions count,
    # the ceil overhang beyond pad does not). The padded extent h + ph + eh
    # can be shorter than h + 2 ph (FLOOR clips the pad): the mask is built
    # at that extent.
    xp = F.pad(x, (pw, ew, ph, eh))
    s = F.avg_pool2d(xp, (kh, kw), (sh, sw)) * (kh * kw)
    mh = min(h + 2 * ph, h + ph + eh)
    mw = min(w + 2 * pw, w + pw + ew)
    mask = F.pad(torch.ones((1, 1, mh, mw), dtype=x.dtype, device=x.device),
                 (0, w + pw + ew - mw, 0, h + ph + eh - mh))
    cnt = F.avg_pool2d(mask, (kh, kw), (sh, sw)) * (kh * kw)
    return s / cnt


def _inner_product(ctx, layer, blobs, x):
    p = layer.inner_product_param
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    x2 = x.reshape(int(np.prod(x.shape[:axis])), -1)
    w = blobs[0]
    out = torch.matmul(x2, w if p.transpose else w.T)
    if p.bias_term and len(blobs) > 1:
        out = out + blobs[1]
    return out.reshape(*x.shape[:axis], -1)


def _batch_norm(ctx, layer, blobs, x):
    p = layer.batch_norm_param
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean, var = blobs[0].reshape(-1), blobs[1].reshape(-1)
    if len(blobs) > 2:      # the stored sums over the scale factor (0: none), on the device
        sf = blobs[2].reshape(-1)[0]
        sf = torch.where(sf != 0, 1.0 / sf, torch.zeros_like(sf))
        mean, var = mean * sf, var * sf
    return (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + p.eps)


def _scale(ctx, layer, blobs, x, y=None):
    p = layer.scale_param
    if y is None:
        y = blobs[0]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    shape = [1] * x.dim()
    shape[axis: axis + y.dim()] = y.shape
    out = x * y.reshape(shape)
    if p.bias_term and len(blobs) > 1:
        out = out + blobs[1].reshape(shape)
    return out


def _lrn(ctx, layer, blobs, x):
    p = layer.lrn_param
    if p.norm_region != C.LRNParameter.ACROSS_CHANNELS:
        raise NotImplementedError("LRN WITHIN_CHANNEL")
    n = int(p.local_size)
    pad = n // 2
    sqp = F.pad(x * x, (0, 0, 0, 0, pad, pad))
    den = F.avg_pool3d(sqp[:, None], (n, 1, 1), stride=1)[:, 0] * n
    return x / torch.pow(p.k + (p.alpha / n) * den, p.beta)


def _eltwise(ctx, layer, blobs, *xs):
    p = layer.eltwise_param
    if p.operation == C.EltwiseParameter.PROD:
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out
    if p.operation == C.EltwiseParameter.MAX:
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out
    coeff = list(p.coeff) or [1.0] * len(xs)
    out = xs[0] * coeff[0]
    for x, c in zip(xs[1:], coeff[1:]):
        out = out + x * c
    return out


def _reshape(ctx, layer, blobs, x):
    p = layer.reshape_param
    dims = [int(d) for d in p.shape.dim]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    num = p.num_axes if p.num_axes >= 0 else x.dim() - axis
    # caffe semantics: only dims [axis, axis+num) are reshaped; 0 copies the
    # corresponding source dim within that span
    span = x.shape[axis: axis + num]
    new = [span[i] if d == 0 else d for i, d in enumerate(dims)]
    return x.reshape(list(x.shape[:axis]) + new + list(x.shape[axis + num:]))


def _flatten(ctx, layer, blobs, x):
    p = layer.flatten_param
    a = p.axis if p.axis >= 0 else x.dim() + p.axis
    e = p.end_axis if p.end_axis >= 0 else x.dim() + p.end_axis
    return x.reshape(tuple(x.shape[:a]) + (-1,) + tuple(x.shape[e + 1:]))


def _slice(ctx, layer, blobs, x):
    p = layer.slice_param
    pts = [int(v) for v in p.slice_point]
    axis = p.axis % x.dim()
    if pts:
        sizes = np.diff([0] + pts + [x.shape[axis]]).tolist()
        return tuple(torch.split(x, sizes, dim=axis))
    # no slice_point: Caffe splits evenly across the layer's tops
    return tuple(torch.chunk(x, max(len(layer.top), 1), dim=axis))


def _prelu(ctx, layer, blobs, x):
    slope = blobs[0].reshape(-1)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    s = slope.reshape(shape) if slope.numel() > 1 else slope
    return torch.where(x >= 0, x, x * s)


def _relu(ctx, layer, blobs, x):
    slope = layer.relu_param.negative_slope
    return torch.where(x >= 0, x, x * slope) if slope else F.relu(x)


_LAYERS: Dict[str, Callable] = {
    "Convolution": _conv,
    "Deconvolution": lambda c, l, b, x: _conv(c, l, b, x, transposed=True),
    "Pooling": _pool,
    "InnerProduct": _inner_product,
    "BatchNorm": _batch_norm,
    "Scale": _scale,
    "LRN": _lrn,
    "Eltwise": _eltwise,
    "ReLU": _relu,
    "ReLU6": lambda c, l, b, x: torch.clamp(x, 0.0, 6.0),
    "PReLU": _prelu,
    "ELU": lambda c, l, b, x: torch.where(x >= 0, x, l.elu_param.alpha * (torch.exp(x) - 1)),
    "Sigmoid": lambda c, l, b, x: torch.sigmoid(x),
    "TanH": lambda c, l, b, x: torch.tanh(x),
    "AbsVal": lambda c, l, b, x: torch.abs(x),
    "BNLL": lambda c, l, b, x: N.softplus(x),
    "Power": lambda c, l, b, x: torch.pow(
        l.power_param.shift + l.power_param.scale * x, l.power_param.power),
    "Exp": lambda c, l, b, x: torch.exp(x),
    "Log": lambda c, l, b, x: torch.log(x),
    "Softmax": lambda c, l, b, x: torch.softmax(x, dim=l.softmax_param.axis),
    "Concat": lambda c, l, b, *xs: torch.cat(xs, dim=l.concat_param.axis),
    "Slice": _slice,
    "Reshape": _reshape,
    "Flatten": _flatten,
    "Dropout": lambda c, l, b, x: x,       # inference
    "Split": lambda c, l, b, x: x,         # fan-out; tops all alias the bottom
    "ArgMax": lambda c, l, b, x: torch.argmax(x, dim=int(l.argmax_param.axis)).to(torch.int32),
}


# ---------------------------------------------------------------------------

load_prototxt = C.load_prototxt


def _read(src, mode):
    with open(src, mode) as f:
        return f.read()


def convert_caffe(prototxt, caffemodel=None, device=None):
    """(.prototxt path / text / NetParameter, .caffemodel path / bytes) ->
    (fn(params, *inputs), params).

    Weight blobs become `params`, tensors on `device` (the card when None;
    raises when there is none), keyed "layer_name.N"; `fn` takes the graph
    inputs as NCHW tensors on that device."""
    dev = resolve_device(device)
    if isinstance(prototxt, (str, os.PathLike)) and "\n" not in str(prototxt) \
            and os.path.exists(prototxt):
        prototxt = _read(prototxt, "r")
    net = prototxt if isinstance(prototxt, C.NetParameter) else load_prototxt(prototxt)

    weights: Dict[str, List[np.ndarray]] = {}
    for layer in net.layer:
        if layer.blobs:
            weights[layer.name] = [_blob_np(b) for b in layer.blobs]
    if caffemodel is not None:
        if isinstance(caffemodel, (str, os.PathLike)):
            caffemodel = _read(caffemodel, "rb")
        for layer in C.NetParameter.FromString(caffemodel).layer:
            if layer.blobs:
                weights[layer.name] = [_blob_np(b) for b in layer.blobs]

    # graph inputs: `input` fields or Input layers
    input_names = list(net.input)
    layers = []
    for layer in net.layer:
        if layer.type == "Input":
            input_names.extend(layer.top)
        else:
            if layer.type not in _LAYERS:
                raise NotImplementedError(
                    f"caffe layer type not supported: {layer.type} "
                    "(extend mnn_tpu_torch.convert.caffe_frontend._LAYERS, or register a "
                    "plugin via mnn_tpu_torch.plugin.register_op(..., frontend='caffe'))")
            layers.append(layer)

    params: Dict[str, torch.Tensor] = {
        f"{name}.{i}": torch.from_numpy(b).to(dev)
        for name, blobs in weights.items() for i, b in enumerate(blobs)}

    # outputs: tops never consumed as bottoms (after in-place collapsing)
    consumed = {b for l in layers for b in l.bottom}
    produced = [t for l in layers for t in l.top]
    output_names = [t for t in produced if t not in consumed] or produced[-1:]

    def fn(params, *inputs):
        env: Dict[str, Any] = dict(zip(input_names, inputs))
        ctx = _Ctx(env, dev)
        for layer in layers:
            blobs = [params[f"{layer.name}.{i}"]
                     for i in range(len(weights.get(layer.name, [])))]
            args = [env[b] for b in layer.bottom]
            out = _LAYERS[layer.type](ctx, layer, blobs, *args)
            tops = list(layer.top)
            if isinstance(out, tuple):
                for t, v in zip(tops, out):
                    env[t] = v
            elif layer.type == "Split":
                for t in tops:
                    env[t] = out
            else:
                env[tops[0]] = out
        outs = tuple(env[n] for n in output_names)
        return outs[0] if len(outs) == 1 else outs

    fn.input_names = input_names
    fn.output_names = output_names
    return fn, params
