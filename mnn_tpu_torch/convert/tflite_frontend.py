"""TFLite -> function graph converter.

Counterpart of the JAX package's `convert/tflite_frontend.py`: parses a
`.tflite` FlatBuffers model with the same self-contained reader (`_FB`,
`_parse`: field ids from the public tensorflow/lite/schema/schema.fbs, no
`flatbuffers` or `tensorflow` package) and lowers the graph through an op
table keyed by builtin operator code (`_OPS`, the JAX table's 88 codes;
`custom_code` is not read, as in the JAX package) onto PyTorch and
`ops/nn_ops.py`, giving `fn(params, *inputs)` and `params`. A converter is
the JAX table's with the port's context in front, `fn(ctx, op, *inputs)`
(`ctx.device`, `ctx.t(value)`), so a plugin can place what it makes.

Quantized weights (int8 / uint8 / int16 with quantization parameters) are
dequantized on the host at conversion, per tensor or per channel along
`quantized_dimension`, in f32 as the JAX package does; execution is float.
Fused activations (`_fused`) and options tables are read with the schema's
defaults. The graph is NHWC: convolutions and pools run through the TF
frontend's channels-last views (`tf_frontend.conv_nhwc`, `pool_nhwc`), no
activation copied for the layout.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.convert.onnx_frontend import _Ctx, _np, _torch_dtype
from mnn_tpu_torch.convert.tf_frontend import (_nchw, _nhwc_of, _pads2, conv_nhwc,
                                               conv_transpose_lax, mirror_pad, pool_nhwc,
                                               strided_index, take)
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.ops import nn_ops as N


# ---------------------------------------------------------------------------
# minimal FlatBuffers wire-format reader

class _FB:
    """Read-only FlatBuffers accessor (tables, vtables, vectors, strings)."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def _sc(self, fmt, pos):
        return struct.unpack_from(fmt, self.buf, pos)[0]

    def u8(self, p): return self._sc("<B", p)
    def i8(self, p): return self._sc("<b", p)
    def u16(self, p): return self._sc("<H", p)
    def i32(self, p): return self._sc("<i", p)
    def u32(self, p): return self._sc("<I", p)
    def i64(self, p): return self._sc("<q", p)
    def f32(self, p): return self._sc("<f", p)

    def root(self) -> int:
        return self.u32(0)

    def field_pos(self, table: int, fid: int) -> int:
        """Absolute position of field `fid` in `table`, or 0 if absent."""
        vt = table - self.i32(table)
        entry = 4 + 2 * fid
        if entry >= self.u16(vt):
            return 0
        off = self.u16(vt + entry)
        return table + off if off else 0

    def scalar(self, table: int, fid: int, fmt: str, default=0):
        p = self.field_pos(table, fid)
        return self._sc(fmt, p) if p else default

    def indirect(self, table: int, fid: int) -> int:
        """Follow an offset field (table/vector/string); 0 if absent."""
        p = self.field_pos(table, fid)
        return p + self.u32(p) if p else 0

    def vec_len(self, vpos: int) -> int:
        return self.u32(vpos) if vpos else 0

    def vec_table(self, vpos: int, i: int) -> int:
        ep = vpos + 4 + 4 * i
        return ep + self.u32(ep)

    def vec_scalars(self, vpos: int, dtype) -> np.ndarray:
        if not vpos:
            return np.zeros((0,), dtype)
        n = self.u32(vpos)
        return np.frombuffer(self.buf, dtype, n, vpos + 4).copy()

    def string(self, table: int, fid: int) -> str:
        sp = self.indirect(table, fid)
        if not sp:
            return ""
        n = self.u32(sp)
        return self.buf[sp + 4: sp + 4 + n].decode("utf-8", "replace")


# TensorType enum per the public tflite schema: 0=F32 1=F16 2=I32 3=U8
# 4=I64 5=STRING 6=BOOL 7=I16 8=COMPLEX64 9=I8 10=F64 11=COMPLEX128
# 12=U64 13=RESOURCE 14=VARIANT 15=U32 16=U16 17=INT4 18=BF16
_TENSOR_DTYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
                  4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8,
                  10: np.float64, 12: np.uint64, 15: np.uint32,
                  16: np.uint16}


class _Tensor:
    def __init__(self, fb: _FB, tpos: int):
        self.shape = fb.vec_scalars(fb.indirect(tpos, 0), np.int32)
        self.type = fb.scalar(tpos, 1, "<b")
        self.buffer = fb.scalar(tpos, 2, "<I")
        self.name = fb.string(tpos, 3)
        self.scale = self.zero = None
        q = fb.indirect(tpos, 4)  # QuantizationParameters
        if q:
            sc = fb.vec_scalars(fb.indirect(q, 2), np.float32)
            zp = fb.vec_scalars(fb.indirect(q, 3), np.int64)
            qd = fb.scalar(q, 6, "<i")
            if sc.size:
                self.scale, self.zero, self.qdim = sc, zp, qd


class _Op:
    def __init__(self, fb: _FB, opos: int, opcodes: List[int]):
        self.code = opcodes[fb.scalar(opos, 0, "<I")]
        self.inputs = fb.vec_scalars(fb.indirect(opos, 1), np.int32)
        self.outputs = fb.vec_scalars(fb.indirect(opos, 2), np.int32)
        self._fb = fb
        self._opts = fb.indirect(opos, 4)

    # option accessors (field ids from schema.fbs builtin-options tables)
    def opt_i(self, fid, default=0):
        return self._fb.scalar(self._opts, fid, "<i", default) if self._opts \
            else default

    def opt_b(self, fid, default=0):
        return self._fb.scalar(self._opts, fid, "<b", default) if self._opts \
            else default

    def opt_bool(self, fid, default=False):
        return bool(self._fb.scalar(self._opts, fid, "<B", int(default))) \
            if self._opts else default

    def opt_f(self, fid, default=0.0):
        return self._fb.scalar(self._opts, fid, "<f", default) if self._opts \
            else default

    def opt_ivec(self, fid):
        return self._fb.vec_scalars(self._fb.indirect(self._opts, fid),
                                    np.int32) if self._opts else \
            np.zeros((0,), np.int32)


def _parse(buf: bytes):
    fb = _FB(buf)
    model = fb.root()
    ocv = fb.indirect(model, 1)  # operator_codes
    opcodes = []
    for i in range(fb.vec_len(ocv)):
        oc = fb.vec_table(ocv, i)
        code = fb.scalar(oc, 3, "<i")          # builtin_code (new field)
        if code == 0:
            code = fb.scalar(oc, 0, "<b")      # deprecated_builtin_code
        opcodes.append(code)

    bufs_v = fb.indirect(model, 4)
    buffers: List[Optional[np.ndarray]] = []
    for i in range(fb.vec_len(bufs_v)):
        b = fb.vec_table(bufs_v, i)
        dv = fb.indirect(b, 0)
        buffers.append(fb.vec_scalars(dv, np.uint8) if dv else None)

    sg = fb.vec_table(fb.indirect(model, 2), 0)  # subgraph 0
    tv = fb.indirect(sg, 0)
    tensors = [_Tensor(fb, fb.vec_table(tv, i)) for i in range(fb.vec_len(tv))]
    g_inputs = fb.vec_scalars(fb.indirect(sg, 1), np.int32)
    g_outputs = fb.vec_scalars(fb.indirect(sg, 2), np.int32)
    ov = fb.indirect(sg, 3)
    ops = [_Op(fb, fb.vec_table(ov, i), opcodes) for i in range(fb.vec_len(ov))]
    return tensors, buffers, g_inputs, g_outputs, ops


def _const_value(t: _Tensor, buffers) -> Optional[np.ndarray]:
    raw = buffers[t.buffer] if t.buffer < len(buffers) else None
    if raw is None or raw.size == 0:
        return None
    dt = _TENSOR_DTYPES.get(t.type)
    if dt is None:
        raise NotImplementedError(f"tflite tensor type {t.type}")
    arr = raw.view(dt).reshape([int(d) for d in t.shape] or [])
    if t.scale is not None and arr.dtype in (np.int8, np.uint8, np.int16):
        # weight dequantization (per-tensor or per-channel)
        sc, zp = t.scale, t.zero
        if sc.size > 1:  # per-channel along qdim
            shape = [1] * arr.ndim
            shape[t.qdim] = sc.size
            sc = sc.reshape(shape)
            zp = zp.reshape(shape) if zp.size > 1 else zp
        arr = (arr.astype(np.float32) - zp.astype(np.float32)) * sc
    return arr


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# lowering table

_PAD = {0: "SAME", 1: "VALID"}


def _fused(act: int, x):
    if act == 0:
        return x
    if act == 1:
        return F.relu(x)
    if act == 2:
        return torch.clamp(x, -1.0, 1.0)
    if act == 3:
        return torch.clamp(x, 0.0, 6.0)
    if act == 4:
        return torch.tanh(x)
    raise NotImplementedError(f"fused activation {act}")


def _conv2d(ctx, op: _Op, x, w, b=None):
    x, w = ctx.t(x), ctx.t(w)          # weights OHWI
    st = (op.opt_i(2, 1), op.opt_i(1, 1))
    dil = (op.opt_i(5, 1) or 1, op.opt_i(4, 1) or 1)
    pads = _pads2(_PAD[op.opt_b(0)], x.shape[1:3], w.shape[1:3], st, dil)
    out = conv_nhwc(x, w.permute(0, 3, 1, 2), st, pads, dil)
    if b is not None:
        out = out + ctx.t(b)
    return _fused(op.opt_b(3), out)


def _dwconv2d(ctx, op: _Op, x, w, b=None):
    x, w = ctx.t(x), ctx.t(w)          # weights [1, kh, kw, c * multiplier]
    c = x.shape[-1]
    st = (op.opt_i(2, 1), op.opt_i(1, 1))
    dil = (op.opt_i(6, 1) or 1, op.opt_i(5, 1) or 1)
    pads = _pads2(_PAD[op.opt_b(0)], x.shape[1:3], w.shape[1:3], st, dil)
    out = conv_nhwc(x, w.permute(3, 0, 1, 2), st, pads, dil, groups=c)
    if b is not None:
        out = out + ctx.t(b)
    return _fused(op.opt_b(4), out)


def _transpose_conv(ctx, op: _Op, out_shape, w, x, b=None):
    # weights OHWI, read as the JAX frontend reads them (HWOI after its
    # transpose, transpose_kernel=True): the forward kernel takes I to O
    out = _nhwc_of(conv_transpose_lax(_nchw(ctx.t(x)), ctx.t(w).permute(0, 3, 1, 2),
                                      (op.opt_i(2, 1), op.opt_i(1, 1)), _PAD[op.opt_b(0)]))
    if b is not None:
        out = out + ctx.t(b)
    return out


def _pool(kind):
    def run(ctx, op: _Op, x):
        x = ctx.t(x)
        k = (op.opt_i(4, 1), op.opt_i(3, 1))
        s = (op.opt_i(2, 1), op.opt_i(1, 1))
        pads = _pads2(_PAD[op.opt_b(0)], x.shape[1:3], k, s)
        return _fused(op.opt_b(5), pool_nhwc(x, kind, k, s, pads))
    return run


def _fully_connected(ctx, op: _Op, x, w, b=None):
    x, w = ctx.t(x), ctx.t(w)
    if not op.opt_bool(2):  # keep_num_dims=False: flatten to [batch, in]
        x = x.reshape(-1, w.shape[-1])
    out = torch.matmul(x, w.T)
    if b is not None:
        out = out + ctx.t(b)
    return _fused(op.opt_b(0), out)


def _reshape(ctx, op: _Op, x, shape=None):
    new = op.opt_ivec(0)
    if new.size == 0 and shape is not None:
        new = _np(shape)
    return x.reshape([int(d) for d in np.asarray(new).reshape(-1)])


def _strided_slice(ctx, op: _Op, x, begin, end, strides):
    begin, end, strides = (_np(v) for v in (begin, end, strides))
    bm, em, sm = op.opt_i(0), op.opt_i(1), op.opt_i(4)
    idx = []
    for d in range(len(begin)):
        b = None if (bm >> d) & 1 else int(begin[d])
        e = None if (em >> d) & 1 else int(end[d])
        if (sm >> d) & 1:  # shrink axis
            idx.append(int(begin[d]))
        else:
            idx.append(slice(b, e, int(strides[d])))
    return strided_index(x, idx)


def _resize(method):
    def run(ctx, op: _Op, x, size):
        h, w = (int(v) for v in _np(size))
        f = N.resize_bilinear if method == "bilinear" else N.resize_nearest
        return _nhwc_of(f(_nchw(ctx.t(x)), (h, w)))
    return run


def _mirror_pad(ctx, op: _Op, x, pads):
    mode = "reflect" if op.opt_b(0) == 0 else "symmetric"
    return mirror_pad(ctx.t(x), [tuple(int(v) for v in p) for p in _np(pads)], mode)


def _pad(ctx, op: _Op, x, pads, value=None):
    return mirror_pad(ctx.t(x), [tuple(int(v) for v in p) for p in _np(pads)], "constant",
                      0.0 if value is None else float(_np(value)))


def _batch_matmul(ctx, op: _Op, a, b):
    a, b = ctx.t(a), ctx.t(b)
    if op.opt_bool(0):
        a = a.transpose(-1, -2)
    if op.opt_bool(1):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _reduce(kind):
    def run(ctx, op: _Op, x, axes):
        x = ctx.t(x)
        ax = tuple(int(a) % max(x.dim(), 1) for a in np.atleast_1d(_np(axes)))
        keep = op.opt_bool(0)
        if not ax:
            return x
        if kind == "mean":
            return torch.mean(x if x.is_floating_point() else x.float(), dim=ax, keepdim=keep)
        if kind == "sum":
            return torch.sum(x, dim=ax, keepdim=keep).to(x.dtype)
        if kind == "max":
            return torch.amax(x, dim=ax, keepdim=keep)
        if kind == "min":
            return torch.amin(x, dim=ax, keepdim=keep)
        for a in sorted(ax, reverse=True):
            x = torch.prod(x, a, keepdim=keep).to(x.dtype)
        return x
    return run


def _split(ctx, op: _Op, axis, x):
    return tuple(torch.tensor_split(ctx.t(x), op.opt_i(0, 1), dim=int(_np(axis))))


def _split_v(ctx, op: _Op, x, sizes, axis):
    pts = np.cumsum(_np(sizes))[:-1]
    return tuple(torch.tensor_split(ctx.t(x), [int(p) for p in pts], dim=int(_np(axis))))


def _pack(ctx, op: _Op, *xs):
    return torch.stack([ctx.t(x) for x in xs], dim=op.opt_i(1))


def _unpack(ctx, op: _Op, x):
    x = ctx.t(x)
    ax = op.opt_i(1)
    n = op.opt_i(0, x.shape[ax])
    return tuple(s.squeeze(ax) for s in torch.tensor_split(x, n, dim=ax))


def _gelu(ctx, op: _Op, x):
    return N.gelu(ctx.t(x), approximate=op.opt_bool(0))


def _arg(f):
    def run(ctx, op: _Op, x, axis):
        return f(ctx.t(x), dim=int(_np(axis))).to(torch.int32)
    return run


def _cast(ctx, op: _Op, x):
    dt = _TENSOR_DTYPES.get(op.opt_b(1), np.float32)
    return ctx.t(x).to(_torch_dtype(dt))


def _elem(f, act_fid=None):
    def run(ctx, op: _Op, *xs):
        out = f(*[ctx.t(x) for x in xs])
        return _fused(op.opt_b(act_fid), out) if act_fid is not None else out
    return run


def _squeeze(ctx, op: _Op, x):
    dims = tuple(int(a) for a in op.opt_ivec(0))
    x = ctx.t(x)
    return x.squeeze(dims) if dims else x.squeeze()


def _slice(ctx, op: _Op, x, begin, size):
    x = ctx.t(x)
    out = x
    for d, (b, sz) in enumerate(zip(_np(begin), _np(size))):
        b, sz = int(b), int(sz)
        sz = sz if sz != -1 else x.shape[d] - b
        out = out.narrow(d, min(max(b, 0), x.shape[d] - sz), sz)   # lax.dynamic_slice clamps
    return out


def _fill(ctx, op: _Op, shape, value):
    v = np.asarray(_np(value))
    return torch.full([int(d) for d in _np(shape)], v.item(), dtype=_torch_dtype(v.dtype),
                      device=ctx.device)


_OPS: Dict[int, Any] = {
    0: _elem(torch.add, 0), 41: _elem(torch.sub, 0),
    18: _elem(torch.mul, 0), 42: _elem(torch.true_divide, 0),
    1: _pool("avg"), 17: _pool("max"),
    2: lambda ctx, op, *xs: _fused(op.opt_b(1), torch.cat([ctx.t(x) for x in xs],
                                                          dim=op.opt_i(0))),
    3: _conv2d, 4: _dwconv2d, 67: _transpose_conv,
    9: _fully_connected,
    14: _elem(torch.sigmoid), 19: _elem(F.relu),
    21: _elem(lambda x: torch.clamp(x, 0.0, 6.0)), 28: _elem(torch.tanh),
    22: _reshape,
    25: lambda ctx, op, x: torch.softmax(ctx.t(x) * op.opt_f(0, 1.0), dim=-1),
    50: _elem(lambda x: torch.log_softmax(x, dim=-1)),
    34: _pad, 60: _pad,
    100: _mirror_pad,
    39: lambda ctx, op, x, perm: ctx.t(x).permute(tuple(int(p) for p in _np(perm))),
    40: _reduce("mean"), 74: _reduce("sum"), 82: _reduce("max"),
    89: _reduce("min"), 81: _reduce("prod"),
    43: _squeeze,
    70: lambda ctx, op, x, ax: ctx.t(x).unsqueeze(int(_np(ax))),
    45: _strided_slice,
    65: _slice,
    47: _elem(torch.exp), 73: _elem(torch.log), 75: _elem(torch.sqrt),
    76: _elem(torch.rsqrt), 78: _elem(torch.pow),
    59: _elem(torch.neg), 101: _elem(torch.abs), 92: _elem(torch.square),
    99: _elem(lambda a, b: torch.square(a - b)),
    8: _elem(torch.floor), 104: _elem(torch.ceil),
    116: _elem(torch.round),
    90: _elem(torch.floor_divide),
    95: _elem(torch.remainder),
    55: _elem(torch.maximum), 57: _elem(torch.minimum),
    58: _elem(torch.lt), 61: _elem(torch.gt), 71: _elem(torch.eq),
    72: _elem(torch.ne), 62: _elem(torch.ge),
    63: _elem(torch.le),
    84: _elem(torch.logical_or), 86: _elem(torch.logical_and),
    87: _elem(torch.logical_not),
    64: _elem(lambda c, a, b: torch.where(c.bool(), a, b)),
    123: _elem(lambda c, a, b: torch.where(c.bool(), a, b)),
    54: _elem(lambda x, a: torch.where(x >= 0, x, x * a)),
    98: lambda ctx, op, x: torch.where(ctx.t(x) >= 0, ctx.t(x), ctx.t(x) * op.opt_f(0, 0.01)),
    111: _elem(F.elu),
    117: _elem(lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0),
    150: _gelu,
    11: _elem(lambda x: x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                                        min=1e-12)),
    66: _elem(torch.sin), 108: _elem(torch.cos),
    36: lambda ctx, op, x, i: take(ctx.t(x), i, op.opt_i(0)),
    107: lambda ctx, op, x, i: ctx.t(x)[tuple(ctx.t(i).long().unbind(-1))],
    69: lambda ctx, op, x, r: torch.tile(ctx.t(x), tuple(int(v) for v in _np(r))),
    77: lambda ctx, op, x: np.asarray(x.shape, np.int32),
    110: lambda ctx, op, x: np.int32(len(x.shape)),
    94: _fill,
    93: _elem(torch.zeros_like),
    83: _pack, 88: _unpack, 49: _split, 102: _split_v,
    53: _cast, 56: _arg(torch.argmax), 79: _arg(torch.argmin),
    23: _resize("bilinear"), 97: _resize("nearest"),
    26: lambda ctx, op, x: _space_to_depth(ctx.t(x), op.opt_i(0, 2)),
    5: lambda ctx, op, x: _depth_to_space(ctx.t(x), op.opt_i(0, 2)),
    106: lambda ctx, op, *xs: sum(ctx.t(x) for x in xs),
    6: lambda ctx, op, x: x,    # DEQUANTIZE (weights already dequantized)
    114: lambda ctx, op, x: x,  # QUANTIZE (float execution)
    126: _batch_matmul,
}

def _space_to_depth(x, bs):
    b, h, w, c = x.shape
    x = x.reshape(b, h // bs, bs, w // bs, bs, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // bs, w // bs, c * bs * bs)


def _depth_to_space(x, bs):
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, bs, bs, c // (bs * bs))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * bs, w * bs, c // (bs * bs))


# ---------------------------------------------------------------------------

def convert_tflite(model, device=None):
    """.tflite path or bytes -> (fn(params, *inputs) -> output(s), params).

    Float constants become `params`, tensors on `device` (the card when
    None; raises when there is none); integer constants stay numpy so shapes
    fold; `fn` takes the graph inputs as NHWC tensors on that device."""
    if isinstance(model, (str, os.PathLike)):
        with open(model, "rb") as f:
            model = f.read()
    dev = resolve_device(device)
    tensors, buffers, g_in, g_out, ops = _parse(bytes(model))

    unsupported = sorted({o.code for o in ops if o.code not in _OPS})
    if unsupported:
        raise NotImplementedError(
            f"tflite builtin ops not supported: {unsupported} "
            "(extend mnn_tpu_torch.convert.tflite_frontend._OPS, or register a plugin via "
            "mnn_tpu_torch.plugin.register_op(code, fn, frontend='tflite'))")

    consts: Dict[int, np.ndarray] = {}
    params: Dict[str, torch.Tensor] = {}
    param_idx: Dict[int, str] = {}
    for i, t in enumerate(tensors):
        val = _const_value(t, buffers)
        if val is None:
            continue
        if val.dtype in (np.float32, np.float16, np.float64):
            name = t.name or f"t{i}"
            params[name] = torch.from_numpy(np.asarray(val, np.float32)).to(dev)
            param_idx[i] = name
        else:
            consts[i] = val

    input_idx = [int(i) for i in g_in]
    output_idx = [int(i) for i in g_out]

    def fn(params, *inputs):
        env: Dict[int, Any] = dict(consts)
        for i, name in param_idx.items():
            env[i] = params[name]
        for i, val in zip(input_idx, inputs):
            env[i] = val
        ctx = _Ctx(env, dev)
        for op in ops:
            args = [env[int(i)] if i >= 0 else None for i in op.inputs]
            while args and args[-1] is None:
                args.pop()
            out = _OPS[op.code](ctx, op, *args)
            if isinstance(out, tuple):
                for oi, v in zip(op.outputs, out):
                    env[int(oi)] = v
            else:
                env[int(op.outputs[0])] = out
        outs = tuple(env[i] for i in output_idx)
        return outs[0] if len(outs) == 1 else outs

    fn.input_names = [tensors[i].name or f"t{i}" for i in input_idx]
    fn.output_names = [tensors[i].name or f"t{i}" for i in output_idx]
    fn.input_shapes = [tuple(int(d) for d in tensors[i].shape) for i in input_idx]
    return fn, params
