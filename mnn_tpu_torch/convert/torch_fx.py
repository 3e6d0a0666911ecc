"""torch.fx -> function graph converter (the generic-model frontend).

Counterpart of the JAX package's `convert/torch_fx.py`: traces a
`torch.nn.Module` with `torch.fx` and lowers every node through an op table
(`MODULE_LOWERING`, `FUNCTION_LOWERING`, `METHOD_LOWERING`) onto
`ops/nn_ops.py`, giving `fn(params, *inputs)` and `params`, a dict
{module path: {tensor name: tensor}} plus {"__attrs__": {...}} of tensors
on the device. `fn` reads each module's hyperparameters (stride, eps, ...)
but never calls the module: every op runs through the tables, so an
unlowered module raises `NotImplementedError` naming its type. BatchNorm
stays unfused, as in the JAX package. Each intermediate is dropped after
its last use (XLA plans the JAX function's buffers; an eager run would
otherwise hold every activation until the output).
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.ops import nn_ops as N


# -- call_module lowering: torch module instance -> fn(params, x, ...) ------

def _lower_conv(mod, p, x):
    return N.conv2d(x, p["weight"], p.get("bias"), stride=mod.stride, padding=mod.padding,
                    dilation=mod.dilation, groups=mod.groups)


def _lower_bn(mod, p, x):
    return N.batch_norm(x, p["running_mean"], p["running_var"], p.get("weight"),
                        p.get("bias"), eps=mod.eps)


def _lower_linear(mod, p, x):
    return N.linear(x, p["weight"], p.get("bias"))


def _lower_ln(mod, p, x):
    return N.layer_norm(x, mod.normalized_shape, p.get("weight"), p.get("bias"), eps=mod.eps)


def MODULE_LOWERING():
    import torch.nn as nn

    return {
        nn.Conv2d: _lower_conv,
        nn.BatchNorm2d: _lower_bn,
        nn.Linear: _lower_linear,
        nn.LayerNorm: _lower_ln,
        nn.ReLU: lambda m, p, x: F.relu(x),
        nn.ReLU6: lambda m, p, x: torch.clamp(x, 0, 6),
        nn.SiLU: lambda m, p, x: F.silu(x),
        nn.GELU: lambda m, p, x: N.gelu(
            x, approximate=(getattr(m, "approximate", "none") != "none")),
        nn.Sigmoid: lambda m, p, x: torch.sigmoid(x),
        nn.Tanh: lambda m, p, x: torch.tanh(x),
        nn.Hardswish: lambda m, p, x: F.hardswish(x),
        nn.Hardsigmoid: lambda m, p, x: F.hardsigmoid(x),
        nn.LeakyReLU: lambda m, p, x: F.leaky_relu(x, m.negative_slope),
        nn.MaxPool2d: lambda m, p, x: N.max_pool2d(x, m.kernel_size, m.stride, m.padding,
                                                   m.ceil_mode),
        nn.AvgPool2d: lambda m, p, x: N.avg_pool2d(x, m.kernel_size, m.stride, m.padding),
        nn.AdaptiveAvgPool2d: lambda m, p, x: N.adaptive_avg_pool2d(x, m.output_size),
        nn.Flatten: lambda m, p, x: _flatten(x, m.start_dim, m.end_dim),
        nn.Dropout: lambda m, p, x: x,
        nn.Identity: lambda m, p, x: x,
        nn.Softmax: lambda m, p, x: torch.softmax(x, dim=m.dim),
        nn.Embedding: lambda m, p, x: p["weight"][x],
        nn.Upsample: lambda m, p, x: _upsample(m, x),
    }


def _flatten(x, start_dim=0, end_dim=-1):
    shape = list(x.shape)
    nd = len(shape)
    s = start_dim % nd
    e = end_dim % nd
    newshape = shape[:s] + [int(np.prod(shape[s: e + 1]))] + shape[e + 1:]
    return x.reshape(newshape)


def _upsample(m, x):
    if m.scale_factor is not None:
        sf = m.scale_factor if isinstance(m.scale_factor, (tuple, list)) else (
            m.scale_factor, m.scale_factor)
        size = (int(x.shape[2] * sf[0]), int(x.shape[3] * sf[1]))
    else:
        size = m.size
    if m.mode == "nearest":
        return N.resize_nearest(x, size)
    return N.resize_bilinear(x, size)


def _shape_arg(shape):
    return shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list)) else shape


# -- call_function / call_method lowering -----------------------------------

def FUNCTION_LOWERING():
    def conv2d_fn(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        return N.conv2d(x, weight, bias, stride, padding, dilation, groups)

    def batch_norm_fn(x, running_mean, running_var, weight=None, bias=None,
                      training=False, momentum=0.1, eps=1e-5):
        return N.batch_norm(x, running_mean, running_var, weight, bias, eps)

    table: Dict[Any, Callable] = {
        operator.add: operator.add,
        operator.sub: operator.sub,
        operator.mul: operator.mul,
        operator.truediv: operator.truediv,
        operator.getitem: lambda x, idx: x[idx],
        operator.floordiv: operator.floordiv,
        torch.add: lambda a, b: a + b,
        torch.mul: lambda a, b: a * b,
        torch.sub: lambda a, b: a - b,
        torch.cat: lambda tensors, dim=0: torch.cat(tensors, dim=dim),
        torch.flatten: _flatten,
        torch.relu: F.relu,
        torch.sigmoid: torch.sigmoid,
        torch.tanh: torch.tanh,
        torch.exp: torch.exp,
        torch.mean: lambda x, dim=None, keepdim=False: (
            x.mean() if dim is None and not keepdim else x.mean(
                dim=tuple(range(x.dim())) if dim is None else dim, keepdim=keepdim)),
        torch.permute: lambda x, dims: x.permute(dims),
        torch.transpose: lambda x, a, b: x.transpose(a, b),
        torch.softmax: lambda x, dim: torch.softmax(x, dim=dim),
        torch.matmul: torch.matmul,
        F.relu: F.relu,
        F.relu6: lambda x: torch.clamp(x, 0, 6),
        F.silu: F.silu,
        F.gelu: lambda x, approximate="none": N.gelu(x, approximate=(approximate != "none")),
        F.hardswish: F.hardswish,
        F.hardsigmoid: F.hardsigmoid,
        F.softmax: lambda x, dim=-1: torch.softmax(x, dim=dim),
        F.adaptive_avg_pool2d: N.adaptive_avg_pool2d,
        F.avg_pool2d: lambda x, kernel_size, stride=None, padding=0, ceil_mode=False,
        count_include_pad=True, divisor_override=None: (
            N.avg_pool2d(x, kernel_size, stride, padding, count_include_pad)),
        F.max_pool2d: lambda x, kernel_size, stride=None, padding=0, dilation=1,
        ceil_mode=False, return_indices=False: (
            N.max_pool2d(x, kernel_size, stride, padding, ceil_mode)),
        F.interpolate: lambda x, size=None, scale_factor=None, mode="nearest",
        align_corners=None: (
            N.resize_nearest(x, size) if mode == "nearest" else N.resize_bilinear(x, size)),
        F.dropout: lambda x, p=0.5, training=False, inplace=False: x,
        F.conv2d: conv2d_fn,
        torch.conv2d: conv2d_fn,
        F.linear: N.linear,
        F.batch_norm: batch_norm_fn,
        F.layer_norm: lambda x, shape, weight=None, bias=None, eps=1e-5: (
            N.layer_norm(x, shape, weight, bias, eps)),
    }
    return table


METHOD_LOWERING = {
    "view": lambda x, *shape: x.reshape(_shape_arg(shape)),
    "reshape": lambda x, *shape: x.reshape(_shape_arg(shape)),
    "flatten": _flatten,
    "permute": lambda x, *dims: x.permute(_shape_arg(dims)),
    "transpose": lambda x, a, b: x.transpose(a, b),
    "contiguous": lambda x: x,
    "mean": lambda x, dim=None, keepdim=False: x.mean(
        dim=tuple(range(x.dim())) if dim is None else dim, keepdim=keepdim),
    "sum": lambda x, dim=None, keepdim=False: x.sum(
        dim=tuple(range(x.dim())) if dim is None else dim, keepdim=keepdim),
    "size": lambda x, dim=None: tuple(x.shape) if dim is None else x.shape[dim],
    "squeeze": lambda x, dim=None: x.squeeze() if dim is None else x.squeeze(dim),
    "unsqueeze": lambda x, dim: x.unsqueeze(dim),
    "chunk": lambda x, n, dim=0: tuple(torch.tensor_split(x, n, dim=dim)),
    "add": lambda x, y: x + y,
    "mul": lambda x, y: x * y,
    "float": lambda x: x.float(),
}


def convert_torch_module(mod, sample_inputs=None, device=None):
    """Trace `mod` (eval mode) and return (fn, params).

    fn(params, *inputs) reproduces mod(*inputs) through the op tables;
    params is {module_path: {tensor_name: tensor}} plus {"__attrs__":
    {...}}, copies of the module's parameters and buffers on `device` (the
    card when None; raises when there is none)."""
    import torch.fx as fx

    dev = resolve_device(device)
    mod = mod.eval()
    gm = fx.symbolic_trace(mod)
    module_table = MODULE_LOWERING()
    fn_table = FUNCTION_LOWERING()

    def copy(t):
        return t.detach().to(dev, copy=True)

    params: Dict[str, Dict[str, torch.Tensor]] = {}
    modules = dict(gm.named_modules())
    for name, sub in modules.items():
        tensors = {tname: copy(t) for tname, t in list(sub.named_parameters(recurse=False))
                   + list(sub.named_buffers(recurse=False))}
        if tensors:
            params[name] = tensors

    attrs: Dict[str, torch.Tensor] = {}
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            t = gm
            for part in node.target.split("."):
                t = getattr(t, part)
            attrs[node.target] = copy(t)
    if attrs:
        params["__attrs__"] = attrs

    graph = gm.graph
    # each value is dropped after its last use, as torch.fx.Interpreter
    # does: an eager run would otherwise hold every activation to the end
    last_use: Dict[str, list] = {}
    seen = set()
    for node in reversed(list(graph.nodes)):
        for inp in node.all_input_nodes:
            if inp.name not in seen:
                seen.add(inp.name)
                last_use.setdefault(node.name, []).append(inp.name)

    def torch_fn(params, *inputs):
        env: Dict[str, Any] = {}
        it = iter(inputs)

        def lookup(a):
            if isinstance(a, fx.Node):
                return env[a.name]
            if isinstance(a, (list, tuple)):
                return type(a)(lookup(x) for x in a)
            if isinstance(a, dict):
                return {k: lookup(v) for k, v in a.items()}
            return a

        for node in graph.nodes:
            if node.op == "placeholder":
                env[node.name] = next(it)
            elif node.op == "get_attr":
                env[node.name] = params["__attrs__"][node.target]
            elif node.op == "call_module":
                sub = modules[node.target]
                fn = module_table.get(type(sub))
                if fn is None:
                    raise NotImplementedError(
                        f"no lowering for module {type(sub).__name__} ({node.target})")
                args = [lookup(a) for a in node.args]
                env[node.name] = fn(sub, params.get(node.target, {}), *args)
            elif node.op == "call_function":
                fn = fn_table.get(node.target)
                if fn is None:
                    raise NotImplementedError(f"no lowering for function {node.target}")
                args = [lookup(a) for a in node.args]
                kwargs = {k: lookup(v) for k, v in node.kwargs.items()}
                env[node.name] = fn(*args, **kwargs)
            elif node.op == "call_method":
                fn = METHOD_LOWERING.get(node.target)
                if fn is None:
                    raise NotImplementedError(f"no lowering for method .{node.target}()")
                args = [lookup(a) for a in node.args]
                kwargs = {k: lookup(v) for k, v in node.kwargs.items()}
                env[node.name] = fn(*args, **kwargs)
            elif node.op == "output":
                return lookup(node.args[0])
            for name in last_use.get(node.name, ()):
                del env[name]
        raise RuntimeError("graph had no output node")

    return torch_fn, params
