"""Functional NN op library (NCHW, torch convention) in PyTorch.

Counterpart of the JAX package's `ops/nn_ops.py`, the table the graph
converters (`convert/torch_fx.py`, `convert/onnx_frontend.py`) lower onto.
The JAX package computes these with `lax` outside any Pallas kernel, so the
counterpart here is a PyTorch call: `F.conv2d` for `lax.conv_general_dilated`
(cuDNN on the card), `F.max_pool2d` / `F.avg_pool2d` for `reduce_window`.

Where the two differ, the JAX arithmetic is kept:
* `batch_norm` folds into one scale and shift in f32 and casts back to the
  input's dtype;
* `max_pool2d(ceil_mode=True)` pads the high side by stride - 1 with -inf
  and keeps every window, as the JAX package's over-padding does
  (`F.max_pool2d`'s ceil mode drops a window that starts in the padding);
* `resize_nearest` / `resize_bilinear` are `jax.image.resize`'s: the
  antialiased triangle weights of `cv/geometric.py` when downscaling, its
  nearest-neighbour ties; `resize_bilinear` ignores `align_corners`, as the
  JAX function does;
* `gelu` is the tanh approximation (`jax.nn.gelu`'s default).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from mnn_tpu_torch.cv.geometric import _linear_weights, _nearest_index

IntOr2 = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: IntOr2 = 1, padding: IntOr2 = 0, dilation: IntOr2 = 1,
           groups: int = 1) -> torch.Tensor:
    """x [N, Cin, H, W], weight [Cout, Cin / groups, kH, kW]; symmetric
    padding; the bias added after the convolution."""
    out = F.conv2d(x, weight, None, _pair(stride), _pair(padding), _pair(dilation), groups)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """weight [out, in] (torch layout)."""
    out = torch.matmul(x, weight.T)
    if bias is not None:
        out = out + bias
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None, eps: float = 1e-5):
    """Inference-mode batchnorm over channel axis 1."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    inv = torch.rsqrt(running_var.float() + eps)
    scale = inv if weight is None else inv * weight
    shift = -running_mean * scale + (0.0 if bias is None else bias)
    return (x * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
    axes = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def max_pool2d(x, kernel_size: IntOr2, stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0, ceil_mode: bool = False):
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    p = _pair(padding)
    if not ceil_mode and 2 * p[0] <= k[0] and 2 * p[1] <= k[1]:
        return F.max_pool2d(x, k, s, p)
    extra = (s[0] - 1, s[1] - 1) if ceil_mode else (0, 0)
    x = F.pad(x, (p[1], p[1] + extra[1], p[0], p[0] + extra[0]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def avg_pool2d(x, kernel_size: IntOr2, stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0, count_include_pad: bool = True):
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    p = _pair(padding)
    if 2 * p[0] <= k[0] and 2 * p[1] <= k[1]:
        return F.avg_pool2d(x, k, s, p, count_include_pad=count_include_pad or p == (0, 0))
    summed = F.avg_pool2d(F.pad(x, (p[1], p[1], p[0], p[0])), k, s) * (k[0] * k[1])
    if count_include_pad:
        return summed / (k[0] * k[1])
    ones = F.pad(torch.ones_like(x[:1, :1]), (p[1], p[1], p[0], p[0]))
    return summed / (F.avg_pool2d(ones, k, s) * (k[0] * k[1]))


def adaptive_avg_pool2d(x, output_size: IntOr2):
    """The bins of `torch.nn.AdaptiveAvgPool2d` (also the JAX package's)."""
    return F.adaptive_avg_pool2d(x, _pair(output_size))


def global_avg_pool(x):
    return x.mean(dim=(2, 3), keepdim=True)


def resize_nearest(x, size: IntOr2):
    oh, ow = _pair(size)
    if x.shape[2] != oh:
        x = x[:, :, _nearest_index(x.shape[2], oh, x.device)]
    if x.shape[3] != ow:
        x = x[:, :, :, _nearest_index(x.shape[3], ow, x.device)]
    return x


def resize_bilinear(x, size: IntOr2, align_corners: bool = False):
    """`jax.image.resize(..., "linear")`: the weights in the input's float
    dtype (integers become f32); `align_corners` is ignored, as in JAX."""
    oh, ow = _pair(size)
    if not x.is_floating_point():
        x = x.float()
    if x.shape[2] != oh:
        x = torch.einsum("nchw,hH->ncHw", x, _linear_weights(x.shape[2], oh, x.device).to(x.dtype))
    if x.shape[3] != ow:
        x = torch.einsum("nchw,wW->nchW", x, _linear_weights(x.shape[3], ow, x.device).to(x.dtype))
    return x


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def gelu(x, approximate: bool = True):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def softplus(x):
    """`jax.nn.softplus`: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# activation table (the JAX package's ACTIVATIONS, by name)
ACTIVATIONS = {
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0, 6),
    "silu": F.silu,
    "gelu": gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "hardswish": F.hardswish,
    "hardsigmoid": F.hardsigmoid,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "softplus": softplus,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "neg": torch.neg,
}
