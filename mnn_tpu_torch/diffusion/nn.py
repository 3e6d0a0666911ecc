"""Shared building blocks of the diffusion models (UNet, VAE, CLIP text) and
of the audio towers.

Counterpart of the JAX package's `diffusion/nn.py`, as plain PyTorch ops
with the same rounding points: f32 accumulation, the result cast back to
the input's dtype, group and layer norms in f32. Layouts are PyTorch's:
feature maps NCHW, convolution weights OIHW (a diffusers checkpoint's own);
linear weights stay [in, out], as the JAX package keeps them. A feature map
flattened to tokens takes (h, w) row-major order, as the JAX package's NHWC
reshape does.

On the card an f32 product must not go through TF32: the f32 paths (the
vocoder, the towers, SD in f32) run under `no_tf32`, which turns TF32 off
in cuDNN (on by default in PyTorch) and in cuBLAS for the call and puts
both flags back after.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.kernels.common import resolve_device


@contextlib.contextmanager
def no_tf32():
    """Full f32 products in cuDNN convolutions and cuBLAS matmuls inside the
    block; the caller's TF32 flags come back after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """x [B, Cin, H, W], w [Cout, Cin, kh, kw] -> [B, Cout, H', W'] in x's
    dtype (f32 products and sums, the bias added in f32)."""
    out = F.conv2d(x.float(), w.float(), None, stride, padding)
    if b is not None:
        out = out + b[None, :, None, None]
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x [..., Din], w [Din, Dout] -> [..., Dout] in x's dtype."""
    out = torch.matmul(x.float(), w.float())
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, w, b, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Group norm over x [B, C, ...] in f32, cast back to x's dtype."""
    bsz, c = x.shape[:2]
    xf = x.float().reshape(bsz, groups, c // groups, -1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf.reshape(bsz, c, -1) * w[:, None] + b[:, None]
    return xf.reshape(x.shape).to(x.dtype)


def layer_norm(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w + b
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, mask=None) -> torch.Tensor:
    """Multi-head attention of projected q [B, Tq, D] over k / v [B, Tk, D]
    -> [B, Tq, D]; `mask` [Tq, Tk] bool (True: attend). f32 scores and
    softmax, the weights cast to v's dtype."""
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // num_heads
    q = q.reshape(b, tq, num_heads, dh).transpose(1, 2)
    k = k.reshape(b, tk, num_heads, dh).transpose(1, 2)
    v = v.reshape(b, tk, num_heads, dh).transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        s = s.masked_fill(~mask[None, None], float("-inf"))
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(a.float(), v.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, tq, d)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each op in x's dtype: `jax.nn.sigmoid`'s rounding
    points (in bf16 three roundings, where `torch.sigmoid` rounds once)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def timestep_embedding(t, dim: int, *, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0,
                       device=None) -> torch.Tensor:
    """Sinusoidal timestep embedding (Stable Diffusion's): t, a scalar or
    [B] timesteps, -> [B, dim] f32 on t's device (a tensor) or `device`
    (None: the card)."""
    if isinstance(t, torch.Tensor):
        t = t.to(torch.float32, copy=False) if device is None else t.to(device, torch.float32)
    else:
        t = torch.as_tensor(np.asarray(t, np.float32), device=resolve_device(device))
    t = t.reshape(-1)
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                     device=t.device)
    # divided by a tensor: on the card PyTorch multiplies by the reciprocal
    # of a Python scalar divisor
    exponent = exponent / torch.full_like(exponent, half - freq_shift)
    args = t[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], nearest neighbour."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def _f32(w, device=None) -> torch.Tensor:
    """A tensor or an array as an f32 tensor on `device`. With device None
    a tensor stays on its own device and an array goes to the card
    (`resolve_device`: raises when there is none)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float()
        return w if device is None else w.to(device)
    return torch.from_numpy(np.array(w, np.float32)).to(resolve_device(device))


def t_lin(w, device=None) -> torch.Tensor:
    """A torch linear weight [out, in] -> [in, out] f32 (`_f32`'s device)."""
    return _f32(w, device).t().contiguous()


def t_vec(w, device=None) -> torch.Tensor:
    return _f32(w, device).contiguous()


def t_conv(w, device=None) -> torch.Tensor:
    """A torch convolution weight, kept OIHW, as f32 (`_f32`'s device)."""
    return _f32(w, device).contiguous()
