"""The building blocks that the audio encoder takes from the JAX package's
`diffusion/nn.py`: `linear`, `layer_norm`, `attention` and the torch-layout
converters `t_lin` / `t_vec`, as plain PyTorch ops with the same rounding
points (f32 accumulation, the result cast back to the input's dtype). The
rest of `diffusion/` is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mnn_tpu_torch.kernels.common import resolve_device


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x [..., Din], w [Din, Dout] -> [..., Dout] in x's dtype."""
    out = torch.matmul(x.float(), w.float())
    if b is not None:
        out = out + b
    return out.to(x.dtype)


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
