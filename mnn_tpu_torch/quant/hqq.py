"""HQQ (half-quadratic quantization) of weights.

Counterpart of `mnn_tpu/quant/hqq.py`, in torch on the weight's device:
calibration-free per-block asymmetric quantization whose zero-point is
optimized under a sparsity-promoting l_p (p < 1) error instead of plain
round to nearest, which holds up against the heavy-tailed outliers that
dominate round-to-nearest error at 4 bits. Half-quadratic splitting:

    repeat:
        Wq = clip(round(W / s + z), 0, 2^b - 1)
        We = shrink_p(W - s (Wq - z), beta)      # generalized shrinkage
        z  = mean(Wq - (W - We) / s)             # closed-form zero update
        beta *= kappa

The scales stay at their min/max start (HQQ v1); only the zero moves. The
result is a standard QuantizedLinear (w = q scale + bias, bias = -z scale),
so the kernels take it unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from mnn_tpu_torch.quant.quantize import (QuantizedLinear, _check_args, as_f32,
                                          choose_block_size, pack_q)


def _shrink_lp(x: torch.Tensor, beta: float, p: float) -> torch.Tensor:
    """Generalized soft threshold for the l_p (p < 1) penalty."""
    ax = x.abs()
    return torch.sign(x) * torch.clamp(ax - (1.0 / beta) * ax ** (p - 1.0), min=0.0)


def quantize_hqq(
    w,
    bits: int = 4,
    block_size: int = 128,
    iters: int = 20,
    p: float = 0.7,
    beta: float = 10.0,
    kappa: float = 1.01,
    out_bias: Optional[torch.Tensor] = None,
    act_bits: int = 16,
    device=None,
) -> QuantizedLinear:
    """Quantize float [K, N] weights with HQQ's zero-point optimization, on
    `device` (None: a tensor's own device, the card for an array)."""
    w = as_f32(w, device)
    k, n = w.shape
    block_size = choose_block_size(k, block_size)
    _check_args(k, bits, block_size)
    qmax = (1 << bits) - 1
    blocks = w.reshape(k // block_size, block_size, n)

    wmin = blocks.amin(dim=1)
    wmax = blocks.amax(dim=1)
    scale = (wmax - wmin) / torch.full_like(wmax, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero = -wmin / scale                  # w / s + z maps wmin to 0
    s3 = scale[:, None, :]
    for _ in range(iters):
        q = torch.clamp(torch.round(blocks / s3 + zero[:, None, :]), 0, qmax)
        w_r = (q - zero[:, None, :]) * s3
        w_e = _shrink_lp(blocks - w_r, beta, p)
        zero = (q - (blocks - w_e) / s3).mean(dim=1)
        beta *= kappa

    # (scale, bias) go to the bf16 storage grid first, and q is chosen
    # against the rounded planes the kernels read back
    scale = scale.to(torch.bfloat16).float()
    bias = (-zero * scale).to(torch.bfloat16).float()
    q = torch.clamp(torch.round((blocks - bias[:, None, :]) / scale[:, None, :]),
                    0, qmax).reshape(k, n)
    ob = None if out_bias is None else as_f32(out_bias, w.device)
    return QuantizedLinear(packed=pack_q(q.to(torch.int32), bits, block_size),
                           scale=scale.to(torch.bfloat16), bias=bias.to(torch.bfloat16),
                           out_bias=ob, bits=bits, block_size=block_size,
                           act_bits=act_bits)
