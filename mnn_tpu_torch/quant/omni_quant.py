"""OmniQuant: quantization parameters learned by gradient descent.

Counterpart of `mnn_tpu/quant/omni_quant.py`, where the loop is jitted
optax; here a `torch.optim.Adam` loop on the weight's device. Two
transforms are learned by minimizing a layer's reconstruction error on
calibration inputs, through the straight-through fake quant of
`train/compress.py`:

  * LWC (learnable weight clipping): factors sigmoid(gamma), sigmoid(beta)
    in (0, 1) per (block, column) shrink the range [wmin, wmax] to
    [sigmoid(beta) wmin, sigmoid(gamma) wmax];
  * LET (learnable equivalent transformation): an input-channel scale s,
    y = (x / s) @ Q(s W), which generalizes the SmoothQuant / AWQ folds
    (the fold targets are `quant/awq_search.py`'s).

The result goes through the standard `quantize`, so the checkpoint keeps
every format invariant (bf16 covering-rounded planes).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mnn_tpu_torch.quant.quantize import (QuantizedLinear, as_f32, choose_block_size,
                                          quantize)
from mnn_tpu_torch.train.compress import clip, ste_round


def _at_least(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor), with `jnp.maximum`'s gradient at a tie."""
    return torch.maximum(x, torch.full_like(x, floor))


def _fake_quant_clipped(w, g_logit, b_logit, bits: int, bs: int, sym: bool) -> torch.Tensor:
    """Fake-quantize [K, N] with learnable clip factors [K // bs, N]."""
    k, n = w.shape
    wb = w.reshape(k // bs, bs, n)
    qmax = (1 << bits) - 1
    gamma = torch.sigmoid(g_logit)[:, None, :]
    if sym:
        amax = wb.abs().amax(dim=1, keepdim=True) * gamma
        center = 1 << (bits - 1)
        scale = _at_least(amax / (center - 1), 1e-8)
        q = clip(ste_round(wb / scale), -(center - 1), center - 1)
        return (q * scale).reshape(k, n)
    beta = torch.sigmoid(b_logit)[:, None, :]
    hi = wb.amax(dim=1, keepdim=True)
    lo = wb.amin(dim=1, keepdim=True)
    hi = torch.where(hi > 0, hi * gamma, hi)
    lo = torch.where(lo < 0, lo * beta, lo)
    scale = _at_least((hi - lo) / qmax, 1e-8)
    q = clip(ste_round((wb - lo) / scale), 0, qmax)
    return (q * scale + lo).reshape(k, n)


def omni_quantize(
    w,                         # [K, N] float weights
    x,                         # [S, K] calibration inputs
    *,
    bits: int = 4,
    block_size: int = 128,
    sym: bool = False,
    let: bool = True,          # learn the equivalent input scale too
    iters: int = 200,
    lr: float = 5e-2,
    out_bias=None,
    act_bits: int = 16,
    device=None,
) -> Tuple[QuantizedLinear, torch.Tensor]:
    """Learn the clipping (and with `let` the equivalent scale) that
    minimizes ||x' @ Q(w') - x @ w||^2, on `device` (None: w's own device
    if a tensor, else the card). Returns (the QuantizedLinear of the transformed weights, s
    [K]): a caller that deploys s folds 1 / s into the producing op, as
    with AWQ's scales; with let=False, s is all ones."""
    w = as_f32(w, device)
    x = as_f32(x, w.device)
    k, n = w.shape
    bs = choose_block_size(k, block_size)
    nb = k // bs
    y_ref = x @ w
    g = torch.full((nb, n), 4.0, device=w.device, requires_grad=True)  # sigmoid(4) ~ 0.982
    b = torch.full((nb, n), 4.0, device=w.device, requires_grad=True)
    ls = torch.zeros(k, device=w.device, requires_grad=True)            # log of s
    opt = torch.optim.Adam([g, b, ls], lr=lr)

    def scale_vec():
        return torch.exp(ls) if let else torch.ones(k, device=w.device)

    for _ in range(iters):
        s = scale_vec()
        wq = _fake_quant_clipped(w * s[:, None], g, b, bits, bs, sym)
        loss = (((x / s) @ wq - y_ref) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    with torch.no_grad():
        s = scale_vec()
        # the clipped, scaled weights go through the standard quantizer
        w_t = _fake_quant_clipped(w * s[:, None], g, b, bits, bs, sym)
        ob = None if out_bias is None else as_f32(out_bias, w.device)
        ql = quantize(w_t, bits=bits, block_size=bs, sym=sym, out_bias=ob,
                      act_bits=act_bits)
    return ql, s
