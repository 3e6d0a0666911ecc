"""Quantization-aware training and pruning.

Counterpart of `mnn_tpu/train/compress.py`: fake quantization and pruning
masks as plain torch functions with straight-through gradients, so they
drop into any autograd training loop. `fake_quant_weight` lands on the
inference quantizer's grid (`quant/quantize.py`), the bf16 rounding of the
stored scale and bias planes included, so a QAT-trained weight deploys
with no gap: on any device its values are those of
`dequantize(quantize(w))`, bit for bit (every divisor is a tensor, as in
`quantize`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mnn_tpu_torch.quant.quantize import _bf16_round_down, _bf16_round_up


class _SteRound(torch.autograd.Function):
    """round(x) with the identity as its gradient (straight through)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)


def _ste_to_bf16_grid(x: torch.Tensor, round_fn) -> torch.Tensor:
    """x snapped onto the bf16 storage grid by a covering rounding, with a
    straight-through gradient: the bit-level rounders have none, so the
    snap is added as a detached delta."""
    xd = x.detach()
    return x + (round_fn(xd) - xd)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi), as `jnp.clip`: at a bound the gradient is split
    between x and the bound (half to x), where `torch.clamp` passes it all."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _div(a: torch.Tensor, d) -> torch.Tensor:
    """a / d with d as a tensor: on the card PyTorch multiplies by the
    reciprocal of a Python scalar divisor, at times an ulp off."""
    return a / torch.full_like(a, d)


def fake_quant_weight(w: torch.Tensor, bits: int = 4, block_size: int = 128,
                      sym: bool = False) -> torch.Tensor:
    """Per-block asym / sym fake quantization of [K, N] weights on the
    inference grid: the scale rounded up and the block minimum down to
    bf16, q = clip(round(.)) against the rounded values. Gradients pass
    straight through the rounding; scale and zero follow the live weights
    (min/max calibration)."""
    k, n = w.shape
    wb = w.reshape(k // block_size, block_size, n)
    qmax = (1 << bits) - 1
    center = 1 << (bits - 1)
    if sym:
        amax = wb.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax == 0, torch.ones_like(amax), _div(amax, center - 1))
        scale = _ste_to_bf16_grid(scale, _bf16_round_up)
        q = clip(ste_round(wb / scale) + center, 1, qmax)
        return ((q - center) * scale).reshape(k, n)
    lo = _ste_to_bf16_grid(wb.amin(dim=1, keepdim=True), _bf16_round_down)
    hi = wb.amax(dim=1, keepdim=True)
    scale = _div(hi - lo, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    scale = _ste_to_bf16_grid(scale, _bf16_round_up)
    q = clip(ste_round((wb - lo) / scale), 0, qmax)
    return (q * scale + lo).reshape(k, n)


def fake_quant_activation(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-token symmetric activation fake quantization (the deployed
    dynamic int8 activation path)."""
    qmax = (1 << (bits - 1)) - 1
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = _div(amax, qmax)
    scale = torch.maximum(scale, torch.full_like(scale, 1e-8))
    return clip(ste_round(x / scale), -qmax - 1, qmax) * scale


def qat_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
               bits: int = 4, block_size: int = 128, sym: bool = False,
               act_bits: int = 0) -> torch.Tensor:
    """A linear layer under QAT: fake-quantized weights (and activations
    with `act_bits`), the product in f32, cast to x's dtype; gradients
    straight through to the float master weights."""
    wq = fake_quant_weight(w, bits=bits, block_size=block_size, sym=sym)
    xq = fake_quant_activation(x, act_bits) if act_bits else x
    y = (xq.float() @ wq.float()).to(x.dtype)
    return y + b if b is not None else y


# ---------------------------------------------------------------------------
# pruning

@dataclasses.dataclass(frozen=True)
class PruneSpec:
    sparsity: float = 0.5          # fraction of weights removed
    structured: bool = False       # True: whole output channels
    block: int = 1                 # K-blocked scores (semi-structured)


def prune_mask(w: torch.Tensor, spec: PruneSpec) -> torch.Tensor:
    """Magnitude mask (1 = keep) in w's dtype: unstructured, by output
    channel (the columns of [K, N] with the lowest L2 norms), or by blocks
    of `spec.block` rows along K."""
    if spec.structured:
        norms = torch.linalg.vector_norm(w, dim=0)
        n_drop = int(w.shape[1] * spec.sparsity)
        if n_drop == 0:
            return torch.ones_like(w)
        thresh = torch.sort(norms).values[n_drop - 1]
        return (norms > thresh)[None].expand(w.shape).to(w.dtype)
    score = w.abs()
    if spec.block > 1:
        k, n = w.shape
        sb = score.reshape(k // spec.block, spec.block, n).sum(dim=1)
        score = sb.repeat_interleave(spec.block, dim=0)
    flat = score.reshape(-1)
    n_drop = int(flat.numel() * spec.sparsity)
    if n_drop == 0:
        return torch.ones_like(w)
    thresh = torch.sort(flat).values[n_drop - 1]
    return (score > thresh).to(w.dtype)


class _ApplyMask(torch.autograd.Function):
    """w * mask whose gradient reaches only the surviving weights, so a
    pruned weight stays pruned across fine-tuning steps."""

    @staticmethod
    def forward(ctx, w, mask):
        ctx.save_for_backward(mask)
        return w * mask

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _ApplyMask.apply(w, mask)


def sparsity_of(mask: torch.Tensor) -> float:
    return float(1.0 - mask.float().mean())


def gmp_sparsity(step: int, *, target: float, begin: int, end: int,
                 power: float = 3.0) -> float:
    """Gradual magnitude pruning (Zhu & Gupta): 0 up to `begin`, `target`
    from `end`, a polynomial ramp between."""
    if step <= begin:
        return 0.0
    if step >= end:
        return target
    frac = (step - begin) / max(end - begin, 1)
    return target * (1.0 - (1.0 - frac) ** power)
