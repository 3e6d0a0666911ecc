"""Sampling chain: penalty -> temperature -> top-k -> top-p -> min-p, plus
tail-free and locally-typical filters, greedy or a draw.

Counterpart of `mnn_tpu/runtime/sampler.py`. Every filter is a
deterministic transform of the logits row; only the final draw uses
randomness, from an explicit `torch.Generator` on the logits' device. The
JAX package draws from its own key stream, so the two packages agree on
the filtered distribution, not on the drawn tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Ring buffer of recent tokens for the repetition penalty."""

    recent: torch.Tensor   # [B, W] int32, -1 = empty
    pos: int = 0           # ring pointer (host-side count)


def make_state(batch: int, window: int = 64, device=None) -> SamplerState:
    return SamplerState(
        recent=torch.full((batch, window), -1, dtype=torch.int32, device=device))


def record_token(state: SamplerState, token: torch.Tensor) -> SamplerState:
    """Push sampled tokens [B] into the ring buffer."""
    recent = state.recent.clone()
    recent[:, state.pos % recent.shape[1]] = token.to(torch.int32)
    return SamplerState(recent=recent, pos=state.pos + 1)


def apply_penalty(logits: torch.Tensor, state: SamplerState,
                  penalty: float) -> torch.Tensor:
    """CTRL-style repetition penalty on the tokens in the window."""
    if penalty == 1.0:
        return logits
    v = logits.shape[-1]
    tok = state.recent.clamp(0, v - 1).long()
    valid = (state.recent >= 0).float()
    counts = torch.zeros(logits.shape, dtype=torch.float32,
                         device=logits.device).scatter_add_(1, tok, valid)
    lf = logits.float()
    penalized = torch.where(lf > 0, lf / penalty, lf * penalty)
    return torch.where(counts > 0, penalized, lf)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logits
    return logits / max(temperature, 1e-4)


def _cut_below(logits, cutoff):
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    cutoff = torch.topk(logits, k, dim=-1).values[..., -1:]
    return _cut_below(logits, cutoff)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always >= 1 token)
    keep = cum - probs < p
    cutoff = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, NEG_INF)
                         ).amax(dim=-1, keepdim=True)
    return _cut_below(logits, cutoff)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = probs.amax(dim=-1, keepdim=True) * min_p
    return torch.where(probs < cutoff, torch.full_like(logits, NEG_INF), logits)


def apply_tfs(logits: torch.Tensor, z: float) -> torch.Tensor:
    """Tail-free sampling (second derivative of the sorted probabilities)."""
    if z >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    d2 = torch.diff(torch.diff(probs, dim=-1), dim=-1).abs()
    d2 = d2 / d2.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    cum = torch.cumsum(d2, dim=-1)
    keep_n = (cum < z).sum(dim=-1, keepdim=True) + 1        # at least 1
    cutoff = torch.gather(sorted_logits, -1, keep_n)
    return _cut_below(logits, cutoff)


def apply_typical(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Locally-typical sampling."""
    if p >= 1.0:
        return logits
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)
    logp = torch.log_softmax(lf, dim=-1)
    ent = -(probs * logp).sum(dim=-1, keepdim=True)
    order = torch.argsort((-logp - ent).abs(), dim=-1, stable=True)
    probs_sorted = torch.gather(probs, -1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = cum - probs_sorted < p
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, lf, torch.full_like(lf, NEG_INF))


def sample(
    logits: torch.Tensor,                 # [B, V]
    generator: Optional[torch.Generator],
    state: Optional[SamplerState] = None,
    *,
    sampler: str = "mixed",
    temperature: float = 1.0,
    top_k: int = 40,
    top_p: float = 0.9,
    min_p: float = 0.05,
    tfs_z: float = 1.0,
    typical_p: float = 1.0,
    penalty: float = 1.0,
    logit_bias: Optional[torch.Tensor] = None,   # [V] or [B, V] additive
):
    """Returns (tokens [B] int32, new_state), in the order of MNN's chain."""
    lf = logits.float()
    if logit_bias is not None:
        bias = logit_bias.float()
        lf = lf + (bias if bias.dim() == 2 else bias[None])
    if state is not None and penalty != 1.0:
        lf = apply_penalty(lf, state, penalty)

    if sampler == "greedy" or (sampler == "temperature" and temperature == 0.0):
        tok = lf.argmax(dim=-1).to(torch.int32)
    else:
        if sampler in ("temperature", "mixed"):
            lf = apply_temperature(lf, temperature)
        if sampler in ("topK", "mixed"):
            lf = apply_top_k(lf, top_k)
        if sampler in ("topP", "mixed"):
            lf = apply_top_p(lf, top_p)
        if sampler in ("minP", "mixed"):
            lf = apply_min_p(lf, min_p)
        if sampler == "tfs":
            lf = apply_tfs(lf, tfs_z)
        if sampler == "typical":
            lf = apply_typical(lf, typical_p)
        probs = torch.softmax(lf, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    if state is not None:
        state = record_token(state, tok)
    return tok, state
