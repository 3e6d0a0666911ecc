"""EAGLE draft model and MTP prediction heads for speculative decoding.

Counterpart of `mnn_tpu/models/eagle.py`. The EAGLE draft net is one
decoder layer over (token, feature) pairs, EAGLE-1's shape: input =
concat(embed(token_t), feature_{t-1}) -> fc -> one layer with NO
pre-attention norm -> hidden; draft logits reuse the TARGET's embedding and
lm head (no final norm, as in the JAX package). `feature` is the target's
post-final-norm hidden state. The layer keeps its own one-layer bf16 KV
cache. Its projections run the port's dequant matmul kernel (the GEMV at
one row, the tile kernel above); a single-position step attends through
the flash decode kernel over the one-layer cache, several positions
through the flash prefill kernel at `q_offset` = the cache length. The fc
product and the MTP heads' residual products are bf16 products with f32
sums, torch ops as the JAX package computes them outside any Pallas kernel.

MTP heads are Medusa-style residual blocks off the last target feature:
head_i(feature) = feature + silu(feature @ w_res[i]) predicts token
t + 1 + i through the target's head; no draft KV state at all.

The greedy argmax is `decode_model.lowest_argmax` (the lowest index among
equal maxima, as `jnp.argmax` takes it), and draft tokens stay on the
device: the caller reads a whole round's tokens at once.

Deliberate difference: `init_random_eagle` and `init_random_mtp` draw from a
`torch.Generator`, so their weights are not the JAX package's for the same
seed (as `decoder.init_random_params`). `eagle_params_from_numpy` and
`mtp_from_numpy` carry the JAX package's own draft weights across.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from mnn_tpu_torch.kernels.decode_model import lowest_argmax
from mnn_tpu_torch.kernels.dequant_matmul import dequant_matmul
from mnn_tpu_torch.kernels.flash_attention import decode_attention, flash_attention
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.decoder import Params, field_from, head_logits, ql_from
from mnn_tpu_torch.models.layers import (apply_rope, rms_norm, rope_cos_sin,
                                         split_gate_up, swiglu)
from mnn_tpu_torch.quant.quantize import QuantizedLinear, quantize
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.kvcache import KVCache


@dataclasses.dataclass(frozen=True)
class EagleParams:
    """One-layer EAGLE draft network (embedding and lm head: the target's)."""

    fc: torch.Tensor            # [2 * hidden, hidden] bf16 fuses (embed, feature)
    wqkv: QuantizedLinear       # grouped [Hkv, G+2, D] columns, like the target
    wo: QuantizedLinear
    wgu: QuantizedLinear        # gate/up in the block-interleaved layout
    wdown: QuantizedLinear
    post_norm: torch.Tensor     # [hidden] f32


@dataclasses.dataclass(frozen=True)
class MtpHeads:
    """K Medusa/MTP residual heads: h_i = feature + silu(feature @ w_res[i])."""

    w_res: torch.Tensor         # [K, hidden, hidden] bf16

    @property
    def num_heads(self) -> int:
        return self.w_res.shape[0]


def init_random_eagle(c: ModelConfig, generator: torch.Generator, bits: int = 4,
                      block_size: int = 128, device=None) -> EagleParams:
    """Random draft weights: normal draws from `generator` (on the CPU, so
    the same seed gives the same weights on every device), quantized on
    `device` as the JAX package quantizes its own (block min(block_size,
    K))."""
    h = c.hidden_size
    g = c.num_heads // c.num_kv_heads
    qkv_n = c.num_kv_heads * (g + 2) * c.head_dim

    def ql(kin, n):
        w = torch.randn((kin, n), generator=generator) * (kin ** -0.5)
        return quantize(w.to(device), bits=bits, block_size=min(block_size, kin))

    fc = (torch.randn((2 * h, h), generator=generator) * h ** -0.5).to(torch.bfloat16)
    return EagleParams(
        fc=fc.to(device), wqkv=ql(h, qkv_n), wo=ql(c.q_dim, h),
        wgu=ql(h, 2 * c.intermediate_size), wdown=ql(c.intermediate_size, h),
        post_norm=torch.ones((h,), dtype=torch.float32, device=device))


def init_random_mtp(c: ModelConfig, generator: torch.Generator, num_heads: int = 4,
                    device=None) -> MtpHeads:
    h = c.hidden_size
    w = torch.randn((num_heads, h, h), generator=generator) * h ** -0.5
    return MtpHeads(w_res=w.to(torch.bfloat16).to(device))


def eagle_params_from_numpy(arrays: Mapping[str, object], device=None) -> EagleParams:
    """EagleParams from the JAX package's EagleParams fields (dotted names:
    "fc", "wqkv.packed", "wqkv.scale", "wqkv.bias", "wqkv.bits",
    "wqkv.block_size", ..., "post_norm"), as numpy arrays (bf16 carried
    through its bits) or tensors; the packed bytes as they are."""
    return EagleParams(
        fc=field_from(arrays, "fc", device), wqkv=ql_from(arrays, "wqkv", device),
        wo=ql_from(arrays, "wo", device), wgu=ql_from(arrays, "wgu", device),
        wdown=ql_from(arrays, "wdown", device),
        post_norm=field_from(arrays, "post_norm", device))


def mtp_from_numpy(arrays: Mapping[str, object], device=None) -> MtpHeads:
    """MtpHeads from the JAX package's MtpHeads fields ("w_res")."""
    return MtpHeads(w_res=field_from(arrays, "w_res", device))


def create_draft_cache(c: ModelConfig, capacity: int, batch: int = 1,
                       device=None) -> KVCache:
    """1-layer bf16 KV cache for the draft network (tiny; quant buys nothing)."""
    return kvcache.create(1, batch, c.num_kv_heads, capacity, c.head_dim,
                          quantized=False, device=device)


def eagle_forward(ep: EagleParams, params: Params, config: ModelConfig,
                  tokens: torch.Tensor,        # [B, T] int
                  features: torch.Tensor,      # [B, T, hidden] target features, shifted -1
                  cache: KVCache):             # 1-layer draft cache
    """The draft layer over (token, feature) pairs, appending T positions to
    the draft cache in place. Returns (hidden [B, T, hidden] bf16, cache
    with the new length)."""
    c = config
    b, t = tokens.shape
    emb = params.embedding[tokens].to(torch.bfloat16)
    x = torch.cat([emb, features.to(torch.bfloat16)], dim=-1)
    x = (x.float() @ ep.fc.float()).to(torch.bfloat16)

    start = cache.length[0]
    positions = cache.length[:, None].long() + torch.arange(t, device=x.device)[None]
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta, scaling=c.rope_scaling)
    kv_len = torch.clamp(cache.length + t, max=cache.capacity).to(torch.int32)

    # attention, NO pre-norm (EAGLE-1 drops the first input layernorm)
    g = c.num_heads // c.num_kv_heads
    qkv = dequant_matmul(x, ep.wqkv).reshape(b, t, c.num_kv_heads, g + 2, c.head_dim)
    q = qkv[..., :g, :].reshape(b, t, c.num_heads, c.head_dim).transpose(1, 2)
    k = qkv[..., g, :].transpose(1, 2)
    v = qkv[..., g + 1, :].transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if t == 1:
        kvcache.append_decode_stacked(cache, 0, k, v, cache.length)
        att = decode_attention(q[:, :, 0], cache.k[0], cache.v[0], kv_len)[:, :, None]
    else:
        kvcache.append_stacked(cache, 0, k, v, start)
        att = flash_attention(q.contiguous(), cache.k[0], cache.v[0], kv_len=kv_len[0],
                              q_offset=start)
    att = att.transpose(1, 2).reshape(b, t, c.q_dim)
    x = x + dequant_matmul(att, ep.wo).to(x.dtype)

    h2 = rms_norm(x, ep.post_norm, c.rms_norm_eps)
    act = swiglu(*split_gate_up(dequant_matmul(h2, ep.wgu)))
    x = x + dequant_matmul(act, ep.wdown).to(x.dtype)
    return x, kvcache.with_length(cache, kv_len)


def eagle_next_token(ep: EagleParams, params: Params, config: ModelConfig,
                     token: torch.Tensor,      # [B, 1] int
                     feature: torch.Tensor,    # [B, 1, hidden]
                     cache: KVCache):
    """One chain step: (greedy token [B] int32 on the device, draft hidden
    [B, 1, hidden], cache)."""
    h, cache = eagle_forward(ep, params, config, token, feature, cache)
    return lowest_argmax(head_logits(params, h[:, -1])), h, cache


def mtp_propose(heads: MtpHeads, params: Params,
                feature: torch.Tensor) -> torch.Tensor:
    """Greedy chain from the MTP heads, feature [B, hidden] -> the tokens
    for t + 1 + i per head, [B, K] int32 on the device."""
    f = feature.to(torch.bfloat16)
    toks = []
    for i in range(heads.num_heads):
        res = F.silu(f.float() @ heads.w_res[i].float()).to(torch.bfloat16)
        toks.append(lowest_argmax(head_logits(params, f + res)))
    return torch.stack(toks, dim=-1)
