"""Prefill + autoregressive decode driver.

Counterpart of `mnn_tpu/runtime/generate.py`. Prefill is chunked and each
chunk is padded to a power-of-two bucket (`prefill_buckets`); the padded
tail's cache rows are rolled back. Decode is a Python loop over `forward`
at T = 1, which takes the whole-model decode kernel when it is eligible:
tokens stay on the device, so the loop never waits on the host, and the
greedy fast path feeds back the token the kernel chose, with no pass over
the logit row outside it. The JAX package runs that loop as a `lax.scan`
inside one dispatch; the port's counterpart, a captured CUDA graph, is
later work.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.decoder import Params, forward
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime import sampler as sampler_mod
from mnn_tpu_torch.runtime.kvcache import KVCache
from mnn_tpu_torch.runtime.sampler import SamplerState


def prefill_buckets(n: int, chunk: int, min_bucket: int = 32):
    """Split n tokens into power-of-2 bucketed chunks (each <= chunk)."""
    out = []
    remaining = n
    while remaining > 0:
        if remaining >= chunk:
            out.append(chunk)
            remaining -= chunk
        else:
            b = min_bucket
            while b < remaining:
                b *= 2
            out.append(min(b, chunk))
            remaining = 0
    return out


def pad_tokens(tokens: torch.Tensor, bucket: int, pad_id: int = 0) -> torch.Tensor:
    pad = bucket - tokens.shape[1]
    return F.pad(tokens, (0, pad), value=pad_id) if pad else tokens


def prefill_chunk(params: Params, config: ModelConfig, tokens: torch.Tensor,
                  cache: KVCache, valid: int):
    """One prefill chunk of [B, bucket] padded tokens, `valid` of them real.
    Returns (logits of the last real token [B, V], cache)."""
    bucket = tokens.shape[1]
    if valid == bucket:
        return forward(params, config, tokens, cache)
    # only the last real row goes through the head; the JAX package takes
    # the same row out of all the chunk's logits
    logits, cache = forward(params, config, tokens, cache, last_index=valid - 1)
    # the padded tail was appended to the cache; roll it back
    return logits, kvcache.rollback(cache, bucket - valid)


def prefill_params_view(params: Params, rt: RuntimeConfig) -> Params:
    """Prefill activation precision: with prefill_act_bits=8 the layers'
    projections run with dynamic int8 rows (W4A8) on the same packed
    weights; the lm head, the expert and shared-expert weights of a
    mixture-of-experts model (both expert kernels need bf16 rows) and
    decode keep bf16 rows."""
    if rt.prefill_act_bits != 8:
        return params

    def a8(ql):     # a pure mixture-of-experts layer has no wgu / wdown
        return None if ql is None else dataclasses.replace(ql, act_bits=8)

    lay = params.layers
    lay = dataclasses.replace(lay, wqkv=a8(lay.wqkv), wo=a8(lay.wo),
                              wgu=a8(lay.wgu), wdown=a8(lay.wdown))
    return dataclasses.replace(params, layers=lay)


def run_prefill(params: Params, config: ModelConfig, rt: RuntimeConfig,
                tokens: torch.Tensor, cache: KVCache):
    """Chunked, bucketed prefill over [B, T] tokens."""
    params = prefill_params_view(params, rt)
    t = tokens.shape[1]
    logits = None
    off = 0
    for bucket in prefill_buckets(t, rt.prefill_chunk):
        valid = min(bucket, t - off)
        chunk = pad_tokens(tokens[:, off:off + valid], bucket)
        logits, cache = prefill_chunk(params, config, chunk, cache, valid)
        off += valid
    return logits, cache


def decode_steps(
    params: Params,
    config: ModelConfig,
    cache: KVCache,
    first_logits: torch.Tensor,      # [B, V] logits for the next position
    state: SamplerState,
    generator: torch.Generator,
    *,
    steps: int,
    sampler: str = "greedy",
    temperature: float = 1.0,
    top_k: int = 40,
    top_p: float = 0.9,
    min_p: float = 0.05,
    penalty: float = 1.0,
    logit_bias=None,                 # [V] additive bias tensor or None
    megakernel=None,                 # forward's: None = auto, False = per-layer
):
    """Sample + forward `steps` times.

    Returns (tokens [B, steps] int32, last_logits, cache, state)."""
    greedy = (sampler == "greedy"
              or (sampler == "temperature" and temperature == 0.0))
    toks = []
    logits = first_logits
    if greedy and logit_bias is None and penalty == 1.0:
        # greedy fast path: the decode kernel's fused head already chose
        # the next token (forward(return_token=True)); it is fed straight
        # back. Tokens are recorded so a later penalty sees the same state.
        tok = first_logits.float().argmax(dim=-1).to(torch.int32)
        for _ in range(steps):
            toks.append(tok)
            state = sampler_mod.record_token(state, tok)
            (logits, tok), cache = forward(params, config, tok[:, None], cache,
                                           return_token=True,
                                           megakernel=megakernel)
    else:
        for _ in range(steps):
            tok, state = sampler_mod.sample(
                logits, generator, state, sampler=sampler,
                temperature=temperature, top_k=top_k, top_p=top_p,
                min_p=min_p, penalty=penalty, logit_bias=logit_bias)
            toks.append(tok)
            logits, cache = forward(params, config, tok[:, None], cache,
                                    megakernel=megakernel)
    return torch.stack(toks, dim=1), logits, cache, state
