"""Perplexity and sequence log-likelihood.

Counterpart of `mnn_tpu/runtime/evaluate.py`: a chunked, teacher-forced
prefill over an unquantized bf16 cache with the logits of every position
(`all_logits=True`), the padded tail of the last chunk rolled back, and the
log-softmax summed in f32. The head then runs at M = chunk rows against
N = vocab (the tile kernel of `kernels/dequant_matmul.py` for a quantized
head), and prefill attention over a bf16 cache. Runs on the device the
params lie on.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from mnn_tpu_torch.models.decoder import forward
from mnn_tpu_torch.runtime import kvcache


def sequence_nll(params, config, token_ids: List[int], *, chunk: int = 512,
                 cache_capacity: Optional[int] = None):
    """Sum of -log p(token | prefix) over positions 1..n-1, in nats.

    Returns (total_nll, token_count)."""
    n = len(token_ids)
    if n < 2:
        raise ValueError("need at least 2 tokens")
    dev = params.embedding.device
    cap = cache_capacity or -(-n // chunk) * chunk
    cache = kvcache.create(config.num_layers, 1, config.num_kv_heads, cap,
                           config.head_dim, quantized=False, device=dev)
    total, count = 0.0, 0
    for off in range(0, n - 1, chunk):
        toks = token_ids[off:off + chunk]
        pad = chunk - len(toks)
        arr = torch.tensor([toks + [0] * pad], dtype=torch.int64, device=dev)
        logits, cache = forward(params, config, arr, cache, all_logits=True)
        if pad:
            cache = kvcache.rollback(cache, pad)
        # targets of positions off .. off + len(toks) - 1
        tgt = token_ids[off + 1:off + len(toks) + 1]
        valid = len(tgt)
        logp = torch.log_softmax(logits[0, :valid].float(), dim=-1)
        idx = torch.tensor(tgt, dtype=torch.int64, device=dev)[:, None]
        total += float(-logp.gather(-1, idx).sum())
        count += valid
    return total, count


def perplexity(params, config, token_ids: List[int], **kw) -> float:
    nll, count = sequence_nll(params, config, token_ids, **kw)
    return math.exp(nll / count)
