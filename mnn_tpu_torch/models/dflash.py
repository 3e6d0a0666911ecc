"""DFlash: block-diffusion draft model for speculative decoding.

Counterpart of `mnn_tpu/models/dflash.py`. DFlash drafts a whole block of
tokens in one forward of a small NON-CAUSAL (bidirectional) transformer
over

  [ context_hidden | noise block ]

where context_hidden = fc(target hidden states), taken in f32 and cleaned
with `nan_to_num`, and the noise block is the embedding of `block_size`
mask tokens at the next block's rope positions. One forward gives logits
for every block position; the target verifies the block with the usual
lossless accept loop. The draft context lives in a fixed-capacity [1, C, H]
buffer with a length.

The draft net's attention and its bf16 products are torch ops, as the JAX
package computes them outside any Pallas kernel; a quantized target head
runs the port's dequant matmul kernel (the JAX package's `matmul_dequant_ref`
rounds each dequantized weight to bf16 first, the kernel does not: the two
sit within the parity tests' 5e-2).

The draft block is the JAX package's as it is: all mask tokens, and draft i
is the argmax at block slot i, one position off from the reference's
DFlash (which seeds slot 0 with the last accepted token). Verification is
lossless either way; it lowers acceptance only.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from mnn_tpu_torch.kernels.dequant_matmul import dequant_matmul
from mnn_tpu_torch.models.decoder import field_from
from mnn_tpu_torch.models.layers import rms_norm, rope_cos_sin, swiglu
from mnn_tpu_torch.quant.quantize import QuantizedLinear


@dataclasses.dataclass(frozen=True)
class DFlashParams:
    """Draft-net weights (bf16) and the f32 fc context projection."""

    fc: torch.Tensor           # [H_in, H] f32
    wqkv: torch.Tensor         # [L, H, (G+2) * Hkv * D] grouped like the target
    wo: torch.Tensor           # [L, H * D, H]
    wgu: torch.Tensor          # [L, H, 2 * I], gate then up
    wdown: torch.Tensor        # [L, I, H]
    in_norm: torch.Tensor      # [L, H]
    post_norm: torch.Tensor    # [L, H]
    final_norm: torch.Tensor   # [H]
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 64
    mask_token_id: int = 0
    block_size: int = 8


def init_random_dflash(config, generator: torch.Generator, *, layers: int = 1,
                       block_size: int = 8, mask_token_id: Optional[int] = None,
                       scale: float = 0.02, device=None) -> DFlashParams:
    """A random draft net sized from the target config, the JAX package's
    shapes (its weights differ: they come from a `torch.Generator`)."""
    h, d = config.hidden_size, config.head_dim
    nh = max(2, config.num_heads // 4)
    nkv = max(1, config.num_kv_heads // 4)
    i_dim = max(128, h // 2)
    nq = (nh + 2 * nkv) * d

    def w(*shape):
        return (torch.randn(shape, generator=generator) * scale).to(torch.bfloat16).to(device)

    ones = lambda *s: torch.ones(s, dtype=torch.bfloat16, device=device)
    return DFlashParams(
        fc=(torch.randn((h, h), generator=generator) * scale).to(device),
        wqkv=w(layers, h, nq), wo=w(layers, nh * d, h), wgu=w(layers, h, 2 * i_dim),
        wdown=w(layers, i_dim, h), in_norm=ones(layers, h), post_norm=ones(layers, h),
        final_norm=ones(h), num_heads=nh, num_kv_heads=nkv, head_dim=d,
        mask_token_id=(mask_token_id if mask_token_id is not None
                       else config.vocab_size - 1),
        block_size=block_size)


def dflash_params_from_numpy(arrays: Mapping[str, object], device=None) -> DFlashParams:
    """DFlashParams from the JAX package's DFlashParams fields: the arrays
    by name (bf16 carried through its bits), the static fields as ints."""
    tensors = ("fc", "wqkv", "wo", "wgu", "wdown", "in_norm", "post_norm", "final_norm")
    statics = ("num_heads", "num_kv_heads", "head_dim", "mask_token_id", "block_size")
    return DFlashParams(**{k: field_from(arrays, k, device) for k in tensors},
                        **{k: int(arrays[k]) for k in statics})


def fc_forward(dp: DFlashParams, feats: torch.Tensor) -> torch.Tensor:
    """context_hidden = fc(target hidden) in f32, NaN and inf cleaned as
    the reference does (the high-fan-in projection overflows in fp16)."""
    return torch.nan_to_num(feats.float() @ dp.fc)


def _rope(v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """v [1, T, heads, D], cos / sin [1, T, D/2]: the neox half rotation in
    f32, cast back to v's dtype."""
    c2, s2 = cos[:, :, None], sin[:, :, None]
    half = v.shape[-1] // 2
    v1, v2 = v[..., :half].float(), v[..., half:].float()
    return torch.cat([v1 * c2 - v2 * s2, v2 * c2 + v1 * s2], dim=-1).to(v.dtype)


def _bf16_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 sums, the product rounded to bf16."""
    return (a.float() @ w.float()).to(torch.bfloat16)


def dflash_block_logits(dp: DFlashParams, params, config,
                        ctx: torch.Tensor,    # [1, C, H] f32 context buffer
                        ctx_len: int,         # valid rows
                        start_pos: int) -> torch.Tensor:   # rope position of ctx[0]
    """One non-causal draft forward -> [1, block_size, vocab] f32 logits.

    The whole sequence [ctx | mask block] runs through the bidirectional
    layers (every position attends to every valid one); only the trailing
    block goes through the final norm and the target's head."""
    c = config
    b_sz, cap, d = dp.block_size, ctx.shape[1], dp.head_dim
    nh, nkv = dp.num_heads, dp.num_kv_heads
    g = nh // nkv
    dev = ctx.device
    mask_ids = torch.full((b_sz,), dp.mask_token_id, dtype=torch.int64, device=dev)
    noise = params.embedding[mask_ids][None]                        # [1, B, H]
    x = torch.cat([ctx.to(torch.bfloat16), noise.to(torch.bfloat16)], dim=1)
    t = cap + b_sz
    # rope positions: ctx rows at start_pos + i, the block at start_pos + len + i
    idx = torch.arange(t, device=dev)
    pos = torch.where(idx < cap, start_pos + idx, start_pos + ctx_len + (idx - cap))
    cos, sin = rope_cos_sin(pos[None], d, c.rope_theta)
    valid = (idx >= cap) | (idx < ctx_len)

    for li in range(dp.wqkv.shape[0]):
        hn = rms_norm(x, dp.in_norm[li], c.rms_norm_eps)
        qkv = _bf16_mm(hn, dp.wqkv[li]).reshape(1, t, nkv, g + 2, d)
        q = _rope(qkv[:, :, :, :g].reshape(1, t, nh, d), cos, sin)
        k = _rope(qkv[:, :, :, g], cos, sin)
        v = qkv[:, :, :, g + 1]
        kr = k.repeat_interleave(g, dim=2).float()
        vr = v.repeat_interleave(g, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / (d ** 0.5)
        # NON-causal: mask only the unused rows of the context buffer
        s = torch.where(valid[None, None, None, :], s, torch.full_like(s, -1e30))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)
        x = x + _bf16_mm(o.reshape(1, t, nh * d).to(torch.bfloat16), dp.wo[li])
        hn = rms_norm(x, dp.post_norm[li], c.rms_norm_eps)
        gu = _bf16_mm(hn, dp.wgu[li])
        i_dim = dp.wdown[li].shape[0]
        x = x + _bf16_mm(swiglu(gu[..., :i_dim], gu[..., i_dim:]), dp.wdown[li])

    blk = rms_norm(x[:, cap:], dp.final_norm, c.rms_norm_eps)
    head = params.lm_head
    if isinstance(head, QuantizedLinear):
        return dequant_matmul(blk, head, out_dtype=torch.float32)
    w_out = params.embedding.T if head is None else head
    return blk.to(torch.bfloat16).float() @ w_out.to(torch.bfloat16).float()
