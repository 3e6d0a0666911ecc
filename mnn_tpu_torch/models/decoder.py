"""Decoder-only transformer forward pass (dense Qwen2/2.5, Qwen3, Llama-3,
and the mixture-of-experts Qwen1.5-MoE / Qwen3-MoE).

Counterpart of `mnn_tpu/models/decoder.py` (`_forward_unrolled`). Weights
and the KV cache are stacked on a leading layer axis. A decode step (T = 1)
runs through the whole-model decode kernel (`kernels/decode_model.py`)
whenever its `supports()` accepts, as in the JAX package; otherwise, and for
prefill, the layers are unrolled: every projection through the fused
dequant-matmul kernel reading its layer in place, prefill attention through
the flash kernel over the dequantized cache window, decode attention through
the fused decode-step kernel (bf16 / int8 cache) or, for an int4 cache,
through a cache append and the flash decode kernel. The cache is updated in
place.

A mixture-of-experts layer routes in plain torch ops (`_route`: router
product, softmax, top-k) and runs its experts in a kernel: a decode step of
at most 8 rows through the fused kernel of `kernels/moe_decode.py`
(`_moe_mlp_fused`), a prefill chunk through capacity-grouped dispatch and the
kernel of `kernels/moe_prefill.py` (`_moe_mlp`). The whole-model decode
kernel takes no mixture-of-experts model, in either package.

Not ported yet: the gemma family (sandwich norms, softcaps, alternating
windows, dual rope), multimodal rope, LoRA, tensor and expert parallelism,
token-tree verify, PLE and deepstack.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch

from mnn_tpu_torch.kernels import decode_model, moe_decode, moe_prefill
from mnn_tpu_torch.kernels.decode_step import fused_decode_attention
from mnn_tpu_torch.kernels.dequant_matmul import dequant_matmul
from mnn_tpu_torch.kernels.flash_attention import decode_attention, flash_attention
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.layers import (apply_rope, rms_norm, rope_cos_sin,
                                         split_gate_up, swiglu)
from mnn_tpu_torch.quant.quantize import QuantizedLinear, choose_block_size
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.kvcache import KVCache


@dataclasses.dataclass(frozen=True)
class LayerParams:
    """Per-layer weights, stacked on a leading num_layers axis.

    wqkv's output columns are grouped by KV head, [Hkv, G+2, D] flattened:
    the G query heads of the group, then its K row, then its V row."""

    wqkv: QuantizedLinear        # [hidden, Hkv * (G+2) * D]
    wo: QuantizedLinear          # [H*D, hidden]
    # [hidden, 2 * intermediate], 64-block gate/up interleave; None for a
    # pure mixture-of-experts layer
    wgu: Optional[QuantizedLinear]
    wdown: Optional[QuantizedLinear]        # [intermediate, hidden]
    input_norm: torch.Tensor     # [L, hidden] f32
    post_norm: torch.Tensor      # [L, hidden] f32
    q_norm: Optional[torch.Tensor] = None   # [L, head_dim] (qwen3)
    k_norm: Optional[torch.Tensor] = None
    # mixture of experts: the expert stacks carry [L, E, ...]
    router: Optional[torch.Tensor] = None             # [L, hidden, E] f32
    wgu_e: Optional[QuantizedLinear] = None           # [L, E, hidden, 2 * moe_inter]
    wdown_e: Optional[QuantizedLinear] = None         # [L, E, moe_inter, hidden]
    wgu_shared: Optional[QuantizedLinear] = None      # qwen2-moe shared expert
    wdown_shared: Optional[QuantizedLinear] = None
    shared_gate: Optional[torch.Tensor] = None        # [L, hidden] f32, sigmoid gate


@dataclasses.dataclass(frozen=True)
class Params:
    embedding: torch.Tensor      # [vocab, hidden] bf16
    final_norm: torch.Tensor     # [hidden] f32
    # [hidden, vocab] bf16, a quantized head, or None when tied
    lm_head: Union[torch.Tensor, QuantizedLinear, None]
    layers: LayerParams


def _check_supported(c: ModelConfig):
    gemma_like = (c.sandwich_norm or c.mlp_act != "silu" or c.attn_softcap
                  or c.final_softcap or c.swa_every_other or c.swa_pattern
                  or c.embed_scale)
    if gemma_like or c.mrope_section or c.kv_rotate:
        raise NotImplementedError(
            f"{c.name}: only qwen/llama configs, dense or mixture of "
            "experts, are ported")


def init_random_params(
    config: ModelConfig,
    generator: torch.Generator,
    quant_bits: int = 4,
    quant_block: int = 128,
    scale: float = 0.02,
    act_bits: int = 16,
    lm_head_bits: int = 0,
    device=None,
) -> Params:
    """Random weights built directly in packed form (the JAX package's
    `fast=True` path): random bytes, scale 2*scale/qmax, bias -scale.

    The generator must live on the CPU; the same seed then gives the same
    weights whatever `device` is. Unlike the JAX fast path, each layer gets
    its own bytes: a stack of one broadcast layer would serve the per-layer
    weights from the H100's 50 MB L2 cache and flatter decode timings. So
    does every expert. Each stack is made one layer at a time and moved to
    `device` as it is made: the host never holds a second copy of the
    expert bytes (6.6 GB at qwen1.5-moe-a2.7b's size)."""
    c = config
    _check_supported(c)
    g = generator

    def packed_rand(lead, rows, n_dim):
        out = torch.empty((*lead, rows, n_dim), dtype=torch.int8, device=device)
        for i in range(lead[0] if lead else 1):
            part = torch.randint(-128, 128, (*lead[1:], rows, n_dim),
                                 generator=g, dtype=torch.int8)
            (out[i] if lead else out).copy_(part)
        return out

    def ql(k_dim, n_dim, with_bias, bits=quant_bits, lead=(c.num_layers,),
           a_bits=act_bits):
        bs = choose_block_size(k_dim, quant_block)
        qmax = (1 << bits) - 1
        s = torch.full((*lead, k_dim // bs, n_dim), 2 * scale / qmax,
                       dtype=torch.bfloat16, device=device)
        return QuantizedLinear(
            packed=packed_rand(lead, k_dim * bits // 8, n_dim),
            scale=s, bias=-s * (qmax / 2),
            out_bias=torch.zeros((*lead, n_dim)) if with_bias else None,
            bits=bits, block_size=bs, act_bits=a_bits)

    qkv_n = (c.num_heads + 2 * c.num_kv_heads) * c.head_dim
    ones = lambda *s: torch.ones(s, dtype=torch.float32)
    wqkv = ql(c.hidden_size, qkv_n, c.attention_bias)
    wo = ql(c.q_dim, c.hidden_size, False)
    moe_fields = {}
    if c.is_moe:
        # expert weights keep bf16 rows (act_bits 16), as in the JAX package
        mi, lead_e = c.moe_intermediate_size, (c.num_layers, c.num_experts)
        moe_fields = dict(
            router=torch.randn((c.num_layers, c.hidden_size, c.num_experts),
                               generator=g) * scale,
            wgu_e=ql(c.hidden_size, 2 * mi, False, lead=lead_e, a_bits=16),
            wdown_e=ql(mi, c.hidden_size, False, lead=lead_e, a_bits=16))
        si = c.shared_expert_intermediate_size
        if si:
            moe_fields.update(
                wgu_shared=ql(c.hidden_size, 2 * si, False),
                wdown_shared=ql(si, c.hidden_size, False),
                shared_gate=torch.zeros((c.num_layers, c.hidden_size)))
    dense = not c.is_moe
    layers = LayerParams(
        wqkv=wqkv, wo=wo,
        wgu=ql(c.hidden_size, 2 * c.intermediate_size, False) if dense else None,
        wdown=ql(c.intermediate_size, c.hidden_size, False) if dense else None,
        input_norm=ones(c.num_layers, c.hidden_size),
        post_norm=ones(c.num_layers, c.hidden_size),
        q_norm=ones(c.num_layers, c.head_dim) if c.qk_norm else None,
        k_norm=ones(c.num_layers, c.head_dim) if c.qk_norm else None,
        **moe_fields,
    )
    emb = torch.randn((c.vocab_size, c.hidden_size), generator=g).to(
        torch.bfloat16) * scale
    if lm_head_bits in (4, 8):
        head = ql(c.hidden_size, c.vocab_size, False, bits=lm_head_bits,
                  lead=(), a_bits=16)
    elif c.tie_word_embeddings:
        head = None
    else:
        head = torch.randn((c.hidden_size, c.vocab_size), generator=g).to(
            torch.bfloat16) * scale
    return params_to(Params(embedding=emb, final_norm=ones(c.hidden_size),
                            lm_head=head, layers=layers), device)


def params_to(params: Params, device) -> Params:
    """Move every tensor of `params` to `device` (None: leave them)."""
    if device is None:
        return params

    def mv(x):   # a tensor or a QuantizedLinear
        return None if x is None else x.to(device)

    lay = params.layers
    lay = dataclasses.replace(lay, **{f.name: mv(getattr(lay, f.name))
                                      for f in dataclasses.fields(lay)})
    return dataclasses.replace(
        params, embedding=mv(params.embedding), final_norm=mv(params.final_norm),
        lm_head=mv(params.lm_head), layers=lay)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, carrying ml_dtypes bfloat16 through its bits."""
    a = np.require(a, requirements=["C", "W"])   # copies a read-only array
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(arrays: Mapping[str, object], config: ModelConfig,
                      device=None) -> Params:
    """Build Params from the JAX package's Params fields as numpy arrays.

    Keys are dotted field names: "embedding", "final_norm", "lm_head" (a
    dense head) or "lm_head.packed"/".scale"/".bias" (quantized),
    "layers.input_norm", "layers.wqkv.packed", "layers.wqkv.out_bias", ...;
    for a mixture-of-experts config "layers.router", "layers.wgu_e.packed"
    ([L, E, ...] as it is), "layers.wgu_shared.packed", "layers.shared_gate".
    A quantized linear's static metadata comes under the same prefix as
    ints: "layers.wqkv.bits", ".block_size", ".act_bits". Bytes are taken
    as they are: the packed layout is the same in both packages."""
    _check_supported(config)

    def get(key):
        return None if arrays.get(key) is None else _tensor(np.asarray(arrays[key]))

    def ql(prefix):
        return QuantizedLinear(
            packed=get(prefix + ".packed"), scale=get(prefix + ".scale"),
            bias=get(prefix + ".bias"), out_bias=get(prefix + ".out_bias"),
            bits=int(arrays[prefix + ".bits"]),
            block_size=int(arrays[prefix + ".block_size"]),
            act_bits=int(arrays.get(prefix + ".act_bits", 16)))

    def opt_ql(prefix):     # a projection the config may not have
        return ql(prefix) if prefix + ".packed" in arrays else None

    layers = LayerParams(
        wqkv=ql("layers.wqkv"), wo=ql("layers.wo"), wgu=opt_ql("layers.wgu"),
        wdown=opt_ql("layers.wdown"), input_norm=get("layers.input_norm"),
        post_norm=get("layers.post_norm"), q_norm=get("layers.q_norm"),
        k_norm=get("layers.k_norm"), router=get("layers.router"),
        wgu_e=opt_ql("layers.wgu_e"), wdown_e=opt_ql("layers.wdown_e"),
        wgu_shared=opt_ql("layers.wgu_shared"),
        wdown_shared=opt_ql("layers.wdown_shared"),
        shared_gate=get("layers.shared_gate"))
    if "lm_head.packed" in arrays:
        head = ql("lm_head")
    else:
        head = get("lm_head")
    return params_to(Params(embedding=get("embedding"),
                            final_norm=get("final_norm"), lm_head=head,
                            layers=layers), device)


def _gated_act(c: ModelConfig, gu: torch.Tensor) -> torch.Tensor:
    """Gated MLP activation: SwiGLU (qwen/llama)."""
    gate, up = split_gate_up(gu)
    return swiglu(gate, up)


# Expert capacity of the grouped prefill path: factor * ceil(n * k / E),
# clamped to n, so that small batches drop nothing.
MOE_CAPACITY_FACTOR = 2.0


def _route(c: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """Top-k routing of rows x [n, hidden] through one layer's router
    [hidden, E]: (weights [n, k] f32, expert ids [n, k]). Among equal
    probabilities the lower expert index comes first, as `jax.lax.top_k`
    orders them (a stable descending sort; `torch.topk` promises no order).
    Everything stays on the device."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = c.num_experts_per_tok
    vals, idx = order.values[:, :k], order.indices[:, :k]
    if c.norm_topk_prob:
        vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return vals, idx


def _shared_expert(x: torch.Tensor, layers: LayerParams, i: int) -> torch.Tensor:
    """The shared expert's MLP of rows x [n, hidden] under its sigmoid gate,
    f32 [n, hidden]."""
    gu = dequant_matmul(x, layers.wgu_shared, layer_index=i)
    out = dequant_matmul(swiglu(*split_gate_up(gu)), layers.wdown_shared,
                         layer_index=i, out_dtype=torch.float32)
    if layers.shared_gate is not None:
        out = out * torch.sigmoid(x.float() @ layers.shared_gate[i])[:, None]
    return out


def _moe_mlp(c: ModelConfig, h2: torch.Tensor, layers: LayerParams,
             i: int) -> torch.Tensor:
    """Top-k routed expert MLP of layer i over h2 [B, T, hidden] -> f32.

    Up to 8 rows (a decode step that the fused kernel refuses): one (token,
    expert) pair at a time through `dequant_matmul`, reading expert
    i * E + e in place; the ids come to the host for that. More rows (a
    prefill chunk): capacity-grouped dispatch. The pairs are sorted by
    expert (a stable sort: the rank inside an expert decides which tokens a
    full expert drops), each takes the next slot of its expert's capacity
    C = min(n, max(8, ceil8(2 * ceil(n * k / E)))), pairs past the capacity
    are dropped, the rows are gathered into [E, C, hidden], the grouped
    kernel runs every expert's batch, and each token gathers its k slots.
    Rows that pad a chunk are routed and take capacity like real ones."""
    b, t, hidden = h2.shape
    n = b * t
    x = h2.reshape(n, hidden)
    vals, idx = _route(c, x, layers.router[i])
    e_n, k = c.num_experts, c.num_experts_per_tok
    dev = x.device
    if layers.wgu_e.packed.shape[1] != e_n:
        raise NotImplementedError(
            "expert-parallel dense dispatch (a shard of the experts) is not "
            "ported")

    if n <= 8:
        gu_flat, dn_flat = layers.wgu_e.flat_experts(), layers.wdown_e.flat_experts()
        y = torch.zeros((n, hidden), dtype=torch.float32, device=dev)
        for p, ei in enumerate(idx.reshape(-1).tolist()):
            ti = p // k
            gu = dequant_matmul(x[ti:ti + 1], gu_flat, layer_index=i * e_n + ei)
            out = dequant_matmul(swiglu(*split_gate_up(gu)), dn_flat,
                                 layer_index=i * e_n + ei, out_dtype=torch.float32)
            y[ti] += out[0] * vals[ti, p % k]
    else:
        avg = -(-n * k // e_n)
        cap = min(n, max(8, -(-int(MOE_CAPACITY_FACTOR * avg) // 8) * 8))
        flat_e = idx.reshape(-1)
        flat_t = torch.arange(n, device=dev).repeat_interleave(k)
        order = torch.argsort(flat_e, stable=True)
        se, st, sw = flat_e[order], flat_t[order], vals.reshape(-1)[order]
        rank = torch.arange(n * k, device=dev) - torch.searchsorted(se, se, right=False)
        # a pair past its expert's capacity goes to a slot past the table's
        # end, which is cut off again
        slot = torch.where(rank < cap, se * cap + rank, e_n * cap)
        tok_tab = torch.full((e_n * cap + 1,), n, dtype=torch.int64, device=dev)
        tok_tab[slot] = st
        w_tab = torch.zeros((e_n * cap + 1,), dtype=torch.float32, device=dev)
        w_tab[slot] = sw
        tok_tab, w_tab = tok_tab[:-1], w_tab[:-1]
        x_pad = torch.cat([x, x.new_zeros((1, hidden))])          # row n: empty
        xe = x_pad[tok_tab].reshape(e_n, cap, hidden)
        w_e = w_tab.reshape(e_n, cap)
        gu_l, dn_l = layers.wgu_e.layer(i), layers.wdown_e.layer(i)
        if moe_prefill.supports(gu_l, dn_l, hidden, cap):
            ye = moe_prefill.moe_prefill_mlp(xe.to(torch.bfloat16), w_e, gu_l, dn_l)
            # combine by gather: each token reads its k slots (a dropped
            # pair reads the zero row)
            slot_of = slot[torch.argsort(order)]
            ye_pad = torch.cat([ye.reshape(e_n * cap, hidden),
                                ye.new_zeros((1, hidden))])
            y = ye_pad[slot_of].reshape(n, k, hidden).sum(dim=1)
        else:
            # what the grouped kernel refuses: one expert's batch at a time
            y = torch.zeros((n + 1, hidden), dtype=torch.float32, device=dev)
            t_e = tok_tab.reshape(e_n, cap)
            for ei in range(e_n):
                gu = dequant_matmul(xe[ei], gu_l, layer_index=ei)
                out = dequant_matmul(swiglu(*split_gate_up(gu)), dn_l,
                                     layer_index=ei, out_dtype=torch.float32)
                y.index_add_(0, t_e[ei], out * w_e[ei][:, None])
            y = y[:n]
    if layers.wgu_shared is not None:
        y = y + _shared_expert(x, layers, i)
    return y.reshape(b, t, hidden)


def _moe_mlp_fused(c: ModelConfig, h2: torch.Tensor, layers: LayerParams,
                   i: int) -> torch.Tensor:
    """A decode step's expert MLP of layer i: routing in torch ops, every
    expert GEMV and the shared expert in the fused kernel. No expert id
    crosses to the host."""
    b, t, hidden = h2.shape
    x = h2.reshape(b * t, hidden)
    vals, idx = _route(c, x, layers.router[i])
    gate = None
    if layers.shared_gate is not None:
        gate = torch.sigmoid(x.float() @ layers.shared_gate[i])
    y = moe_decode.moe_decode_mlp(x, layers, idx, vals, i, gate, config=c)
    return y.reshape(b, t, hidden)


def _attention(c: ModelConfig, q, k_cache, v_cache, k_scale, v_scale,
               kv_len, start, bits):
    """Prefill (T > 1) attention of q [B, H, T, D] over one layer's cache,
    which already holds the chunk's own K/V rows."""
    kf = kvcache.dequant_kv(k_cache, k_scale, bits)
    vf = kvcache.dequant_kv(v_cache, v_scale, bits)
    return flash_attention(q, kf, vf, kv_len=kv_len[0], q_offset=start,
                           window=c.sliding_window, sink=c.attention_sink)


def _decode_megakernel(params: Params, c: ModelConfig, x, cache: KVCache,
                       cos_f, sin_f, kv_len):
    """One decode position through the whole-model kernel. Returns
    (x [B, 1, hidden], cache, logits or None, token or None): logits and
    token when the head is fused into the kernel."""
    head = params.lm_head if decode_model.supports_head(c, params) else None
    on_card = x.is_cuda
    outs = decode_model.fused_decode_model(
        x[:, 0], params.layers, cache.k, cache.v, cache.k_scale,
        cache.v_scale, cache.length, cos_f, sin_f, config=c, head=head,
        final_norm=params.final_norm, write_cache=on_card)
    xh, k_rows, v_rows, k_sc, v_sc = outs[:5]
    logits, token = outs[5:] if len(outs) == 7 else (None, None)
    if not on_card:     # on the card the kernel wrote the rows itself
        decode_model.scatter_rows(cache, k_rows, v_rows, k_sc, v_sc, cache.length)
    return (xh[:, None].to(x.dtype), kvcache.with_length(cache, kv_len),
            logits, token)


def forward(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,        # [B, T] int
    cache: KVCache,
    *,
    all_logits: bool = False,
    last_index: int = -1,
    megakernel: Optional[bool] = None,   # None = auto; False = per-layer path
    return_token: bool = False,          # also return the greedy next token
):
    """Run the model over `tokens`, appending T positions to the cache.

    Returns (logits, cache): logits [B, T, V] with `all_logits`, else the
    logits [B, V] of position `last_index`; with `return_token`,
    ((logits, token [B] int32), cache). The cache's buffers are updated in
    place; the returned cache carries the new lengths.

    `megakernel`: None sends a decode step (T = 1) through the whole-model
    decode kernel when `decode_model.supports()` accepts, False forces the
    per-layer path, True raises when the kernel is not eligible (an explicit
    request never measures the other path). On that path the final norm, the
    lm-head GEMV and the argmax run inside the kernel when
    `decode_model.supports_head()` accepts, and the token is the kernel's;
    otherwise it is the lowest-index argmax of the logits."""
    c = config
    _check_supported(c)
    b, t = tokens.shape
    layers = params.layers
    group = c.num_heads // c.num_kv_heads
    x = params.embedding[tokens]                                # [B, T, hidden]
    start = cache.length[0]
    positions = cache.length[:, None].long() + torch.arange(t, device=x.device)[None]
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta,
                            scaling=c.rope_scaling)
    kv_len = torch.clamp(cache.length + t, max=cache.capacity).to(torch.int32)
    if t == 1:
        # full-width rope phases for the fused kernels (neox halves tiled 2x)
        cos_f = torch.cat([cos[:, 0], cos[:, 0]], dim=-1)        # [B, D]
        sin_f = torch.cat([sin[:, 0], sin[:, 0]], dim=-1)

    eligible = (megakernel is not False and t == 1
                and decode_model.supports(c, params, cache, b))
    if megakernel is True and not eligible:
        raise ValueError(
            "megakernel=True but decode_model.supports() rejects this "
            f"(config={c.name}, batch={b}, T={t}, kv_bits={cache.bits}); use "
            "megakernel=None for the automatic fallback")
    if eligible:
        x, new_cache, logits, token = _decode_megakernel(
            params, c, x, cache, cos_f, sin_f, kv_len)
        if logits is not None:
            if all_logits:
                logits = logits[:, None]
            return ((logits, token), new_cache) if return_token else (logits, new_cache)
        return _finish(params, c, x, new_cache, all_logits, last_index, return_token)

    fused = t == 1 and cache.bits != 4
    # a decode step of at most 8 rows takes the fused expert kernel
    moe_fast = c.is_moe and t == 1 and moe_decode.supports(c, layers, b)
    for i in range(c.num_layers):
        h = rms_norm(x, layers.input_norm[i], c.rms_norm_eps)
        qkv = dequant_matmul(h, layers.wqkv, layer_index=i)
        if fused:
            qkv_g = qkv.reshape(b, c.num_kv_heads, group + 2, c.head_dim)
            att, k_row, v_row, k_sc, v_sc = fused_decode_attention(
                qkv_g, cache.k, cache.v, cache.k_scale, cache.v_scale,
                i, cache.length, cos_f, sin_f,
                q_norm=layers.q_norm[i] if c.qk_norm else None,
                k_norm=layers.k_norm[i] if c.qk_norm else None,
                eps=c.rms_norm_eps, window=c.sliding_window,
                sink=c.attention_sink)
            kvcache.scatter_decode_row(cache, i, k_row, v_row, k_sc, v_sc,
                                       cache.length)
            att = att.reshape(b, t, c.q_dim)
        else:
            qkv5 = qkv.reshape(b, t, c.num_kv_heads, group + 2, c.head_dim)
            q = qkv5[..., :group, :].reshape(b, t, c.num_heads, c.head_dim)
            q = q.transpose(1, 2)                                 # [B, H, T, D]
            k = qkv5[..., group, :].transpose(1, 2)               # [B, Hkv, T, D]
            v = qkv5[..., group + 1, :].transpose(1, 2)
            if c.qk_norm:
                q = rms_norm(q, layers.q_norm[i], c.rms_norm_eps)
                k = rms_norm(k, layers.k_norm[i], c.rms_norm_eps)
            q = apply_rope(q, cos, sin).contiguous()
            k = apply_rope(k, cos, sin)
            if t == 1:
                # int4 cache: quantize and append the row, then attend over
                # the packed cache in place (the new token included)
                kvcache.append_decode_stacked(cache, i, k, v, cache.length)
                att = decode_attention(
                    q[:, :, 0], cache.k, cache.v, kv_len,
                    k_scale=cache.k_scale, v_scale=cache.v_scale,
                    layer_index=i, window=c.sliding_window,
                    sink=c.attention_sink)[:, :, None]
            else:
                kvcache.append_stacked(cache, i, k, v, start)
                att = _attention(
                    c, q, cache.k[i], cache.v[i],
                    None if cache.k_scale is None else cache.k_scale[i],
                    None if cache.v_scale is None else cache.v_scale[i],
                    kv_len, start, cache.bits)
            att = att.transpose(1, 2).reshape(b, t, c.q_dim)
        o = dequant_matmul(att, layers.wo, layer_index=i)
        x = x + o.to(x.dtype)
        h2 = rms_norm(x, layers.post_norm[i], c.rms_norm_eps)
        if c.is_moe:
            d = (_moe_mlp_fused if moe_fast else _moe_mlp)(c, h2, layers, i)
        else:
            gu = dequant_matmul(h2, layers.wgu, layer_index=i)
            d = dequant_matmul(_gated_act(c, gu), layers.wdown, layer_index=i)
        x = x + d.to(x.dtype)

    return _finish(params, c, x, kvcache.with_length(cache, kv_len), all_logits,
                   last_index, return_token)


def _finish(params: Params, c: ModelConfig, x, new_cache, all_logits: bool,
            last_index: int, return_token: bool):
    """Final norm and lm head over hidden states x [B, T, hidden]."""
    x = rms_norm(x, params.final_norm, c.rms_norm_eps)
    if not all_logits:
        x = x[:, last_index]
    logits = head_logits(params, x)
    if return_token:
        tok_logits = logits[:, -1] if all_logits else logits
        return (logits, decode_model.lowest_argmax(tok_logits)), new_cache
    return logits, new_cache


def head_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Project final-normed hidden states [..., hidden] through the lm head
    -> f32 logits. A quantized head runs the dequant-matmul kernel; a bf16
    or tied head is a plain product of bf16 values accumulated in f32."""
    if isinstance(params.lm_head, QuantizedLinear):
        return dequant_matmul(x, params.lm_head, out_dtype=torch.float32)
    head = params.embedding.T if params.lm_head is None else params.lm_head
    return x.to(torch.bfloat16).float() @ head.float()
