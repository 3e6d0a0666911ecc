"""HuggingFace checkpoint -> quantized checkpoint directory.

Counterpart of `mnn_tpu/convert/hf.py` (`convert_hf`), writing the same
bytes: it reads a local HF model directory (config.json and one or more
*.safetensors, with the port's own reader), re-packs the weights into the
decoder's fused layouts, quantizes them with per-block scales and writes
the directory that `convert/checkpoint.py` loads.

Layout re-packing (as `models/decoder.py` `LayerParams` reads it):
  * wqkv grouped by KV head: [Hkv, (G q-heads | K | V), D] on the output
    axis, and its bias grouped the same way;
  * wgu gate/up in 64-column blocks, interleaved (`interleave_gate_up`);
  * phi-3's fused qkv_proj / gate_up_proj split back into their parts;
  * AWQ / GPTQ packed tensors taken as the float weights of their grid;
  * Qwen2-MoE routers, experts, shared expert and its sigmoid gate;
  * Gemma2 / Gemma3: the sandwich norms (`post_attention_layernorm` on the
    attention output, `pre_feedforward_layernorm`,
    `post_feedforward_layernorm`), gemma3's q_norm / k_norm, and gemma's
    `1 + w` RMSNorm offset baked into every norm weight;
  * every weight transposed to [in, out] (HF stores [out, in]).

Unlike the JAX converter, which holds every layer's f32 matrices at once,
this one quantizes on `device` one layer at a time and keeps only the
packed results; each `quantize` call depends on its matrix alone, so the
bytes are the same.

`awq=True` runs the activation-aware scale search of the JAX converter
(`_awq_transform` there) on `device`, within the same walk over the
layers: one float forward of the calibration tokens, layer by layer with
the original weights (the folds are exact, so the stream is the one the
transformed model would see); at each dense pre-norm layer the inputs of
its four projections (at most 512 rows each, drawn with the JAX
converter's numpy generator) go to `quant/awq_search.awq_scale_block`,
and the transformed matrices and norms are quantized in place of the
originals. What the search chose (each layer's scale ratios and clip
steps) is written beside the checkpoint, to `awq_search.json`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections.abc import Mapping
from typing import List, Optional

import numpy as np
import torch

from mnn_tpu_torch.convert.awq import load_awq_weight
from mnn_tpu_torch.convert.checkpoint import save_checkpoint
from mnn_tpu_torch.convert.stfile import StDir
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.decoder import LayerParams, Params, _check_supported
from mnn_tpu_torch.models.layers import (apply_rope, gu_block_for, interleave_gate_up,
                                         rms_norm, rope_cos_sin, split_gate_up, swiglu)
from mnn_tpu_torch.quant.awq_search import awq_scale_block
from mnn_tpu_torch.quant.quantize import QuantizedLinear, choose_block_size, quantize

AWQ_MAX_ROWS = 512      # calibration rows a projection's search sees


def _as_tensor(x) -> torch.Tensor:
    """A source tensor (torch, or numpy from the GGUF reader or a caller's
    dict) as torch; raw bf16 storage (U16) as torch.bfloat16."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":       # ml_dtypes, from a caller's dict
            x = x.view(np.uint16)
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    if x.dtype == torch.uint16:
        x = x.view(torch.bfloat16)
    return x


def _stack(qs: List[QuantizedLinear], biases=None) -> QuantizedLinear:
    """Per-layer QuantizedLinears -> one stacked on a leading axis."""
    st = lambda f: torch.stack([getattr(q, f) for q in qs])
    return dataclasses.replace(
        qs[0], packed=st("packed"), scale=st("scale"), bias=st("bias"),
        out_bias=None if biases is None else torch.stack(biases))


def convert_hf(
    model_dir: Optional[str],
    out_dir: str,
    *,
    bits: int = 4,
    block_size: int = 128,
    sym: bool = False,
    tp_shards: int = 1,
    act_bits: int = 16,
    lm_head_bits: int = 8,
    rt: Optional[RuntimeConfig] = None,
    hf_config: Optional[dict] = None,
    tensors: Optional[Mapping] = None,
    awq: bool = False,
    awq_clip: bool = True,
    calib_tokens=None,          # [B, T] int token ids
    device=None,
):
    """Convert and quantize an HF decoder checkpoint (qwen2 / qwen3 /
    llama / mistral / phi3 / gemma2 / gemma3, dense or Qwen2-MoE) on
    `device` (None: the card)
    and write it to `out_dir`. `hf_config` / `tensors` stand in for the
    files on disk (the GGUF importer feeds its decoded tensors so).
    `awq=True` searches AWQ scales (and with `awq_clip` clips) on
    `calib_tokens` before quantizing: dense pre-norm decoders only.
    Returns (config, params): what was written, as it lies on `device`."""
    if awq and calib_tokens is None:
        raise ValueError("awq=True needs calib_tokens [B, T] int32")
    dev = resolve_device(device)
    if hf_config is not None:
        hf_cfg = hf_config
    else:
        with open(os.path.join(model_dir, "config.json")) as f:
            hf_cfg = json.load(f)
    name = (os.path.basename(model_dir.rstrip("/")) if model_dir
            else hf_cfg.get("architectures", ["model"])[0])
    config = ModelConfig.from_hf_config(hf_cfg, name=name)
    _check_supported(config)
    if awq and (config.is_moe or config.sandwich_norm):
        raise NotImplementedError("AWQ search covers dense pre-norm decoders")
    awq_log = [] if awq else None
    src = StDir(model_dir) if tensors is None else None
    try:
        params = _convert(config, hf_cfg, src if src is not None else tensors,
                          dev, bits=bits, block_size=block_size, sym=sym,
                          tp_shards=tp_shards, act_bits=act_bits,
                          lm_head_bits=lm_head_bits, calib_tokens=calib_tokens,
                          awq_clip=awq_clip, awq_log=awq_log)
    finally:
        if src is not None:
            src.close()
    rt = (rt or RuntimeConfig()).merge(
        quant_bits=bits, quant_block=block_size, quant_sym=sym, act_bits=act_bits)
    save_checkpoint(out_dir, config, params, rt, tokenizer_src=model_dir)
    if awq_log is not None:
        with open(os.path.join(out_dir, "awq_search.json"), "w") as f:
            json.dump({"calib_tokens": list(np.shape(calib_tokens)), "clip": awq_clip,
                       "layers": awq_log}, f, indent=1)
    return config, params


class _AwqPass:
    """The calibration stream of `awq=True`: x [B, T, hidden] f32 on the
    device, advanced one layer at a time with that layer's original float
    weights, as the JAX converter's `_awq_transform` runs it."""

    def __init__(self, c: ModelConfig, tokens, emb: torch.Tensor, *, bits, block_size,
                 sym, clip):
        dev = emb.device
        self.c, self.kw = c, dict(bits=bits, block_size=block_size, sym=sym, clip=clip)
        ids = torch.as_tensor(np.asarray(tokens, np.int32), device=dev).long()
        b, t = ids.shape
        self.x = emb[ids]
        self.cos, self.sin = rope_cos_sin(
            torch.arange(t, device=dev)[None].expand(b, t), c.head_dim, c.rope_theta,
            scaling=c.rope_scaling)
        self.causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        g, d, hkv = c.num_heads // c.num_kv_heads, c.head_dim, c.num_kv_heads
        stride = (g + 2) * d
        self.v_cols = np.concatenate([np.arange(h * stride + (g + 1) * d,
                                                h * stride + (g + 2) * d)
                                      for h in range(hkv)])
        blk = gu_block_for(c.intermediate_size)
        self.up_cols = np.concatenate([np.arange(2 * i * blk + blk, 2 * i * blk + 2 * blk)
                                       for i in range(c.intermediate_size // blk)])
        # attention channel (head i, dim k) reads V column (KV head i // g, dim k)
        self.o_groups = np.concatenate([np.arange(d) + (i // g) * d
                                        for i in range(c.num_heads)])
        self.rng = np.random.default_rng(0)

    def _rows(self, a: torch.Tensor) -> torch.Tensor:
        a = a.reshape(-1, a.shape[-1])
        if a.shape[0] <= AWQ_MAX_ROWS:
            return a
        idx = self.rng.choice(a.shape[0], size=AWQ_MAX_ROWS, replace=False)
        return a[torch.as_tensor(idx, device=a.device)]

    def layer(self, wqkv, qkv_bias, wo, wgu, wdown, in_norm, post_norm, q_norm, k_norm):
        """Advance the stream through one layer and search its transform."""
        c, x = self.c, self.x
        b, t, _ = x.shape
        g, d = c.num_heads // c.num_kv_heads, c.head_dim
        h = rms_norm(x, in_norm, c.rms_norm_eps)
        qkv = h @ wqkv
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
        qkv5 = qkv.reshape(b, t, c.num_kv_heads, g + 2, d)
        q = qkv5[..., :g, :].reshape(b, t, c.num_heads, d).transpose(1, 2)
        k = qkv5[..., g, :].transpose(1, 2)
        v = qkv5[..., g + 1, :].transpose(1, 2)
        if q_norm is not None:
            q = rms_norm(q, q_norm, c.rms_norm_eps)
            k = rms_norm(k, k_norm, c.rms_norm_eps)
        q = apply_rope(q, self.cos, self.sin)
        k = apply_rope(k, self.cos, self.sin).repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("bhtd,bhsd->bhts", q, k) * (1.0 / d ** 0.5)
        s = torch.where(self.causal[None, None], s, torch.full_like(s, -1e30))
        att = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1), v)
        att = att.transpose(1, 2).reshape(b, t, c.q_dim)
        x = x + att @ wo
        h2 = rms_norm(x, post_norm, c.rms_norm_eps)
        act = swiglu(*split_gate_up(h2 @ wgu))
        self.x = x + act @ wdown
        acts = {"qkv": self._rows(h), "o": self._rows(att), "gu": self._rows(h2),
                "down": self._rows(act)}
        return awq_scale_block(acts, wqkv, wo, wgu, wdown, in_norm, post_norm,
                               v_cols=self.v_cols, up_cols=self.up_cols,
                               qkv_bias=qkv_bias, o_groups=self.o_groups, **self.kw)


def _convert(c: ModelConfig, hf_cfg: dict, t: Mapping, dev: torch.device, *,
             bits, block_size, sym, tp_shards, act_bits, lm_head_bits,
             calib_tokens=None, awq_clip=True, awq_log=None) -> Params:
    g = c.num_heads // c.num_kv_heads
    d = c.head_dim
    hkv = c.num_kv_heads

    def f32(name):
        # a copy on `dev` whatever the source: nothing stays a view of a map
        return _as_tensor(t[name]).to(dev).to(torch.float32, copy=True)

    def get(name):
        if name in t:
            return f32(name)
        # phi-3-style fused projections: qkv_proj / gate_up_proj
        for part, (a, b) in (("q_proj", (0, c.q_dim)),
                             ("k_proj", (c.q_dim, c.q_dim + c.kv_dim)),
                             ("v_proj", (c.q_dim + c.kv_dim, c.q_dim + 2 * c.kv_dim))):
            if f".{part}." in name:
                fused = name.replace(part, "qkv_proj")
                if fused in t:
                    return f32(fused)[a:b]
        for part, half in (("gate_proj", 0), ("up_proj", 1)):
            if f".{part}." in name:
                fused = name.replace(part, "gate_up_proj")
                if fused in t:
                    inter = c.intermediate_size
                    return f32(fused)[half * inter:(half + 1) * inter]
        # AWQ / GPTQ: {base}.qweight / qzeros / scales
        base = name[:-len(".weight")] if name.endswith(".weight") else name
        if base + ".qweight" in t:
            packed = {base + k: _as_tensor(t[base + k]).to(dev)
                      for k in (".qweight", ".qzeros", ".scales")}
            w, _group = load_awq_weight(packed, base)
            return w.T          # [out, in], as HF float weights
        raise KeyError(name)

    def maybe(name):
        return f32(name) if name in t else None

    # gemma RMSNorm computes x * (1 + w): the offset is baked into the
    # stored weights, as the JAX converter does
    norm_off = 1.0 if "gemma" in (hf_cfg.get("architectures") or [""])[0].lower() \
        else 0.0

    def get_norm(name):
        return get(name) + norm_off

    def q(w, bs):
        return quantize(w, bits=bits, block_size=bs, sym=sym, act_bits=act_bits)

    bs_qkv = choose_block_size(c.hidden_size, block_size)
    bs_wo = choose_block_size(c.q_dim, block_size, tp_shards)
    bs_gu = choose_block_size(c.hidden_size, block_size)
    if c.is_moe:
        bs_edown = choose_block_size(c.moe_intermediate_size, block_size)
        if c.shared_expert_intermediate_size:
            bs_sdown = choose_block_size(c.shared_expert_intermediate_size, block_size)
    else:
        bs_down = choose_block_size(c.intermediate_size, block_size, tp_shards)

    awq_pass = None
    if awq_log is not None:
        awq_pass = _AwqPass(c, calib_tokens, get("model.embed_tokens.weight"), bits=bits,
                       block_size=block_size, sym=sym, clip=awq_clip)
    acc = {k: [] for k in (
        "wqkv", "qkv_bias", "wo", "wgu", "wdown", "input_norm", "post_norm",
        "pre_ffn_norm", "post_ffn_norm", "q_norm", "k_norm", "router", "wgu_e", "wdown_e", "wgu_shared",
        "wdown_shared", "shared_gate")}
    for i in range(c.num_layers):
        p = f"model.layers.{i}."
        wq = get(p + "self_attn.q_proj.weight").T       # [H, q_dim]
        wk = get(p + "self_attn.k_proj.weight").T       # [H, kv_dim]
        wv = get(p + "self_attn.v_proj.weight").T
        hidden = wq.shape[0]
        wqkv = torch.cat([wq.reshape(hidden, hkv, g, d), wk.reshape(hidden, hkv, 1, d),
                          wv.reshape(hidden, hkv, 1, d)], dim=2).reshape(hidden, -1)
        del wq, wk, wv
        qkv_bias = None
        bq = maybe(p + "self_attn.q_proj.bias")
        if bq is not None:
            bk = get(p + "self_attn.k_proj.bias")
            bv = get(p + "self_attn.v_proj.bias")
            qkv_bias = torch.cat([bq.reshape(hkv, g, d), bk.reshape(hkv, 1, d),
                                  bv.reshape(hkv, 1, d)], dim=1).reshape(-1)
        wo = get(p + "self_attn.o_proj.weight").T
        norms = {"input_norm": get_norm(p + "input_layernorm.weight"),
                 "post_norm": get_norm(p + "post_attention_layernorm.weight")}
        if c.sandwich_norm:
            norms["pre_ffn_norm"] = get_norm(p + "pre_feedforward_layernorm.weight")
            norms["post_ffn_norm"] = get_norm(p + "post_feedforward_layernorm.weight")
        if c.qk_norm:
            norms["q_norm"] = get_norm(p + "self_attn.q_norm.weight")
            norms["k_norm"] = get_norm(p + "self_attn.k_norm.weight")

        if c.is_moe:
            acc["router"].append(get(p + "mlp.gate.weight").T)   # [H, E]
            for e in range(c.num_experts):
                ep = p + f"mlp.experts.{e}."
                gu = interleave_gate_up(get(ep + "gate_proj.weight").T,
                                        get(ep + "up_proj.weight").T)
                acc["wgu_e"].append(q(gu, bs_gu))
                acc["wdown_e"].append(q(get(ep + "down_proj.weight").T, bs_edown))
            if c.shared_expert_intermediate_size:
                sp = p + "mlp.shared_expert."
                gu = interleave_gate_up(get(sp + "gate_proj.weight").T,
                                        get(sp + "up_proj.weight").T)
                acc["wgu_shared"].append(q(gu, bs_gu))
                acc["wdown_shared"].append(q(get(sp + "down_proj.weight").T, bs_sdown))
                acc["shared_gate"].append(get(p + "mlp.shared_expert_gate.weight")[0])
        else:
            gu = interleave_gate_up(get(p + "mlp.gate_proj.weight").T,
                                    get(p + "mlp.up_proj.weight").T)
            down = get(p + "mlp.down_proj.weight").T
            if awq_pass is not None:
                res = awq_pass.layer(wqkv, qkv_bias, wo, gu, down, norms["input_norm"],
                                norms["post_norm"], norms.get("q_norm"), norms.get("k_norm"))
                wqkv, qkv_bias, wo, gu, down = (res.wqkv, res.qkv_bias, res.wo, res.wgu,
                                                res.wdown)
                norms.update(input_norm=res.input_norm, post_norm=res.post_norm)
                awq_log.append(dict(ratios=res.ratios, clip_steps=res.clip_steps))
            acc["wgu"].append(q(gu, bs_gu))
            acc["wdown"].append(q(down, bs_down))
        acc["wqkv"].append(q(wqkv, bs_qkv))
        acc["wo"].append(q(wo, bs_wo))
        if qkv_bias is not None:
            acc["qkv_bias"].append(qkv_bias)
        for key, v in norms.items():
            acc[key].append(v)
        del wqkv, wo

    def stack(key):
        return torch.stack(acc[key]) if acc[key] else None

    def stack_q(key, biases=None):
        return _stack(acc[key], biases) if acc[key] else None

    def per_expert(ql):         # [L * E, ...] -> [L, E, ...]
        r = lambda a: a.reshape(c.num_layers, c.num_experts, *a.shape[1:])
        return dataclasses.replace(ql, packed=r(ql.packed), scale=r(ql.scale),
                                   bias=r(ql.bias))

    layers = LayerParams(
        wqkv=stack_q("wqkv", acc["qkv_bias"] or None), wo=stack_q("wo"),
        wgu=stack_q("wgu"), wdown=stack_q("wdown"),
        input_norm=stack("input_norm"), post_norm=stack("post_norm"),
        pre_ffn_norm=stack("pre_ffn_norm"), post_ffn_norm=stack("post_ffn_norm"),
        q_norm=stack("q_norm"), k_norm=stack("k_norm"), router=stack("router"),
        wgu_e=per_expert(stack_q("wgu_e")) if c.is_moe else None,
        wdown_e=per_expert(stack_q("wdown_e")) if c.is_moe else None,
        wgu_shared=stack_q("wgu_shared"), wdown_shared=stack_q("wdown_shared"),
        shared_gate=stack("shared_gate"))
    acc.clear()

    emb_f32 = get("model.embed_tokens.weight")
    emb = emb_f32.to(torch.bfloat16)
    head_w = emb_f32.T if c.tie_word_embeddings else get("lm_head.weight").T
    if lm_head_bits in (4, 8):
        # a quantized output projection (decode reads it once a token)
        bs_head = choose_block_size(c.hidden_size, block_size)
        lm_head = quantize(head_w, bits=lm_head_bits, block_size=bs_head, sym=sym)
    elif c.tie_word_embeddings:
        lm_head = None
    else:
        lm_head = head_w.to(torch.bfloat16).contiguous()
    del emb_f32, head_w
    return Params(embedding=emb, final_norm=get_norm("model.norm.weight"),
                  lm_head=lm_head, layers=layers)
