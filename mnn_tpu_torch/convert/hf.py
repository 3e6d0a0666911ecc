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
bytes are the same. The activation-aware scale search (`awq=True`) is not
ported (ROADMAP.md, Queue 1 item 10).
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
from mnn_tpu_torch.models.layers import interleave_gate_up
from mnn_tpu_torch.quant.quantize import QuantizedLinear, choose_block_size, quantize


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
    device=None,
):
    """Convert and quantize an HF decoder checkpoint (qwen2 / qwen3 /
    llama / mistral / phi3 / gemma2 / gemma3, dense or Qwen2-MoE) on
    `device` (None: the card)
    and write it to `out_dir`. `hf_config` / `tensors` stand in for the
    files on disk (the GGUF importer feeds its decoded tensors so).
    Returns (config, params): what was written, as it lies on `device`."""
    if awq:
        raise NotImplementedError(
            "awq=True (the activation-aware scale search) is not ported: "
            "ROADMAP.md, Queue 1 item 10")
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
    src = StDir(model_dir) if tensors is None else None
    try:
        params = _convert(config, hf_cfg, src if src is not None else tensors,
                          dev, bits=bits, block_size=block_size, sym=sym,
                          tp_shards=tp_shards, act_bits=act_bits,
                          lm_head_bits=lm_head_bits)
    finally:
        if src is not None:
            src.close()
    rt = (rt or RuntimeConfig()).merge(
        quant_bits=bits, quant_block=block_size, quant_sym=sym, act_bits=act_bits)
    save_checkpoint(out_dir, config, params, rt, tokenizer_src=model_dir)
    return config, params


def _convert(c: ModelConfig, hf_cfg: dict, t: Mapping, dev: torch.device, *,
             bits, block_size, sym, tp_shards, act_bits, lm_head_bits) -> Params:
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
        acc["wqkv"].append(q(wqkv, bs_qkv))
        del wq, wk, wv, wqkv
        bq = maybe(p + "self_attn.q_proj.bias")
        if bq is not None:
            bk = get(p + "self_attn.k_proj.bias")
            bv = get(p + "self_attn.v_proj.bias")
            acc["qkv_bias"].append(torch.cat(
                [bq.reshape(hkv, g, d), bk.reshape(hkv, 1, d), bv.reshape(hkv, 1, d)],
                dim=1).reshape(-1))
        acc["wo"].append(q(get(p + "self_attn.o_proj.weight").T, bs_wo))

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
            acc["wgu"].append(q(gu, bs_gu))
            acc["wdown"].append(q(get(p + "mlp.down_proj.weight").T, bs_down))

        acc["input_norm"].append(get_norm(p + "input_layernorm.weight"))
        acc["post_norm"].append(get_norm(p + "post_attention_layernorm.weight"))
        if c.sandwich_norm:
            acc["pre_ffn_norm"].append(get_norm(p + "pre_feedforward_layernorm.weight"))
            acc["post_ffn_norm"].append(get_norm(p + "post_feedforward_layernorm.weight"))
        if c.qk_norm:
            acc["q_norm"].append(get_norm(p + "self_attn.q_norm.weight"))
            acc["k_norm"].append(get_norm(p + "self_attn.k_norm.weight"))

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
