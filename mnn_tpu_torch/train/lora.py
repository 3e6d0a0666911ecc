"""LoRA adapters for the quantized decoder.

Counterpart of `mnn_tpu/train/lora.py`: the base model stays frozen in its
packed W4/W8 form, the adapters are the only trainable tensors, and
`merge_lora` folds trained adapters back into the quantized weights
(dequantize in f32, add (a @ b) * scaling, quantize again at the layer's
bits and block, keeping its out_bias), one layer at a time on the device
the weights lie on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.decoder import LoraParams, Params
from mnn_tpu_torch.quant.quantize import QuantizedLinear, dequantize, quantize

TARGETS = ("qkv", "o", "gu", "down")


def lora_dims(c: ModelConfig) -> dict:
    """(K, N) of each adaptable projection."""
    qkv_n = (c.num_heads + 2 * c.num_kv_heads) * c.head_dim
    return {"qkv": (c.hidden_size, qkv_n), "o": (c.q_dim, c.hidden_size),
            "gu": (c.hidden_size, 2 * c.intermediate_size),
            "down": (c.intermediate_size, c.hidden_size)}


def init_lora(
    config: ModelConfig,
    generator: torch.Generator,
    rank: int = 8,
    alpha: float = 16.0,
    targets: Sequence[str] = TARGETS,
    device=None,
) -> LoraParams:
    """Adapters for `targets` on `device` (None: the card): a ~ N(0, 1/r),
    b = 0, so the delta starts at 0 (the standard init, as the JAX package
    makes it; the numbers differ, `generator` being torch's). The generator
    lives on the CPU, so a seed gives the same adapters on any device."""
    dev = resolve_device(device)
    fields = {}
    for name, (k_dim, n_dim) in lora_dims(config).items():
        a = b = None
        if name in targets:
            a = (torch.randn((config.num_layers, k_dim, rank), generator=generator)
                 / rank ** 0.5).to(dev)
            b = torch.zeros((config.num_layers, rank, n_dim), device=dev)
        fields["a_" + name], fields["b_" + name] = a, b
    return LoraParams(scaling=alpha / rank, **fields)


def _merge_one(ql: QuantizedLinear, a: Optional[torch.Tensor],
               b: Optional[torch.Tensor], scaling: float,
               bits: Optional[int]) -> QuantizedLinear:
    bits = bits or ql.bits
    if a is None and bits == ql.bits:
        return ql
    parts = []
    with torch.no_grad():
        for i in range(ql.packed.shape[0]):
            ql_l = ql.layer(i)
            w = dequantize(ql_l, dtype=torch.float32)
            if a is not None:
                w = w + (a[i].float() @ b[i].float()) * scaling
            parts.append(quantize(w, bits=bits, block_size=ql.block_size,
                                  act_bits=ql.act_bits))
    st = lambda f: torch.stack([getattr(q, f) for q in parts])
    return dataclasses.replace(ql, packed=st("packed"), scale=st("scale"), bias=st("bias"),
                               bits=bits)


def merge_lora(params: Params, lora: LoraParams, bits: Optional[int] = None) -> Params:
    """Fold adapters into the packed weights (quantized again); the result
    serves with no adapter, on every decode path. `bits` quantizes the
    four projections at another width (None: each layer's own, as the JAX
    package does). At 4 bits a trained delta moves each block's range, so
    every weight is rounded again on a new grid and the merged logits can
    land far from the adapter forward's; 8 bits keep them close (`PERF.md`
    has both on qwen2-0.5b)."""
    lp = params.layers
    layers = dataclasses.replace(
        lp, wqkv=_merge_one(lp.wqkv, lora.a_qkv, lora.b_qkv, lora.scaling, bits),
        wo=_merge_one(lp.wo, lora.a_o, lora.b_o, lora.scaling, bits),
        wgu=_merge_one(lp.wgu, lora.a_gu, lora.b_gu, lora.scaling, bits),
        wdown=_merge_one(lp.wdown, lora.a_down, lora.b_down, lora.scaling, bits))
    return dataclasses.replace(params, layers=layers)
