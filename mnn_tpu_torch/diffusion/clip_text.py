"""CLIP text encoder (Stable Diffusion's conditioning model).

Counterpart of the JAX package's `diffusion/clip_text.py`. Parameters are a
flat dict keyed by the HF `CLIPTextModel` state-dict names (without the
`text_model.` prefix), linear weights [in, out], so a checkpoint's
`text_encoder/` maps by one transpose (`from_hf_clip_text`). Plain torch ops
in the JAX package's order and dtypes (`diffusion/nn.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import (attention, layer_norm, linear, no_tf32,
                                        sigmoid, t_lin, t_vec)
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    act: str = "quick_gelu"
    eos_token_id: int = 49407


def _act(x, kind):
    if kind == "quick_gelu":
        return x * sigmoid(1.702 * x)
    # the JAX package's `jax.nn.gelu(approximate=(kind == "gelu_new"))`
    return F.gelu(x, approximate="tanh" if kind == "gelu_new" else "none")


def clip_text_forward(params: Dict[str, torch.Tensor], cfg: ClipTextConfig,
                      input_ids: torch.Tensor):
    """input_ids [B, T] -> (last_hidden_state [B, T, D], pooled [B, D]).

    Pooled output: the final-LN hidden state at the first EOS token (HF
    semantics); a config with eos_token_id 2 (the SD 1.x text encoders)
    takes HF's legacy rule, the position of the largest token id."""
    b, t = input_ids.shape
    with no_tf32():
        x = params["embeddings.token_embedding.weight"][input_ids]
        x = x + params["embeddings.position_embedding.weight"][None, :t]
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
        for i in range(cfg.num_layers):
            p = f"encoder.layers.{i}."
            h = layer_norm(x, params[p + "layer_norm1.weight"], params[p + "layer_norm1.bias"])
            q = linear(h, params[p + "self_attn.q_proj.weight"], params[p + "self_attn.q_proj.bias"])
            k = linear(h, params[p + "self_attn.k_proj.weight"], params[p + "self_attn.k_proj.bias"])
            v = linear(h, params[p + "self_attn.v_proj.weight"], params[p + "self_attn.v_proj.bias"])
            o = attention(q, k, v, cfg.num_heads, mask=causal)
            x = x + linear(o, params[p + "self_attn.out_proj.weight"],
                           params[p + "self_attn.out_proj.bias"])
            h = layer_norm(x, params[p + "layer_norm2.weight"], params[p + "layer_norm2.bias"])
            h = _act(linear(h, params[p + "mlp.fc1.weight"], params[p + "mlp.fc1.bias"]), cfg.act)
            x = x + linear(h, params[p + "mlp.fc2.weight"], params[p + "mlp.fc2.bias"])
        x = layer_norm(x, params["final_layer_norm.weight"], params["final_layer_norm.bias"])
    if cfg.eos_token_id == 2:
        eos_pos = torch.argmax(input_ids, dim=1)
    else:
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    return x, pooled


def from_hf_clip_text(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a HF CLIPTextModel state dict (tensors or arrays) to f32 on
    `device` (None: tensors stay on their device, arrays go to the card)."""
    out = {}
    for key, val in state_dict.items():
        key = key.removeprefix("text_model.")
        if key.endswith(".weight") and val.ndim == 2 and "embedding" not in key:
            out[key] = t_lin(val, device)
        else:
            out[key] = t_vec(val, device)
    return out


def init_clip_text_params(cfg: ClipTextConfig, generator: torch.Generator,
                          device=None) -> Dict[str, torch.Tensor]:
    """Random weights (normal * 0.02, unit norms, zero biases) with the key
    layout of `from_hf_clip_text`, drawn from `generator` on its own device
    and moved to `device` (None: the card)."""
    dev = resolve_device(device)
    gdev = generator.device

    def rnd(*shape):
        return (torch.randn(shape, generator=generator, device=gdev) * 0.02).to(dev)

    ones = lambda n: torch.ones(n, device=dev)
    zeros = lambda n: torch.zeros(n, device=dev)
    d, f = cfg.hidden_size, cfg.intermediate_size
    p = {"embeddings.token_embedding.weight": rnd(cfg.vocab_size, d),
         "embeddings.position_embedding.weight": rnd(cfg.max_position_embeddings, d),
         "final_layer_norm.weight": ones(d), "final_layer_norm.bias": zeros(d)}
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}."
        for name in ("layer_norm1", "layer_norm2"):
            p[pre + name + ".weight"] = ones(d)
            p[pre + name + ".bias"] = zeros(d)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            p[pre + f"self_attn.{name}.weight"] = rnd(d, d)
            p[pre + f"self_attn.{name}.bias"] = zeros(d)
        p[pre + "mlp.fc1.weight"] = rnd(d, f)
        p[pre + "mlp.fc1.bias"] = zeros(f)
        p[pre + "mlp.fc2.weight"] = rnd(f, d)
        p[pre + "mlp.fc2.bias"] = zeros(d)
    return p
