"""MMDiT denoiser (SD3 / SD3.5-class joint-attention diffusion transformer).

Counterpart of the JAX package's `diffusion/mmdit.py` (MNN-Diffusion's
`diffusion_sd35.cpp` runtime): two token streams, image patches and text
context, each modulated by adaLN-zero from (timestep + pooled text), attend
jointly; per-stream MLPs, a final adaLN and linear head, then unpatchify.
Pairs with `FlowMatchEulerScheduler` (SD3's rectified flow).

Parameters are a flat dict keyed by diffusers `SD3Transformer2DModel`
state-dict names, linears [in, out] as in the JAX package, so the JAX
package's dict carries over key for key (`params_from_numpy`);
`from_diffusers_sd3` maps a diffusers checkpoint. Rounding points are the
JAX package's (`diffusion/nn.py`): f32 products cast to the activations'
dtype, the QK RMS norm in f32 with eps 1e-6, f32 scores and softmax, the
tanh GELU on an f32 tensor. The last block is context_pre_only (the text
stream is not updated), as in SD3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import (layer_norm, linear, no_tf32, silu, t_lin, t_vec,
                                        timestep_embedding)
from mnn_tpu_torch.diffusion.unet import check_shapes
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16           # SD3 latent channels
    patch_size: int = 2
    hidden_size: int = 1536         # SD3-medium: 24 * 64
    depth: int = 24
    num_heads: int = 24
    context_dim: int = 4096         # T5/CLIP-joint text width
    pooled_dim: int = 2048
    pos_embed_max: int = 96         # max patches per side in the position table
    qk_norm: bool = True            # SD3.5

    @staticmethod
    def tiny():
        return MMDiTConfig(in_channels=4, patch_size=2, hidden_size=32,
                           depth=2, num_heads=2, context_dim=16,
                           pooled_dim=24, pos_embed_max=8)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _rms(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    af = a.float()
    n = af * torch.rsqrt((af * af).mean(-1, keepdim=True) + 1e-6)
    return (n * w).to(a.dtype)


def _joint_attention(q, k, v, num_heads: int, qk_norm: bool, nq_img: int, p: Dict,
                     pre: str) -> torch.Tensor:
    """q / k / v [B, T, D] over the concatenated (image, text) stream."""
    b, t, d = q.shape
    hd = d // num_heads

    def heads(a):
        return a.reshape(b, t, num_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if qk_norm:
        # separate norms for the image rows and the text rows (diffusers'
        # norm_q / norm_k against norm_added_q / norm_added_k)
        q = torch.cat([_rms(q[:, :, :nq_img], p[pre + "attn.norm_q.weight"]),
                       _rms(q[:, :, nq_img:], p[pre + "attn.norm_added_q.weight"])], 2)
        k = torch.cat([_rms(k[:, :, :nq_img], p[pre + "attn.norm_k.weight"]),
                       _rms(k[:, :, nq_img:], p[pre + "attn.norm_added_k.weight"])], 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(a.float(), v.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, t, d)


def _gelu_f32(h: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(approximate=True)` on the f32 value, back to h's dtype."""
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def _block(p: Dict, pre: str, x, ctx, c_vec, cfg: MMDiTConfig, last: bool):
    nx = x.shape[1]
    mod_x = linear(silu(c_vec), p[pre + "norm1.linear.weight"], p[pre + "norm1.linear.bias"])
    sx = mod_x.chunk(6, dim=-1)   # AdaLNZero order: shift, scale, gate, twice
    mod_c = linear(silu(c_vec), p[pre + "norm1_context.linear.weight"],
                   p[pre + "norm1_context.linear.bias"])
    sc = mod_c.chunk(2 if last else 6, dim=-1)

    hx = _modulate(layer_norm(x, None, None), sx[0], sx[1])
    if last:
        # context_pre_only takes AdaLayerNormContinuous: (scale, shift)
        hc = _modulate(layer_norm(ctx, None, None), sc[1], sc[0])
    else:
        hc = _modulate(layer_norm(ctx, None, None), sc[0], sc[1])

    def proj(name_x, name_c):
        return torch.cat([linear(hx, p[pre + f"attn.{name_x}.weight"],
                                 p[pre + f"attn.{name_x}.bias"]),
                          linear(hc, p[pre + f"attn.{name_c}.weight"],
                                 p[pre + f"attn.{name_c}.bias"])], 1)

    q, k, v = proj("to_q", "add_q_proj"), proj("to_k", "add_k_proj"), proj("to_v", "add_v_proj")
    o = _joint_attention(q, k, v, cfg.num_heads, cfg.qk_norm, nx, p, pre)
    o_img, o_ctx = o[:, :nx], o[:, nx:]

    x = x + sx[2][:, None] * linear(o_img, p[pre + "attn.to_out.0.weight"],
                                    p[pre + "attn.to_out.0.bias"])
    h = _modulate(layer_norm(x, None, None), sx[3], sx[4])
    h = _gelu_f32(linear(h, p[pre + "ff.net.0.proj.weight"], p[pre + "ff.net.0.proj.bias"]))
    x = x + sx[5][:, None] * linear(h, p[pre + "ff.net.2.weight"], p[pre + "ff.net.2.bias"])

    if last:   # context_pre_only: the text stream ends here
        return x, ctx
    ctx = ctx + sc[2][:, None] * linear(o_ctx, p[pre + "attn.to_add_out.weight"],
                                        p[pre + "attn.to_add_out.bias"])
    hc2 = _modulate(layer_norm(ctx, None, None), sc[3], sc[4])
    hc2 = _gelu_f32(linear(hc2, p[pre + "ff_context.net.0.proj.weight"],
                           p[pre + "ff_context.net.0.proj.bias"]))
    ctx = ctx + sc[5][:, None] * linear(hc2, p[pre + "ff_context.net.2.weight"],
                                        p[pre + "ff_context.net.2.bias"])
    return x, ctx


def mmdit_forward(p: Dict, cfg: MMDiTConfig, latent: torch.Tensor, timestep,
                  context: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """latent [B, C, H, W], timestep a scalar or [B], context [B, Tc,
    context_dim], pooled [B, pooled_dim] -> velocity [B, C, H, W] in
    latent's dtype, on latent's device."""
    b, c, hh, ww = latent.shape
    ps = cfg.patch_size
    nh, nw = hh // ps, ww // ps
    d = cfg.hidden_size
    with no_tf32():
        # patchify through the conv kernel flattened to a linear [C ps ps, D]
        x = latent.reshape(b, c, nh, ps, nw, ps).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, nh * nw, c * ps * ps)
        x = linear(x, p["pos_embed.proj.weight"], p["pos_embed.proj.bias"])
        # the 2-D position table (diffusers keeps [1, max * max, D]) cropped
        # around its centre
        pos = p["pos_embed.pos_embed"][0].reshape(cfg.pos_embed_max, cfg.pos_embed_max, d)
        top = (cfg.pos_embed_max - nh) // 2
        left = (cfg.pos_embed_max - nw) // 2
        x = x + pos[top:top + nh, left:left + nw].reshape(1, nh * nw, d)

        ts = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
        t_emb = timestep_embedding(ts.expand(b), 256).to(x.dtype)
        t_emb = linear(t_emb, p["time_text_embed.timestep_embedder.linear_1.weight"],
                       p["time_text_embed.timestep_embedder.linear_1.bias"])
        t_emb = linear(silu(t_emb), p["time_text_embed.timestep_embedder.linear_2.weight"],
                       p["time_text_embed.timestep_embedder.linear_2.bias"])
        pl = linear(pooled, p["time_text_embed.text_embedder.linear_1.weight"],
                    p["time_text_embed.text_embedder.linear_1.bias"])
        pl = linear(silu(pl), p["time_text_embed.text_embedder.linear_2.weight"],
                    p["time_text_embed.text_embedder.linear_2.bias"])
        c_vec = t_emb + pl

        ctx = linear(context, p["context_embedder.weight"], p["context_embedder.bias"])
        for i in range(cfg.depth):
            x, ctx = _block(p, f"transformer_blocks.{i}.", x, ctx, c_vec, cfg,
                            last=(i == cfg.depth - 1))

        mod = linear(silu(c_vec), p["norm_out.linear.weight"], p["norm_out.linear.bias"])
        # AdaLayerNormContinuous chunks as (scale, shift), diffusers' order
        scale, shift = mod.chunk(2, dim=-1)
        x = _modulate(layer_norm(x, None, None), shift, scale)
        x = linear(x, p["proj_out.weight"], p["proj_out.bias"])
    # unpatchify
    x = x.reshape(b, nh, nw, c, ps, ps).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, hh, ww)


# ---------------------------------------------------------------------------
# parameter plumbing

def from_diffusers_sd3(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a diffusers SD3Transformer2DModel state dict (tensors or arrays)
    to f32 on `device` (None: tensors stay on their device, arrays go to the
    card): the patch convolution [D, C, p, p] to a linear [C p p, D], every
    other 2-D weight transposed to [in, out]."""
    out = {}
    for key, val in state_dict.items():
        if key == "pos_embed.proj.weight":
            out[key] = t_lin(val.reshape(val.shape[0], -1), device)
        elif key.endswith(".weight") and val.ndim == 2:
            out[key] = t_lin(val, device)
        else:
            out[key] = t_vec(val, device)
    return out


def params_from_numpy(params: Dict, device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (arrays in its layouts, which are
    this module's) as `dtype` tensors on `device` (None: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev, dtype)
            for k, v in params.items()}


def param_shapes(cfg: MMDiTConfig) -> Dict[str, tuple]:
    d = cfg.hidden_size
    s: Dict[str, tuple] = {}

    def lin(name, din, dout):
        s[name + ".weight"] = (din, dout)
        s[name + ".bias"] = (dout,)

    s["pos_embed.proj.weight"] = (cfg.in_channels * cfg.patch_size ** 2, d)
    s["pos_embed.proj.bias"] = (d,)
    s["pos_embed.pos_embed"] = (1, cfg.pos_embed_max ** 2, d)
    lin("time_text_embed.timestep_embedder.linear_1", 256, d)
    lin("time_text_embed.timestep_embedder.linear_2", d, d)
    lin("time_text_embed.text_embedder.linear_1", cfg.pooled_dim, d)
    lin("time_text_embed.text_embedder.linear_2", d, d)
    lin("context_embedder", cfg.context_dim, d)
    for i in range(cfg.depth):
        pre = f"transformer_blocks.{i}."
        last = i == cfg.depth - 1
        lin(pre + "norm1.linear", d, 6 * d)
        lin(pre + "norm1_context.linear", d, (2 if last else 6) * d)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            lin(pre + f"attn.{nm}", d, d)
        if cfg.qk_norm:
            hd = d // cfg.num_heads
            for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                s[pre + f"attn.{nm}.weight"] = (hd,)
        lin(pre + "attn.to_out.0", d, d)
        lin(pre + "ff.net.0.proj", d, 4 * d)
        lin(pre + "ff.net.2", 4 * d, d)
        if not last:
            lin(pre + "attn.to_add_out", d, d)
            lin(pre + "ff_context.net.0.proj", d, 4 * d)
            lin(pre + "ff_context.net.2", 4 * d, d)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg.in_channels * cfg.patch_size ** 2)
    return s


def init_mmdit_params(cfg: MMDiTConfig, generator: torch.Generator,
                      device=None) -> Dict[str, torch.Tensor]:
    """Random parameters, the JAX package's rule: zero biases, unit 1-D
    weights (the QK norms), every other weight normal / sqrt(prod(shape[:-1])),
    drawn in sorted key order from `generator` on its own device, moved to
    `device` (None: the card)."""
    dev = resolve_device(device)
    out = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith("bias"):
            out[name] = torch.zeros(shape, device=dev)
        elif len(shape) == 1:
            out[name] = torch.ones(shape, device=dev)
        else:
            fan_in = int(np.prod(shape[:-1])) or 1
            w = torch.randn(shape, generator=generator, device=generator.device)
            out[name] = (w / float(np.sqrt(fan_in))).to(dev)
    return out


def validate_params(cfg: MMDiTConfig, params: Dict[str, torch.Tensor]):
    """Raise if a checkpoint lacks a parameter of `cfg` or holds another shape."""
    check_shapes("mmdit", param_shapes(cfg), params)
