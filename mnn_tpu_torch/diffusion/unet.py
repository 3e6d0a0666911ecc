"""Stable-Diffusion-class conditional UNet denoiser (NCHW).

Counterpart of the JAX package's `diffusion/unet.py`. Parameters are a flat
dict keyed by the diffusers `UNet2DConditionModel` state-dict names:
convolutions kept OIHW, linears [in, out] (`from_diffusers` transposes
them once). The forward is plain torch ops in the JAX package's order and
dtypes (`diffusion/nn.py`): f32 products, the result in the activations'
dtype, group norm in f32, attention on `nn.attention` (f32 scores and
softmax). `sd.py` runs cond and uncond as one batch-2 call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import (attention, conv2d, group_norm, layer_norm,
                                        linear, no_tf32, silu, t_conv, t_lin, t_vec,
                                        timestep_embedding, upsample_nearest_2x)
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int = 8
    transformer_layers: int = 1
    groups: int = 32

    @staticmethod
    def tiny():
        """Small config for tests (structure identical to SD1.5)."""
        return UNetConfig(block_out_channels=(32, 64),
                          cross_attn_blocks=(True, False),
                          layers_per_block=1, cross_attention_dim=32,
                          num_heads=2, groups=8)


# ---------------------------------------------------------------------------
# blocks

def _resnet(p: Dict, pre: str, x, temb, groups):
    h = silu(group_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], groups=groups))
    h = conv2d(h, p[pre + "conv1.weight"], p[pre + "conv1.bias"])
    t = linear(silu(temb), p[pre + "time_emb_proj.weight"], p[pre + "time_emb_proj.bias"])
    h = h + t[:, :, None, None]
    h = silu(group_norm(h, p[pre + "norm2.weight"], p[pre + "norm2.bias"], groups=groups))
    h = conv2d(h, p[pre + "conv2.weight"], p[pre + "conv2.bias"])
    if pre + "conv_shortcut.weight" in p:
        x = conv2d(x, p[pre + "conv_shortcut.weight"], p[pre + "conv_shortcut.bias"],
                   padding=0)
    return x + h


def _basic_transformer_block(p: Dict, pre: str, x, ctx, num_heads):
    h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
    q = linear(h, p[pre + "attn1.to_q.weight"])
    k = linear(h, p[pre + "attn1.to_k.weight"])
    v = linear(h, p[pre + "attn1.to_v.weight"])
    x = x + linear(attention(q, k, v, num_heads), p[pre + "attn1.to_out.0.weight"],
                   p[pre + "attn1.to_out.0.bias"])
    h = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
    q = linear(h, p[pre + "attn2.to_q.weight"])
    k = linear(ctx, p[pre + "attn2.to_k.weight"])
    v = linear(ctx, p[pre + "attn2.to_v.weight"])
    x = x + linear(attention(q, k, v, num_heads), p[pre + "attn2.to_out.0.weight"],
                   p[pre + "attn2.to_out.0.bias"])
    h = layer_norm(x, p[pre + "norm3.weight"], p[pre + "norm3.bias"])
    h = linear(h, p[pre + "ff.net.0.proj.weight"], p[pre + "ff.net.0.proj.bias"])
    h, gate = h.chunk(2, dim=-1)
    # exact erf GELU: diffusers' GEGLU uses nn.GELU()
    h = h * F.gelu(gate.float()).to(h.dtype)
    return x + linear(h, p[pre + "ff.net.2.weight"], p[pre + "ff.net.2.bias"])


def _transformer2d(p: Dict, pre: str, x, ctx, cfg: UNetConfig):
    b, c, hh, ww = x.shape
    res = x
    h = group_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], groups=cfg.groups,
                   eps=1e-6)
    h = conv2d(h, p[pre + "proj_in.weight"], p[pre + "proj_in.bias"], padding=0)
    h = h.reshape(b, c, hh * ww).transpose(1, 2)         # tokens in (h, w) order
    for i in range(cfg.transformer_layers):
        h = _basic_transformer_block(p, f"{pre}transformer_blocks.{i}.", h, ctx,
                                     cfg.num_heads)
    h = h.transpose(1, 2).reshape(b, c, hh, ww)
    h = conv2d(h, p[pre + "proj_out.weight"], p[pre + "proj_out.bias"], padding=0)
    return h + res


# ---------------------------------------------------------------------------
# full model

def unet_forward(p: Dict, cfg: UNetConfig, latent: torch.Tensor, timestep,
                 encoder_hidden: torch.Tensor) -> torch.Tensor:
    """latent [B, C, H, W], timestep a scalar or [B], encoder_hidden [B,
    T_text, cross_attention_dim] -> noise prediction [B, C, H, W] in
    latent's dtype, on latent's device."""
    x = latent
    b = x.shape[0]
    boc = cfg.block_out_channels
    g = cfg.groups
    with no_tf32():
        ts = torch.as_tensor(timestep, device=x.device).reshape(-1).expand(b)
        temb = timestep_embedding(ts, boc[0])
        temb = linear(temb.to(x.dtype), p["time_embedding.linear_1.weight"],
                      p["time_embedding.linear_1.bias"])
        temb = linear(silu(temb), p["time_embedding.linear_2.weight"],
                      p["time_embedding.linear_2.bias"])

        x = conv2d(x, p["conv_in.weight"], p["conv_in.bias"])
        stack = [x]
        for i in range(len(boc)):
            for j in range(cfg.layers_per_block):
                x = _resnet(p, f"down_blocks.{i}.resnets.{j}.", x, temb, g)
                if cfg.cross_attn_blocks[i]:
                    x = _transformer2d(p, f"down_blocks.{i}.attentions.{j}.", x,
                                       encoder_hidden, cfg)
                stack.append(x)
            if i < len(boc) - 1:
                x = conv2d(x, p[f"down_blocks.{i}.downsamplers.0.conv.weight"],
                           p[f"down_blocks.{i}.downsamplers.0.conv.bias"], stride=2)
                stack.append(x)

        x = _resnet(p, "mid_block.resnets.0.", x, temb, g)
        x = _transformer2d(p, "mid_block.attentions.0.", x, encoder_hidden, cfg)
        x = _resnet(p, "mid_block.resnets.1.", x, temb, g)

        n_up = len(boc)
        for i in range(n_up):
            attn = cfg.cross_attn_blocks[n_up - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                x = torch.cat([x, stack.pop()], dim=1)
                x = _resnet(p, f"up_blocks.{i}.resnets.{j}.", x, temb, g)
                if attn:
                    x = _transformer2d(p, f"up_blocks.{i}.attentions.{j}.", x,
                                       encoder_hidden, cfg)
            if i < n_up - 1:
                x = upsample_nearest_2x(x)
                x = conv2d(x, p[f"up_blocks.{i}.upsamplers.0.conv.weight"],
                           p[f"up_blocks.{i}.upsamplers.0.conv.bias"])

        x = silu(group_norm(x, p["conv_norm_out.weight"], p["conv_norm_out.bias"], groups=g))
        return conv2d(x, p["conv_out.weight"], p["conv_out.bias"])


# ---------------------------------------------------------------------------
# parameter plumbing

def from_diffusers(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a diffusers UNet2DConditionModel state dict (tensors or arrays)
    to f32 on `device` (None: tensors stay on their device, arrays go to the
    card): convolutions kept OIHW, linears transposed to [in, out]."""
    out = {}
    for key, val in state_dict.items():
        if val.ndim == 4:
            out[key] = t_conv(val, device)
        elif val.ndim == 2:
            out[key] = t_lin(val, device)
        else:
            out[key] = t_vec(val, device)
    return out


def param_shapes(cfg: UNetConfig) -> Dict[str, tuple]:
    """Every parameter's key and shape (this module's layouts) for `cfg`:
    random init and the loader's structure check."""
    s: Dict[str, tuple] = {}
    boc = cfg.block_out_channels
    tdim = boc[0] * 4

    def conv(name, cin, cout, k=3):
        s[name + ".weight"] = (cout, cin, k, k)
        s[name + ".bias"] = (cout,)

    def lin(name, din, dout, bias=True):
        s[name + ".weight"] = (din, dout)
        if bias:
            s[name + ".bias"] = (dout,)

    def norm(name, c):
        s[name + ".weight"] = (c,)
        s[name + ".bias"] = (c,)

    def resnet(pre, cin, cout):
        norm(pre + "norm1", cin)
        conv(pre + "conv1", cin, cout)
        lin(pre + "time_emb_proj", tdim, cout)
        norm(pre + "norm2", cout)
        conv(pre + "conv2", cout, cout)
        if cin != cout:
            conv(pre + "conv_shortcut", cin, cout, k=1)

    def transformer(pre, c):
        norm(pre + "norm", c)
        conv(pre + "proj_in", c, c, k=1)
        conv(pre + "proj_out", c, c, k=1)
        for i in range(cfg.transformer_layers):
            tb = f"{pre}transformer_blocks.{i}."
            for n in ("norm1", "norm2", "norm3"):
                norm(tb + n, c)
            lin(tb + "attn1.to_q", c, c, bias=False)
            lin(tb + "attn1.to_k", c, c, bias=False)
            lin(tb + "attn1.to_v", c, c, bias=False)
            lin(tb + "attn1.to_out.0", c, c)
            lin(tb + "attn2.to_q", c, c, bias=False)
            lin(tb + "attn2.to_k", cfg.cross_attention_dim, c, bias=False)
            lin(tb + "attn2.to_v", cfg.cross_attention_dim, c, bias=False)
            lin(tb + "attn2.to_out.0", c, c)
            lin(tb + "ff.net.0.proj", c, c * 8)
            lin(tb + "ff.net.2", c * 4, c)

    conv("conv_in", cfg.in_channels, boc[0])
    lin("time_embedding.linear_1", boc[0], tdim)
    lin("time_embedding.linear_2", tdim, tdim)

    ch = boc[0]
    down_out = [ch]
    for i, cout in enumerate(boc):
        for j in range(cfg.layers_per_block):
            resnet(f"down_blocks.{i}.resnets.{j}.", ch, cout)
            if cfg.cross_attn_blocks[i]:
                transformer(f"down_blocks.{i}.attentions.{j}.", cout)
            ch = cout
            down_out.append(ch)
        if i < len(boc) - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch)
            down_out.append(ch)

    resnet("mid_block.resnets.0.", ch, ch)
    transformer("mid_block.attentions.0.", ch)
    resnet("mid_block.resnets.1.", ch, ch)

    for i in range(len(boc)):
        cout = boc[len(boc) - 1 - i]
        attn = cfg.cross_attn_blocks[len(boc) - 1 - i]
        for j in range(cfg.layers_per_block + 1):
            skip = down_out.pop()
            resnet(f"up_blocks.{i}.resnets.{j}.", ch + skip, cout)
            if attn:
                transformer(f"up_blocks.{i}.attentions.{j}.", cout)
            ch = cout
        if i < len(boc) - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch)

    norm("conv_norm_out", boc[0])
    conv("conv_out", boc[0], cfg.out_channels)
    return s


def fan_in(name: str, shape: tuple) -> int:
    """A weight's fan-in in this package's layouts: I * kh * kw of an OIHW
    convolution, the rows of an [in, out] linear."""
    return int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]


def init_from_shapes(shapes: Dict[str, tuple], generator: torch.Generator,
                     device=None) -> Dict[str, torch.Tensor]:
    """Random parameters for `shapes`: unit norm weights, zero biases, every
    other weight normal / sqrt(fan-in), drawn in sorted key order from
    `generator` on its own device, moved to `device` (None: the card)."""
    dev = resolve_device(device)
    params = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("bias"):
            params[name] = torch.zeros(shape, device=dev)
        elif len(shape) == 1 and "norm" in name:
            params[name] = torch.ones(shape, device=dev)
        else:
            w = torch.randn(shape, generator=generator, device=generator.device)
            params[name] = (w / float(np.sqrt(fan_in(name, shape)))).to(dev)
    return params


def init_unet_params(cfg: UNetConfig, generator: torch.Generator,
                     device=None) -> Dict[str, torch.Tensor]:
    return init_from_shapes(param_shapes(cfg), generator, device)


def check_shapes(kind: str, want: Dict[str, tuple], params: Dict[str, torch.Tensor]):
    """Raise if `params` lacks a key of `want` or holds another shape."""
    missing = sorted(set(want) - set(params))
    if missing:
        raise ValueError(f"{kind} checkpoint missing {len(missing)} params, "
                         f"first: {missing[:5]}")
    for k, shp in want.items():
        got = tuple(params[k].shape)
        if got != tuple(shp):
            raise ValueError(f"{kind} param {k}: shape {got} != expected {shp}")


def validate_params(cfg: UNetConfig, params: Dict[str, torch.Tensor]):
    """Raise if a loaded checkpoint doesn't match this config's structure."""
    check_shapes("unet", param_shapes(cfg), params)
