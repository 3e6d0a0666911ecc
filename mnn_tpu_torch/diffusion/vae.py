"""AutoencoderKL VAE (encoder and decoder), NCHW.

Counterpart of the JAX package's `diffusion/vae.py`. Parameters are a flat
dict keyed by the diffusers `AutoencoderKL` state-dict names (convolutions
OIHW, linears [in, out]); `from_diffusers` also takes the legacy attention
names (query / key / value / proj_attn, the projections stored as 1 x 1
convolutions).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion import scheduler
from mnn_tpu_torch.diffusion.nn import (conv2d, group_norm, linear, no_tf32, silu,
                                        t_conv, t_lin, t_vec, upsample_nearest_2x)
from mnn_tpu_torch.diffusion.unet import check_shapes, init_from_shapes


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def tiny():
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1, groups=4)


def _resnet(p: Dict, pre: str, x, groups):
    h = silu(group_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], groups=groups,
                        eps=1e-6))
    h = conv2d(h, p[pre + "conv1.weight"], p[pre + "conv1.bias"])
    h = silu(group_norm(h, p[pre + "norm2.weight"], p[pre + "norm2.bias"], groups=groups,
                        eps=1e-6))
    h = conv2d(h, p[pre + "conv2.weight"], p[pre + "conv2.bias"])
    if pre + "conv_shortcut.weight" in p:
        x = conv2d(x, p[pre + "conv_shortcut.weight"], p[pre + "conv_shortcut.bias"],
                   padding=0)
    return x + h


def _mid_attention(p: Dict, pre: str, x, groups):
    """Single-head self-attention over spatial positions (the mid block's),
    f32 scores and softmax."""
    b, c, hh, ww = x.shape
    h = group_norm(x, p[pre + "group_norm.weight"], p[pre + "group_norm.bias"],
                   groups=groups, eps=1e-6)
    h = h.reshape(b, c, hh * ww).transpose(1, 2)
    q = linear(h, p[pre + "to_q.weight"], p[pre + "to_q.bias"])
    k = linear(h, p[pre + "to_k.weight"], p[pre + "to_k.bias"])
    v = linear(h, p[pre + "to_v.weight"], p[pre + "to_v.bias"])
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(a.float(), v.float()).to(v.dtype)
    o = linear(o, p[pre + "to_out.0.weight"], p[pre + "to_out.0.bias"])
    return x + o.transpose(1, 2).reshape(b, c, hh, ww)


def _mid_block(p: Dict, pre: str, x, groups):
    x = _resnet(p, pre + "resnets.0.", x, groups)
    x = _mid_attention(p, pre + "attentions.0.", x, groups)
    return _resnet(p, pre + "resnets.1.", x, groups)


def vae_decode(p: Dict, cfg: VAEConfig, latent: torch.Tensor) -> torch.Tensor:
    """latent [B, C, H, W] (scaled, as the sampler leaves it) -> image [B,
    3, 8H, 8W] in [-1, 1], in latent's dtype, on its device."""
    with no_tf32():
        x = latent / cfg.scaling_factor
        x = conv2d(x, p["post_quant_conv.weight"], p["post_quant_conv.bias"], padding=0)
        x = conv2d(x, p["decoder.conv_in.weight"], p["decoder.conv_in.bias"])
        g = cfg.groups
        x = _mid_block(p, "decoder.mid_block.", x, g)
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                x = _resnet(p, f"decoder.up_blocks.{i}.resnets.{j}.", x, g)
            if i < n - 1:
                x = upsample_nearest_2x(x)
                x = conv2d(x, p[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"],
                           p[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"])
        x = silu(group_norm(x, p["decoder.conv_norm_out.weight"],
                            p["decoder.conv_norm_out.bias"], groups=g, eps=1e-6))
        return conv2d(x, p["decoder.conv_out.weight"], p["decoder.conv_out.bias"])


def vae_encode(p: Dict, cfg: VAEConfig, image: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """image [B, 3, H, W] in [-1, 1] -> latent [B, C, H/8, W/8] (scaled).
    The posterior mean, or a sample of it given a generator
    (`scheduler.noise`)."""
    with no_tf32():
        x = conv2d(image, p["encoder.conv_in.weight"], p["encoder.conv_in.bias"])
        g = cfg.groups
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                x = _resnet(p, f"encoder.down_blocks.{i}.resnets.{j}.", x, g)
            if i < n - 1:
                # diffusers' VAE downsample: asymmetric (0, 1) pad, stride-2 conv
                x = F.pad(x, (0, 1, 0, 1))
                x = conv2d(x, p[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"],
                           p[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"],
                           stride=2, padding=0)
        x = _mid_block(p, "encoder.mid_block.", x, g)
        x = silu(group_norm(x, p["encoder.conv_norm_out.weight"],
                            p["encoder.conv_norm_out.bias"], groups=g, eps=1e-6))
        x = conv2d(x, p["encoder.conv_out.weight"], p["encoder.conv_out.bias"])
        x = conv2d(x, p["quant_conv.weight"], p["quant_conv.bias"], padding=0)
    mean, logvar = x.chunk(2, dim=1)
    if generator is not None:
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        mean = mean + std * scheduler.noise(generator, mean.shape, mean.device)
    return mean * cfg.scaling_factor


# ---------------------------------------------------------------------------
# parameter plumbing

_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def from_diffusers(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a diffusers AutoencoderKL state dict (tensors or arrays) to f32
    on `device` (None: tensors stay on their device, arrays go to the card).
    Takes the new attention names (to_q / to_k / to_v / to_out.0) and the
    legacy ones (query / key / value / proj_attn), whose projections are
    1 x 1 convolutions, squeezed to linears."""
    out = {}
    for key, val in state_dict.items():
        ndim = val.ndim
        for old, new in _OLD_ATTN.items():
            if f".{old}." in key:
                key = key.replace(f".{old}.", f".{new}.")
                if ndim == 4:      # a legacy 1 x 1 convolution projection
                    val, ndim = val[:, :, 0, 0], 2
                break
        if ndim == 4:
            out[key] = t_conv(val, device)
        elif ndim == 2:
            out[key] = t_lin(val, device)
        else:
            out[key] = t_vec(val, device)
    return out


def param_shapes(cfg: VAEConfig) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {}
    boc = cfg.block_out_channels
    lat = cfg.latent_channels

    def conv(name, cin, cout, k=3):
        s[name + ".weight"] = (cout, cin, k, k)
        s[name + ".bias"] = (cout,)

    def lin(name, din, dout):
        s[name + ".weight"] = (din, dout)
        s[name + ".bias"] = (dout,)

    def norm(name, c):
        s[name + ".weight"] = (c,)
        s[name + ".bias"] = (c,)

    def resnet(pre, cin, cout):
        norm(pre + "norm1", cin)
        conv(pre + "conv1", cin, cout)
        norm(pre + "norm2", cout)
        conv(pre + "conv2", cout, cout)
        if cin != cout:
            conv(pre + "conv_shortcut", cin, cout, k=1)

    def mid(pre, c):
        resnet(pre + "resnets.0.", c, c)
        norm(pre + "attentions.0.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(pre + f"attentions.0.{nm}", c, c)
        resnet(pre + "resnets.1.", c, c)

    # encoder
    conv("encoder.conv_in", 3, boc[0])
    ch = boc[0]
    for i, cout in enumerate(boc):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}.", ch, cout)
            ch = cout
        if i < len(boc) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
    mid("encoder.mid_block.", ch)
    norm("encoder.conv_norm_out", ch)
    conv("encoder.conv_out", ch, 2 * lat)
    conv("quant_conv", 2 * lat, 2 * lat, k=1)

    # decoder
    conv("post_quant_conv", lat, lat, k=1)
    conv("decoder.conv_in", lat, boc[-1])
    ch = boc[-1]
    mid("decoder.mid_block.", ch)
    for i, cout in enumerate(reversed(boc)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}.", ch, cout)
            ch = cout
        if i < len(boc) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
    norm("decoder.conv_norm_out", ch)
    conv("decoder.conv_out", ch, 3)
    return s


def init_vae_params(cfg: VAEConfig, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
    """Random weights (unit norms, zero biases, normal / sqrt(fan-in)) of
    every key of `param_shapes`, on `device` (None: the card)."""
    return init_from_shapes(param_shapes(cfg), generator, device)


def validate_params(cfg: VAEConfig, params: Dict[str, torch.Tensor]):
    check_shapes("vae", param_shapes(cfg), params)
