"""BigVGAN-style neural vocoder (mel -> waveform).

Counterpart of the JAX package's `audio/vocoder.py`: conv_pre, then per
stage a transposed-convolution upsample and multi-receptive-field AMP
blocks with snake activations (averaged), then snake, conv_post and tanh.
Parameters are a flat dict keyed by the public BigVGAN state-dict names,
weight norm fused at load; the anti-aliased up/down FIR pair around each
activation is optional (`use_aa_filters`), its kaiser-sinc filter fixed,
not a weight.

Layouts are PyTorch's own: a convolution's weight [O, I, k], a transposed
convolution's [I, O, k], so a BigVGAN checkpoint maps as it is
(`from_bigvgan`); `params_from_numpy` takes the JAX package's arrays
([k, I, O] and [k, O, I]). Every convolution runs in f32 with the result
cast to the input's dtype, as the JAX package's `preferred_element_type`,
and with TF32 off on the card (`diffusion.nn.no_tf32`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import _f32, no_tf32
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 80
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    snake_logscale: bool = True
    use_aa_filters: bool = False

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))

    @staticmethod
    def tiny():
        return VocoderConfig(n_mels=8, upsample_rates=(4, 2),
                             upsample_kernel_sizes=(8, 4),
                             upsample_initial_channel=16,
                             resblock_kernel_sizes=(3,),
                             resblock_dilations=((1, 3),))


def _conv1d(x, w, b=None, stride=1, pad=0, dilation=1, groups=1):
    """x [B, C, T], w [O, I / groups, k] -> [B, O, T'] in x's dtype."""
    out = F.conv1d(x.float(), w.float(), None, stride, pad, dilation, groups)
    if b is not None:
        out = out + b[None, :, None]
    return out.to(x.dtype)


def _conv_transpose1d(x, w, b, stride, pad):
    """torch ConvTranspose1d, w [I, O, k]: out length (t - 1) * stride -
    2 * pad + k, in x's dtype."""
    out = F.conv_transpose1d(x.float(), w.float(), None, stride=stride, padding=pad)
    if b is not None:
        out = out + b[None, :, None]
    return out.to(x.dtype)


def _snake(x, alpha, logscale):
    """Snake activation: x + sin^2(a x) / a, per channel."""
    a = torch.exp(alpha) if logscale else alpha
    a = a[None, :, None]
    xf = x.float()
    return (xf + torch.sin(a * xf) ** 2 / (a + 1e-9)).to(x.dtype)


def _kaiser_sinc_filter(cutoff: float, half_width: float, taps: int):
    """Fixed low-pass FIR (BigVGAN's alias-free activation pair)."""
    even = taps % 2 == 0
    delta_f = 4 * half_width
    att = 2.285 * (taps // 2) * math.pi * delta_f + 7.95
    if att > 50.0:
        beta = 0.1102 * (att - 8.7)
    elif att >= 21.0:
        beta = 0.5842 * (att - 21) ** 0.4 + 0.07886 * (att - 21.0)
    else:
        beta = 0.0
    win = np.kaiser(taps, beta)
    if even:
        t = np.arange(-taps // 2, taps // 2) + 0.5
    else:
        t = np.arange(taps) - (taps - 1) // 2
    f = 2 * cutoff * win * np.sinc(2 * cutoff * t)
    f = f / f.sum()
    return f.astype(np.float32)


def _aa_activation(x, alpha, logscale):
    """Anti-aliased snake: 2x FIR upsample -> snake -> FIR downsample."""
    b, c, t = x.shape
    up = torch.from_numpy(_kaiser_sinc_filter(0.5 / 2, 0.6 / 2, 12)).to(x.device)
    kc = up.view(1, 1, 12).expand(c, 1, 12)          # depthwise [c, 1, 12]
    # zero-stuff 2x, then filter each channel
    xz = torch.zeros((b, c, t * 2), dtype=x.dtype, device=x.device)
    xz[:, :, ::2] = x
    h = _conv1d(xz, kc * 2.0, pad=6, groups=c)[..., :t * 2]
    h = _snake(h, alpha, logscale)
    h = _conv1d(h, kc, pad=6, groups=c)[..., :t * 2]
    return h[:, :, ::2]


def _act(x, alpha, cfg: VocoderConfig):
    if cfg.use_aa_filters:
        return _aa_activation(x, alpha, cfg.snake_logscale)
    return _snake(x, alpha, cfg.snake_logscale)


def vocoder_forward(p: Dict[str, torch.Tensor], cfg: VocoderConfig,
                    mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, T] -> waveform [B, T * hop_length] in [-1, 1], on
    mel's device."""
    with no_tf32():
        x = _conv1d(mel, p["conv_pre.weight"], p["conv_pre.bias"], pad=3)
        n_res = len(cfg.resblock_kernel_sizes)
        for i, (rate, ksz) in enumerate(zip(cfg.upsample_rates,
                                            cfg.upsample_kernel_sizes)):
            x = _conv_transpose1d(x, p[f"ups.{i}.0.weight"], p[f"ups.{i}.0.bias"],
                                  stride=rate, pad=(ksz - rate) // 2)
            acc = None
            for j, (rk, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                               cfg.resblock_dilations)):
                pre = f"resblocks.{i * n_res + j}."
                h = x
                for d_i, dil in enumerate(dils):
                    a1 = p[pre + f"activations.{2 * d_i}.act.alpha"]
                    a2 = p[pre + f"activations.{2 * d_i + 1}.act.alpha"]
                    t = _act(h, a1, cfg)
                    t = _conv1d(t, p[pre + f"convs1.{d_i}.weight"],
                                p[pre + f"convs1.{d_i}.bias"],
                                pad=(rk - 1) * dil // 2, dilation=dil)
                    t = _act(t, a2, cfg)
                    t = _conv1d(t, p[pre + f"convs2.{d_i}.weight"],
                                p[pre + f"convs2.{d_i}.bias"], pad=(rk - 1) // 2)
                    h = h + t
                acc = h if acc is None else acc + h
            x = acc / n_res
        x = _act(x, p["activation_post.act.alpha"], cfg)
        x = _conv1d(x, p["conv_post.weight"], p["conv_post.bias"], pad=3)
        return torch.tanh(x[:, 0])


# ---------------------------------------------------------------------------

def from_bigvgan(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a BigVGAN generator state dict (tensors or arrays) to f32 on
    `device` (None: tensors stay on their device, arrays go to the card),
    in its own layouts. Fuses weight norm (weight_g * weight_v /
    ||weight_v||, the norm over all but dim 0) where present; takes both
    `activations.N.act.alpha` and `activations.N.alpha`."""
    raw = {k: _f32(v, device) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for k, v in raw.items():
        if k.endswith("weight_g"):
            continue
        if k.endswith("weight_v"):
            g = raw[k[:-1] + "g"]
            norm = torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True))
            v = g * v / torch.clamp(norm, min=1e-12)
            k = k[:-9] + ".weight"
        if ".act." not in k and k.endswith(".alpha"):
            k = k[:-6] + ".act.alpha"
        out[k] = v.contiguous()
    return out


def params_from_numpy(arrays, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's vocoder parameters (its layouts: a convolution
    [k, I, O], a transposed convolution [k, O, I]) -> this module's ([O, I,
    k], [I, O, k]): one transpose of every 3-D array, f32 on `device` (None:
    the card)."""
    dev = resolve_device(device)
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v, np.float32)
        if v.ndim == 3:
            v = np.transpose(v, (2, 1, 0))
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return out


def init_vocoder_params(cfg: VocoderConfig, generator: torch.Generator,
                        device=None) -> Dict[str, torch.Tensor]:
    """Random weights (normal * 0.05, zero biases and alphas) in this
    module's layouts, drawn from `generator` on its own device and moved to
    `device` (None: the card)."""
    dev = resolve_device(device)

    def rnd(*shape):
        return (torch.randn(shape, generator=generator, device=generator.device)
                * 0.05).to(dev)

    zeros = lambda n: torch.zeros(n, device=dev)
    ch = cfg.upsample_initial_channel
    p = {"conv_pre.weight": rnd(ch, cfg.n_mels, 7), "conv_pre.bias": zeros(ch)}
    n_res = len(cfg.resblock_kernel_sizes)
    for i, ksz in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = ch // (2 ** i), ch // (2 ** (i + 1))
        p[f"ups.{i}.0.weight"] = rnd(cin, cout, ksz)          # [I, O, k]
        p[f"ups.{i}.0.bias"] = zeros(cout)
        for j, (rk, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilations)):
            pre = f"resblocks.{i * n_res + j}."
            for d_i in range(len(dils)):
                p[pre + f"convs1.{d_i}.weight"] = rnd(cout, cout, rk)
                p[pre + f"convs1.{d_i}.bias"] = zeros(cout)
                p[pre + f"convs2.{d_i}.weight"] = rnd(cout, cout, rk)
                p[pre + f"convs2.{d_i}.bias"] = zeros(cout)
                p[pre + f"activations.{2 * d_i}.act.alpha"] = zeros(cout)
                p[pre + f"activations.{2 * d_i + 1}.act.alpha"] = zeros(cout)
    last = ch // (2 ** len(cfg.upsample_rates))
    p["activation_post.act.alpha"] = zeros(last)
    p["conv_post.weight"] = rnd(1, last, 7)
    p["conv_post.bias"] = zeros(1)
    return p
