"""Sana: linear-attention DiT, DC-AE decoder and flow-matching pipeline.

Counterpart of the JAX package's `diffusion/sana.py` (MNN-Diffusion's
`sana_diffusion.cpp` runtime): ReLU linear attention for the image tokens,
cross-attention to the text embeddings, Mix-FFN (pointwise expand, 3 x 3
depthwise convolution over the token grid, GLU gate, pointwise project),
adaLN-single conditioning, and the deep-compression autoencoder's decoder
(GLU-gated convolution blocks and depth-to-space upsampling).

The entry points take and give the JAX package's layouts: `sana_forward`
and `dcae_decode` work on NHWC latents and images. Inside, feature maps are
NCHW and convolution weights OIHW (a depthwise weight [C, 1, 3, 3]);
`params_from_numpy` carries the JAX package's dicts (HWIO weights) over.
Rounding points are the JAX package's: linear attention in f32,
right-associated, with eps added to the normaliser, cast to the
activations' dtype after; convolutions in f32 cast to the input's dtype
before the bias. `jax.lax.conv_general_dilated` refuses weights of
another dtype than its input; here the weight is promoted, so bf16 weights
run under the f32 activations the timestep embedding gives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion import scheduler as sched
from mnn_tpu_torch.diffusion.nn import (attention, layer_norm, linear, no_tf32, silu,
                                        timestep_embedding)
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class SanaConfig:
    in_channels: int = 32          # DC-AE latent channels
    dim: int = 1152
    num_heads: int = 16            # linear-attention heads
    cross_heads: int = 16
    depth: int = 12
    ffn_expand: float = 2.5
    text_dim: int = 2304           # Gemma-2 hidden
    patch: int = 1                 # Sana patchifies 1 x 1 (the 32x AE does the work)

    @staticmethod
    def tiny():
        return SanaConfig(in_channels=4, dim=64, num_heads=4, cross_heads=4,
                          depth=2, ffn_expand=2.0, text_dim=32)


def _heads(a: torch.Tensor, h: int) -> torch.Tensor:
    b, n, d = a.shape
    return a.reshape(b, n, h, d // h).transpose(1, 2)   # [B, H, N, hd]


def linear_attention(q, k, v, num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """ReLU linear attention, phi(Q) (phi(K)^T V) / (phi(Q) phi(K)^T 1), on
    q / k / v [B, N, D] -> f32 [B, N, D]. Right-associated: the [hd, hd]
    K^T V product makes it O(N hd^2)."""
    qh = torch.relu(_heads(q, num_heads)).float()
    kh = torch.relu(_heads(k, num_heads)).float()
    vh = _heads(v, num_heads).float()
    kv = torch.matmul(kh.transpose(-1, -2), vh)                       # [B, H, hd, hd]
    z = torch.matmul(qh, kh.sum(dim=2)[..., None])[..., 0]             # the normaliser
    out = torch.matmul(qh, kv) / (z[..., None] + eps)
    b, h, n, hd = out.shape
    return out.transpose(1, 2).reshape(b, n, h * hd)


def cross_attention(x, ctx, p: Dict, pre: str, num_heads: int) -> torch.Tensor:
    q = linear(x, p[f"{pre}.q.w"], p[f"{pre}.q.b"])
    k = linear(ctx, p[f"{pre}.k.w"], p[f"{pre}.k.b"])
    v = linear(ctx, p[f"{pre}.v.w"], p[f"{pre}.v.b"])
    o = attention(q, k, v, num_heads)
    return linear(o, p[f"{pre}.o.w"], p[f"{pre}.o.b"])


def _conv(x: torch.Tensor, w: torch.Tensor, b, groups: int = 1) -> torch.Tensor:
    """A stride-1 'SAME' convolution of NCHW x by OIHW w, in f32, cast to
    x's dtype, then the bias added (the JAX package's order)."""
    pad = w.shape[-1] // 2
    out = F.conv2d(x.float(), w.float(), None, 1, pad, 1, groups).to(x.dtype)
    return out + b[None, :, None, None]


def mix_ffn(x, p: Dict, pre: str, hw) -> torch.Tensor:
    """Pointwise expand, 3 x 3 depthwise over the token grid, GLU, pointwise
    project (Sana's FFN: spatial locality in place of positional
    embeddings)."""
    b, n, _ = x.shape
    h, w = hw
    y = linear(x, p[f"{pre}.in.w"], p[f"{pre}.in.b"])                 # [B, N, 2E]
    e2 = y.shape[-1]
    img = y.reshape(b, h, w, e2).permute(0, 3, 1, 2)
    img = _conv(img, p[f"{pre}.dw.w"], p[f"{pre}.dw.b"], groups=e2)
    gate, val = img.permute(0, 2, 3, 1).reshape(b, n, e2).chunk(2, dim=-1)
    return linear(silu(gate) * val, p[f"{pre}.out.w"], p[f"{pre}.out.b"])


def sana_forward(p: Dict, cfg: SanaConfig, latent: torch.Tensor, timestep,
                 text_embeds: torch.Tensor) -> torch.Tensor:
    """latent [B, H, W, C_in] NHWC, timestep [B], text [B, T, text_dim] ->
    velocity [B, H, W, C_in], on latent's device."""
    b, h, w, _ = latent.shape
    with no_tf32():
        x = linear(latent.reshape(b, h * w, cfg.in_channels), p["patch.w"], p["patch.b"])
        ctx = linear(text_embeds, p["text.w"], p["text.b"])

        ts = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
        temb = timestep_embedding(ts, 256)
        temb = silu(linear(temb, p["t1.w"], p["t1.b"]))
        temb = linear(temb, p["t2.w"], p["t2.b"])                     # [B, D]
        # adaLN-single: one shared 6-chunk modulation for every block
        mod6 = linear(silu(temb), p["adaln.w"], p["adaln.b"])           # [B, 6D]

        for i in range(cfg.depth):
            pre = f"blocks.{i}"
            m = mod6[:, None] + p[f"{pre}.sst"][None]                   # [B, 1, 6D]
            sh1, sc1, g1, sh2, sc2, g2 = m.chunk(6, dim=-1)

            hn = layer_norm(x, None, None) * (1 + sc1) + sh1
            q = linear(hn, p[f"{pre}.attn.q.w"], p[f"{pre}.attn.q.b"])
            k = linear(hn, p[f"{pre}.attn.k.w"], p[f"{pre}.attn.k.b"])
            v = linear(hn, p[f"{pre}.attn.v.w"], p[f"{pre}.attn.v.b"])
            att = linear_attention(q, k, v, cfg.num_heads).to(x.dtype)
            x = x + g1 * linear(att, p[f"{pre}.attn.o.w"], p[f"{pre}.attn.o.b"])

            x = x + cross_attention(x, ctx, p, f"{pre}.xattn", cfg.cross_heads)

            hn = layer_norm(x, None, None) * (1 + sc2) + sh2
            x = x + g2 * mix_ffn(hn, p, f"{pre}.ffn", (h, w))

        shift, scale = linear(silu(temb), p["out_mod.w"], p["out_mod.b"])[:, None].chunk(2, -1)
        x = layer_norm(x, None, None) * (1 + scale) + shift
        x = linear(x, p["out.w"], p["out.b"])
    return x.reshape(b, h, w, cfg.in_channels)


# -- DC-AE decoder ------------------------------------------------------------


def _glumb_conv(x, p: Dict, pre: str) -> torch.Tensor:
    """GLU mobile-bottleneck block (DC-AE's ResBlock), NCHW: pointwise
    expand, depthwise 3 x 3, GLU, pointwise project, residual."""
    y = _conv(x, p[f"{pre}.in.w"], p[f"{pre}.in.b"])
    y = _conv(y, p[f"{pre}.dw.w"], p[f"{pre}.dw.b"], groups=y.shape[1])
    gate, val = y.chunk(2, dim=1)
    y = _conv(silu(gate) * val, p[f"{pre}.out.w"], p[f"{pre}.out.b"])
    return x + y


def _pixel_shuffle_up(x, p: Dict, pre: str) -> torch.Tensor:
    """Convolution to 4x channels, then depth to space 2x in the JAX
    package's order: channel (2 i + j) cout + c goes to row offset i,
    column offset j (not `F.pixel_shuffle`'s c 4 + 2 i + j)."""
    b, _, h, w = x.shape
    y = _conv(x, p[f"{pre}.w"], p[f"{pre}.b"])
    cout = y.shape[1] // 4
    y = y.reshape(b, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, cout, h * 2, w * 2)


def dcae_decode(p: Dict, latent: torch.Tensor, *, stages: int = 3,
                blocks: int = 1) -> torch.Tensor:
    """DC-AE decoder: latent [B, h, w, C] NHWC -> image [B, h 2^stages,
    w 2^stages, 3] in tanh's range, on latent's device."""
    with no_tf32():
        x = _conv(latent.permute(0, 3, 1, 2), p["in.w"], p["in.b"])
        for s in range(stages):
            for bidx in range(blocks):
                x = _glumb_conv(x, p, f"dec.{s}.res.{bidx}")
            x = _pixel_shuffle_up(x, p, f"dec.{s}.up")
        x = _conv(silu(x), p["out.w"], p["out.b"])
    return torch.tanh(x).permute(0, 2, 3, 1)


# -- parameters ---------------------------------------------------------------


def _to_torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A JAX-layout array in this module's layout: HWIO convolutions to OIHW,
    [3, 3, C] depthwise weights to [C, 1, 3, 3]; the rest as it is."""
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 3 and name.endswith("dw.w"):
        return a.transpose(2, 0, 1)[:, None]
    return a


def params_from_numpy(params: Dict, device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's Sana or DC-AE parameter dict (arrays, keys
    unchanged) as `dtype` tensors in this module's layouts on `device`
    (None: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(
        _to_torch_layout(k, np.asarray(v, np.float32)))).to(dev, dtype)
        for k, v in params.items()}



def _normal(g: torch.Generator, shape, scale: float, dev) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(dev)


def init_sana_params(cfg: SanaConfig, generator: torch.Generator,
                     device=None) -> Dict[str, torch.Tensor]:
    """Random parameters, the JAX package's rule (weights normal x 0.02,
    zero biases), drawn from `generator` on its own device, moved to
    `device` (None: the card)."""
    dev = resolve_device(device)

    def lin(din, dout, scale=0.02):
        return _normal(generator, (din, dout), scale, dev), torch.zeros(dout, device=dev)

    p = {}
    p["patch.w"], p["patch.b"] = lin(cfg.in_channels, cfg.dim)
    p["text.w"], p["text.b"] = lin(cfg.text_dim, cfg.dim)
    p["t1.w"], p["t1.b"] = lin(256, cfg.dim)
    p["t2.w"], p["t2.b"] = lin(cfg.dim, cfg.dim)
    p["adaln.w"], p["adaln.b"] = lin(cfg.dim, 6 * cfg.dim)
    e = int(cfg.dim * cfg.ffn_expand)
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        p[f"{pre}.sst"] = _normal(generator, (6 * cfg.dim,), 0.02, dev)
        for a in ("attn", "xattn"):
            for n in "qkvo":
                p[f"{pre}.{a}.{n}.w"], p[f"{pre}.{a}.{n}.b"] = lin(cfg.dim, cfg.dim)
        p[f"{pre}.ffn.in.w"], p[f"{pre}.ffn.in.b"] = lin(cfg.dim, 2 * e)
        p[f"{pre}.ffn.dw.w"] = _normal(generator, (2 * e, 1, 3, 3), 0.02, dev)
        p[f"{pre}.ffn.dw.b"] = torch.zeros(2 * e, device=dev)
        p[f"{pre}.ffn.out.w"], p[f"{pre}.ffn.out.b"] = lin(e, cfg.dim)
    p["out_mod.w"], p["out_mod.b"] = lin(cfg.dim, 2 * cfg.dim)
    p["out.w"], p["out.b"] = lin(cfg.dim, cfg.in_channels)
    return p


def init_dcae_decoder(generator: torch.Generator, latent_ch: int = 4, width: int = 32,
                      stages: int = 3, blocks: int = 1,
                      device=None) -> Dict[str, torch.Tensor]:
    """Random DC-AE decoder parameters (OIHW, normal x 0.02, zero biases);
    each stage halves the width down to 8."""
    dev = resolve_device(device)

    def conv(cin, cout, k=3):
        return (_normal(generator, (cout, cin, k, k), 0.02, dev),
                torch.zeros(cout, device=dev))

    p = {}
    c = width
    p["in.w"], p["in.b"] = conv(latent_ch, c)
    for s in range(stages):
        for bidx in range(blocks):
            pre = f"dec.{s}.res.{bidx}"
            p[f"{pre}.in.w"], p[f"{pre}.in.b"] = conv(c, 2 * c, k=1)
            p[f"{pre}.dw.w"] = _normal(generator, (2 * c, 1, 3, 3), 0.02, dev)
            p[f"{pre}.dw.b"] = torch.zeros(2 * c, device=dev)
            p[f"{pre}.out.w"], p[f"{pre}.out.b"] = conv(c, c, k=1)
        nxt = max(c // 2, 8)
        p[f"dec.{s}.up.w"], p[f"dec.{s}.up.b"] = conv(c, 4 * nxt)
        c = nxt
    p["out.w"], p["out.b"] = conv(c, 3)
    return p


class SanaPipeline:
    """Prompt embeddings -> CFG flow-matching loop -> DC-AE decode.

    As SanaDiffusion::run: cond and uncond batched in one transformer call a
    step, the rectified-flow sigma schedule, the VAE decode at the end. The
    initial latent is drawn through `scheduler.noise` from a CPU
    `torch.Generator(seed)`; the loop runs on the embeddings' device."""

    def __init__(self, cfg: SanaConfig, params: Dict, dcae_params: Dict, *,
                 dcae_stages: int = 3, dcae_blocks: int = 1):
        self.cfg = cfg
        self.params = params
        self.dcae = dcae_params
        self.dcae_stages = dcae_stages
        self.dcae_blocks = dcae_blocks

    def __call__(self, text_embeds, uncond_embeds, *, latent_hw=(8, 8), steps: int = 4,
                 guidance: float = 4.5, seed: int = 0, callback=None):
        """-> image [1, H, W, 3]; `callback(i, latent)` after each step."""
        cfg = self.cfg
        h, w = latent_hw
        dev = text_embeds.device
        x = sched.noise(torch.Generator().manual_seed(seed), (1, h, w, cfg.in_channels), dev)
        sigmas = np.linspace(1.0, 0.0, steps + 1).astype(np.float32)
        ctx = torch.cat([text_embeds, uncond_embeds], dim=0)
        for i in range(steps):
            t, t_prev = sigmas[i], sigmas[i + 1]
            tb = torch.full((2,), float(t * np.float32(1000.0)), device=dev)
            v = sana_forward(self.params, cfg, torch.cat([x, x], dim=0), tb, ctx)
            v_c, v_u = v[:1], v[1:]
            x = x + float(t_prev - t) * (v_u + guidance * (v_c - v_u))
            if callback is not None:
                callback(i, x)
        return dcae_decode(self.dcae, x, stages=self.dcae_stages, blocks=self.dcae_blocks)
