"""Wan: video DiT, causal 3-D VAE decoder and flow-matching pipeline.

Counterpart of the JAX package's `diffusion/wan.py` (MNN-Diffusion's
`wan_diffusion.cpp` runtime, after diffusers' WanTransformer3DModel): a
3-D patchify over (frames, height, width) into one token sequence;
self-attention with 3-D rope (the frequency bands split across the t / h /
w axes); cross-attention to the UMT5 text embeddings under a per-batch key
padding mask; adaLN modulation with per-block tables and a tanh-GELU FFN;
a causal 3-D VAE decoder (time padded at the front only) with temporal and
spatial depth-to-space upsampling.

The entry points take and give the JAX package's layouts: latents and
frames [B, T, H, W, C]. Inside the decoder, volumes are NCTHW and
convolution weights [O, I, kt, kh, kw]; `params_from_numpy` carries the
JAX package's dicts (THWIO) over. Each module keeps the JAX package's
rounding points: self-attention scores and softmax in the activations'
dtype, the cross-attention's softmax in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion import scheduler as sched
from mnn_tpu_torch.diffusion.nn import layer_norm, linear, no_tf32, silu, timestep_embedding
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16          # VAE latent channels
    dim: int = 1536
    num_heads: int = 12
    depth: int = 30
    ffn_expand: float = 4.0
    text_dim: int = 4096           # UMT5-xxl hidden
    patch: Tuple[int, int, int] = (1, 2, 2)   # (t, h, w) patch

    @staticmethod
    def tiny():
        return WanConfig(in_channels=4, dim=64, num_heads=4, depth=2,
                         ffn_expand=2.0, text_dim=32, patch=(1, 2, 2))


def rope_3d(thw: Tuple[int, int, int], head_dim: int, theta: float = 10000.0,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin [N, head_dim // 2] f32 on `device` (None: the card), the
    bands split into three contiguous sections rotated by the token's t, h
    and w; the angles in float64 numpy, then one cast to f32."""
    t, h, w = thw
    half = head_dim // 2
    s_t = half // 3
    s_h = (half - s_t) // 2
    s_w = half - s_t - s_h
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    pos = np.zeros((t * h * w, half))
    off = 0
    for sec, coord in zip((s_t, s_h, s_w), (tt, hh, ww)):
        pos[:, off:off + sec] = coord.reshape(-1)[:, None]
        off += sec
    ang = pos * freqs[None, :]
    dev = resolve_device(device)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev))


def _apply_rope_nd(x, cos, sin):
    """x [B, H, N, D]; cos / sin [N, D // 2] (half rotation)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _self_attention_3d(x, p: Dict, pre: str, num_heads: int, cos, sin) -> torch.Tensor:
    """Scores and softmax in x's dtype (no f32 cast), as the JAX package."""
    b, n, d = x.shape
    hd = d // num_heads

    def heads(a):
        return a.reshape(b, n, num_heads, hd).transpose(1, 2)

    q = _apply_rope_nd(heads(linear(x, p[f"{pre}.q.w"], p[f"{pre}.q.b"])), cos, sin)
    k = _apply_rope_nd(heads(linear(x, p[f"{pre}.k.w"], p[f"{pre}.k.b"])), cos, sin)
    v = heads(linear(x, p[f"{pre}.v.w"], p[f"{pre}.v.b"]))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return linear(o.transpose(1, 2).reshape(b, n, d), p[f"{pre}.o.w"], p[f"{pre}.o.b"])


def _cross_attention_masked(x, ctx, mask, p: Dict, pre: str, num_heads: int) -> torch.Tensor:
    """Cross-attention under a per-batch key padding mask [B, Tk] (> 0:
    attend); the softmax in f32."""
    b, n, d = x.shape
    tk = ctx.shape[1]
    hd = d // num_heads

    def heads(a, t):
        return a.reshape(b, t, num_heads, hd).transpose(1, 2)

    q = heads(linear(x, p[f"{pre}.q.w"], p[f"{pre}.q.b"]), n)
    k = heads(linear(ctx, p[f"{pre}.k.w"], p[f"{pre}.k.b"]), tk)
    v = heads(linear(ctx, p[f"{pre}.v.w"], p[f"{pre}.v.b"]), tk)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, None, None, :], float("-inf"))
    a = torch.softmax(s.float(), dim=-1).to(v.dtype)
    o = torch.matmul(a, v)
    return linear(o.transpose(1, 2).reshape(b, n, d), p[f"{pre}.o.w"], p[f"{pre}.o.b"])


def wan_forward(p: Dict, cfg: WanConfig, latent: torch.Tensor, timestep,
                text_embeds: torch.Tensor, text_mask=None) -> torch.Tensor:
    """latent [B, T, H, W, C] -> velocity [B, T, H, W, C], on latent's
    device; `text_mask` [B, Tk] or None."""
    b, t, h, w, cin = latent.shape
    pt, ph, pw = cfg.patch
    gt, gh, gw = t // pt, h // ph, w // pw
    with no_tf32():
        x = latent.reshape(b, gt, pt, gh, ph, gw, pw, cin).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = linear(x.reshape(b, gt * gh * gw, pt * ph * pw * cin), p["patch.w"], p["patch.b"])
        ctx = linear(text_embeds, p["text.w"], p["text.b"])

        ts = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
        temb = timestep_embedding(ts, 256)
        temb = silu(linear(temb, p["t1.w"], p["t1.b"]))
        temb = linear(temb, p["t2.w"], p["t2.b"])
        mod6 = linear(silu(temb), p["adaln.w"], p["adaln.b"])

        cos, sin = rope_3d((gt, gh, gw), cfg.dim // cfg.num_heads, device=x.device)
        for i in range(cfg.depth):
            pre = f"blocks.{i}"
            m = mod6[:, None] + p[f"{pre}.sst"][None]
            sh1, sc1, g1, sh2, sc2, g2 = m.chunk(6, dim=-1)
            hn = layer_norm(x, None, None) * (1 + sc1) + sh1
            x = x + g1 * _self_attention_3d(hn, p, f"{pre}.attn", cfg.num_heads, cos, sin)
            x = x + _cross_attention_masked(layer_norm(x, None, None), ctx, text_mask, p,
                                            f"{pre}.xattn", cfg.num_heads)
            hn = layer_norm(x, None, None) * (1 + sc2) + sh2
            y = F.gelu(linear(hn, p[f"{pre}.ffn.in.w"], p[f"{pre}.ffn.in.b"]),
                       approximate="tanh")
            x = x + g2 * linear(y, p[f"{pre}.ffn.out.w"], p[f"{pre}.ffn.out.b"])

        shift, scale = linear(silu(temb), p["out_mod.w"], p["out_mod.b"])[:, None].chunk(2, -1)
        x = layer_norm(x, None, None) * (1 + scale) + shift
        x = linear(x, p["out.w"], p["out.b"])          # [B, N, pt ph pw C]
    x = x.reshape(b, gt, gh, gw, pt, ph, pw, cin).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t, h, w, cin)


# -- causal 3-D VAE decoder ---------------------------------------------------


def _conv3d_causal(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """x [B, C, T, H, W], w [O, I, kt, kh, kw]: time padded at the front
    only, so frame t never reads a later frame; f32, cast to x's dtype,
    then the bias."""
    kt, kh, kw = w.shape[2:]
    xp = F.pad(x.float(), (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0))
    return F.conv3d(xp, w.float()).to(x.dtype) + b[None, :, None, None, None]


def _res3d(x, p: Dict, pre: str):
    y = silu(_conv3d_causal(x, p[f"{pre}.c1.w"], p[f"{pre}.c1.b"]))
    return x + _conv3d_causal(y, p[f"{pre}.c2.w"], p[f"{pre}.c2.b"])


def wan_vae_decode(p: Dict, latent: torch.Tensor, *, spatial_stages: int = 2,
                   temporal_up: bool = True) -> torch.Tensor:
    """latent [B, T, h, w, C] -> frames [B, T (x2 with temporal_up),
    h 2^stages, w 2^stages, 3] in tanh's range, on latent's device."""
    with no_tf32():
        x = _conv3d_causal(latent.permute(0, 4, 1, 2, 3), p["in.w"], p["in.b"])
        if temporal_up:
            # each latent frame expands to 2: channel k c + ch to frame 2 t + k
            b, c, t, h, w = x.shape
            y = _conv3d_causal(x, p["tup.w"], p["tup.b"])
            x = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)
        for s in range(spatial_stages):
            x = _res3d(x, p, f"dec.{s}.res")
            b, _, t, h, w = x.shape
            y = _conv3d_causal(x, p[f"dec.{s}.up.w"], p[f"dec.{s}.up.b"])
            # channel (2 i + j) c2 + ch to row offset i, column offset j
            c2 = y.shape[1] // 4
            y = y.reshape(b, 2, 2, c2, t, h, w).permute(0, 3, 4, 5, 1, 6, 2)
            x = y.reshape(b, c2, t, 2 * h, 2 * w)
        x = _conv3d_causal(silu(x), p["out.w"], p["out.b"])
    return torch.tanh(x).permute(0, 2, 3, 4, 1)


# -- parameters ---------------------------------------------------------------


def params_from_numpy(params: Dict, device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's Wan or VAE parameter dict (arrays, keys unchanged)
    as `dtype` tensors on `device` (None: the card): THWIO convolutions to
    [O, I, kt, kh, kw], the rest as they are."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    return out



def _normal(g: torch.Generator, shape, scale: float, dev) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(dev)


def init_wan_params(cfg: WanConfig, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
    """Random parameters, the JAX package's rule (weights normal x 0.02,
    zero biases), drawn from `generator` on its own device, moved to
    `device` (None: the card)."""
    dev = resolve_device(device)

    def lin(din, dout, scale=0.02):
        return _normal(generator, (din, dout), scale, dev), torch.zeros(dout, device=dev)

    pt, ph, pw = cfg.patch
    pdim = pt * ph * pw * cfg.in_channels
    p = {}
    p["patch.w"], p["patch.b"] = lin(pdim, cfg.dim)
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
        p[f"{pre}.ffn.in.w"], p[f"{pre}.ffn.in.b"] = lin(cfg.dim, e)
        p[f"{pre}.ffn.out.w"], p[f"{pre}.ffn.out.b"] = lin(e, cfg.dim)
    p["out_mod.w"], p["out_mod.b"] = lin(cfg.dim, 2 * cfg.dim)
    p["out.w"], p["out.b"] = lin(cfg.dim, pdim)
    return p


def init_wan_vae(generator: torch.Generator, latent_ch: int = 4, width: int = 16,
                 spatial_stages: int = 2, device=None) -> Dict[str, torch.Tensor]:
    """Random VAE decoder parameters ([O, I, 3, 3, 3], normal x 0.02, zero
    biases); each spatial stage halves the width down to 8."""
    dev = resolve_device(device)

    def c3(cin, cout, kt=3, k=3):
        return (_normal(generator, (cout, cin, kt, k, k), 0.02, dev),
                torch.zeros(cout, device=dev))

    p = {}
    c = width
    p["in.w"], p["in.b"] = c3(latent_ch, c)
    p["tup.w"], p["tup.b"] = c3(c, 2 * c)
    for s in range(spatial_stages):
        pre = f"dec.{s}"
        p[f"{pre}.res.c1.w"], p[f"{pre}.res.c1.b"] = c3(c, c)
        p[f"{pre}.res.c2.w"], p[f"{pre}.res.c2.b"] = c3(c, c)
        nxt = max(c // 2, 8)
        p[f"{pre}.up.w"], p[f"{pre}.up.b"] = c3(c, 4 * nxt)
        c = nxt
    p["out.w"], p["out.b"] = c3(c, 3)
    return p


class WanPipeline:
    """Text embeddings (and mask) -> guided flow matching -> 3-D VAE decode.

    As WanDiffusion::run: cond and uncond batched in one transformer call a
    step (the unconditional half's mask all ones), the rectified-flow
    schedule, the causal video decode. The initial latent is drawn through
    `scheduler.noise` from a CPU `torch.Generator(seed)`; the loop runs on
    the embeddings' device."""

    def __init__(self, cfg: WanConfig, params: Dict, vae_params: Dict, *,
                 vae_stages: int = 2):
        self.cfg = cfg
        self.params = params
        self.vae = vae_params
        self.vae_stages = vae_stages

    def __call__(self, text_embeds, uncond_embeds, *, latent_thw=(2, 4, 4), steps: int = 4,
                 guidance: float = 5.0, seed: int = 0, text_mask=None, callback=None):
        """-> frames [1, T', H, W, 3]; `callback(i, latent)` after each step."""
        cfg = self.cfg
        t, h, w = latent_thw
        dev = text_embeds.device
        x = sched.noise(torch.Generator().manual_seed(seed), (1, t, h, w, cfg.in_channels), dev)
        sigmas = np.linspace(1.0, 0.0, steps + 1).astype(np.float32)
        ctx = torch.cat([text_embeds, uncond_embeds], dim=0)
        mask = None if text_mask is None else torch.cat(
            [text_mask, torch.ones_like(text_mask)], dim=0)
        for i in range(steps):
            tcur, tprev = sigmas[i], sigmas[i + 1]
            tb = torch.full((2,), float(tcur * np.float32(1000.0)), device=dev)
            v = wan_forward(self.params, cfg, torch.cat([x, x], dim=0), tb, ctx, mask)
            v_c, v_u = v[:1], v[1:]
            x = x + float(tprev - tcur) * (v_u + guidance * (v_c - v_u))
            if callback is not None:
                callback(i, x)
        return wan_vae_decode(self.vae, x, spatial_stages=self.vae_stages)
