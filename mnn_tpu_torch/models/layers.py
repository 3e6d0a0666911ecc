"""Layer primitives: RMSNorm, RoPE, SwiGLU, GeGLU-tanh, the tanh softcap,
the gate/up column layout, the Hadamard rotation of the head dim.

Counterpart of `mnn_tpu/models/layers.py`, as plain PyTorch ops with the
same rounding points (f32 math, result cast back to the input's dtype).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None):
    """positions [B, T] int -> cos/sin [B, T, head_dim//2] f32.

    scaling: optional (factor, low_freq_factor, high_freq_factor,
    original_max_pos) llama3 rule, or (factor, 0, 0, -1) for linear
    scaling (every band divided by factor)."""
    half = head_dim // 2
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=dev) / half))
    if scaling is not None and scaling[3] < 0:
        freqs = freqs / scaling[0]
        scaling = None
    if scaling is not None:
        factor, low_f, high_f, orig_max = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(
            wavelen > low_wl, freqs / factor,
            torch.where(wavelen < high_wl, freqs, mid))
    angles = positions.float()[..., None] * freqs      # [B, T, half]
    return torch.cos(angles), torch.sin(angles)


def rope_cos_sin_mrope(positions3: torch.Tensor, head_dim: int, theta: float,
                       sections):
    """Multimodal rope (qwen2-vl mrope): positions3 [B, T, 3], each token's
    (temporal, height, width) position -> cos/sin [B, T, head_dim//2] f32.

    The frequency bands are split by `sections` (summing to head_dim//2):
    band i takes its angle from position component i. With all three
    components equal this is exactly `rope_cos_sin` without scaling."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to {half}")
    dev = positions3.device
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=dev) / half))
    angles = positions3.float()[..., None] * freqs          # [B, T, 3, half]
    sel = torch.tensor([i for i, s in enumerate(sections) for _ in range(s)],
                       device=dev)
    angles = angles.gather(2, sel.expand(*angles.shape[:2], 1, half))[:, :, 0]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, D] with neox-style half rotation (HF convention)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[:, None]
    s = sin[:, None]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def geglu_tanh(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Gemma's gated activation: the tanh approximation of gelu on the f32
    gate, cast back to the gate's dtype, times up."""
    return F.gelu(gate.float(), approximate="tanh").to(up.dtype) * up


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh(x / cap) * cap (gemma's score and logit caps); cap 0: x."""
    return torch.tanh(x / cap) * cap if cap else x


# Columns of the fused gate/up projection alternate GU_BLOCK-wide blocks
# [gate | up | gate | up ...], the checkpoint layout of the JAX package.
GU_BLOCK = 64


def gu_block_for(intermediate: int) -> int:
    """Largest power of two <= 64 dividing the intermediate size."""
    blk = GU_BLOCK
    while blk > 1 and intermediate % blk:
        blk //= 2
    return blk


def split_gate_up(gu: torch.Tensor):
    """gu [..., 2I] in the block-interleaved layout -> (gate, up) [..., I]."""
    lead = gu.shape[:-1]
    n = gu.shape[-1]
    blk = gu_block_for(n // 2)
    pairs = gu.reshape(*lead, n // (2 * blk), 2, blk)
    gate = pairs[..., 0, :].reshape(*lead, n // 2)
    up = pairs[..., 1, :].reshape(*lead, n // 2)
    return gate, up


def interleave_gate_up(wg, wu):
    """[K, I] x2 (numpy arrays or torch tensors) -> [K, 2I] in the
    64-block-interleaved layout."""
    k, i = wg.shape
    blk = gu_block_for(i)
    stack = torch.stack if isinstance(wg, torch.Tensor) else np.stack
    stacked = stack([wg.reshape(k, i // blk, blk), wu.reshape(k, i // blk, blk)], 2)
    return stacked.reshape(k, 2 * i)


@functools.lru_cache(maxsize=8)
def hadamard(d: int) -> np.ndarray:
    """Orthonormal Hadamard matrix [d, d] f32 (Sylvester; d a power of 2):
    H @ H.T = I, entries +-1/sqrt(d). A numpy array, as in the JAX package;
    `rotate_heads` moves it to the tensor's device."""
    if d <= 0 or d & (d - 1):
        raise ValueError(f"hadamard requires power-of-2 dim, got {d}")
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < d:
        h = np.block([[h, h], [h, -h]])
    # the JAX package divides in f64 and casts to f32 where it multiplies
    return (h / np.sqrt(d)).astype(np.float32)


def rotate_heads(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Rotate the head dim of x [..., D] by the orthonormal Hadamard (its
    transpose with `inverse`): the product in f32, cast to x's dtype.

    On the card the product must run in full f32, with TF32 off (PyTorch's
    default, `torch.backends.cuda.matmul.allow_tf32 = False`): TF32 would
    round x to 10 mantissa bits first, and a rotated model's tokens would
    leave the CPU's. So a CUDA call with TF32 on raises."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("rotate_heads needs full f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    h = _hadamard_on(x.shape[-1], x.device)
    return torch.matmul(x.float(), h.T if inverse else h).to(x.dtype)


@functools.lru_cache(maxsize=8)
def _hadamard_on(d: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hadamard(d)).to(device)
