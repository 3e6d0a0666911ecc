"""Fused single-position decode attention: QK-norm + rope + KV-quantize +
attention over the stacked cache, one kernel per layer.

Replaces the TPU kernel `mnn_tpu/kernels/decode_step.py::_kernel` (launched
by `fused_decode_attention`). CUDA source: `csrc/decode_step.cu`.

The fused QKV projection enters in its grouped layout [B, Hkv, G+2, D]
(G query rows, then the K row, then the V row). Rope and the optional QK
RMS-norm run inside; the new K/V rows are quantized to int8 (absmax / 127,
round half to even, clip to +-127) and the softmax is seeded with the new
token against its quantize -> dequantize round trip; the cached positions
[0, len_old) of layer `layer_index` are then scanned with the K scale on
score columns and the V scale on probability columns. The quantized rows
and scales come back for the caller's in-place cache write.

What bounds it on the H100, and what the design does about it: at batch 1
the work is a few hundred cached positions of 64 or 128 bytes per KV head,
so the kernel is bound by latency, not by bytes or operations. A
thread-block cluster of P blocks per (batch row, KV head) splits the visible
positions into P ranges (P from B, Hkv and the capacity, never from the
lengths, which stay on the device: `split`); each block stages its range in
64-position tiles by `cp.async` into a two-stage ring and takes one softmax
max and sum per query row a tile. Each block then owns a slice of the
outputs: the others store their softmax states' slices into its shared
memory (`st.async`, counted on an mbarrier), and it merges them in rank
order. One launch a call, the same bits every run, and no host sync, so a
CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import F, I, P, kernel, library
from mnn_tpu_torch.kernels.common import check, use_kernel

NEG_INF = -1e30
MAX_GROUP = 8    # query heads per KV head that the kernel holds in registers

# int mnn_decode_step(qkv, k_cache, v_cache, k_scale, v_scale, cos, sin,
#                     q_norm, k_norm, lengths, att, k_row, v_row, k_sc, v_sc,
#                     B, Hkv, G, D, S, layer, quantized, window, sink,
#                     softcap, scale, eps, stream)
KERNEL = kernel("mnn_decode_step", [P] * 15 + [I] * 9 + [F, F, F])


def split(b: int, hkv: int, g: int, s: int, d: int,
          quantized: bool) -> tuple[int, int, int, int]:
    """(blocks a cluster, positions a tile, dynamic shared bytes a block,
    blocks) that `KERNEL` takes for G query heads a KV head over a
    [.., b, hkv, s, d] cache on this card. Launches nothing."""
    fn = library().mnn_decode_step_split
    fn.argtypes = [I] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    if fn(b, hkv, g, s, d, int(quantized), out):
        raise ValueError(f"no decode step split for B={b} Hkv={hkv} G={g} S={s} D={d}")
    return tuple(out)


def _rms(x, w, eps):
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w


def _rope_full(x, cos, sin):
    """Neox rotation with full-width (tiled twice) cos/sin."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rot * sin


def fused_decode_attention_plain(qkv, k_cache, v_cache, k_scale, v_scale,
                                 layer_index, lengths, cos, sin, q_norm,
                                 k_norm, eps, sm_scale, window, sink, softcap):
    """Plain PyTorch version: the kernel's arithmetic on whole rows."""
    b, hkv, r, d = qkv.shape
    g = r - 2
    quantized = k_cache.dtype == torch.int8
    rows = qkv.to(torch.bfloat16).float()
    q, kr, vr = rows[:, :, :g], rows[:, :, g:g + 1], rows[:, :, g + 1:g + 2]
    if q_norm is not None:
        q = _rms(q, q_norm.float(), eps)
        kr = _rms(kr, k_norm.float(), eps)
    c = cos.float()[:, None, None]
    s_ = sin.float()[:, None, None]
    q = _rope_full(q, c, s_)
    kr = _rope_full(kr, c, s_)
    if quantized:
        def quant(x):
            amax = x.abs().amax(dim=-1, keepdim=True)
            sc = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
            return (x / sc).round().clamp(-127, 127), sc
        kq, ksc = quant(kr)
        vq, vsc = quant(vr)
        k_att, v_att = kq * ksc, vq * vsc
    else:
        kq = k_att = kr.to(torch.bfloat16).float()
        vq = v_att = vr.to(torch.bfloat16).float()

    def cap(x):
        return torch.tanh(x / softcap) * softcap if softcap else x

    s_new = cap((q @ k_att.transpose(-1, -2)) * sm_scale)        # [B,Hkv,G,1]
    kt = k_cache[layer_index].float()                             # [B,Hkv,S,D]
    vt = v_cache[layer_index].float()
    s = q @ kt.transpose(-1, -2)                                  # [B,Hkv,G,S]
    if quantized:
        s = s * k_scale[layer_index][:, :, None, :]
    s = cap(s * sm_scale)
    col = torch.arange(kt.shape[2], device=qkv.device)
    len_old = lengths.to(torch.int64)[:, None, None, None]
    mask = col < len_old
    if window:
        in_window = col > len_old - window
        if sink:
            in_window = in_window | (col < sink)
        mask = mask & in_window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.maximum(s_new, s.amax(dim=-1, keepdim=True))
    p_new = torch.exp(s_new - m)
    p = torch.exp(s - m)
    pv = p * v_scale[layer_index][:, :, None, :] if quantized else p
    l = p_new + p.sum(dim=-1, keepdim=True)
    acc = p_new * v_att + pv @ vt
    att = (acc / l).to(torch.bfloat16).reshape(b, hkv * g, d)
    if quantized:
        return att, kq, vq, ksc[..., 0], vsc[..., 0]
    return att, kq, vq, None, None


def fused_decode_attention(
    qkv: torch.Tensor,               # [B, Hkv, G+2, D] grouped projection rows
    k_cache: torch.Tensor,           # [L, B, Hkv, S, D] int8 or bf16
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [L, B, Hkv, S] f32 (int8 cache)
    v_scale: Optional[torch.Tensor],
    layer_index: int,
    lengths: torch.Tensor,           # [B] int32 pre-append lengths
    cos: torch.Tensor,               # [B, D] f32 full-width rope phases
    sin: torch.Tensor,
    *,
    q_norm: Optional[torch.Tensor] = None,   # [D] (QK-norm)
    k_norm: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    sm_scale: Optional[float] = None,
    window: int = 0,
    sink: int = 0,
    softcap: float = 0.0,
):
    """Returns (att [B, H, D] bf16, k_row [B, Hkv, 1, D] f32, v_row,
    k_sc [B, Hkv, 1] f32 or None, v_sc): the attention output already
    includes the new token; the rows are what the caller writes into the
    cache at each sequence's length."""
    b, hkv, r, d = qkv.shape
    g = r - 2
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm come together")
    if not use_kernel(qkv, k_cache, lengths, cos):
        return fused_decode_attention_plain(
            qkv, k_cache, v_cache, k_scale, v_scale, layer_index, lengths,
            cos, sin, q_norm, k_norm, eps, sm_scale, window, sink, softcap)
    quantized = k_cache.dtype == torch.int8
    nl, _, _, s, _ = k_cache.shape
    if d not in (32, 64, 128, 256) or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"unsupported head_dim {d} or group {g}")
    if not 0 <= layer_index < nl:
        raise IndexError(f"layer {layer_index} of {nl}")
    qkv = qkv.to(torch.bfloat16).contiguous()
    check(k_cache, "k_cache", torch.int8 if quantized else torch.bfloat16, 5)
    check(v_cache, "v_cache", k_cache.dtype, 5)
    if quantized:
        check(k_scale, "k_scale", torch.float32, 4)
        check(v_scale, "v_scale", torch.float32, 4)
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    qn = None if q_norm is None else q_norm.float().contiguous()
    kn = None if k_norm is None else k_norm.float().contiguous()
    dev = qkv.device
    att = torch.empty((b, hkv * g, d), dtype=torch.bfloat16, device=dev)
    k_row = torch.empty((b, hkv, 1, d), dtype=torch.float32, device=dev)
    v_row = torch.empty_like(k_row)
    k_sc = torch.empty((b, hkv, 1), dtype=torch.float32, device=dev) if quantized else None
    v_sc = torch.empty_like(k_sc) if quantized else None
    ptr = lambda t: None if t is None else t.data_ptr()
    KERNEL(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           ptr(k_scale), ptr(v_scale), cos.data_ptr(), sin.data_ptr(),
           ptr(qn), ptr(kn), lengths.data_ptr(), att.data_ptr(),
           k_row.data_ptr(), v_row.data_ptr(), ptr(k_sc), ptr(v_sc),
           b, hkv, g, d, s, int(layer_index), int(quantized), int(window),
           int(sink), float(softcap), float(sm_scale), float(eps))
    return att, k_row, v_row, k_sc, v_sc
