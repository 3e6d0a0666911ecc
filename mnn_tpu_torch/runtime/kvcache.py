"""Fixed-capacity KV cache: bf16, int8 or nibble-packed int4.

Counterpart of `mnn_tpu/runtime/kvcache.py`: one preallocated buffer per
tensor, [L, B, Hkv, S, D] ([.., D/2] for int4), with a per-sequence valid
length. Rollback and reset move the length only; positions at or past it
are masked by every reader. Quantized storage keeps one f32 scale per
(token, head), which the decode kernels fold into score and probability
columns. An int4 byte j holds head dims (j, j + D/2), low nibble first, in
unsigned form (q + 8), stored as signed int8.

Unlike the JAX package, the writes here update the buffers IN PLACE
(`index_copy_` / `index_put_`): a functional copy of the whole cache per
token would cost its full size in memory traffic. Lengths stay on the
cache's device, so no write waits for the host.

The TQ3 and TQ4 codebook encodings are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor                   # [L, B, Hkv, S, D] bf16/int8, [.., D/2] int4
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]   # [L, B, Hkv, S] f32 when quantized
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor              # [B] int32 valid prefix length
    bits: int = 16                    # 16 = bf16, 8 = int8, 4 = packed nibbles

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.bits < 16

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale,
                             self.length) if t is not None)


def create(
    num_layers: int,
    batch: int,
    num_kv_heads: int,
    capacity: int,
    head_dim: int,
    quantized: bool = True,
    dtype=torch.bfloat16,
    kv_bits: int = 8,
    device=None,
) -> KVCache:
    bits = kv_bits if quantized else 16
    if bits not in (4, 8, 16):
        raise ValueError(f"kv_bits={kv_bits} is not ported (4, 8 or bf16)")
    if bits == 4 and head_dim % 2:
        raise ValueError("kv_bits=4 needs an even head_dim")
    d_store = head_dim // 2 if bits == 4 else head_dim
    shape = (num_layers, batch, num_kv_heads, capacity, d_store)
    if quantized:
        k = torch.zeros(shape, dtype=torch.int8, device=device)
        v = torch.zeros(shape, dtype=torch.int8, device=device)
        ks = torch.ones(shape[:-1], dtype=torch.float32, device=device)
        vs = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    else:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = vs = None
    return KVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
                   bits=bits)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8: x [..., D] -> (q, scale [...])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    # divided by a tensor: on the card PyTorch multiplies by the reciprocal
    # of a Python scalar divisor, which can land an ulp off the CPU's quotient
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 127.0))
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_kv4(x: torch.Tensor):
    """Per-(token, head) int4: x [..., D] -> (packed [..., D/2] int8, scale).

    q = clip(round(x / (absmax / 7)), -8, 7); byte j = (q[j] + 8) |
    (q[j + D/2] + 8) << 4, wrapped to signed int8."""
    d = x.shape[-1]
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 7.0))   # by a tensor, as above
    q = (torch.round(xf / scale[..., None]).clamp(-8, 7) + 8).to(torch.int32)
    packed = q[..., :d // 2] | (q[..., d // 2:] << 4)
    packed = torch.where(packed > 127, packed - 256, packed).to(torch.int8)
    return packed, scale


def unpack_kv4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D/2] int8 -> signed values [..., D] f32 (scale not applied)."""
    p32 = packed.to(torch.int32)
    lo = (p32 & 0xF) - 8
    hi = ((p32 >> 4) & 0xF) - 8
    return torch.cat([lo, hi], dim=-1).float()


def quantize_for(bits: int, x: torch.Tensor):
    return quantize_kv4(x) if bits == 4 else quantize_kv(x)


def dequant_kv(cache_vals: torch.Tensor, scale: Optional[torch.Tensor],
               bits: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize a KV buffer slice back to floats (prefill / ref paths)."""
    if bits == 16:
        return cache_vals.to(dtype)
    if bits == 8:
        return (cache_vals.float() * scale[..., None]).to(dtype)
    if bits == 4:
        return (unpack_kv4(cache_vals) * scale[..., None]).to(dtype)
    raise ValueError(f"kv bits {bits} not ported")


def append_stacked(
    cache: KVCache,
    layer: int,
    k_new: torch.Tensor,          # [B, Hkv, T, D] bf16
    v_new: torch.Tensor,
    start: torch.Tensor,          # [] int32 write offset (uniform over batch)
) -> KVCache:
    """Prefill write of T positions into layer `layer`, in place. As a
    dynamic-update-slice does, the offset is clamped so the T rows fit."""
    t = k_new.shape[2]
    first = torch.clamp(start.long(), 0, cache.capacity - t)
    idx = first + torch.arange(t, device=k_new.device)
    if cache.quantized:
        kq, ks = quantize_for(cache.bits, k_new)
        vq, vs = quantize_for(cache.bits, v_new)
        cache.k[layer].index_copy_(2, idx, kq)
        cache.v[layer].index_copy_(2, idx, vq)
        cache.k_scale[layer].index_copy_(2, idx, ks)
        cache.v_scale[layer].index_copy_(2, idx, vs)
    else:
        cache.k[layer].index_copy_(2, idx, k_new.to(cache.k.dtype))
        cache.v[layer].index_copy_(2, idx, v_new.to(cache.v.dtype))
    return cache


def append_decode_stacked(
    cache: KVCache,
    layer: int,
    k_new: torch.Tensor,          # [B, Hkv, 1, D]
    v_new: torch.Tensor,
    lengths: torch.Tensor,        # [B] int32 per-slot write offsets
) -> KVCache:
    """Decode write of one position per sequence into layer `layer`, in
    place: the rows are quantized here (the per-layer path without the
    fused decode kernel). Offsets are clamped to the capacity."""
    b = cache.k.shape[1]
    pos = lengths.long().clamp(0, cache.capacity - 1)
    bi = torch.arange(b, device=pos.device)
    if cache.quantized:
        kq, ks = quantize_for(cache.bits, k_new)
        vq, vs = quantize_for(cache.bits, v_new)
        cache.k[layer, bi, :, pos] = kq[:, :, 0]
        cache.v[layer, bi, :, pos] = vq[:, :, 0]
        cache.k_scale[layer, bi, :, pos] = ks[:, :, 0]
        cache.v_scale[layer, bi, :, pos] = vs[:, :, 0]
    else:
        cache.k[layer, bi, :, pos] = k_new[:, :, 0].to(cache.k.dtype)
        cache.v[layer, bi, :, pos] = v_new[:, :, 0].to(cache.v.dtype)
    return cache


def scatter_decode_row(
    cache: KVCache,
    layer: int,
    k_row: torch.Tensor,          # [B, Hkv, 1, D] quantized (or bf16) values
    v_row: torch.Tensor,
    k_sc: Optional[torch.Tensor],     # [B, Hkv, 1] f32 (quantized cache)
    v_sc: Optional[torch.Tensor],
    lengths: torch.Tensor,        # [B] int32 per-slot write offsets
) -> KVCache:
    """Write a pre-quantized decode row (from the fused decode kernel) into
    layer `layer` at each sequence's length, in place. Offsets are clamped
    to the capacity so a full slot never writes out of bounds."""
    b = cache.k.shape[1]
    pos = lengths.long().clamp(0, cache.capacity - 1)
    bi = torch.arange(b, device=pos.device)
    cache.k[layer, bi, :, pos] = k_row[:, :, 0].to(cache.k.dtype)
    cache.v[layer, bi, :, pos] = v_row[:, :, 0].to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[layer, bi, :, pos] = k_sc[:, :, 0]
        cache.v_scale[layer, bi, :, pos] = v_sc[:, :, 0]
    return cache


def scatter_rows(
    cache: KVCache,
    k_rows: torch.Tensor,         # [L, B, Hkv, 1, D or D/2] stored values as f32
    v_rows: torch.Tensor,
    k_sc: Optional[torch.Tensor],     # [L, B, Hkv, 1] f32 (quantized cache)
    v_sc: Optional[torch.Tensor],
    lengths: torch.Tensor,        # [B] int32 per-slot write offsets
) -> KVCache:
    """Write every layer's pre-quantized decode row (from the whole-model
    decode kernel) at each sequence's length, in place: one indexed write
    per tensor over all layers."""
    b = cache.k.shape[1]
    pos = lengths.long().clamp(0, cache.capacity - 1)
    bi = torch.arange(b, device=pos.device)
    # advanced indices on dims 1 and 3 put the batch first: [B, L, Hkv, D]
    cache.k[:, bi, :, pos] = k_rows[:, :, :, 0].transpose(0, 1).to(cache.k.dtype)
    cache.v[:, bi, :, pos] = v_rows[:, :, :, 0].transpose(0, 1).to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[:, bi, :, pos] = k_sc[:, :, :, 0].transpose(0, 1)
        cache.v_scale[:, bi, :, pos] = v_sc[:, :, :, 0].transpose(0, 1)
    return cache


def cache_from_numpy(arrays, bits: int, device=None) -> KVCache:
    """Build a KVCache from the JAX package's KVCache fields as numpy arrays
    (keys "k", "v", "k_scale", "v_scale", "length"; bf16 carried through its
    bits). The stored layouts are the same in both packages."""
    def get(key):
        a = arrays.get(key)
        if a is None:
            return None
        a = np.require(np.asarray(a), requirements=["C", "W"])
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t if device is None else t.to(device)

    return KVCache(k=get("k"), v=get("v"), k_scale=get("k_scale"),
                   v_scale=get("v_scale"), length=get("length").to(torch.int32),
                   bits=int(bits))


def slot_view(cache: KVCache, slot: int) -> KVCache:
    """A batch-1 cache over slot `slot` of `cache`'s buffers, for prefill
    into one serving slot: the counterpart of the JAX engine's
    `dynamic_slice` of the slot's row. The buffers are views, so prefill
    writes the shared cache in place; the length is a tensor of its own,
    which `write_back` copies into the slot. Each layer's view
    `view.k[i]` is contiguous, but the stacked view `view.k` is not, so it
    must never reach a kernel that takes the whole stacked cache (the decode
    paths): prefill reaches only the per-layer views."""
    sl = lambda t: None if t is None else t[:, slot:slot + 1]
    return KVCache(k=sl(cache.k), v=sl(cache.v), k_scale=sl(cache.k_scale),
                   v_scale=sl(cache.v_scale),
                   length=cache.length[slot:slot + 1].clone(), bits=cache.bits)


def write_back(cache: KVCache, slot: int, view: KVCache) -> KVCache:
    """Copy a slot view's length into `cache.length[slot]`, on the device
    and in place (the buffers were written in place already)."""
    cache.length[slot:slot + 1].copy_(view.length)
    return cache


def reset_slot(cache: KVCache, slot: int) -> KVCache:
    """Clear slot `slot`'s history, in place (its length to zero)."""
    cache.length[slot] = 0
    return cache


def with_length(cache: KVCache, length: torch.Tensor) -> KVCache:
    return dataclasses.replace(cache, length=length)


def rollback(cache: KVCache, n) -> KVCache:
    """Drop the last n tokens."""
    return with_length(cache, (cache.length - n).clamp(min=0))


def reset(cache: KVCache) -> KVCache:
    """Clear all history (lengths to zero; data is masked by length)."""
    return with_length(cache, torch.zeros_like(cache.length))
