"""Fixed-capacity KV cache: bf16, int8, nibble-packed int4, or the TQ3 /
TQ4 codebook encodings.

Counterpart of `mnn_tpu/runtime/kvcache.py`: one preallocated buffer per
tensor, [L, B, Hkv, S, D] ([.., D/2] for int4 and TQ4, [.., 3D/8] for
TQ3), with a per-sequence valid length. Rollback and reset move the length
only; positions at or past it are masked by every reader. Quantized storage
keeps one f32 scale per (token, head), which the decode kernels fold into
score and probability columns. An int4 byte j holds head dims (j, j + D/2),
low nibble first, in unsigned form (q + 8), stored as signed int8.

TQ3 (`kv_bits=3`) and TQ4 (`kv_bits=4, kv_codebook=True`) store the index
of the nearest level of a fixed Lloyd-Max codebook for N(0, 1), the row
scaled by its RMS: TQ3 packs eight 3-bit codes into three bytes, TQ4 uses
int4's nibble layout. No kernel reads them: attention unpacks a codebook
layer to bf16 first (`dequant_kv`), as the JAX package does. A TQ4 cache
looks like an int4 cache by its shape and bits, so every reader keyed on
`bits == 4` must also check `codebook`.

Unlike the JAX package, the writes here update the buffers IN PLACE
(`index_copy_` / `index_put_`): a functional copy of the whole cache per
token would cost its full size in memory traffic. Lengths stay on the
cache's device, so no write waits for the host.
"""

from __future__ import annotations

import dataclasses
import functools
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
    bits: int = 16                    # 16 = bf16, 8 = int8, 4 = nibbles, 3 = TQ3
    codebook: bool = False            # at bits 4: TQ4 codes, not uniform levels

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
    kv_codebook: bool = False,
    device=None,
) -> KVCache:
    bits = kv_bits if quantized else 16
    if bits not in (3, 4, 8, 16):
        raise ValueError(f"kv_bits={kv_bits}: 3, 4, 8 or bf16")
    if bits == 4 and head_dim % 2:
        raise ValueError("kv_bits=4 needs an even head_dim")
    if bits == 3 and head_dim % 8:
        raise ValueError("kv_bits=3 needs head_dim % 8 == 0")
    codebook = bool(kv_codebook) and bits == 4
    d_store = {4: head_dim // 2, 3: head_dim * 3 // 8}.get(bits, head_dim)
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
                   bits=bits, codebook=codebook)


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


# TQ3: the 8-level Lloyd-Max quantizer for N(0, 1), applied to a row divided
# by its RMS; eight 3-bit codes (code k at bits 3k..3k+2 of a 24-bit word)
# fill three bytes, low byte first.
TQ3_LEVELS = (-2.1519, -1.3439, -0.7560, -0.2451, 0.2451, 0.7560, 1.3439, 2.1519)
# TQ4: the 16-level one, in int4's nibble layout (codes, not q + 8)
TQ4_LEVELS = (-2.7326, -2.0690, -1.6180, -1.2562, -0.9423, -0.6568, -0.3880,
              -0.1284, 0.1284, 0.3880, 0.6568, 0.9423, 1.2562, 1.6180, 2.0690,
              2.7326)
_SHIFTS3 = (0, 3, 6, 9, 12, 15, 18, 21)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once a device: made per call, each
    would be a copy from the host that waits for the device."""
    return torch.tensor(values, dtype=dtype, device=device)


def _nearest_code(x: torch.Tensor, levels):
    """(index of the nearest level of x / rms(x) a value [..., D] int64, the
    scale rms(x) [...]); the lowest index on a tie, as `jnp.argmin` takes.

    The mean of squares and its root are taken in f64 and rounded once to
    f32, so the card and the CPU give the same scale: the f64 sum of squared
    bf16 values is exact in any order, and PyTorch's f32 sqrt on the CPU is
    not always correctly rounded (its f64 sqrt, and the card's, are). The
    JAX package sums in f32, in XLA's order: its scale lies within a few f32
    ulps of this one (`tests/test_torch_kv_variants.py` bounds it)."""
    rms = x.double().square().mean(dim=-1).sqrt().float()
    scale = rms.masked_fill(rms == 0, 1.0)
    xn = x.float() / scale[..., None]
    lv = _const(levels, torch.float32, x.device)
    return torch.argmin((xn[..., None] - lv).abs(), dim=-1), scale


def quantize_kv3(x: torch.Tensor):
    """Per-(token, head) TQ3: x [..., D] -> (packed [..., 3D/8] int8, scale).
    A cast to int8 keeps a value's low byte, the wrap the JAX package
    writes out."""
    d = x.shape[-1]
    idx, scale = _nearest_code(x, TQ3_LEVELS)
    shifts = _const(_SHIFTS3, torch.int64, x.device)
    # the codes' bits do not overlap, so their sum is their OR
    val24 = (idx.reshape(*idx.shape[:-1], d // 8, 8) << shifts).sum(dim=-1)
    bytes3 = (val24[..., None] >> _const((0, 8, 16), torch.int64, x.device)).to(torch.int8)
    return bytes3.reshape(*idx.shape[:-1], d * 3 // 8), scale


def unpack_kv3(packed: torch.Tensor) -> torch.Tensor:
    """[..., 3D/8] int8 -> codebook values [..., D] f32 (scale not applied)."""
    dev = packed.device
    p = packed.to(torch.int32) & 0xFF
    grp = p.reshape(*p.shape[:-1], p.shape[-1] // 3, 3)
    val24 = (grp << _const((0, 8, 16), torch.int32, dev)).sum(dim=-1, dtype=torch.int32)
    codes = (val24[..., None] >> _const(_SHIFTS3, torch.int32, dev)) & 0x7
    codes = codes.reshape(*p.shape[:-1], grp.shape[-2] * 8)
    return _const(TQ3_LEVELS, torch.float32, dev)[codes]


def quantize_kv4cb(x: torch.Tensor):
    """Per-(token, head) TQ4: x [..., D] -> (packed [..., D/2] int8, scale)."""
    d = x.shape[-1]
    idx, scale = _nearest_code(x, TQ4_LEVELS)
    return (idx[..., :d // 2] | (idx[..., d // 2:] << 4)).to(torch.int8), scale


def unpack_kv4cb(packed: torch.Tensor) -> torch.Tensor:
    """[..., D/2] int8 -> codebook values [..., D] f32 (scale not applied)."""
    p = packed.to(torch.int32) & 0xFF
    codes = torch.cat([p & 0xF, p >> 4], dim=-1)
    return _const(TQ4_LEVELS, torch.float32, packed.device)[codes]


def quantize_for(bits: int, x: torch.Tensor, codebook: bool = False):
    """The quantizer of a `bits`-bit cache (`codebook`: TQ4 at bits 4)."""
    if bits == 4:
        return quantize_kv4cb(x) if codebook else quantize_kv4(x)
    return quantize_kv3(x) if bits == 3 else quantize_kv(x)


def dequant_kv(cache_vals: torch.Tensor, scale: Optional[torch.Tensor],
               bits: int, dtype=torch.bfloat16, codebook: bool = False) -> torch.Tensor:
    """Dequantize a KV buffer slice back to floats (prefill / ref paths)."""
    if bits == 16:
        return cache_vals.to(dtype)
    if bits == 8:
        vals = cache_vals.float()
    elif bits == 4:
        vals = unpack_kv4cb(cache_vals) if codebook else unpack_kv4(cache_vals)
    elif bits == 3:
        vals = unpack_kv3(cache_vals)
    else:
        raise ValueError(f"kv bits {bits}")
    return (vals * scale[..., None]).to(dtype)


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
        kq, ks = quantize_for(cache.bits, k_new, cache.codebook)
        vq, vs = quantize_for(cache.bits, v_new, cache.codebook)
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
        kq, ks = quantize_for(cache.bits, k_new, cache.codebook)
        vq, vs = quantize_for(cache.bits, v_new, cache.codebook)
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


def cache_from_numpy(arrays, bits: int, device=None, codebook: bool = False) -> KVCache:
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
                   bits=int(bits), codebook=bool(codebook))


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
                   length=cache.length[slot:slot + 1].clone(), bits=cache.bits,
                   codebook=cache.codebook)


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


def compact_tail(cache: KVCache, start, sel, m) -> KVCache:
    """Keep rows start + sel[i] of the appended tail, moved to start + i, and
    set batch row 0's length to start + m (token-tree verify keeps the
    accepted path's rows). Entries of `sel` at i >= m are junk: their rows
    land past the new length, which every reader masks.

    The JAX package's semantics, in place: the rows are gathered into a
    temporary first, because a source row can be the target of another
    (start + sel[i] moves to start + i); a row index outside [-S, S) gathers
    the fill of `jnp.take` (NaN, or -128 in an int8 buffer) and one in
    [-S, 0) counts from the end; the W rows are written at the first offset
    that fits them, as a dynamic-update-slice clamps it. Only row 0's
    length moves."""
    s = cache.capacity
    dev = cache.k.device
    sel = torch.as_tensor(sel, dtype=torch.int64, device=dev)
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    src = start + sel
    inside = (src >= -s) & (src < s)
    src = torch.where(inside, torch.remainder(src, s), torch.zeros_like(src))
    first = torch.clamp(start, 0, s - sel.shape[0])
    dst = first + torch.arange(sel.shape[0], device=dev)

    def move(a: torch.Tensor):
        rows = a.index_select(3, src)
        fill = -128 if a.dtype == torch.int8 else float("nan")
        keep = inside.reshape((1,) * 3 + (-1,) + (1,) * (a.dim() - 4))
        a.index_copy_(3, dst, torch.where(keep, rows, torch.full_like(rows, fill)))

    for a in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if a is not None:
            move(a)
    length = cache.length.clone()
    length[0] = torch.clamp(start + torch.as_tensor(m, device=dev), max=s).to(length.dtype)
    return with_length(cache, length)
