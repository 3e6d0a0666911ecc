"""Causal GQA flash attention for chunked prefill, and single-position
decode attention over the stacked, optionally quantized KV cache.

`flash_attention` replaces the TPU kernel
`mnn_tpu/kernels/flash_attention.py::_prefill_kernel` (CUDA source:
`csrc/flash_prefill.cu`); `decode_attention` replaces `::_decode_kernel`
(CUDA source: `csrc/flash_decode.cu`).

q [B, H, Tq, D] attends over a fixed-capacity K/V buffer [B, Hkv, S, D]
whose first `kv_len` positions are valid; query row i sits at global
position `q_offset + i` (chunked prefill), and the KV head of query head h
is h // (H // Hkv). Masks: causal `col <= q_offset + row`, `col < kv_len`,
and an optional sliding window with an attention sink.

What bounds it on the H100, and what the design does about it: a 512-row
chunk over 300 to 640 positions is 0.1 to 0.5 GFLOP and a few MB a layer,
microseconds at the card's limits, so the kernel is held by latency and by
how the work is spread. Both products run on the bf16 tensor cores
(`mma.sync.m16n8k16`), one warp per 16 query rows with its Q fragments in
registers and the online softmax in the accumulator layout; K/V tiles of 64
positions come in by `cp.async` into a two-stage ring. A block of 4 warps
takes 16, 32 or 64 query rows: the warps of a shorter tile split the K/V
positions and merge in a fixed order, and the kernel takes the most split
shape whose grid the card holds in one wave (`prefill_tile`). It skips
tiles at or past `kv_len`, past the causal edge, or before the window
(outside the sink). `kv_len` and `q_offset` are read from device memory, so
no launch waits on the host.

`decode_attention` takes one query position per sequence, q [B, H, D], over
a bf16, int8 or nibble-packed int4 cache that already holds the new token
(`kv_len` includes it). The K scale multiplies score columns and the V scale
probability columns, so the cache is never dequantized; int4 bytes unpack as
(lo - 8, hi - 8) for dims (j, j + D/2). With `layer_index` it reads one
layer of the stacked [L, B, Hkv, S, D] cache in place. It is bound by
latency at batch 1 (a few hundred positions of 32 to 256 bytes per KV
head), so P blocks a (batch row, KV head) split the visible positions, P
from B, Hkv and the capacity S and never from the lengths, which stay on
the device (`decode_split`). A block stages 64-position tiles of K/V rows
and scales by `cp.async` into a two-stage ring and takes one softmax max
and sum a tile; the P partial states meet in a workspace in device memory,
where the last block of a KV head to arrive merges them in block order, so
two calls give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import F, I, P, kernel, library
from mnn_tpu_torch.kernels.common import check, use_kernel

NEG_INF = -1e30

# int mnn_flash_decode(q, k, v, k_scale, v_scale, kv_len, out, B, Hkv, G, D, S,
#                      layer, kv_bits, window, sink, scale, stream)
KERNEL_DECODE = kernel("mnn_flash_decode", [P] * 7 + [I] * 9 + [F])
MAX_GROUP = 8    # query heads per KV head that the decode kernel holds

# int mnn_flash_prefill(q, k, v, o, lens, B, H, Hkv, Tq, S, D, causal,
#                       window, sink, scale, stream)
KERNEL = kernel("mnn_flash_prefill", [P, P, P, P, P] + [I] * 9 + [F])


def prefill_tile(b: int, h: int, tq: int, d: int) -> tuple[int, int, int, int, int]:
    """(query rows a block, groups of its 4 warps that split the K/V tiles,
    positions a tile, dynamic shared bytes, blocks) that `KERNEL` takes for
    [b, h, tq, d] queries on this card. Launches nothing."""
    fn = library().mnn_flash_prefill_tile
    fn.argtypes = [I, I, I, I, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 5)()
    if fn(b, h, tq, d, out):
        raise ValueError(f"no flash prefill tile for B={b} H={h} Tq={tq} D={d}")
    return tuple(out)


def decode_split(b: int, hkv: int, g: int, s: int, d: int,
                 bits: int) -> tuple[int, int, int, int]:
    """(blocks a KV head, positions a tile, dynamic shared bytes a block,
    blocks) of the split in which `KERNEL_DECODE` takes batch b, hkv KV heads
    of g query heads, capacity s, head dim d over a `bits`-bit cache on this
    card. Launches nothing."""
    fn = library().mnn_flash_decode_split
    fn.argtypes = [I] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    if fn(b, hkv, g, s, d, bits, out):
        raise ValueError(f"no flash decode split for B={b} Hkv={hkv} G={g} D={d} int{bits}")
    return tuple(out)


def _as_len(x, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).reshape(-1).expand(batch)


def _mask(b: int, tq: int, s: int, kv_len, q_offset, causal, window, sink,
          device) -> torch.Tensor:
    """[B, 1, Tq, S] visibility, as the TPU kernel and its XLA reference."""
    col = torch.arange(s, device=device)
    kv_len = _as_len(kv_len, b, device)
    q_offset = _as_len(q_offset, b, device)
    row_pos = q_offset[:, None] + torch.arange(tq, device=device)[None]
    mask = col[None, None, None, :] < kv_len[:, None, None, None]
    if causal:
        mask = mask & (col[None, None, None, :] <= row_pos[:, None, :, None])
    if window:
        in_window = col[None, None, None, :] > row_pos[:, None, :, None] - window
        if sink:
            in_window = in_window | (col[None, None, None, :] < sink)
        mask = mask & in_window
    return mask


def attention_ref(q, k, v, kv_len=None, q_offset=None, causal=True,
                  sm_scale=None, k_scale=None, v_scale=None, window=0, sink=0):
    """Masked-softmax attention in float32 (the numerics oracle).
    q [B, H, Tq, D], k/v [B, Hkv, S, D], optional per-position scales
    [B, Hkv, S]. Counterpart of `attention_xla_ref`."""
    b, h, tq, d = q.shape
    s = k.shape[2]
    group = h // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
    if v_scale is not None:
        vf = vf * v_scale[..., None]
    kf = kf.repeat_interleave(group, dim=1)
    vf = vf.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) * sm_scale
    if kv_len is None:
        kv_len = s
    if q_offset is None:
        q_offset = torch.as_tensor(kv_len) - tq
    mask = _mask(b, tq, s, kv_len, q_offset, causal, window, sink, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(q.dtype)


def flash_attention_plain(q, k, v, kv_len, q_offset, causal=True,
                          sm_scale=None, window=0, sink=0):
    """Plain PyTorch version of the kernel: f32 scores of the bf16 inputs,
    masked with -1e30, exp against the row max, p rounded to bf16 for the
    P.V product, l == 0 -> 1."""
    b, h, tq, d = q.shape
    s = k.shape[2]
    group = h // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) * sm_scale
    mask = _mask(b, tq, s, kv_len, q_offset, causal, window, sink, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhts,bhsd->bhtd", p.to(torch.bfloat16).float(), vf)
    return (o / l).to(q.dtype)


def flash_attention(
    q: torch.Tensor,                 # [B, H, Tq, D] bf16
    k: torch.Tensor,                 # [B, Hkv, S, D] bf16
    v: torch.Tensor,
    *,
    kv_len=None,                     # int or [] int tensor; default S
    q_offset=None,                   # global position of query row 0
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
    sink: int = 0,
) -> torch.Tensor:
    """Attention over a (possibly partially filled) KV buffer -> [B, H, Tq, D]."""
    b, h, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = s
    if q_offset is None:
        q_offset = torch.as_tensor(kv_len) - tq
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if not use_kernel(q, k, v):
        return flash_attention_plain(q, k, v, kv_len, q_offset, causal,
                                     sm_scale, window, sink)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check(t, name, torch.bfloat16, 4)
    if d not in (32, 64, 128) or h % hkv or v.shape != k.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    lens = torch.stack([torch.as_tensor(kv_len, device=q.device).reshape(()),
                        torch.as_tensor(q_offset, device=q.device).reshape(())]
                       ).to(torch.int32)
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lens.data_ptr(), b, h, hkv, tq, s, d, int(causal), int(window),
           int(sink), float(sm_scale))
    return out


def _kv_bits(q: torch.Tensor, k: torch.Tensor) -> int:
    if k.dtype == torch.int8:
        return 4 if k.shape[-1] * 2 == q.shape[-1] else 8
    return 16


def _unpack_nibbles(t: torch.Tensor) -> torch.Tensor:
    t32 = t.to(torch.int32)
    return torch.cat([(t32 & 0xF) - 8, ((t32 >> 4) & 0xF) - 8], dim=-1).float()


def decode_attention_plain(q, k, v, kv_len, k_scale=None, v_scale=None,
                           layer_index=None, sm_scale=None, window=0, sink=0):
    """Plain PyTorch version of the decode kernel: q rounded to bf16, f32
    scores times the K scale and `sm_scale`, masked with -1e30, exp against
    the row max, p times the V scale rounded to bf16 for the P.V product,
    zeros for an empty sequence (the kernel's l == 0 -> 1), bf16 out."""
    if layer_index is not None:
        k, v = k[layer_index], v[layer_index]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer_index], v_scale[layer_index]
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    bits = _kv_bits(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kf = _unpack_nibbles(k) if bits == 4 else k.float()
    vf = _unpack_nibbles(v) if bits == 4 else v.float()
    qg = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    sc = qg @ kf.transpose(-1, -2)                                # [B,Hkv,G,S]
    if bits < 16:
        sc = sc * k_scale[:, :, None, :]
    sc = sc * sm_scale
    col = torch.arange(s, device=q.device)
    n = _as_len(kv_len, b, q.device).to(torch.int64)[:, None, None, None]
    mask = col < n
    if window:
        in_window = col > n - 1 - window
        if sink:
            in_window = in_window | (col < sink)
        mask = mask & in_window
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pv = p * v_scale[:, :, None, :] if bits < 16 else p
    o = pv.to(torch.bfloat16).float() @ vf / l
    o = torch.where(n > 0, o, torch.zeros_like(o))   # no position: l == 0 -> 1
    return o.to(torch.bfloat16).reshape(b, h, d)


def decode_attention(
    q: torch.Tensor,                 # [B, H, D] one query position per sequence
    k: torch.Tensor,                 # [B, Hkv, S, D] bf16/int8, [.., D/2] int4;
    v: torch.Tensor,                 # [L, B, ...] with layer_index
    kv_len,                          # int, [] or [B] int: valid positions
    *,
    k_scale: Optional[torch.Tensor] = None,   # [B, Hkv, S] f32 (quantized KV)
    v_scale: Optional[torch.Tensor] = None,
    layer_index: Optional[int] = None,
    sm_scale: Optional[float] = None,
    window: int = 0,
    sink: int = 0,
) -> torch.Tensor:
    """Single-position GQA attention against the KV cache -> [B, H, D] bf16."""
    b, h, d = q.shape
    bits = _kv_bits(q, k)
    if bits < 16 and (k_scale is None or v_scale is None):
        raise ValueError("quantized KV cache requires k_scale/v_scale")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if not use_kernel(q, k, v):
        return decode_attention_plain(q, k, v, kv_len, k_scale, v_scale,
                                      layer_index, sm_scale, window, sink)
    if layer_index is None:
        k, v = k[None], v[None]
        if bits < 16:
            k_scale, v_scale = k_scale[None], v_scale[None]
        layer_index = 0
    nl, _, hkv, s, d_store = k.shape
    g = h // hkv
    if d not in (64, 128) or h % hkv or not 1 <= g <= MAX_GROUP \
            or v.shape != k.shape or k.shape[1] != b:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if not 0 <= layer_index < nl:
        raise IndexError(f"layer {layer_index} of {nl}")
    q = q.to(torch.bfloat16).contiguous()
    check(k, "k", torch.bfloat16 if bits == 16 else torch.int8, 5)
    check(v, "v", k.dtype, 5)
    if bits < 16:
        check(k_scale, "k_scale", torch.float32, 4)
        check(v_scale, "v_scale", torch.float32, 4)
    lens = _as_len(kv_len, b, q.device).contiguous()
    out = torch.empty_like(q)
    KERNEL_DECODE(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if k_scale is None else k_scale.data_ptr(),
                  None if v_scale is None else v_scale.data_ptr(),
                  lens.data_ptr(), out.data_ptr(), b, hkv, g, d, s,
                  int(layer_index), bits, int(window), int(sink),
                  float(sm_scale))
    return out
