"""Causal GQA flash attention for chunked prefill.

Replaces the TPU kernel `mnn_tpu/kernels/flash_attention.py::_prefill_kernel`
(launched by `flash_attention`). CUDA source: `csrc/flash_prefill.cu`.

q [B, H, Tq, D] attends over a fixed-capacity K/V buffer [B, Hkv, S, D]
whose first `kv_len` positions are valid; query row i sits at global
position `q_offset + i` (chunked prefill), and the KV head of query head h
is h // (H // Hkv). Masks: causal `col <= q_offset + row`, `col < kv_len`,
and an optional sliding window with an attention sink.

What bounds it on the H100, and what the simple design does about it: a
512-token chunk over 640 cached positions is ~0.5 GFLOP per layer, bound by
arithmetic. The kernel computes on CUDA cores (no tensor cores yet), one
block per (batch x head, 32-row query tile), K/V tiles of 64 positions in
shared memory, and skips tiles at or past `kv_len` or past the causal edge.
`kv_len` and `q_offset` are read from device memory, so no launch waits on
the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import F, I, P, kernel
from mnn_tpu_torch.kernels.common import check, use_kernel

NEG_INF = -1e30

# int mnn_flash_prefill(q, k, v, o, lens, B, H, Hkv, Tq, S, D, causal,
#                       window, sink, scale, stream)
KERNEL = kernel("mnn_flash_prefill", [P, P, P, P, P] + [I] * 9 + [F])


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
