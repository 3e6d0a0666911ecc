"""AWQ / GPTQ quantized-checkpoint ingest, on torch tensors.

Counterpart of `mnn_tpu/convert/awq.py`: unpacks the int32-packed AWQ-GEMM
and GPTQ layouts into explicit (q, scale, zero) planes and the float
weights of their grid, which `convert/hf.py` requantizes on this package's
grid.

Layouts (as autoawq / gptqmodel write them):
  AWQ : qweight int32 [K, N/8], 8 nibbles a word along N in the
        interleaved order [0, 2, 4, 6, 1, 3, 5, 7]; qzeros int32
        [K/G, N/8], the same packing; scales f16 [K/G, N]
  GPTQ: qweight int32 [K/8, N], 8 nibbles a word along K, sequential;
        qzeros int32 [K/G, N/8], sequential along N; scales [K/G, N]

Both dequantize as w[k, n] = (q[k, n] - zero[g, n]) * scale[g, n] with
g = k // group. The activation-aware scale search (`awq=True` of the
converter) lives in `quant/awq_search.py`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence, Tuple

import torch

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _unpack_int32_nibbles(packed, dim: int,
                          order: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int32 words -> their 8 nibbles each, expanded 8x along `dim`, as
    uint8. The nibble at shift 4 * i holds offset order[i] of its word."""
    u = torch.as_tensor(packed).to(torch.int32)
    shifts = list(range(0, 32, 4))
    if order is not None:      # the shift that holds each consecutive offset
        shifts = [shifts[order.index(j)] for j in range(8)]
    # an arithmetic shift of a negative word fills ones above bit 31 - s;
    # the mask keeps only the four bits wanted
    parts = [(u >> s) & 0xF for s in shifts]
    out = torch.stack(parts, dim=dim + 1)
    shape = list(u.shape)
    shape[dim] *= 8
    return out.reshape(shape).to(torch.uint8)


def unpack_awq(qweight, qzeros, scales
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q uint8 [K, N], scale f32 [K/G, N], zero uint8 [K/G, N])."""
    q = _unpack_int32_nibbles(qweight, 1, AWQ_ORDER)
    z = _unpack_int32_nibbles(qzeros, 1, AWQ_ORDER)
    return q, torch.as_tensor(scales).to(torch.float32), z


def unpack_gptq(qweight, qzeros, scales
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q uint8 [K, N], scale f32 [K/G, N], zero uint8 [K/G, N])."""
    q = _unpack_int32_nibbles(qweight, 0)       # packed along K
    z = _unpack_int32_nibbles(qzeros, 1)
    return q, torch.as_tensor(scales).to(torch.float32), z


def dequantize_awq_layer(q: torch.Tensor, scale: torch.Tensor,
                         zero: torch.Tensor, group: int) -> torch.Tensor:
    """Exact float weights of the AWQ/GPTQ grid: [K, N] f32."""
    k, n = q.shape
    qb = q.reshape(k // group, group, n).to(torch.float32)
    w = (qb - zero[:, None, :].to(torch.float32)) * scale[:, None, :]
    return w.reshape(k, n)


def load_awq_weight(tensors: Mapping, prefix: str,
                    gptq_v2: bool = False) -> Tuple[torch.Tensor, int]:
    """Read {prefix}.qweight / .qzeros / .scales from a tensor mapping ->
    (float weights [K, N] on the original grid, group size).

    AWQ (qweight [K, N/8]) and GPTQ (qweight [K/8, N]) are told apart by
    shape. GPTQ v1 checkpoints (AutoGPTQ's default) store zero - 1 in
    qzeros; the true zero is restored unless gptq_v2=True."""
    qw = torch.as_tensor(tensors[prefix + ".qweight"])
    qz = torch.as_tensor(tensors[prefix + ".qzeros"])
    sc = torch.as_tensor(tensors[prefix + ".scales"])
    groups, n = sc.shape
    if qw.shape[1] * 8 == n:
        q, s, z = unpack_awq(qw, qz, sc)
    elif qw.shape[1] == n:
        q, s, z = unpack_gptq(qw, qz, sc)
        if not gptq_v2:
            z = z + 1
    else:
        raise ValueError(f"unrecognized quant packing for {prefix}")
    group = q.shape[0] // groups
    return dequantize_awq_layer(q, s, z, group), group
