"""Grouped mixture-of-experts prefill MLP: every expert's capacity batch of
one layer in one kernel entry.

Replaces the TPU kernel `mnn_tpu/kernels/moe_prefill.py::_kernel` (with its
`_deq_dot`). CUDA sources: `csrc/moe_prefill.cu`, `csrc/deq_dot.cuh`.

The caller (`models/decoder.py::_moe_mlp`) sorts the (token, expert) pairs,
gathers the rows into xe [E, C, H] (C the capacity; empty slots are zero rows
with weight 0) and, afterwards, gathers each token's k slots out of the
result. In between, for each expert e,

    y[e] = w_e[e] * down_e(act(gate_up_e(xe[e])))              f32 [E, C, H]

with each product in one of two algebras, picked as the TPU kernel picks
them: partial products, (x_b @ q) * s + rowsum(x_b) * m, while C is below the
product's quant block, else dequantize the block, x_b @ bf16(q * s + m). The
gate/up result is rounded to bf16, split by the 64-block interleave, and
act = bf16(bf16(g * sigmoid(g)) * u).

What bounds it on the H100, and what the design does about it: at the
serving shapes (60 experts, 72 rows each, H 2048, mi 1408) a layer is 75
GFLOP over 0.33 GB of weights and rows, close to the ridge between bytes and
tensor-core operations and 15 times beyond what the CUDA cores could do in
the bytes' time, so both products run on the tensor cores
(`mma.sync.m16n8k16`, bf16 x bf16 -> f32: the integer pattern is exact in
bf16). A block takes (128-column tile, 80-row
slab, expert) over the whole of K; the activations [E, C, mi] go through
device memory between the two products' launches, because the down product
needs all of mi and a block holds one tile. Staging is not overlapped with
the math yet, and `wgmma` and TMA are later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import I, P, kernel
from mnn_tpu_torch.kernels.common import check, use_kernel
from mnn_tpu_torch.kernels.dequant_matmul import MAX_BLOCK, deq_dot_plain
from mnn_tpu_torch.quant.quantize import QuantizedLinear

# int mnn_moe_prefill(xe, w_e, gu_p, gu_s, gu_b, dn_p, dn_s, dn_b, act, y,
#                     E, C, H, mi, bits, bs_h, bs_mi, partial_gu, partial_dn, stream)
KERNEL = kernel("mnn_moe_prefill", [P] * 10 + [I] * 9)


def _inter(wdown_e: QuantizedLinear) -> int:
    return wdown_e.packed.shape[-2] * 8 // wdown_e.bits


def supports(wgu_e: Optional[QuantizedLinear], wdown_e: Optional[QuantizedLinear],
             h: int, cap: int) -> bool:
    """Whether the grouped kernel takes these expert stacks: W4/W8 and the
    same for both, bf16 rows, no output bias, the 64-block gate/up layout,
    quant blocks that divide K and that the kernel can stage."""
    if wgu_e is None or wdown_e is None:
        return False
    if wgu_e.bits not in (4, 8) or wgu_e.bits != wdown_e.bits:
        return False
    if wgu_e.act_bits != 16 or wdown_e.act_bits != 16:
        return False
    if wgu_e.out_bias is not None or wdown_e.out_bias is not None:
        return False
    mi = _inter(wdown_e)
    if mi % 64 or h % wgu_e.block_size or mi % wdown_e.block_size:
        return False
    # the kernel's own limits: staged quant blocks, 16-byte row pieces
    for bs in (wgu_e.block_size, wdown_e.block_size):
        if bs > MAX_BLOCK or bs % 16:
            return False
    return h % 8 == 0 and cap >= 1


def _split_act(gu: torch.Tensor) -> torch.Tensor:
    """[..., 2 * mi] f32 gate/up in the 64-block interleave -> the
    activation [..., mi] as f32 holding bf16 values."""
    r = lambda t: t.to(torch.bfloat16).float()
    pairs = r(gu).reshape(*gu.shape[:-1], gu.shape[-1] // 128, 2, 64)
    g = pairs[..., 0, :].reshape(*gu.shape[:-1], -1)
    u = pairs[..., 1, :].reshape(*gu.shape[:-1], -1)
    return r(r(g * torch.sigmoid(g)) * u)


def moe_prefill_mlp_plain(xe: torch.Tensor, w_e: torch.Tensor,
                          wgu_e: QuantizedLinear,
                          wdown_e: QuantizedLinear) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same algebra per product."""
    cap = xe.shape[1]
    gu = deq_dot_plain(xe, wgu_e.packed, wgu_e.scale, wgu_e.bias, wgu_e.bits,
                       wgu_e.block_size, cap < wgu_e.block_size)
    dn = deq_dot_plain(_split_act(gu), wdown_e.packed, wdown_e.scale,
                       wdown_e.bias, wdown_e.bits, wdown_e.block_size,
                       cap < wdown_e.block_size)
    return dn * w_e[:, :, None].float()


def moe_prefill_mlp(xe: torch.Tensor, w_e: torch.Tensor,
                    wgu_e: QuantizedLinear,
                    wdown_e: QuantizedLinear) -> torch.Tensor:
    """xe [E, C, H] bf16 gathered rows, w_e [E, C] f32 routing weights, one
    layer's expert stacks [E, ...] -> f32 [E, C, H], the routing weight
    times the expert's MLP of each slot."""
    e, cap, h = xe.shape
    if not supports(wgu_e, wdown_e, h, cap):
        raise ValueError("moe_prefill_mlp: unsupported expert stacks; ask "
                         "supports() first")
    if not use_kernel(xe, w_e, wgu_e.packed, wdown_e.packed):
        return moe_prefill_mlp_plain(xe, w_e, wgu_e, wdown_e)
    mi = _inter(wdown_e)
    check(xe, "xe", torch.bfloat16, 3)
    check(w_e, "w_e", torch.float32, 2)
    for ql, k, n in ((wgu_e, h, 2 * mi), (wdown_e, mi, h)):
        check(ql.packed, "packed", torch.int8, 3)
        check(ql.scale, "scale", torch.bfloat16, 3)
        check(ql.bias, "bias", torch.bfloat16, 3)
        if ql.packed.shape != (e, k * ql.bits // 8, n) \
                or ql.scale.shape != (e, k // ql.block_size, n) \
                or ql.bias.shape != ql.scale.shape:
            raise ValueError("expert stack shapes disagree with E, K, N")
    if w_e.shape != (e, cap):
        raise ValueError(f"w_e: expected {(e, cap)}, got {tuple(w_e.shape)}")
    act = torch.empty((e, cap, mi), dtype=torch.bfloat16, device=xe.device)
    y = torch.empty((e, cap, h), dtype=torch.float32, device=xe.device)
    KERNEL(xe.data_ptr(), w_e.data_ptr(),
           wgu_e.packed.data_ptr(), wgu_e.scale.data_ptr(), wgu_e.bias.data_ptr(),
           wdown_e.packed.data_ptr(), wdown_e.scale.data_ptr(),
           wdown_e.bias.data_ptr(), act.data_ptr(), y.data_ptr(),
           e, cap, h, mi, wgu_e.bits, wgu_e.block_size, wdown_e.block_size,
           int(cap < wgu_e.block_size), int(cap < wdown_e.block_size))
    return y
