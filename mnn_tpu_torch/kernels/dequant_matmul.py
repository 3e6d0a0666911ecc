"""Fused per-block dequantize + matmul: W4/W8 weights, bf16 or int8 rows.

Replaces the TPU kernels `mnn_tpu/kernels/dequant_matmul.py::_kernel`
(bf16 activations), `::_kernel_a8` (dynamic int8 activations) and
`::_kernel_deq` (the dequantize-tile variant for many bf16 rows), all
launched from the `pallas_call` in `_dequant_matmul_pallas`. CUDA sources:
`csrc/dequant_matmul.cu`, `csrc/deq_dot.cuh`.

The first two follow the Pallas algebra. With per-block affine weights
w = q * s_b + m_b (q unsigned), a quant block's contribution is

    x_b @ w_b = (x_b @ q_b) * s_b  +  rowsum(x_b) * m_b

so the weights are never dequantized: the integer pattern is dotted with
x, and scale and bias act on the [M, N] partial in f32. The output is
rounded once to `out_dtype`; `out_bias` is added after that in f32 and
rounded again, in that order, as the JAX wrapper does.

The a8 path quantizes rows to int8 (per-row absmax) in torch, dots them
with the re-centred pattern q - 2^(bits-1) in exact int32 arithmetic, and
folds the shift into the bias: part * s + rowsum_int(x) * (2^(bits-1) s + m).
The result is rounded to `out_dtype`, multiplied by the row scale and
rounded again.

What bounds it on the H100, and what the simple design does about it:

* M = 1 (every decode GEMV and the lm head) is bound by the weight bytes:
  0.5 byte per int4 weight read once. In `dqmm_rows_kernel` a lane owns
  four adjacent output columns and reads them as one 32-bit word per
  packed row, so a warp streams 128 contiguous bytes; the block's 8 warps
  take interleaved quant blocks and are summed in shared memory, which
  keeps 8x more loads in flight for the narrow (N = 896) projections.
  Rows of x sit in shared memory.
* The a8 prefill GEMM (M up to 512) is bound by integer operations.
  `dqmm_a8_kernel` tiles the output 64 x 64, stages x and the unpacked,
  re-centred pattern in shared memory as packed int8 quads, and runs
  `__dp4a` on CUDA cores. Tensor cores (`mma`/`wgmma` int8) are later work.
* The bf16 path at M > 1 reuses the row kernel with 4 rows per block. A
  mixture-of-experts model's shared expert runs it at M = 512 in prefill;
  it is not tuned.
* The dequantize-tile kernel (`m >= DEQ_MIN_M`, off by default as in the JAX
  package) turns each quant block into wd = bf16(q * s + m) and dots bf16
  rows with it on the tensor cores (`mma.sync`, `csrc/deq_dot.cuh`), whatever
  `act_bits` says. It rounds the weight, which the other two never do, so
  its plain version is `deq_dot_plain`, shared with the grouped
  mixture-of-experts prefill kernel, and not the loop above.
"""

from __future__ import annotations

from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import I, P, kernel
from mnn_tpu_torch.kernels.common import check, use_kernel
from mnn_tpu_torch.quant.quantize import (QuantizedLinear,
                                          quantize_activations_int8,
                                          unpack_bits)

# int mnn_dequant_matmul(x, packed, scale, bias, out_bias, out,
#                        M, K, N, bits, block_size, out_f32, stream)
KERNEL_BF16 = kernel("mnn_dequant_matmul", [P, P, P, P, P, P, I, I, I, I, I, I])
# int mnn_dequant_matmul_a8(xq, xs, packed, scale, bias, out_bias, out,
#                           M, K, N, bits, block_size, out_f32, stream)
KERNEL_A8 = kernel("mnn_dequant_matmul_a8",
                   [P, P, P, P, P, P, P, I, I, I, I, I, I])

# int mnn_dequant_matmul_deq(...): the same operands as mnn_dequant_matmul
KERNEL_DEQ = kernel("mnn_dequant_matmul_deq", [P, P, P, P, P, P, I, I, I, I, I, I])

MAX_BLOCK = 128   # largest quant block the kernels stage in shared memory

# Rows at or above which the dequantize-tile kernel replaces the other two.
# Off by default, as in the JAX package; a caller or a test sets it lower.
DEQ_MIN_M = 1 << 30


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_weights(ql: QuantizedLinear, k: int):
    if ql.bits not in (4, 8):
        raise ValueError(f"W{ql.bits} has no CUDA kernel yet")
    bs = ql.block_size
    if bs > MAX_BLOCK or bs % 8 or k % bs:
        raise ValueError(f"block_size {bs} unsupported (multiple of 8, "
                         f"<= {MAX_BLOCK}, dividing K={k})")
    n = ql.out_features
    if n % 4:
        raise ValueError(f"N={n} must be a multiple of 4 (32-bit weight loads)")
    check(ql.packed, "packed", torch.int8, 2)
    check(ql.scale, "scale", torch.bfloat16, 2)
    check(ql.bias, "bias", torch.bfloat16, 2)
    if ql.packed.shape[0] != k * ql.bits // 8 or ql.scale.shape != (k // bs, n) \
            or ql.bias.shape != (k // bs, n):
        raise ValueError("packed/scale/bias shapes disagree with K, N")
    if ql.out_bias is not None:
        check(ql.out_bias, "out_bias", torch.float32, 1)


def _unpack_block(packed: torch.Tensor, kb: int, bits: int, bs: int):
    rows = bs * bits // 8
    return unpack_bits(packed[kb * rows:(kb + 1) * rows], bits, bs)


def deq_dot_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, bits: int, bs: int,
                  partial: bool) -> torch.Tensor:
    """Plain PyTorch version of `csrc/deq_dot.cuh`, batched over a leading
    axis: x [E, M, K] @ dequant(packed [E, K * bits / 8, N]) -> f32 [E, M, N].

    Rows are rounded to bf16. Per quant block either the partial-product
    algebra, (x_b @ q) * s + rowsum(x_b) * m, or the dequantize-tile one,
    x_b @ bf16(q * s + m); f32 sums over the blocks in order."""
    xf = x.to(torch.bfloat16).float()
    k = xf.shape[-1]
    rows = bs * bits // 8
    s, b = scale.float(), bias.float()
    acc = None
    for kb in range(k // bs):
        w32 = packed[:, kb * rows:(kb + 1) * rows].to(torch.int32) & 0xFF
        q = torch.cat([w32 & 0xF, w32 >> 4], dim=1) if bits == 4 else w32
        xb = xf[:, :, kb * bs:(kb + 1) * bs]
        sk, bk = s[:, kb, None, :], b[:, kb, None, :]
        if partial:
            term = (torch.bmm(xb, q.float()) * sk
                    + xb.sum(dim=-1, keepdim=True) * bk)
        else:
            wd = (q.float() * sk + bk).to(torch.bfloat16).float()
            term = torch.bmm(xb, wd)
        acc = term if acc is None else acc + term
    return acc


def dequant_matmul_plain(x2: torch.Tensor, ql: QuantizedLinear,
                         out_dtype=torch.bfloat16,
                         deq: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the three kernels: x2 [M, K], one layer's ql.
    Same algebra and rounding points; f32 sums in another order. `deq`: the
    dequantize-tile algebra (bf16 rows whatever `ql.act_bits` is)."""
    m, k = x2.shape
    bs, bits = ql.block_size, ql.bits
    if bits not in (4, 8):
        raise ValueError(f"W{bits} unpacking is not ported")
    s = ql.scale.float()
    b = ql.bias.float()
    acc = torch.zeros((m, ql.out_features), dtype=torch.float32,
                      device=x2.device)
    if deq:
        y = deq_dot_plain(x2[None], ql.packed[None], ql.scale[None],
                          ql.bias[None], bits, bs, partial=False)[0].to(out_dtype)
    elif ql.act_bits == 8:
        xq, xs = quantize_activations_int8(x2)
        center = 1 << (bits - 1)
        xf = xq.float()
        # |products| and partial sums stay below 2^24: f32 sums are exact
        for kb in range(k // bs):
            xb = xf[:, kb * bs:(kb + 1) * bs]
            qb = (_unpack_block(ql.packed, kb, bits, bs) - center).float()
            part = xb @ qb
            rs = xb.sum(dim=1, keepdim=True)
            acc = acc + part * s[kb] + rs * (center * s[kb] + b[kb])
        y = acc.to(out_dtype)
        y = (y.float() * xs).to(out_dtype)
    else:
        xf = x2.to(torch.bfloat16).float()
        for kb in range(k // bs):
            xb = xf[:, kb * bs:(kb + 1) * bs]
            part = xb @ _unpack_block(ql.packed, kb, bits, bs).float()
            rs = xb.sum(dim=1, keepdim=True)
            acc = acc + part * s[kb] + rs * b[kb]
        y = acc.to(out_dtype)
    if ql.out_bias is not None:
        y = (y.float() + ql.out_bias).to(out_dtype)
    return y


def _launch(x2: torch.Tensor, ql: QuantizedLinear, out_dtype,
            deq: bool) -> torch.Tensor:
    m, k = x2.shape
    n = ql.out_features
    _check_weights(ql, k)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} unsupported")
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    out_f32 = int(out_dtype == torch.float32)
    if deq:
        if k % 8 or ql.block_size % 16:
            raise ValueError("the dequantize-tile kernel needs K % 8 == 0 "
                             "and block_size % 16 == 0")
        x2 = x2.to(torch.bfloat16).contiguous()
        KERNEL_DEQ(x2.data_ptr(), ql.packed.data_ptr(), ql.scale.data_ptr(),
                   ql.bias.data_ptr(), _ptr(ql.out_bias), out.data_ptr(),
                   m, k, n, ql.bits, ql.block_size, out_f32)
    elif ql.act_bits == 8:
        if k % 4:
            raise ValueError("a8 path needs K % 4 == 0")
        xq, xs = quantize_activations_int8(x2)
        xs = xs.reshape(m).contiguous()
        KERNEL_A8(xq.data_ptr(), xs.data_ptr(), ql.packed.data_ptr(),
                  ql.scale.data_ptr(), ql.bias.data_ptr(), _ptr(ql.out_bias),
                  out.data_ptr(), m, k, n, ql.bits, ql.block_size, out_f32)
    else:
        x2 = x2.to(torch.bfloat16).contiguous()
        KERNEL_BF16(x2.data_ptr(), ql.packed.data_ptr(), ql.scale.data_ptr(),
                    ql.bias.data_ptr(), _ptr(ql.out_bias), out.data_ptr(),
                    m, k, n, ql.bits, ql.block_size, out_f32)
    return out


def dequant_matmul(
    x: torch.Tensor,
    ql: QuantizedLinear,
    *,
    layer_index: Optional[int] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """y = x @ dequant(ql) (+ out_bias). x: [..., K].

    With `layer_index`, ql's tensors carry a leading layer axis [L, ...]
    and layer `layer_index` is read in place: its views start at the
    stacked buffers' base plus the layer's offset, with no copy. From
    `DEQ_MIN_M` rows on, the dequantize-tile kernel takes the call."""
    if layer_index is not None:
        ql = ql.layer(layer_index)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    deq = x2.shape[0] >= DEQ_MIN_M
    if use_kernel(x2, ql.packed):
        y = _launch(x2, ql, out_dtype, deq)
    else:
        y = dequant_matmul_plain(x2, ql, out_dtype, deq)
    return y.reshape(*lead, ql.out_features)
