"""Fused per-block dequantize + matmul: W4/W8 weights, bf16 or int8 rows.

Replaces the TPU kernels `mnn_tpu/kernels/dequant_matmul.py::_kernel`
(bf16 activations), `::_kernel_a8` (dynamic int8 activations) and
`::_kernel_deq` (the dequantize-tile variant for many bf16 rows), all
launched from the `pallas_call` in `_dequant_matmul_pallas`. CUDA sources:
`csrc/dequant_matmul.cu`, `csrc/dequant_matmul.cuh`, `csrc/deq_dot.cuh`,
and `csrc/dequant_matmul_k256.cu` (quant blocks of 136 to 256 K-values).

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

* M = 1 (every decode GEMV and the lm head) is bound by the weight bytes,
  0.5 byte per int4 weight read once, but at batch 1 a projection is a few
  hundred KB: one block a 128-column tile left N = 896 on 7 of 132 SMs,
  each reading its K serially. `dqmm_gemv_kernel` cuts the GEMV into
  (128-column tile, K range) items, one a block, enough ranges of whole
  quant blocks to fill about two blocks an SM (`gemv_split`); a lane reads
  its four columns as one 32-bit word a packed row, 16 rows in flight and
  the next 16 issued before their math; the per-quant-block f32 step keeps
  the plain version's order; the K ranges meet in a workspace in device
  memory and the last block of a tile to arrive adds them in range order,
  so two calls give the same bits.
* The a8 prefill GEMM (`dqmm_a8_kernel`, M up to 512 and beyond). At
  M = 512 its operation and byte bounds are close: 0.5 to 6.5 us of int8
  tensor-core operations against 0.5 to 4.5 us of bytes over the main-path
  shapes, the bf16 output being the largest of the bytes at N = 896 to 1152.
  Products run on `mma.sync.m16n8k32` int8 tensor cores, on the unsigned
  pattern, with the re-centring folded into the row sum; a three-stage
  ring of `cp.async` copies brings each quant block's packed rows, xq rows
  and scale/bias rows into shared memory two blocks ahead of the math; the
  packed tile is unpacked once per output tile into K-major words (the B
  fragment's layout) and shared by all its rows; A fragments come by
  `ldmatrix`, and row sums ride on them. The tile, 64 x 64 down to 16 x 64,
  is the tallest that still gives every SM a block (`a8_tile`). What holds
  it back is the latency of the serial steps per quant block, not its
  bounds (`PERF.md`).
* The bf16 path at M > 1 (`dqmm_bf16_tile_kernel`): a mixture-of-experts
  model's shared expert at every prefill chunk, and every prefill
  projection under `prefill_act_bits=16`. At M = 512 it is bound by bf16
  tensor-core operations (23.6 GFLOP for the shared expert's gate/up). It is
  the a8 kernel's design with bf16 A fragments: `mma.sync.m16n8k16` on the
  unsigned pattern q (exact in bf16), the row sums as one more product with
  a B of ones, the same `cp.async` ring (shared code), the packed tile
  unpacked once per output tile into bf16 K-rows (W4: low nibbles to row i,
  high ones to row i + bs/2, as the packed layout pairs them) read by
  `ldmatrix.trans`, and the per-block f32 step in the plain version's
  order. Tiles from 64 x 128 down to 16 x 8, chosen from M and N so the
  32-row bucket fills the card (`bf16_tile`); below `BF_TILE_MIN_M` rows
  (M = 1 always) the GEMV kernel keeps the call.
* The dequantize-tile kernel (`m >= DEQ_MIN_M`, off by default as in the JAX
  package) turns each quant block into wd = bf16(q * s + m) and dots bf16
  rows with it on the tensor cores, whatever `act_bits` says. It is the
  bf16 tile kernel's body and tiles (`csrc/deq_dot.cuh`) in another
  algebra: the scale and bias are applied in the unpack, and the products
  accumulate straight into the sum, with no per-block step and no row sums.
  It rounds the weight, which the other two never do, so its plain version
  is `deq_dot_plain`, shared with the grouped mixture-of-experts prefill
  kernel, and not the loop above.
* Quant blocks of up to `MAX_BLOCK` = 256 K-values, as the JAX kernels take
  them (any multiple of 8 that divides K; the dequantize-tile kernel and the
  grouped expert kernel multiples of 16). The three tensor-core kernels have
  a second build for blocks above 128 that stages the whole block (its
  packed rows interleave across it) and unpacks it in two chunks of K-rows;
  the block's partial sums run on across both and its f32 step comes once,
  as the JAX kernel's does. A block above 256 raises on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import I, P, kernel, library
from mnn_tpu_torch.kernels.common import check, use_kernel
from mnn_tpu_torch.quant.quantize import (QuantizedLinear, dequantize,
                                          quantize_activations_int8,
                                          unpack_bits)

# int mnn_dequant_matmul(x, packed, scale, bias, out_bias, out,
#                        M, K, N, bits, block_size, out_f32, stream): M = 1
KERNEL_BF16 = kernel("mnn_dequant_matmul", [P, P, P, P, P, P, I, I, I, I, I, I])
# int mnn_dequant_matmul_a8(xq, xs, packed, scale, bias, out_bias, out,
#                           M, K, N, bits, block_size, out_f32, stream)
KERNEL_A8 = kernel("mnn_dequant_matmul_a8",
                   [P, P, P, P, P, P, P, I, I, I, I, I, I])

# int mnn_dequant_matmul_bf16_tile(...): the same operands, on the tensor cores
KERNEL_BF16_TILE = kernel("mnn_dequant_matmul_bf16_tile",
                          [P, P, P, P, P, P, I, I, I, I, I, I])

# int mnn_dequant_matmul_deq(...): the same operands as mnn_dequant_matmul
KERNEL_DEQ = kernel("mnn_dequant_matmul_deq", [P, P, P, P, P, P, I, I, I, I, I, I])

MAX_BLOCK = 256   # largest quant block the kernels stage in shared memory

# Rows at or above which the dequantize-tile kernel replaces the other two.
# Off by default, as in the JAX package; a caller or a test sets it lower.
DEQ_MIN_M = 1 << 30


def a8_tile(m: int, n: int, bits: int, bs: int = 128) -> tuple[int, int, int]:
    """(rows, columns, dynamic shared bytes) of the tile that `KERNEL_A8`
    takes for m rows and n columns at quant block bs on this card. Launches
    nothing."""
    fn = library().mnn_dequant_matmul_a8_tile
    fn.argtypes = [I, I, I, I, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 3)()
    if fn(m, n, bits, bs, out):
        raise ValueError(f"no a8 tile for M={m} N={n}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def bf16_tile(m: int, n: int, bits: int,
              bs: int = 128) -> Optional[tuple[int, int, int]]:
    """(rows, columns, dynamic shared bytes) of the tile in which
    `KERNEL_BF16_TILE` takes bf16 rows at m rows and n columns at quant
    block bs on this card, or None where the GEMV kernel (`KERNEL_BF16`,
    M = 1) takes them. Launches nothing."""
    fn = library().mnn_dequant_matmul_tile
    fn.argtypes = [I, I, I, I, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 3)()
    if fn(m, n, bits, bs, out):
        raise ValueError(f"no bf16 tile for M={m} N={n}")
    return tuple(out) if out[0] else None


@functools.lru_cache(maxsize=None)
def gemv_split(k: int, n: int, bits: int, bs: int) -> tuple[int, int, int, int]:
    """(columns a tile, K ranges a tile, blocks, dynamic shared bytes a
    block) of the split in which `KERNEL_BF16` takes one bf16 row of K x N
    on this card. Launches nothing."""
    fn = library().mnn_dequant_matmul_gemv_split
    fn.argtypes = [I, I, I, I, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    if fn(k, n, bits, bs, out):
        raise ValueError(f"no GEMV split for K={k} N={n} W{bits} block {bs}")
    return tuple(out)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_weights(ql: QuantizedLinear, k: int):
    if ql.bits not in (2, 3, 4, 8):
        raise ValueError(f"W{ql.bits} has no CUDA kernel")
    bs = ql.block_size
    if bs > MAX_BLOCK or bs % 8 or k % bs:
        raise ValueError(f"block_size {bs} unsupported: the CUDA kernels take "
                         f"quant blocks of at most {MAX_BLOCK} K-values, a "
                         f"multiple of 8 dividing K={k}")
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


def _unpack_block(packed: torch.Tensor, kb: int, bits: int, bs: int, dtype=torch.int32):
    rows = bs * bits // 8
    return unpack_bits(packed[kb * rows:(kb + 1) * rows], bits, bs, dtype)


def deq_dot_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, bits: int, bs: int,
                  partial: bool) -> torch.Tensor:
    """Plain PyTorch version of `csrc/deq_dot.cuh`, batched over a leading
    axis: x [E, M, K] @ dequant(packed [E, K * bits / 8, N]) -> f32 [E, M, N].

    Rows are rounded to bf16. Per quant block either the partial-product
    algebra, (x_b @ q) * s + rowsum(x_b) * m, or the dequantize-tile one,
    x_b @ bf16(q * s + m), where W3's q is its two planes joined, lo + 4 hi,
    as the JAX `_kernel_deq` joins them; f32 sums over the blocks in order."""
    xf = x.to(torch.bfloat16).float()
    e, k, n = xf.shape[0], xf.shape[-1], packed.shape[-1]
    rows = bs * bits // 8
    s, b = scale.float(), bias.float()
    acc = None
    for kb in range(k // bs):
        # block kb of every matrix: one quant block each, in turn
        q = unpack_bits(packed[:, kb * rows:(kb + 1) * rows].reshape(-1, n), bits, bs,
                        torch.float32).reshape(e, bs, n)
        xb = xf[:, :, kb * bs:(kb + 1) * bs]
        sk, bk = s[:, kb, None, :], b[:, kb, None, :]
        if partial:
            term = (torch.bmm(xb, q) * sk
                    + xb.sum(dim=-1, keepdim=True) * bk)
        else:
            wd = (q * sk + bk).to(torch.bfloat16).float()
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
            part = xb @ _unpack_block(ql.packed, kb, bits, bs, torch.float32)
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
        if x2.data_ptr() % 16:           # it copies rows of x 16 bytes at a time
            x2 = x2.clone()
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
        if x2.data_ptr() % 16:           # both copy rows of x 16 bytes at a time
            x2 = x2.clone()
        kern = KERNEL_BF16_TILE if bf16_tile(m, n, ql.bits) else KERNEL_BF16
        kern(x2.data_ptr(), ql.packed.data_ptr(), ql.scale.data_ptr(),
             ql.bias.data_ptr(), _ptr(ql.out_bias), out.data_ptr(),
             m, k, n, ql.bits, ql.block_size, out_f32)
    return out


def _call(x2: torch.Tensor, ql: QuantizedLinear, out_dtype) -> torch.Tensor:
    """One layer's product on rows x2 [M, K]: the kernel for a CUDA tensor,
    the plain version for a CPU one."""
    deq = x2.shape[0] >= DEQ_MIN_M
    if use_kernel(x2, ql.packed):
        return _launch(x2, ql, out_dtype, deq)
    return dequant_matmul_plain(x2, ql, out_dtype, deq)


class DequantMatmulFn(torch.autograd.Function):
    """The product as an autograd node, the counterpart of the JAX
    wrapper's `jax.custom_vjp`: the forward is the kernel call (the plain
    version on the CPU), the backward the JAX VJP, dx = g.bf16 @
    dequantize(ql, bf16).T accumulated in f32 and cast to x's dtype, by
    `torch.matmul` (the JAX package computes it with `jnp.dot` outside any
    kernel). The packed weights are frozen: they get no gradient. `ql` is
    one layer, read in place as the forward reads it."""

    @staticmethod
    def forward(ctx, x2, ql, out_dtype):
        ctx.ql, ctx.x_dtype = ql, x2.dtype
        # autograd may hand over a view with other strides
        return _call(x2.contiguous(), ql, out_dtype)

    @staticmethod
    def backward(ctx, g):
        w = dequantize(ctx.ql, dtype=torch.bfloat16)
        dx = torch.matmul(g.to(torch.bfloat16).float(), w.float().T)
        return dx.to(ctx.x_dtype), None, None


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
    `DEQ_MIN_M` rows on, the dequantize-tile kernel takes the call.

    Differentiable in x: when autograd records (`torch.is_grad_enabled()`
    and `x.requires_grad`), the call goes through `DequantMatmulFn`, whose
    forward launches the same kernel; otherwise nothing is recorded."""
    if layer_index is not None:
        ql = ql.layer(layer_index)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and x2.requires_grad:
        y = DequantMatmulFn.apply(x2, ql, out_dtype)
    else:
        y = _call(x2, ql, out_dtype)
    return y.reshape(*lead, ql.out_features)
