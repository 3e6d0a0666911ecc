"""Per-block weight quantization (INT4/INT8, asymmetric or symmetric).

Counterpart of `mnn_tpu/quant/quantize.py`, with the same checkpoint
layout, byte for byte:

    w_dequant = q * scale + bias,   q in [0, 2**bits - 1]   (asym)
    w_dequant = (q - 2**(bits-1)) * scale                   (sym; stored in
                the same unsigned form with bias = -2**(bits-1) * scale)

* weights are [K, N] (y = x @ W), blocks of `block_size` rows along K;
* INT4 values are nibble-packed two per byte inside a quant block: offset
  i pairs with offset i + block_size//2 (low/high nibble);
* packed storage is int8 (read back as unsigned bytes);
* scales and biases are bfloat16 [K//block_size, N].

W2 and W3 packing are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """Weights of one linear layer in the packed per-block format.

    The tensors may carry a leading layer axis [L, ...] ("stacked");
    kernels then read one layer in place through `layer_index`. Expert
    stacks carry two, [L, E, ...] (`flat_experts`).
    """

    packed: torch.Tensor               # int8 [K*bits//8, N]
    scale: torch.Tensor                # bf16 [K//block_size, N]
    bias: torch.Tensor                 # bf16 [K//block_size, N]
    out_bias: Optional[torch.Tensor]   # f32 [N] or None
    bits: int = 4
    block_size: int = 128
    act_bits: int = 16                 # 8 = dynamic per-row int8 activations

    @property
    def out_features(self) -> int:
        return self.packed.shape[-1]

    def to(self, device) -> "QuantizedLinear":
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, packed=mv(self.packed), scale=mv(self.scale),
            bias=mv(self.bias), out_bias=mv(self.out_bias))

    def layer(self, i: int) -> "QuantizedLinear":
        """Layer i of a stacked QuantizedLinear, as views (no copy)."""
        sl = lambda t: None if t is None else t[i]
        return dataclasses.replace(
            self, packed=sl(self.packed), scale=sl(self.scale),
            bias=sl(self.bias), out_bias=sl(self.out_bias))

    def flat_experts(self) -> "QuantizedLinear":
        """An expert stack [L, E, ...] seen as [L * E, ...], as views (no
        copy): expert e of layer l is `.layer(l * E + e)`, and a kernel
        wrapper hands its kernel the base pointers and that flat index."""
        fl = lambda t: None if t is None else t.reshape(-1, *t.shape[2:])
        return dataclasses.replace(
            self, packed=fl(self.packed), scale=fl(self.scale),
            bias=fl(self.bias), out_bias=fl(self.out_bias))


def choose_block_size(k: int, requested: int, shards: int = 1) -> int:
    """Largest block <= requested such that blocks tile each of `shards`
    equal K-partitions."""
    if k % shards:
        raise ValueError(f"shards {shards} must divide K={k}")
    local = k // shards
    bs = min(requested, local)
    while bs > 1 and (local % bs or bs % 2):
        bs -= 1
    if bs <= 1:
        raise ValueError(
            f"no even block size divides K={k} over {shards} shards "
            f"(local K = {local}); quantized K dims must be even")
    return bs


def _check_args(k: int, bits: int, block_size: int):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8 in this package, got {bits}")
    align = {4: 2, 8: 1}[bits]
    if block_size % align or k % block_size:
        raise ValueError(
            f"block_size {block_size} must be a multiple of {align} "
            f"(W{bits} packing) and divide K={k}")


def pack_int4(q: torch.Tensor, block_size: int) -> torch.Tensor:
    """Pack unsigned 4-bit values [K, N] -> int8 [K//2, N], pairing
    offsets (i, i + block_size//2) of each quant block in one byte."""
    k, n = q.shape
    half = block_size // 2
    blocks = q.reshape(k // block_size, 2, half, n).to(torch.int32)
    packed = blocks[:, 0] | (blocks[:, 1] << 4)
    return packed.to(torch.uint8).view(torch.int8).reshape(k // 2, n)


def unpack_int4(packed: torch.Tensor, block_size: int) -> torch.Tensor:
    """Inverse of pack_int4: int8 [K//2, N] -> int32 q in [0, 15], [K, N]."""
    kh, n = packed.shape
    half = block_size // 2
    w32 = packed.to(torch.int32) & 0xFF
    w32 = w32.reshape(kh // half, half, n)
    lo = w32 & 0xF
    hi = (w32 >> 4) & 0xF
    return torch.cat([lo, hi], dim=1).reshape(kh * 2, n)


def unpack_bits(packed: torch.Tensor, bits: int, block_size: int) -> torch.Tensor:
    """int8 packed -> int32 q in [0, 2^bits), [K, N]."""
    if bits == 4:
        return unpack_int4(packed, block_size)
    if bits == 8:
        return packed.to(torch.int32) & 0xFF
    raise ValueError(f"W{bits} unpacking is not ported")


def _bf16_bits(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.int16).to(torch.int32) & 0xFFFF


def _from_bf16_bits(bits: torch.Tensor) -> torch.Tensor:
    bits = bits & 0xFFFF
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(torch.int16).view(torch.bfloat16)


def _bf16_round_up(x: torch.Tensor) -> torch.Tensor:
    """f32 -> nearest bf16 value >= x, returned upcast to f32 (x > 0)."""
    b = x.to(torch.bfloat16)
    f = b.float()
    bumped = _from_bf16_bits(_bf16_bits(b) + 1).float()
    return torch.where(f < x, bumped, f)


def _bf16_round_down(x: torch.Tensor) -> torch.Tensor:
    """f32 -> nearest bf16 value <= x, returned upcast to f32 (any sign)."""
    b = x.to(torch.bfloat16)
    f = b.float()
    bits = _bf16_bits(b)
    down = _from_bf16_bits(torch.where(f > 0, bits - 1, bits + 1)).float()
    # f == 0 with x < 0: step to the smallest-magnitude negative bf16
    down = torch.where(f == 0, torch.full_like(down, -1.1754944e-38), down)
    return torch.where(f > x, down, f)


def quantize(
    w: torch.Tensor | np.ndarray,
    bits: int = 4,
    block_size: int = 128,
    sym: bool = False,
    out_bias: Optional[torch.Tensor] = None,
    act_bits: int = 16,
) -> QuantizedLinear:
    """Quantize a float [K, N] weight matrix to the per-block packed format."""
    w = torch.as_tensor(w).to(torch.float32)
    k, n = w.shape
    _check_args(k, bits, block_size)
    qmax = (1 << bits) - 1
    center = 1 << (bits - 1)
    blocks = w.reshape(k // block_size, block_size, n)

    # scale rounded toward +inf and wmin toward -inf so the bf16 grid still
    # covers [wmin, wmax]; q is chosen against the rounded values
    if sym:
        absmax = blocks.abs().amax(dim=1)
        scale = absmax / (center - 1)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        scale = _bf16_round_up(scale)
        q = torch.round(blocks / scale[:, None, :]) + center
        q = q.clamp(1, qmax)
        bias = -float(center) * scale
    else:
        wmin = _bf16_round_down(blocks.amin(dim=1))
        wmax = blocks.amax(dim=1)
        scale = (wmax - wmin) / qmax
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        scale = _bf16_round_up(scale)
        q = torch.round((blocks - wmin[:, None, :]) / scale[:, None, :])
        q = q.clamp(0, qmax)
        bias = wmin

    q = q.to(torch.int32).reshape(k, n)
    if bits == 4:
        packed = pack_int4(q, block_size)
    else:
        packed = q.to(torch.uint8).view(torch.int8)
    return QuantizedLinear(
        packed=packed,
        scale=scale.to(torch.bfloat16),
        bias=bias.to(torch.bfloat16),
        out_bias=None if out_bias is None
        else torch.as_tensor(out_bias).to(torch.float32),
        bits=bits,
        block_size=block_size,
        act_bits=act_bits,
    )


def dequantize(ql: QuantizedLinear, dtype=torch.float32) -> torch.Tensor:
    """Reference dequantization: packed -> float [K, N]."""
    q = unpack_bits(ql.packed, ql.bits, ql.block_size)
    k, n = q.shape
    nb = k // ql.block_size
    qb = q.reshape(nb, ql.block_size, n).float()
    w = qb * ql.scale.float()[:, None, :] + ql.bias.float()[:, None, :]
    return w.reshape(k, n).to(dtype)


def matmul_dequant_ref(x: torch.Tensor, ql: QuantizedLinear,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize-then-matmul reference: bf16 weights, f32 accumulation,
    output cast to `dtype`. (Rounds q*s+m to bf16, which the kernels never
    do; the kernels' plain versions follow the kernels' own algebra.)"""
    w = dequantize(ql, dtype=torch.bfloat16).float()
    y = x.to(torch.bfloat16).float() @ w
    if ql.out_bias is not None:
        y = y + ql.out_bias
    return y.to(dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Per-row symmetric int8: returns (q [M,K] int8, scale [M,1] f32)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale
