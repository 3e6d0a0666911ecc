"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where there is no card. On a machine with an
NVIDIA Hopper card and nvcc, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use). Each case builds the kernels once, launches one on CUDA tensors,
and holds the result against the plain version on the same inputs, at odd
shapes the serving path does not reach: ragged N, a partial last row tile,
group sizes 1 to 8, windows and sinks. Tolerances as in the CPU tests
against JAX: rel-L2 1e-2 for the dequant matmuls, 2e-2 for flash prefill,
3e-2 for decode attention; quantized K/V rows at most one int8 level apart
(a rounding tie under another summation order). The whole-model decode
kernel is held to `decode_model.PARITY_BOUNDS` from the same state: logits
rel-L2 5e-2, x 2e-2, layer-0 rows one level and scales 8e-3, all layers'
dequantized rows 3e-2. The two mixture-of-experts kernels are held to rel-L2
2e-2 (the JAX tests' own bound, `tests/test_moe_decode.py`), the
dequantize-tile matmul to 1e-2; the fused expert decode kernel, flash
prefill and the decode step (whose split K/V ranges merge in a fixed order)
must also give the same bits twice; the fused expert kernel is one launch a
call and gives the same bits over three calls and a replayed CUDA graph
with no host reset of its ticket and counters. So must the two kernels that split a
batch-1 call over blocks and merge through a workspace of their own (the
M = 1 GEMV and flash decode): at the edges of their splits, and in a
captured CUDA graph replayed three times with two shapes of each
interleaved, which shows that every launch leaves the counters at zero.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from mnn_tpu_torch.kernels import (build, decode_model, decode_step, dequant_matmul,
                                   flash_attention, moe_decode, moe_prefill)
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.llm import Llm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc for sm_90a")
    build.library()
    return torch.device("cuda")


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def rand_ql(g, dev, k, n, bits, act_bits, layers, with_bias, bs=128):
    packed = torch.randint(-128, 128, (layers, k * bits // 8, n), dtype=torch.int8,
                           device=dev, generator=g)
    scale = (torch.rand((layers, k // bs, n), device=dev, generator=g) * 2e-3
             + 1e-3).to(torch.bfloat16)
    bias = (-(1 << (bits - 1)) * scale.float()).to(torch.bfloat16)
    ob = (torch.randn((layers, n), device=dev, generator=g) * 0.1
          if with_bias else None)
    return QuantizedLinear(packed=packed, scale=scale, bias=bias, out_bias=ob,
                           bits=bits, block_size=bs, act_bits=act_bits)


# (bits, act_bits, M, K, N, out f32, out_bias)
GEMM = [(4, 16, 1, 256, 200, False, True), (4, 16, 5, 384, 1028, False, False),
        (8, 16, 1, 256, 132, True, False), (8, 16, 40, 256, 200, False, True),
        (4, 8, 1, 256, 200, False, True), (4, 8, 130, 384, 1028, False, False),
        (8, 8, 70, 256, 132, True, True)]


@pytest.mark.parametrize("bits,act_bits,m,k,n,f32,with_bias", GEMM)
def test_dequant_matmul_kernel(dev, bits, act_bits, m, k, n, f32, with_bias):
    g = torch.Generator(device=dev).manual_seed(m * n + bits)
    ql = rand_ql(g, dev, k, n, bits, act_bits, 3, with_bias)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    kern = dequant_matmul.KERNEL_A8 if act_bits == 8 else (
        dequant_matmul.KERNEL_BF16_TILE if dequant_matmul.bf16_tile(m, n, bits)
        else dequant_matmul.KERNEL_BF16)
    before = kern.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(2), out_dtype)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 1e-2


# The split GEMV (M = 1) at the edges of its items: (bits, K, N, block, out
# f32, out_bias). K = 4864 takes 38 quant blocks in ranges of unequal length;
# N = 200, 132 and 1028 end in a partial tile; blocks of 40 and 8 K-values end
# in a partial unit of 16 packed rows; K = 12288 takes more ranges than
# filling the card asks for, so that a range's units fit shared memory; the
# lm head takes one range a tile.
GEMV = [(4, 4864, 896, 128, False, False), (4, 896, 1152, 128, False, True),
        (4, 4864, 200, 128, True, True), (4, 2048, 2048, 128, False, False),
        (8, 2048, 132, 128, True, False), (4, 320, 1028, 40, False, True),
        (8, 160, 200, 40, False, False), (4, 128, 132, 8, True, False),
        (8, 256, 1028, 16, False, True), (4, 12288, 896, 128, False, False),
        (4, 896, 151936, 128, True, False)]


@pytest.mark.parametrize("bits,k,n,bs,f32,with_bias", GEMV)
def test_dequant_matmul_gemv_split_edges(dev, bits, k, n, bs, f32, with_bias):
    g = torch.Generator(device=dev).manual_seed(k + n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 16, 2, with_bias, bs=bs)
    x = torch.randn((1, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    cols, ranges, blocks, smem = dequant_matmul.gemv_split(k, n, bits, bs)
    print(f"K={k} N={n} W{bits} block {bs}: {cols}-column tiles, {ranges} K ranges, "
          f"{blocks} blocks, smem {smem}")
    assert 1 <= ranges <= k // bs and blocks == math.ceil(n / cols) * ranges
    kern = dequant_matmul.KERNEL_BF16
    before = kern.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(1), out_dtype)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (1, n)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert rel(got, want) <= 1e-2


# int8 rows at the main path's shapes (qwen2-0.5b's qkv, wo, gate/up and
# down, qwen1.5-moe-a2.7b's qkv; the 32-, 128- and 512-row buckets) and at
# the tiles' edges: (bits, M, K, N, block, out f32, out_bias)
GEMM_A8 = [(4, 512, 896, 1152, 128, False, True), (4, 512, 896, 896, 128, False, False),
           (4, 512, 896, 9728, 128, False, False), (4, 512, 4864, 896, 128, False, False),
           (4, 512, 2048, 6144, 128, False, True), (4, 32, 896, 9728, 128, False, False),
           (4, 128, 896, 9728, 128, False, False), (4, 128, 896, 1152, 64, False, True),
           (4, 32, 4864, 896, 32, False, False), (4, 130, 896, 1028, 32, True, True),
           (4, 77, 960, 200, 40, True, True), (4, 300, 384, 1028, 8, False, False),
           (4, 1, 256, 200, 16, False, True), (8, 512, 896, 1152, 128, False, True),
           (8, 33, 256, 132, 64, True, True), (8, 200, 2048, 2048, 16, False, False)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", GEMM_A8)
def test_dequant_matmul_a8_kernel(dev, bits, m, k, n, bs, f32, with_bias):
    """The tensor-core a8 kernel sums each output over the whole of K in
    block order, with the plain version's f32 steps: the same bits as the
    plain version, and from run to run."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 8, 3, with_bias, bs)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    before = dequant_matmul.KERNEL_A8.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(2), out_dtype)
    torch.cuda.synchronize()
    assert dequant_matmul.KERNEL_A8.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 1e-2
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) == 0.0


# bf16 rows at the main path's shapes (qwen1.5-moe-a2.7b's shared expert at
# the 32-, 128- and 512-row buckets, its down projection with the f32 output
# the model asks for; qwen2-0.5b's qkv, wo, gate/up and down at M = 512 under
# prefill_act_bits=16, and wo and down at the 32-row bucket), at the tile
# kernel's edges (M = 2 to 130, blocks of 8 to 128 K-values, W8, ragged N,
# f32 with out_bias, tiles from 64 x 128 to 16 x 8), and at M = 1, which the
# row kernel keeps: (bits, M, K, N, block, out f32, out_bias)
GEMM_ROWS = [(4, 32, 2048, 11264, 128, False, False), (4, 128, 2048, 11264, 128, False, False),
             (4, 512, 2048, 11264, 128, False, False), (4, 32, 5632, 2048, 128, True, False),
             (4, 128, 5632, 2048, 128, True, False), (4, 512, 5632, 2048, 128, True, False),
             (4, 512, 896, 1152, 128, False, True), (4, 512, 896, 896, 128, False, False),
             (4, 512, 896, 9728, 128, False, False), (4, 512, 4864, 896, 128, False, False),
             (4, 2, 256, 200, 16, False, True), (4, 16, 384, 1028, 8, False, False),
             (4, 33, 960, 200, 40, True, True), (4, 64, 2048, 2048, 64, False, False),
             (4, 130, 896, 1028, 32, True, True), (8, 64, 256, 1028, 64, False, True),
             (8, 130, 512, 200, 128, True, False), (8, 33, 320, 1152, 40, False, False),
             (8, 512, 896, 1152, 128, False, True), (4, 32, 896, 896, 128, False, False),
             (4, 32, 4864, 896, 128, False, False), (8, 2, 256, 132, 8, True, True),
             (4, 1, 2048, 2048, 128, False, False)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", GEMM_ROWS)
def test_dequant_matmul_rows_kernel(dev, bits, m, k, n, bs, f32, with_bias):
    """bf16 rows from 32 on take the tensor-core tile kernel, M = 1 the row
    kernel; either way the result meets the plain version at rel-L2 1e-2
    and gives the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 16, 3, with_bias, bs)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    tile = dequant_matmul.bf16_tile(m, n, bits)
    if m >= 32:
        assert tile is not None and tile[0] <= max(16, m)
    if m == 1:
        assert tile is None
    kern, other = dequant_matmul.KERNEL_BF16_TILE, dequant_matmul.KERNEL_BF16
    if tile is None:
        kern, other = other, kern
    before, before_other = kern.launches, other.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(2), out_dtype)
    torch.cuda.synchronize()
    assert kern.launches == before + 2 and other.launches == before_other
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    err = rel(got, want)
    print(f"bf16 rows M={m} K={k} N={n} W{bits} bs={bs} tile={tile}: rel-L2 {err:.3e}")
    assert err <= 1e-2
    assert torch.equal(got, again)


# (H, Hkv, Tq, S, kv_len, q_offset, D, window, sink), batch 2: head dims 32,
# 64 and 128; Tq off the 16- and 64-row tiles (1, 37, 45, 90, 200); kv_len
# inside a 64-position tile; T = 128 over 600 positions at q_offset 512 (the
# second chunk of a 600-token prompt; 1-warp blocks); a window and a sink
# across tile edges; groups 1, 7 and 8.
FLASH = [(2, 2, 16, 64, 40, 24, 64, 0, 0), (4, 2, 45, 128, 77, 32, 64, 0, 0),
         (14, 2, 100, 256, 228, 128, 64, 0, 0), (4, 2, 33, 96, 90, 57, 32, 16, 2),
         (2, 1, 20, 64, 20, 0, 128, 0, 0),
         (7, 1, 37, 160, 101, 64, 64, 0, 0), (8, 8, 50, 128, 128, 78, 32, 0, 0),
         (14, 2, 128, 1024, 600, 512, 64, 0, 0), (16, 16, 128, 1024, 600, 512, 128, 0, 0),
         (8, 1, 90, 512, 300, 210, 64, 100, 70), (4, 4, 70, 256, 250, 180, 128, 64, 10),
         (2, 2, 1, 64, 30, 29, 64, 0, 0), (4, 2, 200, 512, 450, 250, 64, 0, 0)]


@pytest.mark.parametrize("h,hkv,t,s,kv_len,q_off,d,window,sink", FLASH)
def test_flash_prefill_kernel(dev, h, hkv, t, s, kv_len, q_off, d, window, sink):
    g = torch.Generator(device=dev).manual_seed(h * t + s)
    mk = lambda *shape: torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = mk(2, h, t, d), mk(2, hkv, s, d), mk(2, hkv, s, d)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo,
                                          window=window, sink=sink)
    again = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo,
                                            window=window, sink=sink)
    want = flash_attention.flash_attention_plain(q, k, v, kl, qo, True, None,
                                                 window, sink)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 2
    assert torch.isfinite(got).all()
    err = rel(got, want)
    print(f"flash prefill H={h} Hkv={hkv} T={t} S={s} kv={kv_len} q_off={q_off} D={d} "
          f"window={window} sink={sink} tile={flash_attention.prefill_tile(2, h, t, d)}: "
          f"rel-L2 {err:.3e}")
    assert err <= 2e-2
    assert torch.equal(got, again)


# (G, D, int8 cache, qk-norm, window, sink, lengths)
DECODE = [(7, 64, True, False, 0, 0, (0, 300)), (7, 64, True, True, 64, 4, (500, 37)),
          (3, 32, True, False, 0, 0, (1, 255)), (2, 128, False, False, 0, 0, (33, 256)),
          (8, 64, False, True, 0, 0, (100, 5))]


@pytest.mark.parametrize("grp,d,int8,qkn,window,sink,lengths", DECODE)
def test_decode_step_kernel(dev, grp, d, int8, qkn, window, sink, lengths):
    nl, b, hkv, s = 3, 2, 2, 512
    g = torch.Generator(device=dev).manual_seed(grp * d + len(lengths))
    kf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    vf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    if int8:
        (kc, ks), (vc, vs) = kvcache.quantize_kv(kf), kvcache.quantize_kv(vf)
    else:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    qkv = (torch.randn((b, hkv, grp + 2, d), device=dev, generator=g) * 2
           ).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, d // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    norms = ((torch.rand(d, device=dev, generator=g) + 0.5,
              torch.rand(d, device=dev, generator=g) + 0.5) if qkn else (None, None))
    check_decode_step(qkv, kc, vc, ks, vs, lens, cos, sin, norms, window, sink, 0.0, int8)


def check_decode_step(qkv, kc, vc, ks, vs, lens, cos, sin, norms, window, sink, softcap,
                      int8):
    """Two calls: one launch each, the same bits, and the plain version's
    result within rel-L2 3e-2 (rows one int8 level, scales 1e-6)."""
    b, hkv, r, d = qkv.shape
    kw = dict(q_norm=norms[0], k_norm=norms[1], window=window, sink=sink, softcap=softcap)
    before = decode_step.KERNEL.launches
    got = decode_step.fused_decode_attention(qkv, kc, vc, ks, vs, 1, lens, cos, sin, **kw)
    assert decode_step.KERNEL.launches == before + 1
    again = decode_step.fused_decode_attention(qkv, kc, vc, ks, vs, 1, lens, cos, sin, **kw)
    assert decode_step.KERNEL.launches == before + 2
    want = decode_step.fused_decode_attention_plain(
        qkv, kc, vc, ks, vs, 1, lens, cos, sin, norms[0], norms[1], 1e-6,
        d ** -0.5, window, sink, softcap)
    torch.cuda.synchronize()
    assert got[0].shape == (b, hkv * (r - 2), d) and torch.isfinite(got[0]).all()
    err = rel(got[0], want[0])
    print(f"decode step B={b} Hkv={hkv} G={r - 2} D={d} S={kc.shape[3]} lengths="
          f"{lens.tolist()} int8={int8} window={window} sink={sink} softcap={softcap} "
          f"split={decode_step.split(b, hkv, r - 2, kc.shape[3], d, int8)}: rel-L2 {err:.3e}")
    assert err <= 3e-2
    for j in (1, 2):
        assert float((got[j] - want[j]).abs().max()) <= (1.0 if int8 else 0.0)
    if int8:
        for j in (3, 4):
            assert rel(got[j], want[j]) <= 1e-6
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


# The split's edges at a capacity of 1024: (B, Hkv, G, D, int8 cache, window,
# sink, softcap, lengths). qwen2-0.5b's heads at batch 1 take clusters of 16
# blocks, 64 positions each at len_old 1023; lengths below P leave blocks
# empty; 16 and 17 sit on a split boundary; B = 4 x Hkv 16 takes 2 blocks a
# cluster and eight tiles a block.
DECODE_SPLIT = [
    (1, 2, 7, 64, True, 0, 0, 0.0, (0,)), (1, 2, 7, 64, True, 0, 0, 0.0, (1023,)),
    (1, 2, 7, 64, True, 0, 0, 0.0, (5,)), (1, 2, 7, 64, True, 0, 0, 0.0, (16,)),
    (1, 2, 7, 64, True, 0, 0, 0.0, (17,)), (2, 2, 7, 64, True, 0, 0, 0.0, (0, 1023)),
    (1, 2, 7, 64, True, 0, 0, 30.0, (631,)), (1, 16, 1, 128, True, 0, 0, 0.0, (331,)),
    (1, 16, 1, 128, True, 0, 0, 0.0, (1023,)), (1, 2, 8, 64, True, 100, 70, 0.0, (700,)),
    (2, 2, 4, 128, False, 0, 0, 50.0, (1023, 1)),
    (4, 16, 1, 128, True, 0, 0, 0.0, (1000, 0, 513, 64))]


@pytest.mark.parametrize("b,hkv,grp,d,int8,window,sink,softcap,lengths", DECODE_SPLIT)
def test_decode_step_split_edges(dev, b, hkv, grp, d, int8, window, sink, softcap, lengths):
    nl, s = 2, 1024
    g = torch.Generator(device=dev).manual_seed(b * hkv + grp * d + sum(lengths))
    kf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    vf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    if int8:
        (kc, ks), (vc, vs) = kvcache.quantize_kv(kf), kvcache.quantize_kv(vf)
    else:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    qkv = (torch.randn((b, hkv, grp + 2, d), device=dev, generator=g) * 2
           ).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, d // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    check_decode_step(qkv, kc, vc, ks, vs, lens, cos, sin, (None, None), window, sink,
                      softcap, int8)


def test_cuda_tensors_never_take_the_plain_version(dev):
    """A shape the kernel does not take raises on the card; it does not
    fall back to the plain version."""
    q = torch.zeros((1, 2, 8, 48), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q.cpu(), q)


def rand_cache(g, dev, nl, b, hkv, s, d, bits):
    kf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    vf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    if bits == 16:
        return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    (kc, ks), (vc, vs) = kvcache.quantize_for(bits, kf), kvcache.quantize_for(bits, vf)
    return kc, vc, ks, vs


# (G, D, kv bits, window, sink, kv_len per sequence)
FLASH_DECODE = [(7, 64, 8, 0, 0, (1, 301)), (7, 64, 4, 0, 0, (49, 512)),
                (4, 128, 4, 64, 4, (500, 37)), (2, 128, 16, 0, 0, (33, 256)),
                (8, 64, 16, 16, 0, (100, 5)), (1, 128, 8, 0, 0, (0, 77))]


@pytest.mark.parametrize("grp,d,bits,window,sink,lengths", FLASH_DECODE)
def test_flash_decode_kernel(dev, grp, d, bits, window, sink, lengths):
    nl, b, hkv, s = 3, 2, 2, 512
    g = torch.Generator(device=dev).manual_seed(grp * d + bits)
    kc, vc, ks, vs = rand_cache(g, dev, nl, b, hkv, s, d, bits)
    q = (torch.randn((b, hkv * grp, d), device=dev, generator=g) * 2).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = flash_attention.KERNEL_DECODE.launches
    got = flash_attention.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs,
                                           layer_index=1, window=window, sink=sink)
    want = flash_attention.decode_attention_plain(q, kc, vc, lens, ks, vs, 1, None,
                                                  window, sink)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL_DECODE.launches == before + 1
    assert got.shape == (b, hkv * grp, d) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 3e-2


# Flash decode at the edges of its split: (B, Hkv, G, D, kv bits, capacity,
# window, sink, kv_len per sequence). qwen2-0.5b's heads over a capacity of
# 1024 take 16 blocks a KV head, each at most one 64-position tile: lengths
# 0, 1, 5 (most blocks empty), 63, 64, 65, 1023 and the capacity. B = 4 x
# Hkv 16 takes 4 blocks a KV head: 255, 256, 257 put a range of 64 +- 1
# positions in a block, 260 two tiles in each, 1024 four. kv_len 4000 of
# 4096 gives 16 blocks four tiles each; then a ragged batch 2, windows with
# sinks, and bf16 caches.
FDEC_SPLIT = [
    (1, 2, 7, 64, 8, 1024, 0, 0, (0,)), (1, 2, 7, 64, 8, 1024, 0, 0, (1,)),
    (1, 2, 7, 64, 4, 1024, 0, 0, (5,)), (1, 2, 7, 64, 4, 1024, 0, 0, (63,)),
    (1, 2, 7, 64, 8, 1024, 0, 0, (64,)), (1, 2, 7, 64, 4, 1024, 0, 0, (65,)),
    (1, 2, 7, 64, 8, 1024, 0, 0, (1023,)), (1, 2, 7, 64, 4, 1024, 0, 0, (1024,)),
    (1, 16, 1, 128, 4, 1024, 0, 0, (332,)), (1, 16, 1, 128, 8, 1024, 0, 0, (49,)),
    (4, 16, 1, 128, 8, 1024, 0, 0, (255, 256, 257, 260)),
    (4, 16, 1, 128, 4, 1024, 0, 0, (1024, 0, 513, 1)),
    (1, 16, 1, 128, 4, 4096, 0, 0, (4000,)), (2, 2, 7, 64, 8, 1024, 0, 0, (332, 632)),
    (1, 2, 7, 64, 4, 1024, 100, 4, (700,)), (1, 2, 8, 64, 16, 1024, 64, 70, (700,)),
    (2, 2, 4, 128, 16, 512, 64, 4, (500, 37)), (1, 4, 2, 128, 16, 1024, 0, 0, (900,))]


@pytest.mark.parametrize("b,hkv,grp,d,bits,s,window,sink,lengths", FDEC_SPLIT)
def test_flash_decode_split_edges(dev, b, hkv, grp, d, bits, s, window, sink, lengths):
    g = torch.Generator(device=dev).manual_seed(b * hkv + grp * d + bits + sum(lengths))
    kc, vc, ks, vs = rand_cache(g, dev, 2, b, hkv, s, d, bits)
    q = (torch.randn((b, hkv * grp, d), device=dev, generator=g) * 2).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    p, tile, smem, blocks = flash_attention.decode_split(b, hkv, grp, s, d, bits)
    print(f"B={b} Hkv={hkv} G={grp} D={d} int{bits} S={s}: {p} blocks a KV head, "
          f"{tile}-position tiles, smem {smem}, {blocks} blocks")
    assert p in (1, 2, 4, 8, 16) and blocks == b * hkv * p and (p == 1 or p * tile <= s)
    before = flash_attention.KERNEL_DECODE.launches
    call = lambda: flash_attention.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs,
                                                    layer_index=1, window=window, sink=sink)
    got, again = call(), call()
    want = flash_attention.decode_attention_plain(q, kc, vc, lens, ks, vs, 1, None,
                                                  window, sink)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL_DECODE.launches == before + 2
    assert got.shape == (b, hkv * grp, d) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert rel(got, want) <= 3e-2
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()


def test_split_kernels_replay_in_a_graph(dev):
    """The GEMV and flash decode at two shapes each, interleaved, eager and
    in a captured CUDA graph replayed three times: every replay gives the
    eager bits, so the shapes share the workspaces and every launch leaves
    the counters at zero."""
    g = torch.Generator(device=dev).manual_seed(10)
    gemvs = []
    for k, n, with_bias in ((4864, 896, False), (896, 1152, True)):
        ql = rand_ql(g, dev, k, n, 4, 16, 1, with_bias)
        x = torch.randn((1, k), device=dev, generator=g).to(torch.bfloat16)
        gemvs.append(lambda x=x, ql=ql: dequant_matmul.dequant_matmul(x, ql, layer_index=0))
    decodes = []
    for bsz, hkv, grp, d, bits, s, lengths in ((1, 2, 7, 64, 4, 1024, (632,)),
                                               (1, 16, 1, 128, 8, 4096, (4000,))):
        kc, vc, ks, vs = rand_cache(g, dev, 1, bsz, hkv, s, d, bits)
        q = torch.randn((bsz, hkv * grp, d), device=dev, generator=g).to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        decodes.append(lambda q=q, kc=kc, vc=vc, ks=ks, vs=vs, lens=lens:
                       flash_attention.decode_attention(q, kc, vc, lens, k_scale=ks,
                                                        v_scale=vs, layer_index=0))
    calls = [gemvs[0], decodes[0], gemvs[1], decodes[1], gemvs[0], decodes[1], gemvs[1],
             decodes[0]]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = [c() for c in calls]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))


MK = ModelConfig(name="mk-test", vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=10000.0, attention_bias=True, tie_word_embeddings=True)
# (config changes, weight bits, kv bits, head bits, lengths)
DECODE_MODEL = [
    ({}, 4, 8, 4, (9,)), ({}, 4, 4, 4, (40,)), ({}, 4, 16, 0, (0,)),
    ({}, 8, 8, 8, (33, 5)), (dict(qk_norm=True, attention_bias=False), 4, 8, 4, (9, 70, 3)),
    (dict(sliding_window=6, attention_sink=2), 4, 4, 4, (20, 128, 1, 64, 7)),
    (dict(hidden_size=512, head_dim=128, intermediate_size=1024), 4, 4, 4, (50, 9)),
    (dict(hidden_size=896, num_heads=14, intermediate_size=4864, vocab_size=1024,
          num_layers=2), 4, 8, 4, (100,)),
    (dict(num_heads=16, hidden_size=1024), 8, 16, 4, (17,) * 8),
]
# the lengths at a 64-position split's edges and the last slot; batch 1, 3
# and 8; D 64 and 128; KV 4, 8 and 16 bits; QK-norm with and without the
# QKV bias; window + sink
DECODE_MODEL_EDGES = [
    ({}, 4, 8, 4, (1, 63, 64, 65, 127, 0, 9, 100)),
    (dict(hidden_size=512, head_dim=128, intermediate_size=1024), 4, 8, 4, (63, 64, 65)),
    (dict(hidden_size=512, head_dim=128, intermediate_size=1024), 4, 16, 4, (127,)),
    (dict(qk_norm=True), 4, 4, 4, (0, 65, 127)),
    (dict(qk_norm=True, hidden_size=512, head_dim=128, intermediate_size=1024,
          sliding_window=40, attention_sink=4), 8, 8, 8, (127, 1, 64)),
]


@pytest.mark.parametrize("changes,bits,kv_bits,head_bits,lengths", DECODE_MODEL)
def test_decode_model_kernel(dev, changes, bits, kv_bits, head_bits, lengths):
    check_decode_model(dev, changes, bits, kv_bits, head_bits, lengths)


@pytest.mark.parametrize("changes,bits,kv_bits,head_bits,lengths", DECODE_MODEL_EDGES)
def test_decode_model_kernel_edges(dev, changes, bits, kv_bits, head_bits, lengths):
    """The same checks at the edges of the kernel's schedule. An int4 level
    is 18 times an int8 one, so another summation order that flips a bf16
    rounding in layer 1 or 2 moves a stored row by a whole level: past layer
    0 (held to the same levels and scales), int4 rows are held as
    `chip_smoke.py` holds them, within one level and a dequantized rel-L2 of
    1.5e-1."""
    deep4 = dict(rows_levels=1.0, rows_rel=1.5e-1) if kv_bits == 4 else {}
    check_decode_model(dev, changes, bits, kv_bits, head_bits, lengths, **deep4)


def check_decode_model(dev, changes, bits, kv_bits, head_bits, lengths, quant_block=128,
                       skip=(), **bounds):
    """The kernel against its plain version from the same state, within
    `decode_model.PARITY_BOUNDS` (`bounds` replaces some, `skip` leaves some
    to the caller); the same bits again with the cache written in place, and
    the rows where they belong. Returns the kernel's and the plain version's
    results and a call of the plain version on the same inputs."""
    cfg = dataclasses.replace(MK, **changes)
    b, s = len(lengths), 128
    gen = torch.Generator().manual_seed(bits + kv_bits + b)
    params = decoder.init_random_params(cfg, gen, quant_bits=bits, scale=0.05,
                                        quant_block=quant_block, lm_head_bits=head_bits,
                                        device=dev)
    lay = params.layers
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda t: torch.rand(t.shape, device=dev, generator=g) * 0.6 + 0.7
    lay = dataclasses.replace(lay, input_norm=rnd(lay.input_norm), post_norm=rnd(lay.post_norm))
    if cfg.attention_bias:
        lay = dataclasses.replace(lay, wqkv=dataclasses.replace(
            lay.wqkv, out_bias=torch.randn(lay.wqkv.out_bias.shape, device=dev, generator=g) * 0.1))
    if cfg.qk_norm:
        lay = dataclasses.replace(lay, q_norm=rnd(lay.q_norm), k_norm=rnd(lay.k_norm))
    kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, s,
                                cfg.head_dim, kv_bits)
    x = (torch.randn((b, cfg.hidden_size), device=dev, generator=g) * 0.05).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, cfg.head_dim // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    head = params.lm_head if head_bits else None
    kw = dict(config=cfg, head=head, final_norm=rnd(params.final_norm))
    want = decode_model.fused_decode_model_plain(x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)
    before = decode_model.KERNEL.launches
    got = decode_model.fused_decode_model(x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)
    again = decode_model.fused_decode_model(x, lay, kc, vc, ks, vs, lens, cos, sin,
                                            write_cache=True, **kw)
    torch.cuda.synchronize()
    assert decode_model.KERNEL.launches == before + 2
    assert len(got) == (7 if head_bits else 5)
    assert all(torch.isfinite(t).all() for t in got if t is not None)
    m = decode_model.parity_metrics(got, want, kv_bits)
    assert not decode_model.parity_failures(m, skip=skip, **bounds), m
    # the same launch again gives the same bits, and wrote the rows in place
    for a, c in zip(got, again):
        assert a is None or torch.equal(a, c)
    pos = lens.long().clamp(0, s - 1)
    bi = torch.arange(b, device=dev)
    assert torch.equal(kc[:, bi, :, pos].float(), got[1][:, :, :, 0].transpose(0, 1))
    assert torch.equal(vc[:, bi, :, pos].float(), got[2][:, :, :, 0].transpose(0, 1))
    if kv_bits < 16:
        assert torch.equal(ks[:, bi, :, pos], got[3][:, :, :, 0].transpose(0, 1))
    # the rows written at `pos` lie outside the plain version's mask
    return got, want, lambda: decode_model.fused_decode_model_plain(
        x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)


def _decode_model_case(dev, cfg, b, s, lengths, kv_bits=8, seed=5):
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(seed), scale=0.05,
                                        lm_head_bits=4, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, s, cfg.head_dim,
                                kv_bits)
    x = (torch.randn((b, cfg.hidden_size), device=dev, generator=g) * 0.05).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, cfg.head_dim // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    args = (x, params.layers, kc, vc, ks, vs, lens, cos, sin)
    return args, dict(config=cfg, head=params.lm_head, final_norm=params.final_norm)


def test_decode_model_kernel_replays_without_reset(dev):
    """Three launches back to back, then a captured CUDA graph of one launch
    replayed three times, with no host-side reset of the arrival counters in
    between: every call gives the first call's bits, so each launch zeroes
    its counters itself and leaves the grid-wide wait's word as it found it.
    A second shape in between shares the counters."""
    args, kw = _decode_model_case(dev, MK, 1, 128, (70,))
    other = _decode_model_case(dev, dataclasses.replace(MK, num_layers=2), 3, 128, (5, 64, 9))
    first = decode_model.fused_decode_model(*args, **kw)
    for _ in range(2):
        decode_model.fused_decode_model(*other[0], **other[1])
        again = decode_model.fused_decode_model(*args, **kw)
        torch.cuda.synchronize()
        assert all(a is None or torch.equal(a, c) for a, c in zip(first, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_model.fused_decode_model(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = decode_model.fused_decode_model(*args, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(a is None or torch.equal(a, c) for a, c in zip(first, static))


def test_tiny_slice_card_matches_cpu(dev):
    """The serving slice at a tiny size, from one seed on the card and
    through the plain versions on the CPU: every kernel of the per-layer
    path launches on the card (`tiny` has head_dim 32, which the whole-model
    kernel does not take) and none on the CPU, and the prefill logits and
    first token agree (the token where the CPU's top-2 margin exceeds the
    largest difference)."""
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                       sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                       max_new_tokens=6)
    ids = list(range(3, 48))
    runs = []
    for device in (dev, "cpu"):
        llm = Llm.synthetic("tiny", rt=rt, seed=1, device=device)
        build.reset_launches()
        toks = list(llm.stream(token_ids=ids))
        runs.append((toks, llm.last_prefill_logits.float().cpu(),
                     {k.name: k.launches for k in build.KERNELS}))
    (card_toks, card, card_n), (cpu_toks, cpu, cpu_n) = runs
    per_layer = ("mnn_dequant_matmul", "mnn_dequant_matmul_a8", "mnn_flash_prefill",
                 "mnn_decode_step")
    assert all(card_n[k] > 0 for k in per_layer) and not any(cpu_n.values())
    assert card_n["mnn_decode_model"] == 0
    assert len(card_toks) == len(cpu_toks) == rt.max_new_tokens
    assert torch.isfinite(card).all() and rel(card, cpu) <= 5e-2
    top2 = cpu[0].topk(2).values
    if float(top2[0] - top2[1]) > float((card - cpu).abs().max()):
        assert card_toks[0] == cpu_toks[0]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_megakernel_slice_card_matches_cpu(dev, kv_bits):
    """Greedy decode through the whole-model kernel at a small size (head_dim
    64), on the card and through the plain versions on the CPU: one
    `mnn_decode_model` launch per decode step and no `mnn_decode_step`
    launch, and from the same state the per-layer path's logits agree."""
    cfg = dataclasses.replace(MK, tie_word_embeddings=False)
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                       sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                       kv_bits=kv_bits, max_new_tokens=6)
    ids = list(range(3, 48))
    runs = []
    for device in (dev, "cpu"):
        gen = torch.Generator().manual_seed(1)
        params = decoder.init_random_params(cfg, gen, scale=0.05, lm_head_bits=4,
                                            device=device)
        llm = Llm(cfg, params, rt, device=device)
        assert llm.info()["decode_megakernel"] and llm.info()["decode_fused_head"]
        build.reset_launches()
        toks = list(llm.stream(token_ids=ids))
        runs.append((toks, {k.name: k.launches for k in build.KERNELS}, llm))
    (card_toks, card_n, llm), (cpu_toks, cpu_n, _) = runs
    assert card_n["mnn_decode_model"] == rt.max_new_tokens
    assert card_n["mnn_decode_step"] == 0 and not any(cpu_n.values())
    assert len(card_toks) == len(cpu_toks) == rt.max_new_tokens
    tok = torch.tensor([[card_toks[-1]]], device=dev)
    cache = llm.cache
    ref, _ = decoder.forward(llm.params, cfg, tok, _clone(cache), megakernel=False)
    (mk, mtok), _ = decoder.forward(llm.params, cfg, tok, _clone(cache),
                                    megakernel=True, return_token=True)
    torch.cuda.synchronize()
    assert rel(mk, ref) <= 5e-2
    assert int(mtok[0]) == int(decode_model.lowest_argmax(mk)[0])


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_megakernel_stream_matches_per_layer(dev, kv_bits):
    """A 32-token greedy `Llm.stream` on the card through the whole-model
    kernel (one launch a token, fed back from its own argmax), against the
    per-layer path teacher-forced on the card from the same prompt: the
    tokens agree at every step whose top-2 margin is above the largest logit
    difference seen, and at least 8 of the 32 steps are compared."""
    cfg = dataclasses.replace(MK, tie_word_embeddings=False)
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=8, sampler="greedy",
                       lm_head_bits=4, kv_bits=kv_bits, max_new_tokens=32)
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(3), scale=0.05,
                                        lm_head_bits=4, device=dev)
    llm = Llm(cfg, params, rt, device=dev)
    assert llm.info()["decode_megakernel"]
    ids = list(range(5, 45))
    build.reset_launches()
    out = list(llm.stream(token_ids=ids))
    assert len(out) == 32 and decode_model.KERNEL.launches == rt.max_new_tokens
    from mnn_tpu_torch.runtime import generate
    logits, cache = generate.run_prefill(params, cfg, rt, torch.tensor([ids], device=dev),
                                         llm._new_cache())
    rows, diff = [logits], 0.0
    for tok in out[:-1]:
        t = torch.tensor([[tok]], device=dev)
        mk, _ = decoder.forward(params, cfg, t, _clone(cache), megakernel=True)
        logits, cache = decoder.forward(params, cfg, t, cache, megakernel=False)
        diff = max(diff, float((mk - logits).abs().max()))
        rows.append(logits)
    compared = 0
    for step, row in enumerate(rows):
        top2 = row[0].float().topk(2).values
        if float(top2[0] - top2[1]) <= diff:
            continue
        assert int(row.argmax()) == out[step], f"step {step}"
        compared += 1
    print(f"kv{kv_bits}: {compared} of 32 steps compared (largest difference {diff:.3e})")
    assert compared >= 8, f"{compared} of 32 steps compared (largest difference {diff:.3e})"


def _clone(cache):
    cl = lambda t: None if t is None else t.clone()
    return dataclasses.replace(cache, k=cl(cache.k), v=cl(cache.v),
                               k_scale=cl(cache.k_scale), v_scale=cl(cache.v_scale))


# (bits, M, K, N, block, out f32, out_bias): ragged N, partial row slabs,
# the grouped kernel's row edges (8, 72, 81), tiles from 64 x 128 to 16 x 8
DEQ = [(4, 512, 256, 384, 128, False, True), (4, 90, 384, 1028, 128, True, False),
       (8, 33, 256, 132, 64, False, True), (4, 7, 128, 200, 32, False, False),
       (4, 8, 512, 2048, 128, False, False), (8, 72, 256, 1028, 16, True, True),
       (4, 81, 1024, 4096, 64, False, True), (4, 512, 2048, 6144, 128, False, True)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", DEQ)
def test_dequant_matmul_deq_kernel(dev, bits, m, k, n, bs, f32, with_bias, monkeypatch):
    """The dequantize-tile algebra on the bf16 tile kernel's body, in the tile
    `bf16_tile` reports: rel-L2 1e-2 against its plain version, one launch a
    call, the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits)
    ql = rand_ql(g, dev, k, n, bits, 8, 3, with_bias)      # act_bits is ignored
    nb = k // bs
    ql = dataclasses.replace(
        ql, block_size=bs,
        scale=ql.scale[:, :1].expand(3, nb, n).contiguous(),
        bias=(torch.randn((3, nb, n), device=dev, generator=g) * 0.01).to(torch.bfloat16))
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", m)
    tile = dequant_matmul.bf16_tile(m, n, bits)
    assert tile is not None and tile[0] <= max(16, m)
    before = dequant_matmul.KERNEL_DEQ.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(1), out_dtype, deq=True)
    torch.cuda.synchronize()
    assert dequant_matmul.KERNEL_DEQ.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    err = rel(got, want)
    print(f"dequantize-tile M={m} K={k} N={n} W{bits} bs={bs} tile={tile}: rel-L2 {err:.3e}")
    assert err <= 1e-2
    assert torch.equal(got, again)


def rand_experts(g, dev, lead, k, n, bits, bs):
    """An expert stack [*lead, ...] with its own scale and bias per block."""
    packed = torch.randint(-128, 128, (*lead, k * bits // 8, n), dtype=torch.int8,
                           device=dev, generator=g)
    qmax = (1 << bits) - 1
    scale = ((torch.rand((*lead, k // bs, n), device=dev, generator=g) + 0.5)
             * 0.1 / qmax).to(torch.bfloat16)
    bias = (-(qmax / 2) * scale.float()
            + torch.randn((*lead, k // bs, n), device=dev, generator=g) * 2e-3
            ).to(torch.bfloat16)
    return QuantizedLinear(packed=packed, scale=scale, bias=bias, out_bias=None,
                           bits=bits, block_size=bs)


def moe_tile_rows(e, cap, h, mi, sms):
    """The slab height `csrc/moe_prefill.cu` picks (moe_tile), written out
    again: of the tiles that give every SM a block, the least slabs * (rows
    + 16), ties to the taller; the shortest where none fills the card."""
    cols = -(-min(2 * mi, h) // 128)
    best = None
    for rows in (80, 64, 32, 16):
        slabs = -(-cap // rows)
        if e * slabs * cols >= sms and (best is None or slabs * (rows + 16) < best[0]):
            best = (slabs * (rows + 16), rows)
    return 16 if best is None else best[1]


# (bits, E, C, H, mi, block of gate/up, block of down): both algebras per
# product, a partial last slab, a ragged last tile of H, mi = 64 x an odd
# number, C = 1; at E = 20, H = 1024, mi = 512 every slab height is taken:
# C = 72 and 144 rows of 80 (one slab, two), 64 of 64, 81 of 32, 8 of 16
PREFILL_MOE = [(4, 3, 72, 256, 128, 128, 128), (4, 2, 144, 256, 192, 128, 64),
               (8, 2, 24, 128, 64, 64, 64), (4, 2, 100, 192, 64, 64, 32),
               (4, 2, 8, 256, 128, 128, 128), (4, 2, 81, 256, 128, 128, 128),
               (8, 3, 80, 192, 192, 64, 64), (4, 2, 1, 256, 320, 128, 64),
               (4, 20, 72, 1024, 512, 128, 128), (8, 20, 64, 1024, 512, 128, 128),
               (4, 20, 81, 1024, 512, 128, 128), (4, 20, 8, 1024, 512, 128, 128),
               (4, 20, 144, 1024, 512, 128, 64)]


@pytest.mark.parametrize("bits,e,cap,h,mi,bs_h,bs_mi", PREFILL_MOE)
def test_moe_prefill_kernel(dev, bits, e, cap, h, mi, bs_h, bs_mi):
    """Two launches a call in the tile `moe_prefill.tile` reports, rel-L2
    2e-2 against the plain version, empty slots exactly zero, the same bits
    twice."""
    g = torch.Generator(device=dev).manual_seed(e * cap + h)
    gu = rand_experts(g, dev, (e,), h, 2 * mi, bits, bs_h)
    dn = rand_experts(g, dev, (e,), mi, h, bits, bs_mi)
    xe = torch.randn((e, cap, h), device=dev, generator=g).to(torch.bfloat16)
    w_e = torch.rand((e, cap), device=dev, generator=g)
    empty = min(3, cap // 4)
    xe[:, cap - empty:] = 0                  # empty slots
    w_e[:, cap - empty:] = 0
    assert moe_prefill.supports(gu, dn, h, cap)
    tile = moe_prefill.tile(e, cap, h, mi, bits)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tile[:2] == (moe_tile_rows(e, cap, h, mi, sms), 128)
    before = moe_prefill.KERNEL.launches
    got = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
    again = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
    want = moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn)
    torch.cuda.synchronize()
    assert moe_prefill.KERNEL.launches == before + 2
    assert got.shape == (e, cap, h) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = rel(got, want)
    print(f"grouped experts E={e} C={cap} H={h} mi={mi} W{bits} tile={tile}: rel-L2 {err:.3e}")
    assert err <= 2e-2
    assert (got[:, cap - empty:] == 0).all()
    assert torch.equal(got, again)


def moe_cfg(h, e, k, mi, si):
    return ModelConfig(name="moe-test", vocab_size=256, hidden_size=h,
                       intermediate_size=256, num_layers=3, num_heads=2,
                       num_kv_heads=1, head_dim=64, num_experts=e,
                       num_experts_per_tok=k, moe_intermediate_size=mi,
                       shared_expert_intermediate_size=si)


# (bits, n, H, E, k, mi, si, with gate); down quant blocks of 64 where mi is
# not a multiple of 128. After the first four, the edges of the item table at
# full width: n = 2, 4, 8 with a shared expert (gate/up tiles cut into K
# ranges at n = 1 and 4, whole at 2 and 8), k = 8 with mi = 768 and none,
# W8, and down blocks of 64 (mi = 1344)
DECODE_MOE = [(4, 1, 256, 6, 2, 128, 256, True), (4, 3, 256, 6, 4, 192, 0, False),
              (8, 8, 128, 4, 2, 64, 128, False), (4, 5, 2048, 8, 4, 1408, 1024, True),
              (4, 2, 2048, 8, 4, 1408, 5632, True), (4, 4, 2048, 8, 4, 1408, 5632, True),
              (4, 8, 2048, 16, 4, 1408, 5632, True), (4, 1, 2048, 16, 8, 768, 0, False),
              (4, 4, 2048, 16, 8, 768, 0, False), (8, 1, 2048, 8, 4, 1408, 5632, True),
              (8, 4, 2048, 16, 8, 768, 0, False), (4, 4, 2048, 8, 4, 1344, 5632, True)]


@pytest.mark.parametrize("bits,n,h,e,k,mi,si,with_gate", DECODE_MOE)
def test_moe_decode_kernel(dev, bits, n, h, e, k, mi, si, with_gate):
    cfg = moe_cfg(h, e, k, mi, si)
    nl = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(n * h + e)
    bs_mi = 128 if mi % 128 == 0 else 64
    lay = decoder.LayerParams(
        wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
        wgu_e=rand_experts(g, dev, (nl, e), h, 2 * mi, bits, 128),
        wdown_e=rand_experts(g, dev, (nl, e), mi, h, bits, bs_mi),
        wgu_shared=rand_experts(g, dev, (nl,), h, 2 * si, bits, 128) if si else None,
        wdown_shared=rand_experts(g, dev, (nl,), si, h, bits, 128) if si else None)
    x = torch.randn((n, h), device=dev, generator=g) * 0.5
    sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k] for _ in range(n)])
    wsel = torch.rand((n, k), device=dev, generator=g)
    gate = torch.rand((n,), device=dev, generator=g) if with_gate else None
    assert moe_decode.supports(cfg, lay, n)
    before = moe_decode.KERNEL.launches
    got = moe_decode.moe_decode_mlp(x, lay, sel, wsel, 2, gate, config=cfg)
    again = moe_decode.moe_decode_mlp(x, lay, sel, wsel, 2, gate, config=cfg)
    want = moe_decode.moe_decode_mlp_plain(x, lay, sel, wsel, 2, gate, config=cfg)
    torch.cuda.synchronize()
    assert moe_decode.KERNEL.launches == before + 2
    assert got.shape == (n, h) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = rel(got, want)
    sch = moe_decode.schedule(n, k, h, mi, si, bits, 128, bs_mi, 128 if si else 0,
                              128 if si else 0, *moe_decode.launch_shape(dev, n, bits))
    print(f"fused experts n={n} H={h} E={e} k={k} mi={mi} si={si} W{bits}: rel-L2 {err:.3e}, "
          f"{sch.n_items} items ({sch.gu_items} gate/up), rd {sch.rd}, sd {sch.sd}")
    assert err <= 2e-2
    assert torch.equal(got, again)           # the same bits from run to run


def test_moe_decode_one_launch_replays_without_reset(dev):
    """The fused expert kernel at qwen1.5-moe-a2.7b's widths (n = 4, gate/up
    tiles cut into K ranges): one device launch a call (torch.profiler sees
    one kernel), three calls in a row and a captured CUDA graph of two
    calls, replayed three times, give the first call's bits with no host
    reset of the ticket or the counters; a call at another shape in between
    keeps its own counters."""
    cfg, other = moe_cfg(2048, 8, 4, 1408, 5632), moe_cfg(2048, 16, 8, 768, 0)
    g = torch.Generator(device=dev).manual_seed(12)

    def case(c, n):
        nl, e, k, mi, si = c.num_layers, c.num_experts, c.num_experts_per_tok, \
            c.moe_intermediate_size, c.shared_expert_intermediate_size
        lay = decoder.LayerParams(
            wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
            wgu_e=rand_experts(g, dev, (nl, e), 2048, 2 * mi, 4, 128),
            wdown_e=rand_experts(g, dev, (nl, e), mi, 2048, 4, 128),
            wgu_shared=rand_experts(g, dev, (nl,), 2048, 2 * si, 4, 128) if si else None,
            wdown_shared=rand_experts(g, dev, (nl,), si, 2048, 4, 128) if si else None)
        x = torch.randn((n, 2048), device=dev, generator=g) * 0.5
        sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k]
                           for _ in range(n)]).to(torch.int32)
        wsel = torch.rand((n, k), device=dev, generator=g)
        gate = torch.rand((n,), device=dev, generator=g) if si else None
        return lambda li: moe_decode.moe_decode_mlp(x, lay, sel, wsel, li, gate, config=c)

    run, run2 = case(cfg, 4), case(other, 1)
    first, first2 = run(1), run2(2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = moe_decode.KERNEL.launches
    with torch.profiler.profile(activities=acts) as prof:
        run(1)
        torch.cuda.synchronize()
    assert moe_decode.KERNEL.launches == before + 1
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count > 0
               and ev.self_device_time_total > 0]
    assert [ev.count for ev in kernels] == [1], [(ev.key, ev.count) for ev in kernels]
    assert "moe_decode_kernel" in kernels[0].key
    for _ in range(3):
        assert torch.equal(run(1), first)
        assert torch.equal(run2(2), first2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static, static2 = run(1), run2(2)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, first) and torch.equal(static2, first2)


# --------------------------------------------------------------------------
# the continuous-batching engine and the server on the card
# --------------------------------------------------------------------------

ENGINE_MOE = ModelConfig(name="moe-engine-test", vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=64, attention_bias=True, tie_word_embeddings=False,
                         num_experts=6, num_experts_per_tok=2, moe_intermediate_size=128,
                         shared_expert_intermediate_size=256)
ENGINE_STEPS = 8      # the steps each request is held to its batch-1 run


def _engine_llm(dev, cfg, cap=256, **kw):
    rt = RuntimeConfig(max_seq_len=cap, prefill_chunk=64, decode_block=8,
                       sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                       max_new_tokens=16, **kw)
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(4), scale=0.05,
                                        lm_head_bits=4, device=dev)
    return Llm(cfg, params, rt, device=dev)


def _single_rows(llm, ids):
    """Batch-1 greedy run on the card: ENGINE_STEPS + 1 logit rows, the
    tokens it fed."""
    from mnn_tpu_torch.runtime import generate

    dev = llm.device
    logits, cache = generate.run_prefill(llm.params, llm.config, llm.rt,
                                         torch.tensor([ids], device=dev), llm._new_cache())
    rows, toks = [logits.float()], []
    for _ in range(ENGINE_STEPS):
        toks.append(int(rows[-1].argmax()))
        logits, cache = decoder.forward(llm.params, llm.config,
                                        torch.tensor([[toks[-1]]], device=dev), cache)
        rows.append(logits.float())
    return rows, toks


def _hold_to_single_stream(llm, rt, prompts, served):
    """`chip_smoke.py`'s rule for batched serving: the prompts prefilled
    into the slots of a cache as wide as the engine (a short group padded
    with its own prompts), decoded teacher-forced with the batch-1 tokens;
    the batched rows within rel-L2 5e-2 of the batch-1 rows, and each served
    request's tokens equal to the batch-1 ones at every step whose batch-1
    top-2 margin is above the largest difference seen, up to the first step
    under a smaller margin whose token differs. Returns the steps
    compared."""
    from mnn_tpu_torch.runtime import batch_engine

    c, dev, b = llm.config, llm.device, rt.max_batch
    singles = [_single_rows(llm, ids) for ids in prompts]
    compared = 0
    for g0 in range(0, len(prompts), b):
        idx = list(range(g0, min(g0 + b, len(prompts))))
        group = (idx * b)[:b]
        cache = kvcache.create(c.num_layers, b, c.num_kv_heads, rt.max_seq_len, c.head_dim,
                               kv_bits=rt.kv_bits, device=dev)
        rows = [[batch_engine.prefill_slot(llm.params, c, rt, cache, prompts[i], slot).float()]
                for slot, i in enumerate(group)]
        for s in range(ENGINE_STEPS):
            tok = torch.tensor([[singles[i][1][s]] for i in group], device=dev)
            logits, cache = decoder.forward(llm.params, c, tok, cache)
            for slot, r in enumerate(rows):
                r.append(logits[slot:slot + 1].float())
        for slot, i in enumerate(idx):
            want, fed = singles[i]
            diff = max(float((a - w).abs().max()) for a, w in zip(rows[slot], want))
            for s, (a, w) in enumerate(zip(rows[slot], want)):
                assert torch.isfinite(a).all() and rel(a, w) <= 5e-2, (i, s)
            for s in range(ENGINE_STEPS):
                top2 = want[s][0].topk(2).values
                if float(top2[0] - top2[1]) <= diff:
                    if served[i][s] != fed[s]:
                        break       # the contexts part here
                    continue
                assert served[i][s] == fed[s], f"request {i} step {s}"
                compared += 1
    return compared


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_engine_four_slots_matches_single_stream(dev, kind):
    """Six requests of ragged lengths on a 4-slot engine (so two are
    admitted between decode blocks, beside idle slots decoding filler):
    3-layer dense through the whole-model kernel's batch-4 build, 2-layer
    mixture of experts through the fused expert and decode-step kernels at
    4 tokens. Each request is held to its batch-1 run on the card."""
    from mnn_tpu_torch.runtime.batch_engine import BatchEngine, Status

    cfg = dataclasses.replace(MK, tie_word_embeddings=False) if kind == "dense" else ENGINE_MOE
    llm = _engine_llm(dev, cfg)
    rt = dataclasses.replace(llm.rt, max_batch=4)
    prompts = [list(range(3 + i, 3 + i + n)) for i, n in enumerate((17, 90, 5, 130, 40, 64))]
    eng = BatchEngine(cfg, llm.params, rt)
    build.reset_launches()
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in build.KERNELS}
    assert all(r.status == Status.DONE and len(r.generated) == 16 for r in reqs)
    if kind == "dense":
        assert n["mnn_decode_model"] > 0 and n["mnn_decode_model"] % rt.decode_block == 0
        assert n["mnn_decode_step"] == 0 and n["mnn_dequant_matmul_a8"] > 0
    else:
        assert n["mnn_decode_model"] == 0 and n["mnn_moe_prefill"] > 0
        assert n["mnn_moe_decode"] == n["mnn_decode_step"] > 0
        assert n["mnn_moe_decode"] % (cfg.num_layers * rt.decode_block) == 0
    compared = _hold_to_single_stream(llm, rt, prompts, [r.generated for r in reqs])
    print(f"{kind}: {compared} of {len(prompts) * ENGINE_STEPS} steps compared; launches {n}")
    assert compared >= 2 * len(prompts)


def test_engine_slot_to_capacity_with_idle_rows(dev):
    """Three long requests one after another in slot 0 of a 4-slot engine at
    capacity 64 (prompts truncated to 43 tokens, 20 new, decode blocks of
    8): the slot runs past the capacity in its last block and three idle
    rows decode filler until their lengths reach it too; the whole-model
    kernel writes and attends clamped at the last position throughout."""
    from mnn_tpu_torch.runtime.batch_engine import BatchEngine

    cfg = dataclasses.replace(MK, tie_word_embeddings=False)
    llm = _engine_llm(dev, cfg, cap=64)
    rt = dataclasses.replace(llm.rt, max_batch=4)
    eng = BatchEngine(cfg, llm.params, rt)
    prompts = [list(range(10 + 7 * i, 60 + 7 * i)) for i in range(3)]
    compared = 0
    for i, p in enumerate(prompts):
        req = eng.submit(p, 20)
        eng.run_until_idle()
        assert len(req.generated) == 20
        assert eng.cache.length.tolist() == [64] + [min(24 * (i + 1), 64)] * 3
        compared += _hold_to_single_stream(llm, dataclasses.replace(rt, max_batch=4),
                                           [p[-43:]], [req.generated])
    assert compared >= 3
    logits, _ = decoder.forward(llm.params, cfg, eng.last_tokens[:, None], eng.cache)
    assert torch.isfinite(logits).all()


def test_server_answers_two_concurrent_engine_requests(dev):
    """The server's handler over a 4-slot engine on the card, the engine on
    its own thread: two completions with logprobs at once, each the text
    and the logprobs that the engine gives the same ids alone."""
    import json
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    from mnn_tpu_torch.runtime.batch_engine import BatchEngine
    from mnn_tpu_torch.serve.server import make_handler

    cfg = dataclasses.replace(MK, tie_word_embeddings=False)
    llm = _engine_llm(dev, cfg)
    eng = BatchEngine(cfg, llm.params, dataclasses.replace(llm.rt, max_batch=4))
    prompts = ["first request on the card", "and a second, longer one beside it"]
    want = []
    for p in prompts:
        r = eng.submit(llm.tokenizer.encode(p), 12, logprobs=1)
        eng.run_until_idle()
        want.append([r.out.get() for _ in range(12)])
    stop = threading.Event()
    worker = threading.Thread(target=eng.run_forever, args=(stop,), daemon=True)
    worker.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(llm, threading.Lock(), eng))
    front = threading.Thread(target=httpd.serve_forever, daemon=True)
    front.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions"

    def ask(p):
        req = urllib.request.Request(
            url, data=json.dumps(dict(prompt=p, max_tokens=12, logprobs=1)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with ThreadPoolExecutor(2) as ex:
            bodies = [f.result(timeout=180) for f in [ex.submit(ask, p) for p in prompts]]
    finally:
        httpd.shutdown()
        httpd.server_close()
        stop.set()
        worker.join(timeout=60)
        front.join(timeout=60)
    assert not worker.is_alive() and not front.is_alive()
    for body, items in zip(bodies, want):
        choice = body["choices"][0]
        assert choice["text"] == llm.tokenizer.decode([t for t, _, _ in items])
        assert choice["logprobs"]["token_logprobs"] == pytest.approx(
            [lp for _, lp, _ in items], abs=1e-4)


# --------------------------------------------------------------------------
# checkpoints on the card: load, convert, and serve a loaded model
# --------------------------------------------------------------------------

def write_hf_dir(path, cfg, seed=0):
    """An HF-layout qwen2 directory of `cfg` (HF names, bf16, std 0.05),
    written with the port's own writer: no transformers on the card's
    machine."""
    from mnn_tpu_torch.convert import stfile

    g = torch.Generator().manual_seed(seed)
    h = cfg.hidden_size
    rnd = lambda *s, mean=0.0: (torch.randn(s, generator=g) * 0.05 + mean).to(torch.bfloat16)
    t = {"model.embed_tokens.weight": rnd(cfg.vocab_size, h), "model.norm.weight": rnd(h, mean=1)}
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = rnd(cfg.vocab_size, h)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for name, n in (("q", cfg.q_dim), ("k", cfg.kv_dim), ("v", cfg.kv_dim)):
            t[p + f"self_attn.{name}_proj.weight"] = rnd(n, h)
            t[p + f"self_attn.{name}_proj.bias"] = rnd(n)
        t[p + "self_attn.o_proj.weight"] = rnd(h, cfg.q_dim)
        t[p + "mlp.gate_proj.weight"] = rnd(cfg.intermediate_size, h)
        t[p + "mlp.up_proj.weight"] = rnd(cfg.intermediate_size, h)
        t[p + "mlp.down_proj.weight"] = rnd(h, cfg.intermediate_size)
        t[p + "input_layernorm.weight"] = rnd(h, mean=1)
        t[p + "post_attention_layernorm.weight"] = rnd(h, mean=1)
    path.mkdir()
    stfile.save_file(t, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(dict(
        architectures=["Qwen2ForCausalLM"], vocab_size=cfg.vocab_size, hidden_size=h,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        rope_theta=cfg.rope_theta, tie_word_embeddings=cfg.tie_word_embeddings)))
    return str(path)


def same_params(a, b):
    from mnn_tpu_torch.convert.checkpoint import flatten

    (ta, qa), (tb, qb) = flatten(a), flatten(b)
    assert qa == qb and sorted(ta) == sorted(tb)
    for k, x in ta.items():
        y = tb[k].to(x.device)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)), k


# (bits, lm_head_bits, sym, tied)
CONVERT = [(4, 4, False, True), (8, 0, False, True), (4, 8, True, False), (8, 0, True, False)]


@pytest.mark.parametrize("bits,head_bits,sym,tied", CONVERT)
def test_convert_hf_card_equals_cpu(dev, tmp_path, bits, head_bits, sym, tied):
    """`convert_hf` quantizes on the card to the CPU's bytes, and
    `load_checkpoint(device="cuda")` reads back the CPU load's bytes."""
    from mnn_tpu_torch.convert.checkpoint import load_checkpoint
    from mnn_tpu_torch.convert.hf import convert_hf

    cfg = dataclasses.replace(MK, tie_word_embeddings=tied)
    src = write_hf_dir(tmp_path / "hf", cfg)
    kw = dict(bits=bits, block_size=128, sym=sym, lm_head_bits=head_bits)
    _, card = convert_hf(src, str(tmp_path / "card"), device=dev, **kw)
    _, cpu = convert_hf(src, str(tmp_path / "cpu"), device="cpu", **kw)
    assert card.embedding.is_cuda and not cpu.embedding.is_cuda
    same_params(card, cpu)
    _, loaded_card, _ = load_checkpoint(str(tmp_path / "cpu"), device="cuda")
    _, loaded_cpu, _ = load_checkpoint(str(tmp_path / "card"), device="cpu")
    assert loaded_card.embedding.is_cuda
    same_params(loaded_card, loaded_cpu)
    same_params(loaded_card, card)


@pytest.mark.parametrize("head_bits", [4, 0])
def test_loaded_model_serves_as_in_memory(dev, tmp_path, head_bits):
    """A model loaded onto the card gives the greedy tokens of the same
    params in memory, through the whole-model kernel (its head fused at int4,
    outside it when the tied bf16 embedding is the head)."""
    from mnn_tpu_torch.convert.hf import convert_hf

    src = write_hf_dir(tmp_path / "hf", MK, seed=3)
    cfg, params = convert_hf(src, str(tmp_path / "ckpt"), lm_head_bits=head_bits, device=dev)
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4, sampler="greedy",
                       prefill_act_bits=8, max_new_tokens=6)
    loaded = Llm.from_pretrained(str(tmp_path / "ckpt"), rt=rt, device=dev)
    assert loaded.device.type == "cuda"
    assert loaded.info()["decode_fused_head"] == bool(head_bits)
    ids = list(range(3, 48))
    runs = []
    for llm in (loaded, Llm(cfg, params, rt, device=dev)):
        build.reset_launches()
        runs.append((list(llm.stream(token_ids=ids)), decode_model.KERNEL.launches))
    assert runs[0] == runs[1] and runs[0][1] == rt.max_new_tokens


# --------------------------------------------------------------------------
# the gemma family: the decode step at head_dim 256, the whole-model kernel
# with gemma's flags, the quantizers' bytes, the slice against the CPU
# --------------------------------------------------------------------------

# (B, Hkv, G, int8 cache, qk-norm, window, softcap, lengths) at head_dim 256
DECODE_D256 = [(1, 4, 2, True, False, 4096, 50.0, (331,)),
               (4, 4, 2, True, False, 0, 50.0, (331, 0, 1023, 64)),
               (1, 4, 2, False, False, 0, 50.0, (1000,)),
               (1, 4, 2, True, True, 1024, 0.0, (900,)),
               (2, 1, 4, False, True, 0, 0.0, (17, 1023)),
               (1, 2, 8, True, False, 0, 0.0, (500,)),
               (1, 8, 1, True, False, 0, 30.0, (64,))]


@pytest.mark.parametrize("b,hkv,grp,int8,qkn,window,softcap,lengths", DECODE_D256)
def test_decode_step_d256_kernel(dev, b, hkv, grp, int8, qkn, window, softcap, lengths):
    """Row 6 at gemma's head_dim 256: one launch a call, the same bits twice,
    the plain version's result (`check_decode_step`)."""
    nl, s, d = 2, 1024, 256
    g = torch.Generator(device=dev).manual_seed(b * hkv + grp + sum(lengths))
    kc, vc, ks, vs = rand_cache(g, dev, nl, b, hkv, s, d, 8 if int8 else 16)
    qkv = (torch.randn((b, hkv, grp + 2, d), device=dev, generator=g) * 2).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, d // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    norms = ((torch.rand(d, device=dev, generator=g) + 0.5,
              torch.rand(d, device=dev, generator=g) + 0.5) if qkn else (None, None))
    check_decode_step(qkv, kc, vc, ks, vs, lens, cos, sin, norms, window, 0, softcap, int8)


G2_MK = dataclasses.replace(MK, attention_bias=False, mlp_act="gelu_tanh", embed_scale=True,
                            sandwich_norm=True, attn_softcap=50.0, final_softcap=30.0,
                            query_scale=64.0 ** -0.5, swa_every_other=True, sliding_window=6)
G3_MK = dataclasses.replace(MK, attention_bias=False, mlp_act="gelu_tanh", embed_scale=True,
                            sandwich_norm=True, qk_norm=True, swa_pattern=3,
                            rope_local_theta=1000.0, sliding_window=6)
# (config, kv bits, head bits, lengths)
DECODE_MODEL_GEMMA = [
    (G2_MK, 8, 4, (9,)), (G2_MK, 16, 4, (100, 3, 64, 127)), (G2_MK, 8, 0, (5, 40)),
    (G3_MK, 8, 4, (70,)), (G3_MK, 16, 4, (1, 65)),
    (dataclasses.replace(G2_MK, head_dim=256, num_layers=2, query_scale=256.0 ** -0.5),
     8, 4, (90, 0, 127)),
    (dataclasses.replace(G3_MK, head_dim=256, hidden_size=512, num_heads=8, num_kv_heads=4,
                         intermediate_size=1024), 16, 4, (120,)),
    (dataclasses.replace(MK, mlp_act="gelu_tanh"), 8, 4, (33,)),
    (dataclasses.replace(MK, attn_softcap=5.0), 4, 4, (50, 7)),
]


@pytest.mark.parametrize("cfg,kv_bits,head_bits,lengths", DECODE_MODEL_GEMMA)
def test_decode_model_gemma_kernel(dev, cfg, kv_bits, head_bits, lengths):
    """Row 7 with gemma's flags (sandwich norms, GeGLU, softcap, alternating
    and N:1 windows, local rope phases) and at head_dim 256, against its
    plain version from the same state with every norm random; the same bits
    twice, the rows written in place."""
    b, s = len(lengths), 128
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(b + kv_bits),
                                        scale=0.05, lm_head_bits=head_bits, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda t: None if t is None else torch.rand(t.shape, device=dev, generator=g) * 0.8 + 0.6
    lay = params.layers
    lay = dataclasses.replace(lay, **{f: rnd(getattr(lay, f)) for f in (
        "input_norm", "post_norm", "pre_ffn_norm", "post_ffn_norm", "q_norm", "k_norm")})
    kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, s, cfg.head_dim,
                                kv_bits)
    x = (torch.randn((b, cfg.hidden_size), device=dev, generator=g) * 0.5).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    phases = []
    for _ in range(2):
        ang = torch.rand((b, cfg.head_dim // 2), device=dev, generator=g) * 6.28
        phases += [torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)]
    cos, sin, cos_l, sin_l = phases
    head = params.lm_head if head_bits else None
    kw = dict(config=cfg, head=head, final_norm=rnd(params.final_norm))
    if cfg.swa_pattern:
        kw.update(cos_l=cos_l, sin_l=sin_l)
    want = decode_model.fused_decode_model_plain(x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)
    before = decode_model.KERNEL.launches
    got = decode_model.fused_decode_model(x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)
    again = decode_model.fused_decode_model(x, lay, kc, vc, ks, vs, lens, cos, sin,
                                            write_cache=True, **kw)
    torch.cuda.synchronize()
    assert decode_model.KERNEL.launches == before + 2
    assert all(torch.isfinite(t).all() for t in got if t is not None)
    m = decode_model.parity_metrics(got, want, kv_bits)
    info = decode_model.schedule_info(cfg, lay, head, b, s, dev)
    print(f"{cfg.name} D={cfg.head_dim} flags={decode_model.model_flags(cfg)} kv{kv_bits} "
          f"lengths={lengths}: {m}; grid {info['grid']}, ring {info['slots']} slots")
    assert not decode_model.parity_failures(m), m
    for a, c in zip(got, again):
        assert a is None or torch.equal(a, c)
    pos = lens.long().clamp(0, s - 1)
    bi = torch.arange(b, device=dev)
    assert torch.equal(kc[:, bi, :, pos].float(), got[1][:, :, :, 0].transpose(0, 1))


def test_quantizers_card_equals_cpu(dev):
    """The KV and activation quantizers give the CPU's bytes on the card
    (every divisor a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal). Rows of bf16 values put many quotients on
    a rounding tie, where an ulp decides the level."""
    from mnn_tpu_torch.quant.quantize import quantize_activations_int8

    g = torch.Generator().manual_seed(0)
    x = (torch.randn((64, 8, 256), generator=g) * 3).to(torch.bfloat16)
    x[0, 0, :4] = torch.tensor([7.0, 3.5, -0.5, 1.5])     # ties at absmax 7
    for fn in (kvcache.quantize_kv, kvcache.quantize_kv4,
               lambda t: quantize_activations_int8(t.reshape(-1, t.shape[-1]))):
        cpu = fn(x)
        card = fn(x.to(dev))
        for a, c in zip(cpu, card):
            assert torch.equal(a, c.cpu()), fn


@pytest.mark.parametrize("cfg", [G2_MK, G3_MK])
def test_gemma_slice_card_matches_cpu(dev, cfg):
    """A tiny gemma through `Llm` on the card and through the plain versions
    on the CPU: one whole-model launch a decode step, no flash prefill or
    flash decode launch (gemma's prefill is the eager path), the tokens
    where the CPU's margins are clear; then 3 steps over an int4 cache (the
    eager path, no decode kernel at all)."""
    for kv_bits in (8, 4):
        rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                           sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                           kv_bits=kv_bits, max_new_tokens=6)
        ids = list(range(3, 48))
        runs = []
        for device in (dev, "cpu"):
            params = decoder.init_random_params(cfg, torch.Generator().manual_seed(1),
                                                scale=0.05, lm_head_bits=4, device=device)
            llm = Llm(cfg, params, rt, device=device)
            build.reset_launches()
            toks = list(llm.stream(token_ids=ids))
            runs.append((toks, llm.last_prefill_logits.float().cpu(),
                         {k.name: k.launches for k in build.KERNELS}))
        (card_toks, card, card_n), (cpu_toks, cpu, cpu_n) = runs
        assert card_n["mnn_flash_prefill"] == 0 and card_n["mnn_flash_decode"] == 0
        assert card_n["mnn_decode_model"] == (rt.max_new_tokens if kv_bits == 8 else 0)
        assert card_n["mnn_decode_step"] == 0 and card_n["mnn_dequant_matmul_a8"] > 0
        assert not any(cpu_n.values())
        assert torch.isfinite(card).all() and rel(card, cpu) <= 5e-2
        top2 = cpu[0].topk(2).values
        if float(top2[0] - top2[1]) > float((card - cpu).abs().max()):
            assert card_toks[0] == cpu_toks[0]


# --------------------------------------------------------------------------
# W2 and W3 weights: rows 1a, 1b, 2, 3 and 7 at the same bounds as their
# W4 cases. Blocks of 128 (the served ones) and the unpacks' edges: W2 blocks
# of 8, 16 and 40 K values (the a8 kernel transposes four 2-bit rows at a
# time from blocks of 16 on, W3 from 32 on, and stores bytes below), W3
# blocks of 8, 24 and 32 (a 64-row unit of the whole-model kernel then
# touches 6 quant blocks, W2's 8).
# --------------------------------------------------------------------------

# (bits, K, N, block, out f32, out_bias)
GEMV_W23 = [(3, 896, 1152, 128, False, True), (2, 4864, 896, 128, False, False),
            (3, 896, 151936, 128, True, False), (2, 896, 151936, 128, True, False),
            (3, 4864, 200, 128, True, True), (2, 320, 1028, 40, False, True),
            (3, 128, 132, 8, True, False), (3, 960, 200, 24, False, False),
            (2, 256, 1028, 8, False, True)]


@pytest.mark.parametrize("bits,k,n,bs,f32,with_bias", GEMV_W23)
def test_w23_gemv_kernel(dev, bits, k, n, bs, f32, with_bias):
    """Row 1a at W2/W3: the split GEMV, rel-L2 1e-2 and the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(k + n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 16, 2, with_bias, bs=bs)
    x = torch.randn((1, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    cols, ranges, blocks, smem = dequant_matmul.gemv_split(k, n, bits, bs)
    print(f"W{bits} K={k} N={n} block {bs}: {ranges} K ranges, {blocks} blocks, smem {smem}")
    kern, other = dequant_matmul.KERNEL_BF16, dequant_matmul.KERNEL_BF16_TILE
    before, before_other = kern.launches, other.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(1), out_dtype)
    torch.cuda.synchronize()
    assert kern.launches == before + 2 and other.launches == before_other
    assert got.dtype == out_dtype and got.shape == (1, n) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert rel(got, want) <= 1e-2


# (bits, M, K, N, block, out f32, out_bias)
A8_W23 = [(3, 512, 896, 1152, 128, False, True), (2, 512, 4864, 896, 128, False, False),
          (3, 512, 896, 9728, 128, False, False), (2, 130, 896, 1028, 32, True, True),
          (3, 300, 384, 1028, 64, False, False), (3, 33, 256, 132, 8, True, True),
          (2, 77, 960, 200, 40, True, True), (2, 1, 256, 200, 16, False, True),
          (3, 200, 960, 2048, 24, False, False), (2, 64, 256, 1028, 8, False, False)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", A8_W23)
def test_w23_a8_kernel(dev, bits, m, k, n, bs, f32, with_bias):
    """Row 2 at W2/W3: the pattern re-centred on 2^(bits-1) (-2..1, -4..3),
    W3's planes joined before the int8 products, so the same bits as the
    plain version, and from run to run."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 8, 3, with_bias, bs)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    print(f"a8 W{bits} M={m} K={k} N={n} bs={bs}: tile {dequant_matmul.a8_tile(m, n, bits)}")
    before = dequant_matmul.KERNEL_A8.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(2), out_dtype)
    torch.cuda.synchronize()
    assert dequant_matmul.KERNEL_A8.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (m, n) and torch.isfinite(got).all()
    assert rel(got, want) <= 1e-2
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) == 0.0


# (bits, M, K, N, block, out f32, out_bias)
ROWS_W23 = [(3, 512, 896, 1152, 128, False, True), (2, 512, 4864, 896, 128, False, False),
            (3, 512, 896, 9728, 128, False, False), (2, 2, 256, 200, 16, False, True),
            (3, 16, 384, 1028, 8, False, False), (2, 33, 960, 200, 40, True, True),
            (3, 130, 896, 1028, 32, True, True), (3, 64, 960, 2048, 24, False, False),
            (2, 130, 512, 200, 8, True, False)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", ROWS_W23)
def test_w23_rows_kernel(dev, bits, m, k, n, bs, f32, with_bias):
    """Row 1b at W2/W3: bf16 rows at M > 1 on the tensor-core tile kernel, in
    the tile `bf16_tile` reports; rel-L2 1e-2 and the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 16, 3, with_bias, bs)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    tile = dequant_matmul.bf16_tile(m, n, bits)
    assert tile is not None
    kern, other = dequant_matmul.KERNEL_BF16_TILE, dequant_matmul.KERNEL_BF16
    before, before_other = kern.launches, other.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(2), out_dtype)
    torch.cuda.synchronize()
    assert kern.launches == before + 2 and other.launches == before_other
    assert got.dtype == out_dtype and got.shape == (m, n) and torch.isfinite(got).all()
    err = rel(got, want)
    print(f"bf16 rows W{bits} M={m} K={k} N={n} bs={bs} tile={tile}: rel-L2 {err:.3e}")
    assert err <= 1e-2
    assert torch.equal(got, again)


# (bits, M, K, N, block, out f32, out_bias)
DEQ_W23 = [(3, 512, 896, 1152, 128, False, True), (2, 512, 4864, 896, 128, False, False),
           (2, 90, 256, 1028, 32, True, False), (3, 33, 384, 200, 16, False, True),
           (3, 7, 128, 200, 32, False, False), (2, 81, 1024, 4096, 64, False, True)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", DEQ_W23)
def test_w23_deq_kernel(dev, bits, m, k, n, bs, f32, with_bias, monkeypatch):
    """Row 3 at W2/W3: bf16(q * s + m) on the whole code (W3's planes joined
    first), rel-L2 1e-2, one launch a call, the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 16, 3, with_bias, bs)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", m)
    before = dequant_matmul.KERNEL_DEQ.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(1), out_dtype, deq=True)
    torch.cuda.synchronize()
    assert dequant_matmul.KERNEL_DEQ.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (m, n) and torch.isfinite(got).all()
    err = rel(got, want)
    print(f"dequantize-tile W{bits} M={m} K={k} N={n} bs={bs}: rel-L2 {err:.3e}")
    assert err <= 1e-2
    assert torch.equal(got, again)


# (config changes, weight bits, kv bits, lengths, quant block): the head
# stays off the kernel at W2/W3, as in the JAX package. The int4 case at
# len_old 0 is `test_w23_decode_model_kernel_int4_len_old_0`.
DECODE_MODEL_W23 = [
    ({}, 3, 8, (9,), 128), ({}, 2, 8, (40,), 128), ({}, 3, 4, (3, 65), 128),
    ({}, 3, 8, (0, 65), 128),
    ({}, 2, 16, (1, 63, 64, 65), 128), ({}, 3, 8, (127, 5, 9, 33, 1, 0, 64, 100), 128),
    ({}, 2, 8, (9,), 32), ({}, 3, 8, (9, 70), 32), ({}, 3, 8, (12,), 64),
    (dict(hidden_size=512, head_dim=128, intermediate_size=1024), 2, 8, (63, 64, 65), 32),
]


@pytest.mark.parametrize("changes,bits,kv_bits,lengths,bs", DECODE_MODEL_W23)
def test_w23_decode_model_kernel(dev, changes, bits, kv_bits, lengths, bs):
    """Row 7 at W2/W3, batch 1 to 8 (the 1-, 2-, 4- and 8-row builds), blocks
    of 32 to 128: the kernel against its plain version as the W4 cases are
    held, and its ring sized for the layers' bits."""
    deep4 = dict(rows_levels=1.0, rows_rel=1.5e-1) if kv_bits == 4 else {}
    check_decode_model(dev, changes, bits, kv_bits, 0, lengths, quant_block=bs, **deep4)
    b = decode_model.bucket(len(lengths))
    lim = decode_model.LIMITS(b, dataclasses.replace(MK, **changes).head_dim, bits)
    assert lim[2] == decode_model.ring_slots(b, dataclasses.replace(MK, **changes).head_dim,
                                             bits)


def test_w23_decode_model_kernel_int4_len_old_0(dev, monkeypatch):
    """Row 7 at W3 over an int4 cache, one sequence at len_old 0: its new V
    row is then each layer's whole attention output (one key, weight 1).
    Where a V value lies on an int4 level boundary, the kernel's own
    rounding (qkv summed in another order, the 1-bit plane apart; its own
    division by the scale) can take the other level, a step of a seventh
    of the row's largest value that the later layers carry into x. Held:
    every metric but x_rel at the other int4 cases' bounds (layer 0 within
    one level); each V level of layer 0 that differs from the plain
    version's sits on a level boundary of the plain version's value, within
    what one bf16 step of the value and the row's scale difference move it
    (so the flip is rounding); and x_out within x_rel of the plain version
    attending over the kernel's own stored rows."""
    got, _, plain = check_decode_model(dev, {}, 3, 4, 0, (0, 65), skip=("x_rel",),
                                       rows_levels=1.0, rows_rel=1.5e-1)
    unpack = lambda r: kvcache.unpack_kv4(r.to(torch.int8))
    seen, quant = [], decode_model._quant_kv

    def record(x, qmax):
        seen.append(x)
        return quant(x, qmax)
    monkeypatch.setattr(decode_model, "_quant_kv", record)
    want = plain()
    v_sc = want[4][0][..., None]                      # layer 0, [B, Hkv, 1, 1]
    t = seen[1] / v_sc                                # its V values in levels
    lg, lw = unpack(got[2][0]), unpack(want[2][0])
    assert torch.equal(lw, t.round().clamp(-8, 7))
    flip = lg != lw
    sc_rel = (got[4][0][..., None] - v_sc).abs() / v_sc
    off = (t - (lg + lw) / 2).abs()
    slack = t.abs() * (2.0 ** -7 + sc_rel) + 1e-6
    print(f"W3 kv4 len_old 0,65: {int(flip.sum())} V levels of layer 0 differ, "
          f"at most {float(off[flip].max()) if flip.any() else 0.0:.3e} from a boundary")
    assert bool((off <= slack)[flip].all())
    rows = iter([(unpack(got[j][i]), got[j + 2][i][..., None])
                 for i in range(MK.num_layers) for j in (1, 2)])
    monkeypatch.setattr(decode_model, "_quant_kv", lambda x, qmax: next(rows))
    forced = plain()
    err = rel(got[0], forced[0])
    print(f"W3 kv4 len_old 0,65: x rel-L2 {rel(got[0], want[0]):.3e} against the plain "
          f"version, {err:.3e} against it over the kernel's rows")
    assert err <= decode_model.PARITY_BOUNDS["x_rel"]


# --------------------------------------------------------------------------
# KV variants: row 5 over one bf16 layer and a stacked int8 cache, the
# codebook quantizers, compact_tail, and a small model under each variant
# --------------------------------------------------------------------------

# (Hkv, G, D, kv_len, capacity): qwen2-0.5b's heads at 331 and 631 of 1,024
# (the last decode step of the 300- and 600-token requests), then the
# qwen1.5-moe-a2.7b heads and a window
FLASH_DECODE_LAYER = [(2, 7, 64, 331, 1024), (2, 7, 64, 631, 1024),
                      (16, 1, 128, 331, 1024), (2, 7, 64, 900, 1024)]


@pytest.mark.parametrize("one_layer", [True, False])
@pytest.mark.parametrize("hkv,grp,d,kv_len,s", FLASH_DECODE_LAYER)
def test_flash_decode_over_one_bf16_layer_and_stacked_int8(dev, hkv, grp, d, kv_len, s,
                                                           one_layer):
    """Row 5 as a TQ3 / TQ4 decode step calls it, over one unpacked bf16
    layer [B, Hkv, S, D] without `layer_index`, and as a rotated int8 decode
    step calls it, over the stacked int8 cache with `layer_index`: one
    launch a call, within rel-L2 3e-2 of the plain version, the same bits
    twice."""
    g = torch.Generator(device=dev).manual_seed(hkv * d + kv_len)
    window = 256 if kv_len == 900 else 0
    if one_layer:
        kc, vc, ks, vs = rand_cache(g, dev, 1, 1, hkv, s, d, 16)
        kc, vc, li = kc[0], vc[0], None
    else:
        kc, vc, ks, vs = rand_cache(g, dev, 4, 1, hkv, s, d, 8)
        li = 2
    q = (torch.randn((1, hkv * grp, d), device=dev, generator=g) * 2).to(torch.bfloat16)
    lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    call = lambda: flash_attention.decode_attention(q, kc, vc, lens, k_scale=ks,
                                                    v_scale=vs, layer_index=li,
                                                    window=window, sink=4 if window else 0)
    before = flash_attention.KERNEL_DECODE.launches
    got, again = call(), call()
    want = flash_attention.decode_attention_plain(q, kc, vc, lens, ks, vs, li, None,
                                                  window, 4 if window else 0)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL_DECODE.launches == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert rel(got, want) <= 3e-2


def test_codebook_quantizers_and_rotation_card_equal_cpu(dev):
    """TQ3 and TQ4 give the CPU's bytes and scales on the card (the RMS is
    summed in f64 and rounded once); `rotate_heads` within 1e-6 of the CPU
    in f32 and refuses to run with TF32 on."""
    from mnn_tpu_torch.models.layers import rotate_heads

    g = torch.Generator().manual_seed(0)
    x = (torch.randn((64, 8, 128), generator=g)
         * torch.rand((64, 8, 1), generator=g) * 6).to(torch.bfloat16)
    x[0, 0] = 0
    for fn in (kvcache.quantize_kv3, kvcache.quantize_kv4cb):
        for a, c in zip(fn(x), fn(x.to(dev))):
            assert torch.equal(a, c.cpu()), fn
        packed, scale = fn(x)
        bits, cb = (3, False) if fn is kvcache.quantize_kv3 else (4, True)
        assert torch.equal(kvcache.dequant_kv(packed, scale, bits, codebook=cb),
                           kvcache.dequant_kv(packed.to(dev), scale.to(dev), bits,
                                              codebook=cb).cpu())
    xf = x.float()
    for inverse in (False, True):
        got = rotate_heads(xf.to(dev), inverse=inverse).cpu()
        assert (got - rotate_heads(xf, inverse=inverse)).abs().max() <= 1e-6
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            rotate_heads(xf.to(dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("bits", [8, 16, 3])
def test_compact_tail_card_equals_cpu(dev, bits):
    g = torch.Generator().manual_seed(bits)
    kc, vc, ks, vs = rand_cache(g, "cpu", 2, 2, 2, 32, 64, bits)
    cpu = kvcache.KVCache(k=kc, v=vc, k_scale=ks, v_scale=vs,
                          length=torch.tensor([20, 7], dtype=torch.int32), bits=bits)
    card = kvcache.KVCache(k=kc.to(dev), v=vc.to(dev),
                           k_scale=None if ks is None else ks.to(dev),
                           v_scale=None if vs is None else vs.to(dev),
                           length=cpu.length.to(dev), bits=bits)
    sel = [0, 3, 1, 6, 2, 50, -2, 9]
    want = kvcache.compact_tail(cpu, 12, torch.tensor(sel), 4)
    got = kvcache.compact_tail(card, torch.tensor(12, device=dev),
                               torch.tensor(sel, device=dev), 4)
    for name in ("k", "v", "k_scale", "v_scale", "length"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if b is not None:
            assert torch.equal(a.cpu(), b) or (b.is_floating_point() and torch.equal(
                a.cpu().nan_to_num(7.0), b.nan_to_num(7.0))), name


# (runtime flags): TQ3, TQ4, and the rotation over an int8 and an int4 cache
KV_VARIANTS = [dict(kv_bits=3), dict(kv_bits=4, kv_codebook=True),
               dict(kv_rotate=True), dict(kv_rotate=True, kv_bits=4)]


@pytest.mark.parametrize("flags", KV_VARIANTS)
def test_kv_variant_slice_card_matches_cpu(dev, flags):
    """A small model (head_dim 64) under each KV variant through `Llm` on
    the card and through the plain versions on the CPU: neither the
    whole-model nor the decode-step kernel runs; flash decode once a layer a
    step and flash prefill once a layer a chunk; the prefill logits within
    rel-L2 5e-2 and the tokens equal where the CPU's margins are clear."""
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                       sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                       max_new_tokens=6, **flags)
    ids = list(range(3, 48))
    runs = []
    for device in (dev, "cpu"):
        params = decoder.init_random_params(MK, torch.Generator().manual_seed(1),
                                            scale=0.05, lm_head_bits=4, device=device)
        llm = Llm(MK, params, rt, device=device)
        info = llm.info()
        assert not info["decode_megakernel"]
        assert info["kv_rotate"] == bool(flags.get("kv_rotate"))
        assert info["kv_codebook"] == bool(flags.get("kv_codebook"))
        build.reset_launches()
        toks = list(llm.stream(token_ids=ids))
        runs.append((toks, llm.last_prefill_logits.float().cpu(),
                     {k.name: k.launches for k in build.KERNELS}))
    (card_toks, card, n), (cpu_toks, cpu, cpu_n) = runs
    assert n["mnn_decode_model"] == n["mnn_decode_step"] == 0 and not any(cpu_n.values())
    assert n["mnn_flash_decode"] == MK.num_layers * rt.max_new_tokens
    assert n["mnn_flash_prefill"] == MK.num_layers * 2          # chunks of 32 and 16 -> 32
    assert torch.isfinite(card).all() and rel(card, cpu) <= 5e-2
    top2 = cpu[0].topk(2).values
    if float(top2[0] - top2[1]) > float((card - cpu).abs().max()):
        assert card_toks[0] == cpu_toks[0]


# --------------------------------------------------------------------------
# speculative decoding: the verify shapes, the draft cache, a stream
# --------------------------------------------------------------------------

# (H, Hkv, Tq, S, q_offset, D): chain and tree verify, fewer query rows than
# one warp's 16, far into the cache; kv_len = q_offset + Tq
VERIFY_FLASH = [(14, 2, 5, 1024, 331, 64), (14, 2, 8, 1024, 631, 64),
                (14, 2, 13, 1024, 500, 64), (4, 2, 1, 64, 40, 64),
                (16, 16, 5, 1024, 1019, 128), (4, 2, 3, 256, 100, 32)]


@pytest.mark.parametrize("h,hkv,t,s,q_off,d", VERIFY_FLASH)
def test_flash_prefill_verify_shapes(dev, h, hkv, t, s, q_off, d):
    """Row 4 at Tq < 16 with q_offset > 0: the plain version's output, the
    same bits twice, and nothing written past the output rows (a guard
    after the buffer keeps its fill)."""
    g = torch.Generator(device=dev).manual_seed(h * t + q_off)
    mk = lambda *shape: torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = mk(1, h, t, d), mk(1, hkv, s, d), mk(1, hkv, s, d)
    kl = torch.tensor(q_off + t, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
    again = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
    assert flash_attention.KERNEL.launches == before + 2
    n = q.numel()
    flat = torch.full((n + 64 * d,), 7.0, dtype=torch.bfloat16, device=dev)
    lens = torch.stack([kl, qo])
    flash_attention.KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), flat.data_ptr(),
                           lens.data_ptr(), 1, h, hkv, t, s, d, 1, 0, 0, d ** -0.5)
    want = flash_attention.flash_attention_plain(q, k, v, kl, qo)
    torch.cuda.synchronize()
    assert torch.equal(flat[:n].view_as(got), got) and bool((flat[n:] == 7.0).all())
    err = rel(got, want)
    print(f"verify flash prefill H={h} Hkv={hkv} T={t} q_off={q_off} D={d}: rel-L2 {err:.3e}")
    assert torch.isfinite(got).all() and err <= 2e-2
    assert torch.equal(got, again)


# (M, K, N, out f32, out_bias): qwen2-0.5b's four projections and its int4
# head at a chain verify of 4 + 1 and 7 + 1 rows and a 13-node tree
VERIFY_ROWS = [(m, k, n, f32, ob) for m in (5, 8, 13)
               for k, n, f32, ob in ((896, 1152, False, True), (896, 896, False, False),
                                     (896, 9728, False, False), (4864, 896, False, False),
                                     (896, 151936, True, False))]


@pytest.mark.parametrize("m,k,n,f32,with_bias", VERIFY_ROWS)
def test_dequant_matmul_verify_rows(dev, m, k, n, f32, with_bias):
    """Row 1b at M = 5, 8 and 13: the tile kernel (not the GEMV), rel-L2
    1e-2 to the plain version, the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    ql = rand_ql(g, dev, k, n, 4, 16, 1, with_bias)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    assert dequant_matmul.bf16_tile(m, n, 4) is not None
    before = dequant_matmul.KERNEL_BF16_TILE.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(0), out_dtype)
    torch.cuda.synchronize()
    assert dequant_matmul.KERNEL_BF16_TILE.launches == before + 2
    assert got.dtype == out_dtype and torch.isfinite(got).all()
    assert rel(got, want) <= 1e-2 and torch.equal(got, again)


# (Hkv, G, D, kv_len, S): the EAGLE draft's one-layer bf16 cache
DRAFT_CACHE = [(2, 7, 64, 1, 1024), (2, 7, 64, 300, 1024), (2, 7, 64, 600, 1024),
               (2, 2, 64, 64, 64), (4, 4, 128, 1000, 1024)]


@pytest.mark.parametrize("hkv,grp,d,kv_len,s", DRAFT_CACHE)
def test_flash_decode_over_the_draft_cache(dev, hkv, grp, d, kv_len, s):
    """Row 5 over a one-layer bf16 cache [1, Hkv, S, D] (no layer index), as
    `eagle_forward` calls it at t = 1: rel-L2 3e-2, the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(kv_len + s)
    cache = eagle_draft_cache = kvcache.create(1, 1, hkv, s, d, quantized=False, device=dev)
    eagle_draft_cache.k.copy_(torch.randn(cache.k.shape, device=dev, generator=g))
    eagle_draft_cache.v.copy_(torch.randn(cache.v.shape, device=dev, generator=g))
    q = torch.randn((1, hkv * grp, d), device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    before = flash_attention.KERNEL_DECODE.launches
    got = flash_attention.decode_attention(q, cache.k[0], cache.v[0], lens)
    again = flash_attention.decode_attention(q, cache.k[0], cache.v[0], lens)
    want = flash_attention.decode_attention_plain(q, cache.k[0], cache.v[0], lens)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL_DECODE.launches == before + 2
    assert rel(got, want) <= 3e-2 and torch.equal(got, again)


def _verify_rows(llm, ids, toks):
    """The logit rows [N, V] along `toks` three ways on llm's device: decode
    steps after the runtime's prefill (the plain stream's path), and a chain
    and a single-chain tree verify after the feature prefill (bf16 rows, the
    draft modes' prefill)."""
    from mnn_tpu_torch.runtime import generate
    from mnn_tpu_torch.runtime import speculative as spec

    p, c, rt = llm.params, llm.config, llm.rt
    ids_t = torch.tensor([ids], device=llm.device)
    logits, cache = generate.run_prefill(p, c, rt, ids_t, llm._new_cache())
    dec = [logits[0]]
    for tok in toks[:-1]:
        logits, cache = decoder.forward(p, c, torch.tensor([[tok]], device=llm.device), cache)
        dec.append(logits[0])
    out = [torch.stack(dec).float()]
    t = len(toks) - 1
    ar = torch.arange(t, device=llm.device)
    for tree in (None, (ar, torch.ones(t, t, dtype=torch.bool, device=llm.device).tril())):
        first, _, cache = spec.prefill_with_features(p, c, rt, ids_t, llm._new_cache())
        rows, _ = decoder.forward(p, c, torch.tensor([toks[:-1]], device=llm.device), cache,
                                  all_logits=True, tree=tree)
        out.append(torch.cat([first, rows[0]]).float())
    return out


class _OracleTree:
    """A 3 x 3 tree whose chain `good` is the target's own greedy chain under
    this very verify (the same 10-node verify run ahead on a copy of the
    cache, a node at a time: a node's target depends on its ancestors only),
    the others junk: accepted whole by construction."""

    kind, draft_len, fanout = "eagle-tree", 3, 3

    def __init__(self, llm, good):
        from mnn_tpu_torch.runtime import speculative as spec

        self.llm, self.good, self.spec = llm, good, spec
        layout = spec.TreeEagleDraft(None, draft_len=3, fanout=3).tree_layout()
        self.tree = tuple(a.to(llm.device) for a in layout)

    def tree_layout(self):
        return self.tree

    def start(self, params, config, prompt_ids, feats):
        self.params, self.config = params, config

    def propose_tree(self, last_token, last_feat):
        c, dev = self.llm.cache, self.llm.device
        chains = (torch.arange(9, device=dev).reshape(3, 3) + 7).long()
        for j in range(3):
            cache = dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                                        k_scale=c.k_scale.clone(), v_scale=c.v_scale.clone())
            nodes = torch.cat([torch.as_tensor(last_token, device=dev).long().reshape(1),
                               chains.reshape(-1)])[None]
            targets, _, _ = self.spec.verify_forward(self.params, self.config, nodes, cache,
                                                     tree=self.tree)
            chains[self.good, j] = targets[0, 0 if j == 0 else 1 + self.good * 3 + j - 1]
        return chains

    def commit(self, *a, **kw):
        pass

    def rollback(self, n):
        pass


def test_eagle_tree_stream_on_the_card_matches_plain(dev):
    """A short `eagle-tree` stream of a small model (head_dim 64) on the
    card: the plain greedy stream's tokens up to the first step whose margin
    is not above that step's largest logit difference between the verify
    paths and the decode path; the draft's t = 1 steps on flash decode, the
    verify on the tile kernel and the eager attention, no whole-model
    launch. Then an oracle tree whose last chain is the target's own: every
    round accepted whole, the accepted rows moved by `compact_tail` on the
    card to where the root's path continues, byte for byte."""
    from mnn_tpu_torch.runtime import speculative as spec

    rt = RuntimeConfig(max_seq_len=256, prefill_chunk=32, decode_block=4, sampler="greedy",
                       lm_head_bits=4, prefill_act_bits=16, max_new_tokens=12)
    params = decoder.init_random_params(MK, torch.Generator().manual_seed(1), scale=0.05,
                                        lm_head_bits=4, device=dev)
    ids = list(range(3, 48))
    plain = Llm(MK, params, rt, device=dev)
    want = list(plain.stream(token_ids=ids))
    dec, chain, tree = _verify_rows(plain, ids, want)
    diff = torch.maximum((chain - dec).abs().amax(-1), (tree - dec).abs().amax(-1))
    top2 = dec.topk(2, dim=-1).values
    n = ((top2[:, 0] - top2[:, 1] > diff).tolist() + [False]).index(False)
    llm = Llm(MK, params, dataclasses.replace(rt, speculative="eagle-tree", draft_len=3),
              device=dev)
    build.reset_launches()
    got = list(llm.stream(token_ids=ids))
    counts = {k.name: k.launches for k in build.KERNELS}
    same = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
    print(f"eagle-tree on the card: equal to the plain stream for {same} of 12 tokens, "
          f"{n} clear")
    assert n >= 1 and same >= n and len(got) == 12
    assert counts["mnn_decode_model"] == counts["mnn_decode_step"] == 0
    assert counts["mnn_flash_decode"] > 0 and counts["mnn_dequant_matmul_bf16_tile"] > 0
    assert isinstance(llm.drafter, spec.TreeEagleDraft)

    llm.reset()
    moved = []
    orig = kvcache.compact_tail

    def checked(cache, start, sel, m):
        s0 = int(start)
        src = [s0 + i for i in sel[:m]]
        before = [t[:, :, :, src].clone() for t in (cache.k, cache.v, cache.k_scale)]
        out = orig(cache, start, sel, m)
        after = [t[:, :, :, s0:s0 + m] for t in (out.k, out.v, out.k_scale)]
        moved.append(all(torch.equal(a, b) for a, b in zip(before, after)))
        return out
    kvcache.compact_tail = checked
    try:
        blocks = list(spec.tree_draft_generate(llm, ids, 13, drafter=_OracleTree(llm, 2)))
    finally:
        kvcache.compact_tail = orig
    assert [len(b) for b in blocks] == [1, 4, 4, 4] and llm.spec_stats["accept_rate"] == 1.0
    assert moved == [True] * 3


# --------------------------------------------------------------------------
# multimodal input: mrope through the whole-model kernel, a tiny Omni, PLE
# --------------------------------------------------------------------------

MK_MROPE = dataclasses.replace(MK, name="mk-mrope", mrope_section=(8, 12, 12))


def _margin_tokens_equal(card_toks, card_rows, cpu_toks, cpu_rows):
    """Tokens equal up to the first step whose CPU top-2 margin is not above
    the largest logit difference; returns the steps compared."""
    diff = max(float((a - b).abs().max()) for a, b in zip(card_rows, cpu_rows))
    n = 0
    for a, b, row in zip(card_toks, cpu_toks, cpu_rows):
        top2 = row.reshape(-1).topk(2).values
        if float(top2[0] - top2[1]) <= diff:
            break
        assert a == b, n
        n += 1
    return n


def test_multimodal_mrope_forward_card_matches_cpu(dev):
    """Spliced embeddings at mrope positions (`build_mrope_positions`, a
    6 x 4 image run) at int8 prefill rows, then 4 decode steps given
    position_ids at max(position) + 1 + s on all three components: on the
    card the prefill runs rows 2 and 4 and each step one whole-model launch
    with the mrope phases; logits within rel-L2 5e-2 of the CPU's plain
    versions, and the per-layer path (row 6) within 5e-2 of the whole-model
    one."""
    from mnn_tpu_torch.runtime.generate import prefill_params_view

    from mnn_tpu_torch.models.vision_encoder import build_mrope_positions

    img = -1
    ids = list(range(3, 20)) + [img] * 24 + list(range(40, 60))
    pos = torch.from_numpy(build_mrope_positions(ids, img, grid_hw=(6, 4)))
    g = torch.Generator().manual_seed(4)
    embeds = (torch.randn((1, len(ids), MK.hidden_size), generator=g) * 0.05).to(torch.bfloat16)
    rows, toks = {}, {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        params = decoder.init_random_params(MK_MROPE, torch.Generator().manual_seed(1),
                                            scale=0.05, lm_head_bits=4, device=device)
        cache = kvcache.create(MK.num_layers, 1, MK.num_kv_heads, 128, MK.head_dim,
                               device=device)
        build.reset_launches()
        logits, cache = decoder.forward(
            prefill_params_view(params, RuntimeConfig(prefill_act_bits=8)), MK_MROPE,
            torch.zeros((1, len(ids)), dtype=torch.int64, device=device),
            cache, inputs_embeds=embeds.to(device), position_ids=pos.to(device))
        out, tk = [logits.float().cpu()], []
        nxt = int(pos.max()) + 1
        for s in range(4):
            tk.append(int(out[-1].argmax()))
            p3 = torch.full((1, 1, 3), nxt + s, device=device)
            step_args = (params, MK_MROPE, torch.tensor([[tk[-1]]], device=device))
            if side == "card" and s == 3:     # the per-layer path from a copy
                copy = dataclasses.replace(cache, **{
                    f: getattr(cache, f).clone() for f in ("k", "v", "k_scale", "v_scale")})
                alt, _ = decoder.forward(*step_args, copy, position_ids=p3, megakernel=False)
            logits, cache = decoder.forward(*step_args, cache, position_ids=p3)
            out.append(logits.float().cpu())
        if side == "card":
            n = {k.name: k.launches for k in build.KERNELS}
            assert n["mnn_decode_model"] == 4 and n["mnn_decode_step"] == MK.num_layers
            assert n["mnn_flash_prefill"] == MK.num_layers and n["mnn_dequant_matmul_a8"] > 0
            assert rel(alt.float().cpu(), out[-1]) <= 5e-2
        rows[side], toks[side] = out, tk
    for a, b in zip(rows["card"], rows["cpu"]):
        assert torch.isfinite(a).all() and rel(a, b) <= 5e-2
    print("mrope steps compared:", _margin_tokens_equal(toks["card"], rows["card"][1:],
                                                       toks["cpu"], rows["cpu"][1:]))


def test_multimodal_tiny_omni_card_matches_cpu(dev):
    """A small model (head_dim 64) as an `Omni` with a Qwen2.5-VL tower of
    two blocks (patch 28: 16 image tokens) and a whisper encoder of one
    layer (1 s: 50 audio tokens), on the card and through the plain
    versions on the CPU: the towers' features within rel-L2 1e-3 (f32), the
    prefill logits within 5e-2, the tokens equal while the CPU's margins
    are clear; rows 2, 4 and 7 launched on the card, row 6 not."""
    from mnn_tpu_torch.models import audio_encoder as ae
    from mnn_tpu_torch.models import qwen_vl_vision as qv
    from mnn_tpu_torch.runtime.omni import Omni

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vl = dataclasses.replace(qv.QwenVLVisionConfig.tiny(), patch_size=28, window_size=112,
                             out_hidden_size=64)
    acfg = ae.AudioEncoderConfig(n_mels=80, hidden_size=64, num_layers=1, num_heads=2,
                                 ffn_size=128, max_positions=64)
    rng = torch.Generator().manual_seed(9)
    image = torch.randint(0, 256, (300, 400, 3), generator=rng, dtype=torch.uint8).numpy()
    wav = (torch.randn(16000, generator=rng) * 0.1).numpy()
    ids = list(range(3, 13)) + [-1] * 16 + list(range(20, 25)) + [-2] * 50 + [7, 8, 9]
    rt = RuntimeConfig(max_seq_len=256, prefill_chunk=32, decode_block=4, sampler="greedy",
                       lm_head_bits=4, prefill_act_bits=8, max_new_tokens=8)
    runs = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        g = torch.Generator().manual_seed(2)
        params = decoder.init_random_params(MK, g, scale=0.05, lm_head_bits=4, device=device)
        vlp = qv.from_hf_qwen_vl_vision(
            qv.random_hf_state_dict(vl, torch.Generator().manual_seed(3)), device)
        ap = ae.from_hf_whisper_encoder(
            ae.random_hf_whisper_encoder(acfg, torch.Generator().manual_seed(4)), device)

        def encode(px, vlp=vlp):
            hwc = px[0].permute(1, 2, 0)
            pt = torch.stack([hwc, hwc]).reshape(1, 2, 8, 28, 8, 28, 3).permute(
                0, 2, 4, 1, 3, 5, 6).reshape(64, -1)
            return qv.qwen_vl_vision_forward(vlp, vl, pt, [(1, 8, 8)])

        proj = torch.randn((64, MK.hidden_size), generator=torch.Generator().manual_seed(5))
        o = Omni(MK, params, rt, vision_encode=encode, vision_proj=(proj * 0.05).to(device),
                 image_token_id=-1, audio_encode=lambda mel, ap=ap: ae.audio_encoder_forward(
                     ap, acfg, mel), audio_proj=(proj * 0.05).to(device), audio_token_id=-2,
                 audio_n_mels=80, device=device)
        feats = (o.embed_image(image).float().cpu(), o.embed_audio(wav).float().cpu())
        build.reset_launches()
        toks = list(o.stream_mm(ids, images=[image], audios=[wav]))
        runs[side] = (
            toks, o.last_prefill_logits.float().cpu(), feats,
            {k.name: k.launches for k in build.KERNELS})
    (card_toks, card, card_f, n), (cpu_toks, cpu, cpu_f, _) = runs["card"], runs["cpu"]
    for a, b in zip(card_f, cpu_f):
        assert rel(a, b) <= 1e-3
    assert torch.isfinite(card).all() and rel(card, cpu) <= 5e-2
    assert n["mnn_decode_model"] == 8 and n["mnn_decode_step"] == 0
    assert n["mnn_flash_prefill"] == MK.num_layers * 3 and n["mnn_dequant_matmul_a8"] > 0
    top2 = cpu[0].topk(2).values
    if float(top2[0] - top2[1]) > float((card - cpu).abs().max()):
        assert card_toks[0] == cpu_toks[0]


def test_multimodal_ple_decode_runs_the_decode_step_kernel(dev):
    """A PLE table keeps decode off the whole-model kernel: each step runs
    the decode-step kernel once a layer; the logits of a prefill and 4
    steps within rel-L2 5e-2 of the CPU's."""
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4, sampler="greedy",
                       lm_head_bits=4, prefill_act_bits=8, max_new_tokens=4)
    ids = list(range(3, 48))
    runs = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        g = torch.Generator().manual_seed(6)
        params = decoder.init_random_params(MK, torch.Generator().manual_seed(1), scale=0.05,
                                            lm_head_bits=4, device=device)
        params = dataclasses.replace(
            params, ple_table=(torch.randn((MK.vocab_size, MK.num_layers, 32), generator=g)
                               * 0.05).to(device),
            layers=dataclasses.replace(params.layers, ple_proj=(
                torch.randn((MK.num_layers, 32, MK.hidden_size), generator=g) * 0.05).to(device)))
        llm = Llm(MK, params, rt, device=device)
        build.reset_launches()
        toks = list(llm.stream(token_ids=ids))
        runs[side] = (
            toks, llm.last_prefill_logits.float().cpu(),
            {k.name: k.launches for k in build.KERNELS})
    (card_toks, card, n), (cpu_toks, cpu, _) = runs["card"], runs["cpu"]
    assert n["mnn_decode_model"] == 0 and n["mnn_decode_step"] == MK.num_layers * 4
    assert torch.isfinite(card).all() and rel(card, cpu) <= 5e-2
    top2 = cpu[0].topk(2).values
    if float(top2[0] - top2[1]) > float((card - cpu).abs().max()):
        assert card_toks[0] == cpu_toks[0]


# --------------------------------------------------------------------------
# training: the projection's autograd node, a LoRA step, merge and serve
# --------------------------------------------------------------------------

def _lora_arrays(cfg, rank, b_scale, seed):
    """numpy-made adapters on all four projections, as tensors on the CPU."""
    from mnn_tpu_torch.train.lora import lora_dims

    rng = np.random.default_rng(seed)
    out = {}
    for name, (k, n) in lora_dims(cfg).items():
        out["a_" + name] = torch.from_numpy(
            (rng.standard_normal((cfg.num_layers, k, rank)) / rank ** 0.5).astype(np.float32))
        out["b_" + name] = torch.from_numpy(
            (rng.standard_normal((cfg.num_layers, rank, n)) * b_scale).astype(np.float32))
    return out


@pytest.mark.parametrize("m,k,n,f32", [(1024, 896, 1152, False), (1024, 4864, 896, False),
                                       (96, 896, 8200, True), (1, 896, 1152, False)])
def test_train_dequant_matmul_vjp(dev, m, k, n, f32):
    """`DequantMatmulFn` on the card: the forward is the kernel (the tile
    kernel above M = 1, the GEMV at M = 1: one launch), dx (the JAX VJP)
    within rel-L2 1e-2 of the same Function's on the CPU, where it wraps
    the plain version."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    ql = rand_ql(g, dev, k, n, 4, 16, 2, True)
    odt = torch.float32 if f32 else torch.bfloat16
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    gy = torch.randn((m, n), device=dev, generator=g).to(odt)
    outs = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        xs = x.detach().to(d).requires_grad_(True)   # a leaf on each side
        ql_d = ql.to(d)
        build.reset_launches()
        y = dequant_matmul.dequant_matmul(xs, ql_d, layer_index=1, out_dtype=odt)
        n_launch = {kk.name: kk.launches for kk in build.KERNELS}
        y.backward(gy.to(d))
        outs[side] = (y.detach().float().cpu(), xs.grad.float().cpu(), n_launch)
    (y, dx, launches), (y_cpu, dx_cpu, cpu_launches) = outs["card"], outs["cpu"]
    entry = "mnn_dequant_matmul" if m == 1 else "mnn_dequant_matmul_bf16_tile"
    assert launches[entry] == 1 and sum(launches.values()) == 1
    assert not any(cpu_launches.values())
    assert rel(y, y_cpu) <= 1e-2 and rel(dx, dx_cpu) <= 1e-2


def test_train_lora_step_card_matches_cpu(dev):
    """One LoRA step (adamw) at 2 layers, W4 and an int4 head, the same
    params and numpy-made adapters on both sides: the loss within rel
    1e-2, every adapter gradient within rel-L2 5e-2, every projection and
    the head on the tile kernel (4 a layer + 1, forward only), no flash
    kernel, and the adapters after the step within rel-L2 5e-2."""
    from mnn_tpu_torch.models.decoder import LoraParams
    from mnn_tpu_torch.train import lm_loss, make_lora_train_step, make_optimizer

    cfg = dataclasses.replace(MK, num_layers=2, tie_word_embeddings=False)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(3))
    arrays = _lora_arrays(cfg, 8, 0.01, 4)
    runs = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        params = decoder.init_random_params(cfg, torch.Generator().manual_seed(1), scale=0.05,
                                            lm_head_bits=4, device=d)
        lora = LoraParams(scaling=2.0, **{k: v.clone().to(d) for k, v in arrays.items()})
        for t in lora.tensors():
            t.requires_grad_(True)
        build.reset_launches()
        loss = lm_loss(params, lora, cfg, tokens.to(d))
        n = {k.name: k.launches for k in build.KERNELS}
        loss.backward()
        grads = {f: getattr(lora, f).grad.float().cpu() for f in arrays}
        lora = LoraParams(scaling=2.0, **{k: v.clone().to(d) for k, v in arrays.items()})
        opt = make_optimizer("adamw", lr=1e-3)
        state = opt.init(lora)
        make_lora_train_step(cfg, opt)(params, lora, state, tokens.to(d))
        after = {f: getattr(lora, f).detach().cpu() for f in arrays}
        runs[side] = (float(loss.detach()), grads, n, after)
    (loss, grads, n, after), (loss_cpu, grads_cpu, _, after_cpu) = runs["card"], runs["cpu"]
    assert n["mnn_dequant_matmul_bf16_tile"] == 4 * cfg.num_layers + 1
    assert n["mnn_flash_prefill"] == 0 and n["mnn_dequant_matmul_a8"] == 0
    assert abs(loss - loss_cpu) <= 1e-2 * abs(loss_cpu)
    for f in arrays:
        assert rel(grads[f], grads_cpu[f]) <= 5e-2, f
        assert rel(after[f], after_cpu[f]) <= 5e-2, f


def test_train_merged_model_decodes_on_the_whole_model_kernel(dev):
    """`merge_lora` on the card gives the CPU's bytes but for rounding ties
    (at most 1 % of the codes), and the merged model decodes through the
    whole-model kernel, one launch a step, its logits within rel-L2 5e-2 of
    the per-layer path's."""
    from mnn_tpu_torch.models.decoder import LoraParams
    from mnn_tpu_torch.train import merge_lora

    cfg = MK
    arrays = _lora_arrays(cfg, 8, 0.002, 5)
    merged = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        params = decoder.init_random_params(cfg, torch.Generator().manual_seed(1), scale=0.05,
                                            lm_head_bits=4, device=d)
        lora = LoraParams(scaling=2.0, **{k: v.to(d) for k, v in arrays.items()})
        merged[side] = merge_lora(params, lora)
    for name in ("wqkv", "wo", "wgu", "wdown"):
        a = getattr(merged["card"].layers, name).packed.cpu()
        b = getattr(merged["cpu"].layers, name).packed
        assert (a != b).float().mean() <= 0.01, name
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4, sampler="greedy",
                       lm_head_bits=4, prefill_act_bits=8, max_new_tokens=4)
    llm = Llm(cfg, merged["card"], rt, device=dev)
    assert llm.info()["decode_megakernel"]
    build.reset_launches()
    toks = list(llm.stream(token_ids=list(range(3, 40))))
    assert build.KERNELS and {k.name: k.launches for k in build.KERNELS}[
        "mnn_decode_model"] == rt.max_new_tokens
    tok = torch.tensor([[toks[-1]]], device=dev)
    ref, _ = decoder.forward(llm.params, cfg, tok, _clone(llm.cache), megakernel=False)
    mk, _ = decoder.forward(llm.params, cfg, tok, _clone(llm.cache), megakernel=True)
    torch.cuda.synchronize()
    assert torch.isfinite(mk).all() and rel(mk, ref) <= 5e-2


# --------------------------------------------------------------------------
# generative output: the vocoder, a Stable Diffusion step, the talker
# --------------------------------------------------------------------------

def test_generative_vocoder_card_matches_cpu(dev):
    """BigVGAN at 80 mels and its six upsampling rates (256 channels at the
    first, so the CPU side stays short), 16 mel frames, with and without the
    anti-aliased activations: the card's waveform within 1e-3 of the CPU's.
    TF32 stays off inside the call whatever the caller set, and the
    caller's flags come back after."""
    from mnn_tpu_torch.audio import vocoder as voc

    cfg = dataclasses.replace(voc.VocoderConfig(), upsample_initial_channel=256)
    p = voc.init_vocoder_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # weights at 0.75 / sqrt(fan-in): a waveform of std about 0.15, not
    # saturated in tanh (at 0.05 every sample sits at +-1)
    p = {k: v * 0.75 / (0.05 * math.sqrt(v.shape[1] * v.shape[2])) if v.dim() == 3 else v
         for k, v in p.items()}
    mel = torch.randn((1, 80, 16), generator=torch.Generator().manual_seed(1))
    for aa in (False, True):
        c = dataclasses.replace(cfg, use_aa_filters=aa)
        want = voc.vocoder_forward(p, c, mel)
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = voc.vocoder_forward({k: v.to(dev) for k, v in p.items()}, c, mel.to(dev))
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        assert got.shape == want.shape == (1, 16 * 256)
        assert float((want.abs() > 0.99).float().mean()) < 0.01 and float(want.std()) > 0.05
        assert float((got.cpu() - want).abs().max()) <= 1e-3, aa


def test_generative_sd_step_card_matches_cpu(dev):
    """One CFG step of a small SD (the tiny UNet at 128 channels, a 32 x 32
    latent) in f32, card against CPU within rel-L2 1e-3; a 2-step tiny
    txt2img from the same seed gives the same latents within 1e-3 (the
    noise is the CPU generator's on both sides) and a uint8 image."""
    from mnn_tpu_torch.diffusion import StableDiffusion, clip_text, unet, vae

    ucfg = dataclasses.replace(unet.UNetConfig.tiny(), block_out_channels=(128, 256),
                               groups=32, cross_attention_dim=64)
    tcfg = clip_text.ClipTextConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                                    num_layers=2, num_heads=2, max_position_embeddings=16,
                                    eos_token_id=511)
    g = torch.Generator().manual_seed(0)
    parts = dict(unet_params=unet.init_unet_params(ucfg, g, "cpu"), unet_cfg=ucfg,
                 text_params=clip_text.init_clip_text_params(tcfg, g, "cpu"), text_cfg=tcfg,
                 vae_params=vae.init_vae_params(vae.VAEConfig.tiny(), g, "cpu"),
                 vae_cfg=vae.VAEConfig.tiny())
    sides = {d: StableDiffusion(**parts, dtype=torch.float32, device=d) for d in (dev, "cpu")}
    outs = {}
    for d, s in sides.items():
        ctx2 = torch.cat([s.encode_prompt(""), s.encode_prompt("a cat")])
        lat = torch.randn((1, 4, 32, 32), generator=torch.Generator().manual_seed(2)).to(d)
        s.scheduler.set_timesteps(20)
        step = s.denoise_step(lat, 951, 901, ctx2, 7.5, torch.Generator().manual_seed(3))
        latent = s.txt2img("a cat", num_steps=2, height=32, width=32, output="latent")
        outs[str(d)] = (step.cpu(), latent, s.txt2img("a cat", num_steps=2, height=32, width=32))
    (step, latent, img), (step_cpu, latent_cpu, img_cpu) = outs[str(dev)], outs["cpu"]
    assert rel(step, step_cpu) <= 1e-3
    assert rel(torch.from_numpy(latent), torch.from_numpy(latent_cpu)) <= 1e-3
    assert img.dtype == np.uint8 and img.shape == img_cpu.shape == (32, 32, 3)


def test_generative_talker_decodes_on_the_whole_model_kernel(dev):
    """A talker on the mk-test stack with a 512-code vocabulary, W4, an int4
    head and a bf16 cache: its prefill runs the tile kernel 4 times a layer
    and flash prefill once a layer, the head on the GEMV; every codec token
    is one whole-model launch with the head fused; the next step's logits
    on the whole-model kernel within rel-L2 5e-2 of `megakernel=False` from
    the same cache."""
    from mnn_tpu_torch.models.talker import Talker, TalkerConfig

    cfg = TalkerConfig(model=MK, thinker_hidden=96, codec_eos_ids=(511,), max_new_tokens=12)
    params = decoder.init_random_params(MK, torch.Generator().manual_seed(1), scale=0.05,
                                        lm_head_bits=4, device=dev)
    assert decoder.decode_model.supports_head(MK, params)
    tk = Talker(cfg, params, np.random.default_rng(0).standard_normal((96, 256)) * 0.05,
                device=dev)
    hidden = np.random.default_rng(1).standard_normal((21, 96)).astype(np.float32)
    build.reset_launches()
    codec = tk.generate_codec(hidden, thinker_tokens=list(range(21)), capacity=512)
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in build.KERNELS}
    assert 0 < len(codec) <= 12 and tk.perf.codec_tokens == len(codec)
    assert n["mnn_decode_model"] == len(codec)
    assert n["mnn_dequant_matmul_bf16_tile"] == 4 * MK.num_layers
    assert n["mnn_flash_prefill"] == MK.num_layers and n["mnn_dequant_matmul"] == 1
    assert n["mnn_decode_step"] == 0 and n["mnn_dequant_matmul_a8"] == 0
    cache = kvcache.create(MK.num_layers, 1, MK.num_kv_heads, 512, MK.head_dim,
                           quantized=False, device=dev)
    embeds = torch.from_numpy(hidden).to(dev) @ tk.in_proj
    _, cache = decoder.forward(params, MK, torch.zeros((1, 21), dtype=torch.int64, device=dev),
                               cache, inputs_embeds=embeds[None].to(torch.bfloat16))
    tok = torch.tensor([[codec[0] if codec else 0]], device=dev)
    ref, _ = decoder.forward(params, MK, tok, _clone(cache), megakernel=False)
    mk, _ = decoder.forward(params, MK, tok, _clone(cache), megakernel=True)
    torch.cuda.synchronize()
    assert torch.isfinite(mk).all() and rel(mk, ref) <= 5e-2


# --------------------------------------------------------------------------
# the diffusion transformers, their decoders and the CV library
# --------------------------------------------------------------------------

def _dit_case(name):
    """(fn(params, *inputs), params on the CPU, CPU inputs) of one DiT
    forward at batch 2 (one CFG call) or one decoder, narrow widths."""
    from mnn_tpu_torch.diffusion import mmdit, sana, wan

    g = torch.Generator().manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=g)
    if name == "mmdit":
        cfg = dataclasses.replace(mmdit.MMDiTConfig(), hidden_size=256, num_heads=4, depth=2,
                                  context_dim=512, pooled_dim=256, pos_embed_max=32)
        return (lambda p, x, c, pl: mmdit.mmdit_forward(p, cfg, x, 951.0, c, pl),
                mmdit.init_mmdit_params(cfg, g, "cpu"), [rnd(2, 16, 24, 40), rnd(2, 77, 512),
                                                         rnd(2, 256)])
    if name == "sana":
        cfg = dataclasses.replace(sana.SanaConfig(), dim=256, num_heads=4, cross_heads=4,
                                  depth=2, text_dim=512)
        return (lambda p, x, c: sana.sana_forward(p, cfg, x, torch.tensor(
            [951.0, 951.0], device=x.device), c),
                sana.init_sana_params(cfg, g, "cpu"), [rnd(2, 16, 24, 32), rnd(2, 40, 512)])
    if name == "wan":
        cfg = dataclasses.replace(wan.WanConfig(), dim=256, num_heads=2, depth=2, text_dim=512)
        mask = torch.ones((2, 30))
        mask[0, 12:] = 0
        return (lambda p, x, c: wan.wan_forward(p, cfg, x, torch.tensor(
            [951.0, 951.0], device=x.device), c, mask.to(x.device)),
                wan.init_wan_params(cfg, g, "cpu"), [rnd(2, 3, 16, 20, 16), rnd(2, 30, 512)])
    if name == "dcae":
        return (lambda p, z: sana.dcae_decode(p, z, stages=4),
                sana.init_dcae_decoder(g, latent_ch=32, stages=4, device="cpu"), [rnd(1, 8, 8, 32)])
    return (lambda p, z: wan.wan_vae_decode(p, z, spatial_stages=3),
            wan.init_wan_vae(g, latent_ch=16, width=16, spatial_stages=3, device="cpu"),
            [rnd(1, 2, 8, 8, 16)])


@pytest.mark.parametrize("name", ["mmdit", "sana", "wan", "dcae", "wan_vae"])
def test_dit_card_matches_cpu(dev, name):
    """Each DiT forward (a CFG call at batch 2) and both decoders in f32,
    card against CPU within rel-L2 1e-3 (chip_smoke (bbb)'s bound), with
    TF32 on in the caller: each entry point turns it off for its products."""
    fn, params, inputs = _dit_case(name)
    want = fn(params, *inputs)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn({k: v.to(dev) for k, v in params.items()}, *[a.to(dev) for a in inputs])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert got.device.type == "cuda" and got.shape == want.shape
    assert torch.isfinite(got).all() and rel(got.cpu(), want) <= 1e-3


def test_dit_pipelines_card_match_cpu(dev):
    """`SanaPipeline` and `WanPipeline` from one seed: the noise is the CPU
    generator's on both sides, the images within rel-L2 1e-3."""
    from mnn_tpu_torch.diffusion import sana, wan

    g = torch.Generator().manual_seed(8)
    scfg, wcfg = sana.SanaConfig.tiny(), wan.WanConfig.tiny()
    sp = (sana.init_sana_params(scfg, g, "cpu"), sana.init_dcae_decoder(g, stages=2, device="cpu"))
    wp = (wan.init_wan_params(wcfg, g, "cpu"), wan.init_wan_vae(g, spatial_stages=1, device="cpu"))
    txt = torch.randn((1, 6, 32), generator=g)
    outs = {}
    for d in (dev, torch.device("cpu")):
        on = lambda p: {k: v.to(d) for k, v in p.items()}
        img = sana.SanaPipeline(scfg, on(sp[0]), on(sp[1]), dcae_stages=2)(
            txt.to(d), torch.zeros_like(txt).to(d), latent_hw=(6, 8), steps=3, seed=5)
        vid = wan.WanPipeline(wcfg, on(wp[0]), on(wp[1]), vae_stages=1)(
            txt.to(d), torch.zeros_like(txt).to(d), latent_thw=(2, 4, 6), steps=3, seed=5,
            text_mask=torch.tensor([[1, 1, 1, 1, 0, 0.0]], device=d))
        outs[d.type] = (img.cpu(), vid.cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and rel(a, b) <= 1e-3


def test_cv_card_matches_cpu(dev):
    """Every case of chip_smoke (ccc) on a seeded 270 x 480 image, card
    against CPU: integer outputs equal, uint8 resamples within one level,
    float outputs within rel-L2 1e-5."""
    import chip_smoke

    img = torch.randint(0, 256, (270, 480, 3), generator=torch.Generator().manual_seed(9),
                        dtype=torch.uint8)
    card, cpu = chip_smoke.cv_inputs(img, dev)
    for name, (kinds, fn) in chip_smoke.CV_CASES.items():
        chip_smoke.cv_compare(name, kinds, fn(card), fn(cpu))


def test_native_library_builds_and_reads_a_checkpoint(dev, tmp_path):
    """On the card's machine the native library builds from `native/` with
    g++; its StFile reads what `convert/stfile` reads."""
    import chip_smoke
    from mnn_tpu_torch.convert import stfile
    from mnn_tpu_torch.utils import native

    native.load(raise_on_error=True)
    path = str(tmp_path / "x.safetensors")
    stfile.save_file({"w": torch.randn(64, 32).bfloat16(), "b": torch.arange(5)}, path)
    got = chip_smoke.native_stfile_check([path])
    assert got["tensors"] == 2 and got["bytes"] == 64 * 32 * 2 + 5 * 8


# --------------------------------------------------------------------------
# the graph frontends, CNN inference and row 10 (the plugin example kernel)
# --------------------------------------------------------------------------

# (shape, dtype): the plugin test's, a ResNet-50 activation in bf16 and f32,
# ragged tails
SOFTSHRINK = [((2, 8, 128), torch.float32), ((2, 8, 128), torch.bfloat16),
              ((32, 256, 56, 56), torch.bfloat16), ((1000003,), torch.float32),
              ((7, 13), torch.bfloat16), ((3, 5), torch.float32),
              ((32, 256, 56, 56), torch.float32), (((1 << 20) + 7,), torch.bfloat16)]


@pytest.mark.parametrize("shape,dt", SOFTSHRINK)
def test_plugin_softshrink_kernel(dev, shape, dt):
    """Row 10: one launch a call, the plain version's bits (signed zeros,
    x = +-lam, a NaN and the bf16 rounding of lam included), also from a
    pointer off 16 bytes (x[1:]: a scalar head, the vector body, a tail)."""
    from mnn_tpu_torch.kernels import softshrink

    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev).to(dt)
    x.view(-1)[:5] = torch.tensor([0.0, -0.0, 0.3, -0.3, float("nan")], device=dev).to(dt)
    ib = torch.int16 if dt == torch.bfloat16 else torch.int32
    for xin in (x, x.view(-1)[1:]):
        before = softshrink._KERNEL.launches
        got = softshrink.softshrink(xin, 0.3)
        assert softshrink._KERNEL.launches == before + 1
        want = softshrink.softshrink_plain(xin, 0.3)
        torch.cuda.synchronize()
        assert torch.equal(got.view(ib), want.view(ib))


def test_onnx_breadth_card_matches_cpu(dev):
    """Every case of chip_smoke's ONNX breadth set (every op of the
    frontend's table) card against CPU: ints equal, floats within 1e-5."""
    import chip_smoke

    for name, case in chip_smoke.onnx_cases().items():
        worst = chip_smoke.onnx_worst(chip_smoke.run_onnx_case(case, dev),
                                      chip_smoke.run_onnx_case(case, "cpu"), case[2])
        assert worst <= chip_smoke.ONNX_TOL, (name, worst)


def test_onnx_plugin_on_the_card(dev):
    """The plugin op backed by row 10 through the ONNX frontend on the card."""
    import chip_smoke
    from mnn_tpu_torch.kernels import softshrink

    before = softshrink._KERNEL.launches
    chip_smoke.phase_plugin(dev)
    assert softshrink._KERNEL.launches == before + len(chip_smoke.SOFTSHRINK_SHAPES)


@pytest.mark.parametrize("frontend", ["tf", "tflite", "caffe"])
def test_frontend_breadth_card_matches_cpu(dev, frontend):
    """Every entry of the TF, TFLite and Caffe tables in chip_smoke's small
    graphs, card against CPU: ints equal, floats within 1e-5."""
    import chip_smoke

    cases, run = {"tf": (chip_smoke.tf_cases, chip_smoke.run_tf_case),
                  "tflite": (chip_smoke.tfl_cases, chip_smoke.run_tfl_case),
                  "caffe": (chip_smoke.caffe_cases, chip_smoke.run_caffe_case)}[frontend]
    for name, case in cases().items():
        worst = chip_smoke.onnx_worst(run(case, dev), run(case, "cpu"), case[2])
        assert worst <= chip_smoke.ONNX_TOL, (name, worst)


def test_frontend_plugins_on_the_card(dev):
    """Softshrink registered in the tf, tflite and caffe tables, backed by
    row 10, in a converted graph of each: the plain version's bits."""
    import chip_smoke
    from mnn_tpu_torch.kernels import softshrink

    before = softshrink._KERNEL.launches
    chip_smoke.phase_frontend_plugins(dev, shape=(4, 64, 28, 28))
    assert softshrink._KERNEL.launches == before + 3


@pytest.mark.parametrize("name", ["mobilenet_v2", "squeezenet_v1.0", "resnet50"])
def test_cnn_card_matches_cpu(dev, name):
    """A vision model through the fx frontend at 96 x 96, 16 classes: f32
    card vs CPU within rel-L2 1e-4 (TF32 off), bf16 within 5e-2 of the f32
    CPU logits; ResNet-50 also through the port's ONNX writer and reader."""
    import chip_smoke
    from mnn_tpu_torch.convert import onnx_pb2
    from mnn_tpu_torch.convert.onnx_frontend import convert_onnx
    from mnn_tpu_torch.convert.torch_fx import convert_torch_module
    from mnn_tpu_torch.diffusion.nn import no_tf32
    from mnn_tpu_torch.models.vision import VISION_MODELS

    torch.manual_seed(0)
    mod = VISION_MODELS[name](num_classes=16).eval()
    x = torch.randn(2, 3, 96, 96, generator=torch.Generator().manual_seed(1))
    fn, p_card = convert_torch_module(mod, device=dev)
    _, p_cpu = convert_torch_module(mod, device="cpu")
    with torch.no_grad(), no_tf32():
        card = fn(p_card, x.to(dev)).float().cpu()
        cpu = fn(p_cpu, x)
        card16 = fn(chip_smoke.cli._bf16_params(p_card), x.to(dev, torch.bfloat16)).float().cpu()
        assert rel(card, cpu) <= 1e-4 and rel(card16, cpu) <= 5e-2
        if name == "resnet50":
            ofn, oparams = convert_onnx(onnx_pb2.ModelProto.FromString(
                chip_smoke.onnx_of_module(mod)), device=dev)
            assert rel(ofn(oparams, x.to(dev)).float().cpu(), card) <= 1e-4


def test_nms_and_classify_card_match_cpu(dev):
    """NMS over 2,000 seeded boxes (kept indices equal) and the
    classification preprocessing (rel-L2 1e-5), card against CPU."""
    from mnn_tpu_torch.ops.nms import nms
    from mnn_tpu_torch.runtime.classify import preprocess_classification

    r = np.random.default_rng(0)
    xy = r.uniform(0, 500, (2000, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + r.uniform(10, 60, (2000, 2))], 1)
                             .astype(np.float32))
    scores = torch.from_numpy(r.random(2000).astype(np.float32))
    got = nms(boxes.to(dev), scores.to(dev), 0.5, 0.05, 300)
    want = nms(boxes, scores, 0.5, 0.05, 300)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    img = r.integers(0, 256, (300, 451, 3), dtype=np.uint8)
    card = preprocess_classification(img, device=dev).cpu()
    cpu = preprocess_classification(img, device="cpu")
    assert card.shape == (3, 224, 224) and rel(card, cpu) <= 1e-5


# --------------------------------------------------------------------------
# Quant blocks of up to 256 K-values. Blocks of 136 to 256 take the second
# build of the three tensor-core kernels and of the grouped expert kernel
# (the whole block in a ring stage, unpacked in two chunks of K-rows, one f32
# step a block); the GEMV and the whole-model and fused expert kernels take
# them in their one build. Blocks of 256 at qwen2-7b's widths (K = 3,584 and
# 18,944; the head, N = 152,064) and qwen3-moe-30b-a3b's; 176 at
# qwen1.5-moe-a2.7b's K = 1,408 (`choose_block_size(1408, 256)`); 136 and 176
# leave a last chunk of 8 or 48 K-values, padded to the mma depth; W3 at 176
# and W2 at 136 take the a8 unpack's byte path.
# --------------------------------------------------------------------------

# (route, bits, M, K, N, block, out f32, out_bias): gemv row 1a, tile row 1b,
# a8 row 2, deq row 3
BLOCK256 = [
    ("gemv", 4, 1, 3584, 4608, 256, False, True), ("gemv", 4, 1, 18944, 3584, 256, False, False),
    ("gemv", 4, 1, 3584, 152064, 256, True, False), ("gemv", 4, 1, 1408, 2048, 176, False, False),
    ("gemv", 8, 1, 512, 200, 256, True, True), ("gemv", 3, 1, 768, 1028, 256, False, False),
    ("gemv", 2, 1, 1056, 200, 176, True, True),
    ("tile", 4, 512, 3584, 4608, 256, False, True), ("tile", 4, 512, 18944, 3584, 256, False, False),
    ("tile", 4, 2, 512, 200, 256, False, True), ("tile", 4, 130, 1408, 1028, 176, True, True),
    ("tile", 8, 33, 768, 132, 256, False, False), ("tile", 4, 64, 1088, 2048, 136, False, False),
    ("tile", 3, 40, 512, 200, 256, True, False), ("tile", 2, 16, 528, 1028, 176, False, True),
    ("a8", 4, 512, 3584, 4608, 256, False, True), ("a8", 4, 512, 18944, 3584, 256, False, False),
    ("a8", 4, 512, 1408, 2048, 176, False, False), ("a8", 8, 77, 512, 200, 256, True, True),
    ("a8", 4, 1, 1088, 200, 136, False, True), ("a8", 3, 64, 768, 1028, 256, False, False),
    ("a8", 3, 40, 528, 200, 176, True, True), ("a8", 2, 130, 1056, 132, 176, False, False),
    ("a8", 2, 33, 1088, 200, 136, False, True),
    ("deq", 4, 512, 3584, 3584, 256, False, False), ("deq", 4, 90, 1408, 1028, 176, True, True),
    ("deq", 8, 33, 512, 132, 256, False, True), ("deq", 3, 64, 768, 200, 256, False, False),
    ("deq", 2, 7, 1056, 200, 176, True, False),
]


@pytest.mark.parametrize("route,bits,m,k,n,bs,f32,with_bias", BLOCK256)
def test_block256_dequant_matmul(dev, route, bits, m, k, n, bs, f32, with_bias, monkeypatch):
    """Rows 1a, 1b, 2 and 3 at blocks above 128: the route's kernel launched
    once a call, rel-L2 1e-2 against the plain version, the same bits twice;
    row 2 the plain version's bits."""
    g = torch.Generator(device=dev).manual_seed(m * n + bits + bs)
    ql = rand_ql(g, dev, k, n, bits, 8 if route == "a8" else 16, 2, with_bias, bs)
    ql = dataclasses.replace(ql, bias=(ql.bias.float() + torch.randn(
        ql.bias.shape, device=dev, generator=g) * 1e-3).to(torch.bfloat16))
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    kern = {"gemv": dequant_matmul.KERNEL_BF16, "tile": dequant_matmul.KERNEL_BF16_TILE,
            "a8": dequant_matmul.KERNEL_A8, "deq": dequant_matmul.KERNEL_DEQ}[route]
    if route == "deq":
        monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", m)
    tile = (dequant_matmul.a8_tile(m, n, bits, bs) if route == "a8" else
            dequant_matmul.bf16_tile(m, n, bits, bs))
    assert (tile is None) == (route == "gemv")
    before = kern.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    again = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(1), out_dtype, deq=route == "deq")
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (m, n) and torch.isfinite(got).all()
    err = rel(got, want)
    print(f"block {bs} {route} W{bits} M={m} K={k} N={n} tile={tile}: rel-L2 {err:.3e}")
    assert err <= 1e-2
    assert torch.equal(got, again)
    if route == "a8":
        assert float((got.float() - want.float()).abs().max()) == 0.0


def test_block_above_256_raises_on_the_card(dev):
    """A block of 264 raises before any launch, naming the limit; the
    grouped expert kernel declines it."""
    g = torch.Generator(device=dev).manual_seed(264)
    x = torch.randn((4, 528), device=dev, generator=g).to(torch.bfloat16)
    for act_bits in (16, 8):
        ql = rand_ql(g, dev, 528, 200, 4, act_bits, 1, False, bs=264).layer(0)
        with pytest.raises(ValueError, match="at most 256"):
            dequant_matmul.dequant_matmul(x, ql)
    gu = rand_experts(g, dev, (2,), 528, 256, 4, 264)
    dn = rand_experts(g, dev, (2,), 128, 528, 4, 128)
    assert not moe_prefill.supports(gu, dn, 528, 8)


# (bits, E, C, H, mi, block of gate/up, block of down): qwen1.5-moe-a2.7b's
# and qwen3-moe-30b-a3b's widths at quant_block 256, the partial algebra
# (C below the block) and the dequantize one, a 256 product beside a 128 one
BLOCK256_MOE = [(4, 4, 72, 2048, 1408, 256, 176), (4, 8, 64, 2048, 768, 256, 256),
                (8, 2, 300, 512, 256, 256, 256), (4, 2, 200, 512, 704, 256, 176),
                (4, 3, 17, 256, 320, 256, 160), (4, 2, 144, 1024, 512, 256, 128)]


@pytest.mark.parametrize("bits,e,cap,h,mi,bs_h,bs_mi", BLOCK256_MOE)
def test_block256_moe_prefill(dev, bits, e, cap, h, mi, bs_h, bs_mi):
    """Row 9 at blocks above 128: two launches a call, rel-L2 2e-2, empty
    slots zero, the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(e * cap + h + bs_mi)
    gu = rand_experts(g, dev, (e,), h, 2 * mi, bits, bs_h)
    dn = rand_experts(g, dev, (e,), mi, h, bits, bs_mi)
    xe = torch.randn((e, cap, h), device=dev, generator=g).to(torch.bfloat16)
    w_e = torch.rand((e, cap), device=dev, generator=g)
    xe[:, cap - 3:] = 0
    w_e[:, cap - 3:] = 0
    assert moe_prefill.supports(gu, dn, h, cap)
    tile = moe_prefill.tile(e, cap, h, mi, bits, bs_h)
    before = moe_prefill.KERNEL.launches
    got = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
    again = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
    want = moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn)
    torch.cuda.synchronize()
    assert moe_prefill.KERNEL.launches == before + 2
    assert got.shape == (e, cap, h) and torch.isfinite(got).all()
    err = rel(got, want)
    print(f"grouped experts blocks {bs_h}/{bs_mi} E={e} C={cap} H={h} mi={mi} W{bits} "
          f"tile={tile}: rel-L2 {err:.3e}")
    assert err <= 2e-2
    assert (got[:, cap - 3:] == 0).all()
    assert torch.equal(got, again)


QWEN7B_2L = dict(hidden_size=3584, intermediate_size=18944, num_layers=2, num_heads=28,
                 num_kv_heads=4, head_dim=128, vocab_size=1024)


# (config changes, weight bits, kv bits, head bits, lengths): qwen2-7b's
# widths at 2 layers with the head fused, and the mk-test shape at batch 1
# to 8, W4 and W8
BLOCK256_MODEL = [(QWEN7B_2L, 4, 8, 4, (331,)), (QWEN7B_2L, 4, 8, 4, (40, 9, 127, 0)),
                  ({}, 4, 8, 4, (9,)), ({}, 8, 4, 8, (33, 5)),
                  ({}, 4, 16, 4, (1, 63, 64, 65, 127, 0, 9, 100))]


@pytest.mark.parametrize("changes,bits,kv_bits,head_bits,lengths", BLOCK256_MODEL)
def test_block256_decode_model(dev, changes, bits, kv_bits, head_bits, lengths):
    """Row 7 at quant_block 256 (every projection and the head): within
    `decode_model.PARITY_BOUNDS` of the plain version, the same bits twice."""
    deep4 = dict(rows_levels=1.0, rows_rel=1.5e-1) if kv_bits == 4 else {}
    check_decode_model(dev, changes, bits, kv_bits, head_bits, lengths, quant_block=256,
                       **deep4)


@pytest.mark.parametrize("bits,n", [(4, 1), (4, 4), (8, 1)])
def test_block256_moe_decode(dev, bits, n):
    """Row 8 at qwen3-moe-30b-a3b's widths (H 2,048, 128 experts top-8 of
    768) at quant_block 256: rel-L2 2e-2, the same bits twice."""
    e, k, h, mi = 128, 8, 2048, 768
    cfg = moe_cfg(h, e, k, mi, 0)
    g = torch.Generator(device=dev).manual_seed(n * h + bits)
    lay = decoder.LayerParams(
        wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
        wgu_e=rand_experts(g, dev, (cfg.num_layers, e), h, 2 * mi, bits, 256),
        wdown_e=rand_experts(g, dev, (cfg.num_layers, e), mi, h, bits, 256))
    x = torch.randn((n, h), device=dev, generator=g) * 0.5
    sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k] for _ in range(n)])
    wsel = torch.rand((n, k), device=dev, generator=g)
    assert moe_decode.supports(cfg, lay, n)
    before = moe_decode.KERNEL.launches
    got = moe_decode.moe_decode_mlp(x, lay, sel, wsel, 2, None, config=cfg)
    again = moe_decode.moe_decode_mlp(x, lay, sel, wsel, 2, None, config=cfg)
    want = moe_decode.moe_decode_mlp_plain(x, lay, sel, wsel, 2, None, config=cfg)
    torch.cuda.synchronize()
    assert moe_decode.KERNEL.launches == before + 2
    assert got.shape == (n, h) and torch.isfinite(got).all()
    err = rel(got, want)
    print(f"fused experts block 256 n={n} W{bits}: rel-L2 {err:.3e}")
    assert err <= 2e-2
    assert torch.equal(got, again)
