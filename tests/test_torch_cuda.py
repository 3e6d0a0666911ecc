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
import math

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


def check_decode_model(dev, changes, bits, kv_bits, head_bits, lengths, **bounds):
    """The kernel against its plain version from the same state, within
    `decode_model.PARITY_BOUNDS` (`bounds` replaces some); the same bits
    again with the cache written in place, and the rows where they belong."""
    cfg = dataclasses.replace(MK, **changes)
    b, s = len(lengths), 128
    gen = torch.Generator().manual_seed(bits + kv_bits + b)
    params = decoder.init_random_params(cfg, gen, quant_bits=bits, scale=0.05,
                                        lm_head_bits=head_bits, device=dev)
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
    assert not decode_model.parity_failures(m, **bounds), m
    # the same launch again gives the same bits, and wrote the rows in place
    for a, c in zip(got, again):
        assert a is None or torch.equal(a, c)
    pos = lens.long().clamp(0, s - 1)
    bi = torch.arange(b, device=dev)
    assert torch.equal(kc[:, bi, :, pos].float(), got[1][:, :, :, 0].transpose(0, 1))
    assert torch.equal(vc[:, bi, :, pos].float(), got[2][:, :, :, 0].transpose(0, 1))
    if kv_bits < 16:
        assert torch.equal(ks[:, bi, :, pos], got[3][:, :, :, 0].transpose(0, 1))


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
