#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mnn_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. the card (`nvidia-smi` name and power limit) and the build of the
   hand-written kernels from `mnn_tpu_torch/csrc/` with nvcc for sm_90a;
2. every kernel of the serving paths at the shapes those paths give it,
   held against its plain PyTorch version on the same inputs on the card,
   with its time, the plain version's time, one PyTorch library call's time
   as a yardstick where one call computes the same function, and the least
   time the card could take (bound). The int8-row matmul is also timed
   alone on rows quantized beforehand and beside `torch._int_mm` on its
   re-centred int8 pattern, at M = 512 and at the 32- and 128-row
   buckets. The bf16-row matmul runs the split GEMV kernel at M = 1 (each
   row with its tiles and K ranges; two calls must give the same bits) and
   the tensor-core tile kernel above (the shared expert at the 32-, 128- and
   512-row buckets, qwen2-0.5b's projections at M = 512), each row with the
   kernel it launched and its tile. Flash prefill runs the prefill chunks
   of the three requests (also the short chunk over the long cache at batch
   2, and the chunk serving sends for the 300-token prompt), each row with
   the tiling the kernel took and SDPA's time. The decode step runs the
   last decode step of the three requests on qwen2-0.5b's and
   qwen1.5-moe-a2.7b's heads and at batch 2, each row with its split
   (blocks a cluster, positions a tile) and SDPA's time; two calls must
   give the same bits. Flash decode runs the last decode step of the three
   requests at int8 and int4 with qwen2-0.5b's and qwen1.5-moe-a2.7b's
   heads, at batch 2, and at kv_len 4000 of 4096, each row with its split
   (blocks a KV head) and SDPA's time; two calls must give the same bits
   (the first six rows are also summed alone, `six_shapes`). The
   whole-model decode kernel runs
   full-size `qwen2-0.5b` (int8, int4 and bf16 caches, batch 1 and 4), two
   layers at `qwen2-7b` widths and all 28 of qwen2-7b (each row with the
   schedule the kernel walked; two calls must give the same bits); the two mixture-of-experts kernels and
   the dequantize-tile matmul at `qwen1.5-moe-a2.7b`'s and
   `qwen3-moe-30b-a3b`'s widths, each row with the tile the kernel took
   (the fused expert kernel's with the share of its bound it reaches);
   both expert kernels must give the same bits twice;
3. the serving paths themselves on `Llm.synthetic("qwen2-0.5b")` at full
   width and depth (W4 block-128 weights, int4 lm head, int8 prefill
   activations), each with the launch counts set to 0 before and read after:
   (a) three greedy requests of 17, 300 and 600 prompt tokens and 32 new
   tokens each over an int8 KV cache, decoded by the whole-model kernel, one
   launch per generated token; (b) one request over an int4 KV cache, the
   same way; (c) the per-layer fallback (`forward(megakernel=False)`), a
   prompt and 8 decode steps over an int8 and over an int4 cache, which
   runs the decode-step and flash-decode kernels; (f) the 300-token request
   with `prefill_act_bits=16`, the library's default: every prefill
   projection on bf16 rows through the tensor-core tile kernel, 96 launches
   a chunk; (d) `Llm.synthetic(
   "qwen1.5-moe-a2.7b")` at its 24 layers, the same three requests: the
   grouped expert kernel 24 times per prefill chunk, the shared expert on the
   tile kernel 48 times per chunk, the fused expert kernel
   and the decode-step kernel 24 times per token, the whole-model kernel
   never; (e) the 300-token request again with the dequantize-tile switch on
   (`dequant_matmul.DEQ_MIN_M = 512`), held against (d)'s logits. A kernel
   of a path that was launched no time in that path's run fails the script;
4. the first request again, prefill and 8 decode steps, on the card and
   through the plain versions on the CPU with the same weights: logits
   within rel-L2 5e-2 and equal tokens wherever the CPU's top-2 margin
   exceeds the largest logit difference seen; then the whole-model kernel
   against the per-layer path on the card from the same state, and the
   first request's prefill with `prefill_act_bits=16` on both. The same
   for the mixture-of-experts model at full width and 4 layers (the CPU side
   of 24 would take minutes).

It then prints one JSON line with every kernel's numbers (the bf16-row
matmul also split into `m1`, the GEMV kernel, and `m_gt1`, the tile kernel)
and, last, the device line. Details go to `chiprun_out/chip_smoke.json`. It imports no JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))      # the checkout's package, not an installed one

import numpy as np
import torch

import mnn_tpu_torch
from mnn_tpu_torch.kernels import (build, decode_model, decode_step, dequant_matmul,
                                   flash_attention, moe_decode, moe_prefill)
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, RuntimeConfig
from mnn_tpu_torch.models.layers import rope_cos_sin
from mnn_tpu_torch.quant import quantize
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import generate, kvcache
from mnn_tpu_torch.runtime.llm import Llm

HBM_BYTES_S = 3.35e12       # H100 SXM device memory (data sheet)
BF16_OPS_S = 989e12         # dense bf16 tensor-core peak
INT8_OPS_S = 1979e12        # dense int8 tensor-core peak
L2_ROTATE_BYTES = 128 << 20  # rotate over this many weight bytes: > 50 MB L2

PREFILL_LENS = (17, 300, 600)
NEW_TOKENS = 32
PARITY_STEPS = 8
FALLBACK_PROMPT = 300       # phase 3c: the per-layer path's prompt
PARITY_REL = 5e-2           # JAX megakernel logits bound, tests/test_decode_model.py:97
SEED = 0                    # weights and inputs
MOE_PRESET = "qwen1.5-moe-a2.7b"
MOE_PARITY_LAYERS = 4       # phase 4, mixture of experts: depth of both sides
MOE_TOL = 2e-2              # both expert kernels, tests/test_moe_decode.py:61


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, calls: int, replays: int = 3) -> float:
    """Device time of one `fn(i)` call. The calls are captured into a CUDA
    graph and replayed, so the time is the card's and not Python's launch
    overhead."""
    for i in range(2):                          # warm-up (allocator, handles)
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def event_ms(fn, calls: int) -> float:
    """Device time of one `fn(i)` call from CUDA events around a plain loop
    of launches, for a kernel that takes far longer than its enqueue: the
    whole-model decode kernel is a cooperative launch, which is kept out of
    graph capture here."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profiled_device_ms(fn, calls: int):
    """(device ms, kernel launches) of one `fn()` call: the sum of the
    kernels' device times that torch.profiler records over `calls` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    check(bool(evs), "the profiler recorded no device time")
    return (sum(e.self_device_time_total for e in evs) / 1e3 / calls,
            sum(e.count for e in evs) / calls)


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main-path shapes
# --------------------------------------------------------------------------

def rand_quantized(g, dev, k, n, *, layers, bits=4,
                   bs=128, with_bias=False, act_bits=16):
    packed = torch.randint(-128, 128, (layers, k * bits // 8, n),
                           dtype=torch.int8, device=dev, generator=g)
    scale = (torch.rand((layers, k // bs, n), device=dev, generator=g)
             * 2e-3 + 1e-3).to(torch.bfloat16)
    bias = (-7.5 * scale.float()
            + torch.randn((layers, k // bs, n), device=dev, generator=g)
            * 1e-3).to(torch.bfloat16)
    ob = (torch.randn((layers, n), device=dev, generator=g) * 0.1
          if with_bias else None)
    return QuantizedLinear(packed=packed, scale=scale, bias=bias, out_bias=ob,
                           bits=bits, block_size=bs, act_bits=act_bits)


def copies_for(nbytes: int, cap: int = 512) -> int:
    return max(1, min(cap, math.ceil(L2_ROTATE_BYTES / max(nbytes, 1))))


def bound_of(ops: float, nbytes: float, ops_s: float = BF16_OPS_S):
    """(least ms the card could take, which of the two limits it)."""
    t_ops, t_bytes = ops / ops_s, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


PROJ = {  # qwen2-0.5b: (K, N, has out_bias) per projection
    "qkv": (896, 1152, True),
    "wo": (896, 896, False),
    "wgu": (896, 9728, False),
    "wdown": (4864, 896, False),
}
MOE_PROJ = {  # qwen1.5-moe-a2.7b's attention projections
    "moe_qkv": (2048, 6144, True),
    "moe_wo": (2048, 2048, False),
}


def a8_kernel_alone(ql, x, out_dtype, nl):
    """Device ms of `KERNEL_A8` alone, on rows quantized beforehand: the
    whole call also runs `quantize_activations_int8`'s torch ops."""
    m, k = x.shape
    xq, xs = quantize.quantize_activations_int8(x)
    xs = xs.reshape(m).contiguous()
    out = torch.empty((m, ql.out_features), dtype=out_dtype, device=x.device)

    def launch(i):
        q = ql.layer(i % nl)
        dequant_matmul.KERNEL_A8(
            xq.data_ptr(), xs.data_ptr(), q.packed.data_ptr(), q.scale.data_ptr(),
            q.bias.data_ptr(), None if q.out_bias is None else q.out_bias.data_ptr(),
            out.data_ptr(), m, k, ql.out_features, ql.bits, ql.block_size,
            int(out_dtype == torch.float32))
    return time_ms(launch, calls=max(nl, 8)), xq


def int_mm_ms(ql, xq, nl):
    """Yardstick: `torch._int_mm` of the int8 rows with the re-centred int8
    pattern [K, N] (column-major, as cuBLASLt takes it), with no per-block
    scales: the rate cuBLAS reaches on the int8 tensor cores."""
    k, n = xq.shape[1], ql.out_features
    center = 1 << (ql.bits - 1)
    nint = copies_for(k * n, cap=nl)
    wq = [(quantize.unpack_bits(ql.packed[i], ql.bits, ql.block_size) - center)
          .to(torch.int8).t().contiguous().t() for i in range(nint)]
    return time_ms(lambda i: torch._int_mm(xq, wq[i % nint]), calls=max(nint, 8))


def phase_gemm(dev, g, results, *, a8: bool):
    """K1 (bf16 rows: at M = 1 the decode GEMVs and the lm head on the GEMV
    kernel; at M > 1 the tensor-core tile kernel, for qwen1.5-moe-a2.7b's
    shared expert at the 32-, 128- and 512-row buckets and qwen2-0.5b's
    projections at M = 512 under prefill_act_bits=16) or K2 (int8 rows,
    M = 512: prefill GEMMs; and qwen2-0.5b's gate/up at the 32- and
    128-row buckets)."""
    name = "dequant_matmul_a8" if a8 else "dequant_matmul"
    shapes = [(p, k, n, b, 512 if a8 else 1)
              for p, (k, n, b) in list(PROJ.items()) + list(MOE_PROJ.items())]
    if a8:
        shapes += [("wgu", *PROJ["wgu"], 32), ("wgu", *PROJ["wgu"], 128)]
    else:
        shapes += [("lm_head", 896, 151936, False, 1),
                   ("moe_lm_head", 2048, 151936, False, 1)]
        # qwen1.5-moe-a2.7b's shared expert in a prefill chunk: bf16 rows
        shapes += [(p, k, n, False, m) for m in (32, 128, 512)
                   for p, k, n in (("moe_shared_gu", 2048, 11264),
                                   ("moe_shared_dn", 5632, 2048))]
        shapes += [(p, k, n, b, 512) for p, (k, n, b) in PROJ.items()]
    tol = 1e-2
    rows = []
    for proj, k, n, with_bias, m in shapes:
        # the shared expert's down projection gives f32 rows, as in the model
        out_dtype = (torch.float32 if proj.endswith("lm_head") or proj == "moe_shared_dn"
                     else torch.bfloat16)
        wbytes = k * n // 2 + 2 * (k // 128) * n * 2 + (n * 4 if with_bias else 0)
        nl = copies_for(wbytes)
        ql = rand_quantized(g, dev, k, n, layers=nl,
                            with_bias=with_bias, act_bits=8 if a8 else 16)
        x = (torch.randn((m, k), device=dev, generator=g)).to(torch.bfloat16)
        tile = None if a8 else dequant_matmul.bf16_tile(m, n, ql.bits)
        kern = (dequant_matmul.KERNEL_A8 if a8 else
                dequant_matmul.KERNEL_BF16_TILE if tile else dequant_matmul.KERNEL_BF16)
        before = kern.launches
        got = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
        check(kern.launches == before + 1, f"{name} {proj} M={m}: {kern.name} not launched")
        if m == 1:   # the GEMV's K ranges meet in a fixed order
            again = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
            check(torch.equal(got, again), f"{name} {proj} M=1: two calls gave different bits")
        check(a8 or (tile is None) == (m == 1),
              f"{name} {proj} M={m}: bf16 rows took {kern.name}")
        want = dequant_matmul.dequant_matmul_plain(x, ql.layer(0), out_dtype)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{name} {proj}: non-finite output")
        check(rel <= tol, f"{name} {proj} M={m}: rel-L2 {rel:.3g} > {tol}")
        ms = time_ms(lambda i: dequant_matmul.dequant_matmul(
            x, ql, layer_index=i % nl, out_dtype=out_dtype), calls=max(nl, 8))
        plain_ms = time_ms(lambda i: dequant_matmul.dequant_matmul_plain(
            x, ql.layer(i % nl), out_dtype), calls=2, replays=2)
        # yardstick: one bf16 torch.matmul on weights dequantized beforehand
        nlib = copies_for(k * n * 2, cap=nl)
        wlib = [quantize.dequantize(ql.layer(i), dtype=torch.bfloat16)
                for i in range(nlib)]
        ob = ql.out_bias
        lib_ms = time_ms(lambda i: (
            torch.matmul(x, wlib[i % nlib]) if ob is None
            else torch.addmm(ob[i % nlib].to(torch.bfloat16), x, wlib[i % nlib])),
            calls=max(nlib, 8))
        del wlib
        out_b = m * n * (4 if out_dtype == torch.float32 else 2)
        nbytes = (m * k + m * 4 if a8 else m * k * 2) + wbytes + out_b
        bound, bound_by = bound_of(2 * m * k * n, nbytes,
                                   INT8_OPS_S if a8 else BF16_OPS_S)
        row = dict(shape=f"{proj} M={m} K={k} N={n}", m=m, max_abs_err=err, rel_l2=rel,
                   tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   l2_rotation=nl, kernel=kern.name)
        extra = ""
        if tile:
            row["tile"] = tile
            extra = f" | tile {tile[0]}x{tile[1]} smem {tile[2]}"
        elif not a8:
            cols, ranges, blocks, smem = dequant_matmul.gemv_split(k, n, ql.bits, ql.block_size)
            row["split"] = dict(tile=cols, k_ranges=ranges, blocks=blocks, smem=smem)
            extra = f" | {cols}-column tiles x {ranges} K ranges, {blocks} blocks, smem {smem}"
        if a8:
            row["kernel_alone_ms"], xq = a8_kernel_alone(ql, x, out_dtype, nl)
            row["int_mm_ms"] = int_mm_ms(ql, xq, nl)
            row["tile"] = dequant_matmul.a8_tile(m, n, ql.bits)
            extra = (f" | alone {row['kernel_alone_ms']:.4f} int_mm {row['int_mm_ms']:.4f} "
                     f"tile {row['tile'][0]}x{row['tile'][1]} smem {row['tile'][2]}")
        rows.append(row)
        print(f"  {name:18s} {row['shape']:32s} rel {rel:.2e} max_abs {err:.3g} | "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} lib {lib_ms:.4f} "
              f"bound {bound:.4f} ({bound_by}){extra}", flush=True)
        del ql, x, got, want
        torch.cuda.empty_cache()
    results[name] = rows


def phase_flash(dev, g, results):
    """K3 at the prefill chunks of the three requests (cache capacity 1024),
    with qwen2-0.5b's heads and, for two of the chunks, qwen1.5-moe-a2.7b's;
    the short chunk over the long cache also at batch 2, and the chunk the
    300-token request sends the mixture-of-experts model in serving. Each
    row with the tiling the kernel took (`flash_attention.prefill_tile`)."""
    cap = 1024
    tol = 2e-2
    rows = []
    # (B, H, Hkv, D, bucket, kv_len, q_offset): 17 -> 32, 300 -> 512,
    # 600 -> 512 + 128, kv_len the prompt's length. Serving appends the
    # whole padded bucket before attention (and rolls the tail back after),
    # so it runs kv_len = 32, 512 and 640: the last row is that shape for
    # the 300-token request on qwen1.5-moe-a2.7b.
    for b, h, hkv, d, t, kv_len, q_off in (
            (1, 14, 2, 64, 32, 17, 0), (1, 14, 2, 64, 512, 300, 0), (1, 14, 2, 64, 512, 512, 0),
            (1, 14, 2, 64, 128, 600, 512), (1, 16, 16, 128, 512, 300, 0),
            (1, 16, 16, 128, 128, 600, 512), (2, 16, 16, 128, 128, 600, 512),
            (1, 16, 16, 128, 512, 512, 0)):
        q = torch.randn((b, h, t, d), device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn((b, hkv, cap, d), device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn((b, hkv, cap, d), device=dev, generator=g).to(torch.bfloat16)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
        got = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
        want = flash_attention.flash_attention_plain(q, k, v, kl, qo)
        torch.cuda.synchronize()
        # rows past the prompt (padded bucket tail) are rolled back; the
        # kernel's contract still covers them, so they are compared too
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), "flash_prefill: non-finite output")
        check(rel <= tol, f"flash_prefill B={b} T={t} kv={kv_len}: rel-L2 {rel:.3g} > {tol}")
        ms = time_ms(lambda i: flash_attention.flash_attention(
            q, k, v, kv_len=kl, q_offset=qo), calls=24)
        plain_ms = time_ms(lambda i: flash_attention.flash_attention_plain(
            q, k, v, kl, qo), calls=4, replays=2)
        mask = flash_attention._mask(b, t, cap, kl, qo, True, 0, 0, dev)
        kr = k.repeat_interleave(h // hkv, dim=1)
        vr = v.repeat_interleave(h // hkv, dim=1)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask), calls=24)
        visible = sum(min(kv_len, q_off + r + 1) for r in range(t))
        flops = 4 * b * h * d * visible
        nbytes = 2 * b * (2 * h * t * d + 2 * hkv * kv_len * d)
        bound, bound_by = bound_of(flops, nbytes)
        rows_a_block, splits, bkv, smem, blocks = flash_attention.prefill_tile(b, h, t, d)
        row = dict(shape=f"B={b} H={h} Hkv={hkv} D={d} T={t} kv_len={kv_len} q_offset={q_off} "
                         f"S={cap}",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=bound_by, tile=dict(rows=rows_a_block, kv_splits=splits,
                                                kv_tile=bkv, smem=smem, blocks=blocks))
        rows.append(row)
        print(f"  flash_prefill      {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} ({bound_by}) | "
              f"{rows_a_block} rows x {blocks} blocks, K/V in {splits} splits of "
              f"{bkv}-position tiles, smem {smem}",
              flush=True)
    results["flash_prefill"] = rows


# K4's rows: (batch, Hkv, G, D, len_old per sequence) at the last decode step
# of the 17-, 300- and 600-token requests (len_old 48, 331, 631): qwen2-0.5b's
# heads at the three and qwen1.5-moe-a2.7b's at 331 first, then
# qwen1.5-moe-a2.7b's at 48 and 631, and qwen2-0.5b at batch 2 with ragged
# lengths.
DECODE_ROWS = [(1, 2, 7, 64, (48,)), (1, 2, 7, 64, (331,)), (1, 2, 7, 64, (631,)),
               (1, 16, 1, 128, (331,)), (1, 16, 1, 128, (48,)), (1, 16, 1, 128, (631,)),
               (2, 2, 7, 64, (331, 631))]
DECODE_FIRST_ROWS = 4   # the rows the kernels line summed before the last three


def phase_decode(dev, g, results):
    """K4 at the rows of DECODE_ROWS over a 24-layer int8 cache of capacity
    1024, each with the split the kernel took (`decode_step.split`): blocks a
    cluster, positions a tile, shared bytes a block, blocks. Two calls must
    give the same bits."""
    L, cap = 24, 1024
    tol = 3e-2
    rows = []
    kq = None
    for bsz, hkv, grp, d, lens in DECODE_ROWS:
        if kq is None or kq.shape[1:4] != (bsz, hkv, cap):
            kq = vq = None
            kf = torch.randn((L, bsz, hkv, cap, d), device=dev, generator=g)
            kq, ks = kvcache.quantize_kv(kf)
            kf = torch.randn((L, bsz, hkv, cap, d), device=dev, generator=g)
            vq, vs = kvcache.quantize_kv(kf)
            del kf
        qkv = torch.randn((bsz, hkv, grp + 2, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        ang = torch.rand((bsz, d // 2), device=dev, generator=g) * 6.28
        cos = torch.cat([ang.cos(), ang.cos()], -1)
        sin = torch.cat([ang.sin(), ang.sin()], -1)
        got = decode_step.fused_decode_attention(qkv, kq, vq, ks, vs, 3, lengths, cos, sin)
        again = decode_step.fused_decode_attention(qkv, kq, vq, ks, vs, 3, lengths, cos, sin)
        want = decode_step.fused_decode_attention_plain(qkv, kq, vq, ks, vs, 3, lengths, cos,
                                               sin, None, None, 1e-6, d ** -0.5, 0, 0, 0.0)
        torch.cuda.synchronize()
        name = f"decode_step B={bsz} len={lens}"
        err, rel = max_abs(got[0], want[0]), rel_l2(got[0], want[0])
        check(bool(torch.isfinite(got[0]).all()), f"{name}: non-finite output")
        check(rel <= tol, f"{name}: att rel-L2 {rel:.3g} > {tol}")
        for j, nm in ((1, "k_row"), (2, "v_row")):
            lv = max_abs(got[j], want[j])
            check(lv <= 1.0, f"{name} {nm}: {lv} int8 levels apart")
        for j, nm in ((3, "k_scale"), (4, "v_scale")):
            check(rel_l2(got[j], want[j]) <= 1e-6, f"{name} {nm} differs")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name}: two calls gave different bits")
        ms = time_ms(lambda i: decode_step.fused_decode_attention(
            qkv, kq, vq, ks, vs, i % L, lengths, cos, sin), calls=48)
        plain_ms = time_ms(lambda i: decode_step.fused_decode_attention_plain(
            qkv, kq, vq, ks, vs, i % L, lengths, cos, sin, None, None, 1e-6,
            d ** -0.5, 0, 0, 0.0), calls=8, replays=2)
        # yardstick: SDPA of the query rows over the dequantized rows, each
        # sequence masked to its len_old + 1 positions
        q = qkv[:, :, :grp].reshape(bsz, hkv * grp, 1, d)
        n = max(lens) + 1
        kd = kvcache.dequant_kv(kq[3], ks[3], 8)[:, :, :n].repeat_interleave(grp, 1)
        vd = kvcache.dequant_kv(vq[3], vs[3], 8)[:, :, :n].repeat_interleave(grp, 1)
        mask = (torch.arange(n, device=dev)[None, :] <= lengths[:, None])[:, None, None]
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), calls=48)
        nbytes = bsz * (hkv * (grp + 2) * d * 2 + 2 * d * 4        # qkv, cos/sin
                        + hkv * grp * d * 2 + 2 * hkv * (d + 1) * 4)   # att, rows, scales
        nbytes += sum(2 * hkv * n_old * (d + 4) for n_old in lens)     # int8 K/V + scales
        bound = nbytes / HBM_BYTES_S * 1e3
        blocks_a_cluster, tile, smem, blocks = decode_step.split(bsz, hkv, grp, cap, d, True)
        row = dict(shape=f"B={bsz} Hkv={hkv} G={grp} D={d} len_old={','.join(map(str, lens))} "
                         f"S={cap} int8",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by="bytes", split=dict(blocks_a_cluster=blocks_a_cluster, tile=tile,
                                                smem=smem, blocks=blocks))
        rows.append(row)
        print(f"  decode_step        {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} | clusters of "
              f"{blocks_a_cluster} blocks, {tile}-position tiles, smem {smem}, {blocks} blocks",
              flush=True)
    del kq, vq
    results["decode_step"] = rows


def rand_cache(g, dev, layers, batch, hkv, cap, d, bits):
    """A cache filled with quantized random rows: (k, v, k_scale, v_scale)."""
    kf = torch.randn((layers, batch, hkv, cap, d), device=dev, generator=g)
    vf = torch.randn((layers, batch, hkv, cap, d), device=dev, generator=g)
    if bits == 16:
        return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    kq, ks = kvcache.quantize_for(bits, kf)
    vq, vs = kvcache.quantize_for(bits, vf)
    return kq, vq, ks, vs


# K5's rows: (B, Hkv, G, D, kv bits, kv_len per sequence, capacity). The last
# decode step of the 17-, 300- and 600-token requests (kv_len counts the new
# token) with qwen2-0.5b's heads at int8 and int4 first (the six rows the
# kernels line summed before the rest), then qwen1.5-moe-a2.7b's at both
# widths, a ragged batch 2, and kv_len 4000 of a 4096 cache at int4.
FLASH_DECODE_ROWS = [(1, 2, 7, 64, bits, (n + NEW_TOKENS,), 1024)
                     for bits in (8, 4) for n in PREFILL_LENS]
FLASH_DECODE_ROWS += [(1, 16, 1, 128, bits, (n + NEW_TOKENS,), 1024)
                      for bits in (8, 4) for n in PREFILL_LENS]
FLASH_DECODE_ROWS += [(2, 2, 7, 64, 8, (332, 632), 1024), (1, 16, 1, 128, 4, (4000,), 4096)]
FLASH_DECODE_FIRST_ROWS = 6


def phase_flash_decode(dev, g, results):
    """K5 at the rows of FLASH_DECODE_ROWS over a 24-layer cache, each with
    the split the kernel took (`flash_attention.decode_split`): blocks a KV
    head, positions a tile, shared bytes a block, blocks. Two calls must give
    the same bits."""
    L = 24
    tol = 3e-2                      # tests/test_attention.py:126
    rows = []
    key = kq = None
    for bsz, hkv, grp, d, bits, lens, cap in FLASH_DECODE_ROWS:
        if kq is None or key != (bsz, hkv, d, bits, cap):
            kq = vq = ks = vs = None        # the last cache goes first
            key = (bsz, hkv, d, bits, cap)
            kq, vq, ks, vs = rand_cache(g, dev, L, bsz, hkv, cap, d, bits)
        q = torch.randn((bsz, hkv * grp, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        name = f"flash_decode B={bsz} Hkv={hkv} int{bits} kv_len={lens}"
        got = flash_attention.decode_attention(q, kq, vq, lengths, k_scale=ks,
                                               v_scale=vs, layer_index=3)
        again = flash_attention.decode_attention(q, kq, vq, lengths, k_scale=ks,
                                                 v_scale=vs, layer_index=3)
        want = flash_attention.decode_attention_plain(q, kq, vq, lengths, ks, vs, 3)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(rel <= tol, f"{name}: rel-L2 {rel:.3g} > {tol}")
        check(torch.equal(got, again), f"{name}: two calls gave different bits")
        ms = time_ms(lambda i: flash_attention.decode_attention(
            q, kq, vq, lengths, k_scale=ks, v_scale=vs, layer_index=i % L), calls=48)
        plain_ms = time_ms(lambda i: flash_attention.decode_attention_plain(
            q, kq, vq, lengths, ks, vs, i % L), calls=8, replays=2)
        # yardstick: SDPA of the query rows over the dequantized rows, each
        # sequence masked to its kv_len
        n = max(lens)
        q4 = q.reshape(bsz, hkv * grp, 1, d)
        kd = kvcache.dequant_kv(kq[3], ks[3], bits)[:, :, :n].repeat_interleave(grp, 1)
        vd = kvcache.dequant_kv(vq[3], vs[3], bits)[:, :, :n].repeat_interleave(grp, 1)
        mask = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, None]
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask), calls=48)
        nbytes = 2 * bsz * hkv * grp * d * 2                           # q in, out
        nbytes += sum(2 * hkv * kv_len * (d * bits // 8 + 4) for kv_len in lens)
        bound = nbytes / HBM_BYTES_S * 1e3
        blocks_a_head, tile, smem, blocks = flash_attention.decode_split(bsz, hkv, grp, cap,
                                                                         d, bits)
        row = dict(shape=f"B={bsz} Hkv={hkv} G={grp} D={d} kv_len={','.join(map(str, lens))} "
                         f"S={cap} int{bits}",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by="bytes",
                   split=dict(blocks_a_head=blocks_a_head, tile=tile, smem=smem,
                              blocks=blocks))
        rows.append(row)
        print(f"  flash_decode       {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} | {blocks_a_head} "
              f"blocks a KV head, {tile}-position tiles, smem {smem}, {blocks} blocks",
              flush=True)
    del kq, vq, ks, vs
    results["flash_decode"] = rows


def decode_model_bytes(cfg, lay, head, batch, kv_bits, lengths) -> int:
    """Bytes one step must move: every weight, plane, bias and norm byte and
    the head once, the cached K/V rows and scales of this run's lengths, x in,
    and x, the new rows and the logits out."""
    def ql_bytes(ql):
        return sum(t.numel() * t.element_size()
                   for t in (ql.packed, ql.scale, ql.bias, ql.out_bias) if t is not None)
    n = sum(ql_bytes(q) for q in (lay.wqkv, lay.wo, lay.wgu, lay.wdown, head))
    n += (lay.input_norm.numel() + lay.post_norm.numel() + cfg.hidden_size) * 4
    row = cfg.head_dim * kv_bits // 8 + (4 if kv_bits < 16 else 0)
    n += 2 * cfg.num_layers * cfg.num_kv_heads * row * (sum(lengths) + batch)
    n += batch * (2 * cfg.hidden_size + cfg.vocab_size) * 4
    return n


def step_inputs(params, cfg, lengths, dev, g):
    """x, lengths and rope phases of one decode step, as `forward` makes them."""
    b = len(lengths)
    tok = torch.randint(0, cfg.vocab_size, (b,), device=dev, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(lens[:, None].long(), cfg.head_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling)
    cos_f = torch.cat([cos[:, 0], cos[:, 0]], dim=-1)
    sin_f = torch.cat([sin[:, 0], sin[:, 0]], dim=-1)
    return tok, params.embedding[tok], lens, cos_f, sin_f


DECODE_MODEL_FIRST_ROWS = 7   # the rows the kernels line summed before the 28-layer one


def phase_decode_model(dev, g, results, params05):
    """K7: the whole-model decode kernel against its plain version from the
    same state. Full-size qwen2-0.5b (the serving weights) over an int8 cache
    at the three requests' last steps, an int4 and a bf16 cache, and batch 4
    with unequal lengths; then two layers at qwen2-7b widths, and qwen2-7b at
    its full 28 layers. Each row prints the schedule the kernel walked, and
    two calls must give the same bits."""
    cap = 1024
    cfg05 = PRESETS["qwen2-0.5b"]
    cfg7 = dataclasses.replace(PRESETS["qwen2-7b"], num_layers=2)
    t0 = time.perf_counter()
    params7 = decoder.init_random_params(
        cfg7, torch.Generator().manual_seed(SEED + 1), lm_head_bits=4, device=dev)
    print(f"  qwen2-7b widths, 2 layers: built in {time.perf_counter() - t0:.1f} s", flush=True)
    last = [n + NEW_TOKENS - 1 for n in PREFILL_LENS]
    cases = [("qwen2-0.5b", cfg05, params05, 8, (last[0],)),
             ("qwen2-0.5b", cfg05, params05, 8, (last[1],)),
             ("qwen2-0.5b", cfg05, params05, 8, (last[2],)),
             ("qwen2-0.5b", cfg05, params05, 4, (last[1],)),
             ("qwen2-0.5b", cfg05, params05, 16, (last[1],)),
             ("qwen2-0.5b", cfg05, params05, 8, (last[0], last[1], last[2], 5)),
             ("qwen2-7b x2 layers", cfg7, params7, 8, (last[1],)),
             # the whole of qwen2-7b's depth (built below): the shape held by bytes
             ("qwen2-7b", PRESETS["qwen2-7b"], None, 8, (last[1],))]
    rows = []
    for name, cfg, params, kv_bits, lengths in cases:
        if params is None:
            t0 = time.perf_counter()
            params = decoder.init_random_params(
                cfg, torch.Generator().manual_seed(SEED + 1), lm_head_bits=4, device=dev)
            print(f"  qwen2-7b, {cfg.num_layers} layers: built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        b = len(lengths)
        kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, cap,
                                    cfg.head_dim, kv_bits)
        tok, x, lens, cos_f, sin_f = step_inputs(params, cfg, lengths, dev, g)
        args = (x, params.layers, kc, vc, ks, vs, lens, cos_f, sin_f)
        kw = dict(config=cfg, head=params.lm_head, final_norm=params.final_norm)
        check(decode_model.supports_head(cfg, params), f"{name}: head not fusable")
        got = decode_model.fused_decode_model(*args, **kw)
        want = decode_model.fused_decode_model_plain(*args, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
              f"decode_model {name}: non-finite output")
        m = decode_model.parity_metrics(got, want, kv_bits)
        # x_out is held at three layers by the tests; at full depth the
        # residual stream's bf16 noise compounds (x rel-L2 ~3e-2) and only
        # the logits are held. An int4 level is 18 times an int8 level's
        # size, so that noise, far below one level, still flips some: over
        # all layers int4 rows stay within one LEVEL of the plain version's,
        # and their dequantized rel-L2 within 1.5e-1 instead of 3e-2.
        deep4 = dict(rows_levels=1.0, rows_rel=1.5e-1) if kv_bits == 4 else {}
        bad = decode_model.parity_failures(m, skip=("x_rel",), **deep4)
        check(not bad, f"decode_model {name} kv{kv_bits} lengths {lengths}: {bad} in {m}")
        ms = event_ms(lambda i: decode_model.fused_decode_model(*args, **kw), calls=20)
        plain_ms = event_ms(lambda i: decode_model.fused_decode_model_plain(*args, **kw),
                            calls=2)
        # no single PyTorch call computes this function; beside it, the
        # per-layer path's device time for the same step (its kernels' sum)
        cache = kvcache.KVCache(k=kc, v=vc, k_scale=ks, v_scale=vs, length=lens,
                                bits=kv_bits)
        per_layer_ms, per_layer_n = profiled_device_ms(lambda: decoder.forward(
            params, cfg, tok[:, None], cache, megakernel=False), calls=3)
        nbytes = decode_model_bytes(cfg, params.layers, params.lm_head, b, kv_bits, lengths)
        bound = nbytes / HBM_BYTES_S * 1e3
        again = decode_model.fused_decode_model(*args, **kw)
        same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
        check(same, f"decode_model {name}: two calls gave different bits")
        sched = decode_model.schedule_info(cfg, params.layers, params.lm_head, b, cap, dev)
        row = dict(shape=f"{name} B={b} kv{kv_bits} len_old={','.join(map(str, lengths))}",
                   max_abs_err=m["logits_max_abs"], rel_l2=m["logits_rel"],
                   tol=decode_model.PARITY_BOUNDS["logits_rel"], parity=m, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by="bytes",
                   bytes=nbytes, per_layer_path_device_ms=per_layer_ms,
                   per_layer_path_launches=per_layer_n, same_twice=same,
                   schedule={k: v for k, v in sched.items() if k != "units"})
        rows.append(row)
        print(f"  decode_model       {row['shape']:44s} logits rel {m['logits_rel']:.2e} "
              f"x {m['x_rel']:.1e} rows {m['rows_rel']:.1e} row0 {m['row0_levels']:.0f} lvl "
              f"tokens {m['tokens_compared']}/{b} | kernel {ms:.4f} ms plain {plain_ms:.2f} "
              f"bound {bound:.4f} | per-layer path (device) {per_layer_ms:.3f} ms, "
              f"{per_layer_n:.0f} launches", flush=True)
        print(f"    schedule: {sched['grid']} blocks, items a phase (layer 0) "
              f"{sched['items_a_layer']}, K ranges a cut tile {sched['k_ranges']} "
              f"(tiles cut {sched['cut_tiles']}), "
              f"{sched['grid_waits_a_layer']} grid-wide waits a layer, ring {sched['slots']} "
              f"slots ({sched['ring_bytes']} B a block, {sched['bytes_in_flight']} B in "
              f"flight), weight bytes a block {sched['max_block_bytes']} most / "
              f"{sched['mean_block_bytes']:.0f} mean", flush=True)
        del kc, vc, ks, vs, cache, got, want, again, params
        torch.cuda.empty_cache()
    results["decode_model"] = rows


def ql_nbytes(ql, count: int = 1) -> int:
    """Bytes of `count` matrices of a stack whose first axis is the matrices."""
    per = sum(t[0].numel() * t.element_size() for t in (ql.packed, ql.scale, ql.bias))
    return per * count


def rand_experts(g, dev, lead, k, n, bs=128):
    ql = rand_quantized(g, dev, k, n, layers=math.prod(lead), bs=bs)
    rs = lambda t: t.reshape(*lead, *t.shape[1:])
    return dataclasses.replace(ql, packed=rs(ql.packed), scale=rs(ql.scale), bias=rs(ql.bias))


MOE_SHAPES = {   # preset -> (E, k, mi, si); H = 2048 for both
    "qwen1.5-moe-a2.7b": (60, 4, 1408, 5632),
    "qwen3-moe-30b-a3b": (128, 8, 768, 0),
}


def phase_moe_decode(dev, g, results):
    """K8 at n = 1 and n = 4: qwen1.5-moe-a2.7b's widths (shared expert
    under its gate) and qwen3-moe-30b-a3b's (none). A call reads other
    experts than the one before: the layer index rotates over a stack
    larger than L2."""
    rows = []
    for preset, (e, k, mi, si) in MOE_SHAPES.items():
        cfg = PRESETS[preset]
        h = cfg.hidden_size
        check((cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size,
               cfg.shared_expert_intermediate_size) == (e, k, mi, si), f"{preset}: shapes")
        nl = 4 if si else 8
        lay = decoder.LayerParams(
            wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
            wgu_e=rand_experts(g, dev, (nl, e), h, 2 * mi),
            wdown_e=rand_experts(g, dev, (nl, e), mi, h),
            wgu_shared=rand_experts(g, dev, (nl,), h, 2 * si) if si else None,
            wdown_shared=rand_experts(g, dev, (nl,), si, h) if si else None)
        for n in (1, 4):
            check(moe_decode.supports(cfg, lay, n), f"moe_decode {preset}: unsupported")
            x = torch.randn((n, h), device=dev, generator=g) * 0.5
            sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k]
                               for _ in range(n)]).to(torch.int32)
            wsel = torch.softmax(torch.randn((n, k), device=dev, generator=g), -1)
            gate = torch.rand((n,), device=dev, generator=g) if si else None
            run = lambda i: moe_decode.moe_decode_mlp(x, lay, sel, wsel, i % nl, gate,
                                                      config=cfg)
            plain = lambda i: moe_decode.moe_decode_mlp_plain(x, lay, sel, wsel, i % nl,
                                                              gate, config=cfg)
            got, again, want = run(1), run(1), plain(1)
            torch.cuda.synchronize()
            err, rel = max_abs(got, want), rel_l2(got, want)
            check(bool(torch.isfinite(got).all()), f"moe_decode {preset}: non-finite")
            check(rel <= MOE_TOL, f"moe_decode {preset} n={n}: rel-L2 {rel:.3g} > {MOE_TOL}")
            check(torch.equal(got, again), f"moe_decode {preset} n={n}: two runs differ")
            ms = time_ms(run, calls=16)
            plain_ms = time_ms(plain, calls=2, replays=2)
            # yardstick: the four products as bmm / matmul over the selected
            # experts' weights, dequantized to bf16 beforehand
            ids = sel.reshape(-1).long()
            deq = lambda ql, idx: torch.stack([quantize.dequantize(QuantizedLinear(
                packed=ql.packed[1][j], scale=ql.scale[1][j], bias=ql.bias[1][j],
                out_bias=None), dtype=torch.bfloat16) for j in idx])
            wg, wd = deq(lay.wgu_e, ids.tolist()), deq(lay.wdown_e, ids.tolist())
            xr = x.to(torch.bfloat16).repeat_interleave(k, 0)[:, None]
            ar = torch.randn((n * k, 1, mi), device=dev, generator=g).to(torch.bfloat16)
            if si:
                sg = quantize.dequantize(lay.wgu_shared.layer(1), dtype=torch.bfloat16)
                sd = quantize.dequantize(lay.wdown_shared.layer(1), dtype=torch.bfloat16)
                a_s = torch.randn((n, si), device=dev, generator=g).to(torch.bfloat16)

            def lib(i):
                torch.bmm(xr, wg)
                torch.bmm(ar, wd)
                if si:
                    torch.matmul(xr[::k, 0], sg)
                    torch.matmul(a_s, sd)
            lib_ms = time_ms(lib, calls=8)
            # bytes this run's routing needs: each distinct expert once
            distinct = int(sel.unique().numel())
            nbytes = (distinct * (ql_nbytes(lay.wgu_e.flat_experts())
                                  + ql_nbytes(lay.wdown_e.flat_experts()))
                      + (ql_nbytes(lay.wgu_shared) + ql_nbytes(lay.wdown_shared) if si else 0)
                      + 2 * n * h * 4 + n * k * 8 + n * 4)
            ops = 2 * 3 * h * (n * k * mi + n * si)
            bound, bound_by = bound_of(ops, nbytes)
            row = dict(shape=f"{preset} n={n} E={e} k={k} mi={mi} si={si}",
                       max_abs_err=err, rel_l2=rel, tol=MOE_TOL, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                       bound_share=bound / ms, distinct_experts=distinct)
            rows.append(row)
            print(f"  moe_decode         {row['shape']:48s} rel {rel:.2e} (tol {MOE_TOL}) | "
                  f"kernel {ms:.4f} ms plain {plain_ms:.3f} lib {lib_ms:.4f} "
                  f"bound {bound:.4f} ({bound_by}, {100 * bound / ms:.1f} % of it)", flush=True)
            del wg, wd
        del lay
        torch.cuda.empty_cache()
    results["moe_decode"] = rows


def phase_moe_prefill(dev, g, results):
    """K9 at the capacities of qwen1.5-moe-a2.7b's chunks: C = 8, 24 and 72
    (the 32-, 128- and 512-token buckets of the three requests: partial
    products) and C = 144 (a 1024-token chunk: dequantized blocks); and of a
    512-token chunk of qwen3-moe-30b-a3b (C = 64)."""
    rows = []
    for preset, cap in (("qwen1.5-moe-a2.7b", 8), ("qwen1.5-moe-a2.7b", 24),
                        ("qwen1.5-moe-a2.7b", 72), ("qwen1.5-moe-a2.7b", 144),
                        ("qwen3-moe-30b-a3b", 64)):
        e, k, mi, _ = MOE_SHAPES[preset]
        h = PRESETS[preset].hidden_size
        gu = rand_experts(g, dev, (e,), h, 2 * mi)
        dn = rand_experts(g, dev, (e,), mi, h)
        check(moe_prefill.supports(gu, dn, h, cap), f"moe_prefill {preset}: unsupported")
        xe = (torch.randn((e, cap, h), device=dev, generator=g) * 0.5).to(torch.bfloat16)
        w_e = torch.rand((e, cap), device=dev, generator=g)
        xe[:, -cap // 8:] = 0              # empty slots: zero rows, weight 0
        w_e[:, -cap // 8:] = 0
        tile = moe_prefill.tile(e, cap, h, mi, gu.bits)
        got = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
        again = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
        want = moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"moe_prefill {preset}: non-finite")
        check(rel <= MOE_TOL, f"moe_prefill {preset} C={cap}: rel-L2 {rel:.3g} > {MOE_TOL}")
        check(bool((got[:, -cap // 8:] == 0).all()), f"moe_prefill {preset}: empty slots not 0")
        check(torch.equal(got, again), f"moe_prefill {preset} C={cap}: two runs differ")
        del want, again
        ms = time_ms(lambda i: moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn), calls=4)
        plain_ms = time_ms(lambda i: moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn),
                           calls=1, replays=2)
        # yardstick: two bmm over all experts' weights dequantized beforehand
        deq = lambda ql: torch.stack([quantize.dequantize(ql.layer(j), dtype=torch.bfloat16)
                                      for j in range(e)])
        wg, wd = deq(gu), deq(dn)
        act = torch.randn((e, cap, mi), device=dev, generator=g).to(torch.bfloat16)
        lib_ms = time_ms(lambda i: (torch.bmm(xe, wg), torch.bmm(act, wd)), calls=4)
        del wg, wd
        nbytes = (ql_nbytes(gu, e) + ql_nbytes(dn, e) + e * cap * (h * 2 + 4 + h * 4))
        bound, bound_by = bound_of(2 * e * cap * 3 * h * mi, nbytes)
        algebra = "/".join("partial" if cap < q.block_size else "dequant" for q in (gu, dn))
        row = dict(shape=f"{preset} E={e} C={cap} H={h} mi={mi} ({algebra})",
                   max_abs_err=err, rel_l2=rel, tol=MOE_TOL, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   tile=dict(rows=tile[0], cols=tile[1], smem=tile[2]))
        rows.append(row)
        print(f"  moe_prefill        {row['shape']:58s} rel {rel:.2e} (tol {MOE_TOL}) | "
              f"kernel {ms:.4f} ms plain {plain_ms:.2f} lib {lib_ms:.4f} "
              f"bound {bound:.4f} ({bound_by}) | tile {tile[0]} x {tile[1]}, "
              f"{tile[2]} B shared", flush=True)
        del gu, dn, xe, got
        torch.cuda.empty_cache()
    results["moe_prefill"] = rows


def phase_gemm_deq(dev, g, results):
    """K3 behind its switch, at M = 512: qwen1.5-moe-a2.7b's shared expert
    and its qkv projection."""
    tol, m = 1e-2, 512
    rows = []
    dequant_matmul.DEQ_MIN_M = m
    try:
        for proj, k, n, with_bias in (("moe_shared_gu", 2048, 11264, False),
                                      ("moe_shared_dn", 5632, 2048, False),
                                      ("moe_qkv", 2048, 6144, True)):
            wbytes = k * n // 2 + 2 * (k // 128) * n * 2 + (n * 4 if with_bias else 0)
            nl = copies_for(wbytes)
            ql = rand_quantized(g, dev, k, n, layers=nl, with_bias=with_bias, act_bits=8)
            x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
            before = dequant_matmul.KERNEL_DEQ.launches
            got = dequant_matmul.dequant_matmul(x, ql, layer_index=0)
            check(dequant_matmul.KERNEL_DEQ.launches == before + 1,
                  "dequant_matmul_deq: the switch did not route the call")
            want = dequant_matmul.dequant_matmul_plain(x, ql.layer(0), deq=True)
            torch.cuda.synchronize()
            err, rel = max_abs(got, want), rel_l2(got, want)
            check(bool(torch.isfinite(got).all()), f"dequant_matmul_deq {proj}: non-finite")
            check(rel <= tol, f"dequant_matmul_deq {proj}: rel-L2 {rel:.3g} > {tol}")
            ms = time_ms(lambda i: dequant_matmul.dequant_matmul(x, ql, layer_index=i % nl),
                         calls=max(nl, 8))
            plain_ms = time_ms(lambda i: dequant_matmul.dequant_matmul_plain(
                x, ql.layer(i % nl), deq=True), calls=2, replays=2)
            nlib = copies_for(k * n * 2, cap=nl)
            wlib = [quantize.dequantize(ql.layer(i), dtype=torch.bfloat16) for i in range(nlib)]
            ob = ql.out_bias
            lib_ms = time_ms(lambda i: (
                torch.matmul(x, wlib[i % nlib]) if ob is None
                else torch.addmm(ob[i % nlib].to(torch.bfloat16), x, wlib[i % nlib])),
                calls=max(nlib, 8))
            del wlib
            bound, bound_by = bound_of(2 * m * k * n, m * k * 2 + wbytes + m * n * 2)
            tile = dequant_matmul.bf16_tile(m, n, ql.bits)   # the tile kernel's tiles
            row = dict(shape=f"{proj} M={m} K={k} N={n}", max_abs_err=err, rel_l2=rel,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=bound_by, l2_rotation=nl,
                       tile=dict(rows=tile[0], cols=tile[1]))
            rows.append(row)
            print(f"  dequant_matmul_deq {row['shape']:36s} rel {rel:.2e} | kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} lib {lib_ms:.4f} bound {bound:.4f} ({bound_by}) | "
                  f"tile {tile[0]} x {tile[1]}", flush=True)
            del ql, x, got, want
            torch.cuda.empty_cache()
    finally:
        dequant_matmul.DEQ_MIN_M = 1 << 30
    results["dequant_matmul_deq"] = rows


# --------------------------------------------------------------------------
# phases 3 and 4: the serving path, and its parity with the CPU
# --------------------------------------------------------------------------

def serving_rt(kv_bits: int = 8):
    return RuntimeConfig(
        max_seq_len=1024, prefill_chunk=512, decode_block=NEW_TOKENS,
        sampler="greedy", kv_quant=True, kv_bits=kv_bits, quant_bits=4,
        quant_block=128, lm_head_bits=4, prefill_act_bits=8,
        max_new_tokens=NEW_TOKENS)


def prompts(vocab):
    rng = np.random.default_rng(1234)
    return [rng.integers(0, vocab, size=n).tolist() for n in PREFILL_LENS]


PREFILL_KERNELS = ("mnn_dequant_matmul", "mnn_dequant_matmul_a8", "mnn_flash_prefill")


def read_launches(label, must, never=()):
    """The counts since the last reset: every kernel in `must` was launched,
    none in `never`."""
    launches = {k.name: k.launches for k in build.KERNELS}
    for kname in must:
        check(launches[kname] > 0, f"{label}: kernel {kname} was never launched")
    for kname in never:
        check(launches[kname] == 0, f"{label}: kernel {kname} launched "
              f"{launches[kname]} times on a path that does not run it")
    print(f"  launches, {label}: {launches}", flush=True)
    return launches


def serve(llm, reqs, label):
    """Answer `reqs` through `Llm.stream`; (tokens, perf) per request."""
    vocab = llm.config.vocab_size
    outs, perf = [], []
    for ids in reqs:
        llm.reset()
        toks = list(llm.stream(token_ids=ids, max_new_tokens=NEW_TOKENS))
        check(bool(torch.isfinite(llm.last_prefill_logits).all()),
              f"{label}: non-finite prefill logits")
        check(0 < len(toks) <= NEW_TOKENS, f"{label}: {len(toks)} tokens")
        check(all(0 <= t < vocab for t in toks), f"{label}: token out of range")
        p = llm.perf
        perf.append(dict(prompt_len=p.prompt_len, gen_len=p.gen_len,
                         prefill_s=p.prefill_s, decode_s=p.decode_s,
                         prefill_tok_s=p.prefill_tok_s,
                         decode_tok_s=p.decode_tok_s))
        outs.append(toks)
        print(f"  {label}: {len(ids):4d} prompt tokens: prefill {p.prefill_tok_s:10.1f} tok/s "
              f"({p.prefill_s * 1e3:.2f} ms) | decode {p.gen_len} tok "
              f"{p.decode_tok_s:8.1f} tok/s", flush=True)
    return outs, perf


def phase_serve(llm):
    """Phase 3, sub-phases (a) to (c), each with its own launch counts."""
    dev = llm.device
    reqs = prompts(llm.config.vocab_size)
    info = llm.info()
    check(info["decode_megakernel"] and info["decode_fused_head"],
          f"serve: the whole-model kernel does not serve this model: {info}")
    # warm-up request (allocator, cuBLAS handles), not counted
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))
    torch.cuda.synchronize()

    build.reset_launches()                  # (a) int8 cache, whole-model kernel
    outs, perf = serve(llm, reqs, "megakernel int8 kv")
    counts = {"megakernel_int8": read_launches(
        "megakernel int8 kv", PREFILL_KERNELS + ("mnn_decode_model",),
        never=("mnn_decode_step", "mnn_flash_decode"))}
    steps = NEW_TOKENS * len(reqs)          # a decode block runs to its end
    check(counts["megakernel_int8"]["mnn_decode_model"] == steps,
          f"serve: {counts['megakernel_int8']['mnn_decode_model']} launches of the "
          f"whole-model kernel for {steps} decode steps")

    llm4 = Llm(llm.config, llm.params, serving_rt(kv_bits=4), device=dev)
    build.reset_launches()                  # (b) int4 cache, whole-model kernel
    outs4, perf4 = serve(llm4, reqs[1:2], "megakernel int4 kv")
    counts["megakernel_int4"] = read_launches(
        "megakernel int4 kv", PREFILL_KERNELS + ("mnn_decode_model",),
        never=("mnn_decode_step", "mnn_flash_decode"))
    check(counts["megakernel_int4"]["mnn_decode_model"] == NEW_TOKENS,
          "serve: int4 request not decoded by the whole-model kernel")

    ids = reqs[1][:FALLBACK_PROMPT]
    steps = PARITY_STEPS * llm.config.num_layers
    build.reset_launches()                  # (c) the per-layer fallback, int8
    rows8, _, _ = greedy_trace(llm, ids, None, megakernel=False)
    counts["per_layer_int8"] = read_launches(
        "per-layer int8 kv", PREFILL_KERNELS + ("mnn_decode_step",),
        never=("mnn_decode_model", "mnn_flash_decode"))
    check(counts["per_layer_int8"]["mnn_decode_step"] == steps,
          "serve: per-layer int8 path did not run the decode-step kernel per layer")
    build.reset_launches()                  # (c) the per-layer fallback, int4
    rows4, _, _ = greedy_trace(llm4, ids, None, megakernel=False)
    counts["per_layer_int4"] = read_launches(
        "per-layer int4 kv", PREFILL_KERNELS + ("mnn_flash_decode",),
        never=("mnn_decode_model", "mnn_decode_step"))
    check(counts["per_layer_int4"]["mnn_flash_decode"] == steps,
          "serve: per-layer int4 path did not run the flash-decode kernel per layer")
    for rows in (rows8, rows4):
        check(all(bool(torch.isfinite(r).all()) for r in rows),
              "serve: non-finite logits on the per-layer path")
    perf = dict(megakernel_int8=perf, megakernel_int4=perf4)
    return reqs, outs, perf, counts


def phase_serve_act16(llm, reqs):
    """Phase 3 (f): the 300-token request with `prefill_act_bits=16`, the
    library's default: every prefill projection takes bf16 rows through the
    tensor-core tile kernel, four launches a layer a chunk, and none the
    int8-row kernel."""
    rt = dataclasses.replace(llm.rt, prefill_act_bits=16)
    llm16 = Llm(llm.config, llm.params, rt, device=llm.device)
    list(llm16.stream(token_ids=reqs[0][:8], max_new_tokens=2))    # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    _, perf = serve(llm16, reqs[1:2], "dense act16")
    got = read_launches("dense act16", ("mnn_dequant_matmul_bf16_tile", "mnn_flash_prefill",
                                        "mnn_decode_model"), never=("mnn_dequant_matmul_a8",))
    chunks = len(generate.prefill_buckets(len(reqs[1]), rt.prefill_chunk))
    tiles = got["mnn_dequant_matmul_bf16_tile"]
    check(tiles == 4 * llm.config.num_layers * chunks,
          f"serve act16: {tiles} tile-kernel launches for {chunks} chunks")
    print(f"  dense act16: {len(reqs[1])}-token prefill {perf[0]['prefill_s'] * 1e3:.2f} ms, "
          f"bf16 tile kernel launched {tiles} times", flush=True)
    return perf, got


MOE_PREFILL_KERNELS = PREFILL_KERNELS + ("mnn_moe_prefill",)


def phase_serve_moe(llm):
    """Phase 3 (d) and (e): the mixture-of-experts model at full width and
    depth. Per prefill chunk one grouped-expert launch a layer; per decode
    step one fused-expert and one decode-step launch a layer."""
    cfg, dev = llm.config, llm.device
    nl = cfg.num_layers
    reqs = prompts(cfg.vocab_size)
    info = llm.info()
    check(info["decode_moe_fused"] and not info["decode_megakernel"],
          f"serve moe: unexpected decode path: {info}")
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))    # warm-up
    torch.cuda.synchronize()

    build.reset_launches()                  # (d) int8 cache, fused expert kernel
    outs, perf = serve(llm, reqs, "moe int8 kv")
    counts = {"moe_int8": read_launches(
        "moe int8 kv", MOE_PREFILL_KERNELS + ("mnn_moe_decode", "mnn_decode_step",
                                              "mnn_dequant_matmul_bf16_tile"),
        never=("mnn_decode_model", "mnn_flash_decode", "mnn_dequant_matmul_deq"))}
    chunks = sum(len(generate.prefill_buckets(len(r), llm.rt.prefill_chunk)) for r in reqs)
    steps = NEW_TOKENS * len(reqs)
    got = counts["moe_int8"]
    check(got["mnn_moe_prefill"] == nl * chunks,
          f"serve moe: {got['mnn_moe_prefill']} grouped-expert launches for {chunks} "
          f"chunks of {nl} layers")
    check(got["mnn_dequant_matmul_bf16_tile"] == 2 * nl * chunks,
          f"serve moe: {got['mnn_dequant_matmul_bf16_tile']} tile-kernel launches for the "
          f"shared expert of {chunks} chunks of {nl} layers")
    check(got["mnn_moe_decode"] == nl * steps and got["mnn_decode_step"] == nl * steps,
          f"serve moe: {got['mnn_moe_decode']} fused-expert and {got['mnn_decode_step']} "
          f"decode-step launches for {steps} steps of {nl} layers")

    # (e) the dequantize-tile switch on: every M = 512 projection of the
    # chunk (qkv, wo, the shared expert) takes K3; logits against (d)'s path
    ids = reqs[1]
    tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
    base, _ = generate.run_prefill(llm.params, cfg, llm.rt, tokens, llm._new_cache())
    build.reset_launches()
    dequant_matmul.DEQ_MIN_M = llm.rt.prefill_chunk
    try:
        deq, _ = generate.run_prefill(llm.params, cfg, llm.rt, tokens, llm._new_cache())
    finally:
        dequant_matmul.DEQ_MIN_M = 1 << 30
    torch.cuda.synchronize()
    counts["moe_deq_switch"] = read_launches(
        "moe, dequantize-tile switch on", ("mnn_dequant_matmul_deq", "mnn_moe_prefill"),
        never=("mnn_dequant_matmul_a8",))
    check(counts["moe_deq_switch"]["mnn_dequant_matmul_deq"] == 4 * nl,
          "serve moe: the switch did not route qkv, wo and the shared expert")
    rel = rel_l2(deq, base)
    check(bool(torch.isfinite(deq).all()) and rel <= PARITY_REL,
          f"serve moe: dequantize-tile prefill logits rel-L2 {rel:.3g} > {PARITY_REL}")
    print(f"  dequantize-tile switch on: prefill logits rel-L2 {rel:.2e} against the "
          f"default path", flush=True)
    return perf, counts, dict(deq_switch_rel_l2=rel)


def phase_parity_moe(dev):
    """Phase 4 for the mixture-of-experts model: full width, MOE_PARITY_LAYERS
    layers on both sides, the same weights from the same seed."""
    cfg = dataclasses.replace(PRESETS[MOE_PRESET], num_layers=MOE_PARITY_LAYERS)
    rt = serving_rt()

    def make(device):
        params = decoder.init_random_params(
            cfg, torch.Generator().manual_seed(SEED), quant_bits=rt.quant_bits,
            quant_block=rt.quant_block, act_bits=rt.act_bits,
            lm_head_bits=rt.lm_head_bits, device=device)
        return Llm(cfg, params, rt, device=device)

    ids = prompts(cfg.vocab_size)[0]
    build.reset_launches()
    card, fed, _ = greedy_trace(make(dev), ids, None)
    read_launches(f"moe parity, {MOE_PARITY_LAYERS} layers",
                  ("mnn_moe_prefill", "mnn_moe_decode"))
    t0 = time.perf_counter()
    cpu, _, _ = greedy_trace(make("cpu"), ids, fed)
    out = compare_traces(card, cpu, f"moe ({MOE_PARITY_LAYERS} layers, full width) ")
    print(f"    cpu run {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(out, layers=MOE_PARITY_LAYERS)


def compare_traces(card, cpu, label=""):
    """Logit rows of the card against the CPU's: rel-L2 per step within
    PARITY_REL, tokens equal where the CPU's top-2 margin exceeds the largest
    difference seen."""
    rels = [rel_l2(a, b) for a, b in zip(card, cpu)]
    diff = max(max_abs(a, b) for a, b in zip(card, cpu))
    checked = 0
    for s, (a, b) in enumerate(zip(card, cpu)):
        check(bool(torch.isfinite(a).all()), f"parity: non-finite card logits at {s}")
        check(rels[s] <= PARITY_REL, f"parity: {label}step {s} rel-L2 {rels[s]:.3g} > {PARITY_REL}")
        top2 = b[0].topk(2).values
        if float(top2[0] - top2[1]) > diff:
            checked += 1
            check(int(a.argmax()) == int(b.argmax()),
                  f"parity: {label}step {s} token {int(a.argmax())} != cpu {int(b.argmax())}")
    print(f"  {label}card vs cpu: rel-L2 per step {[f'{r:.2e}' for r in rels]}, "
          f"max |diff| {diff:.3g}, tokens compared at {checked}/{len(rels)} steps", flush=True)
    return dict(rel_l2=rels, max_abs_diff=diff, tokens_checked=checked)


def greedy_trace(llm, ids, feed, megakernel=None):
    """Prefill + PARITY_STEPS decode steps on llm's device. `feed`: the
    tokens to feed (teacher forcing), or None for the own argmax.
    Returns (logit rows, fed tokens, the cache it leaves)."""
    cache = llm._new_cache()
    tokens = torch.tensor([ids], dtype=torch.int64, device=llm.device)
    logits, cache = generate.run_prefill(llm.params, llm.config, llm.rt, tokens, cache)
    rows = [logits.float().cpu()]
    fed = []
    for s in range(PARITY_STEPS):
        tok = feed[s] if feed is not None else int(rows[-1].argmax())
        fed.append(tok)
        t = torch.tensor([[tok]], dtype=torch.int64, device=llm.device)
        logits, cache = decoder.forward(llm.params, llm.config, t, cache,
                                        megakernel=megakernel)
        rows.append(logits.float().cpu())
    return rows, fed, cache


def phase_parity(llm, reqs, outs):
    card, fed, cache = greedy_trace(llm, reqs[0], None)
    n = min(len(outs[0]), PARITY_STEPS)
    check(fed[:n] == outs[0][:n], f"parity: the card's Llm tokens {outs[0][:n]} "
          f"differ from its own decode trace {fed[:n]}")
    cpu_llm = Llm.synthetic(llm.config.name, rt=llm.rt, seed=SEED, device="cpu")
    t0 = time.perf_counter()
    cpu, _, _ = greedy_trace(cpu_llm, reqs[0], fed)
    cpu_s = time.perf_counter() - t0
    out = compare_traces(card, cpu)
    print(f"    cpu run {cpu_s:.1f} s", flush=True)
    # the whole-model kernel against the per-layer path, from the same state
    tok = torch.tensor([[int(card[-1].argmax())]], device=llm.device)
    clone = lambda: dataclasses.replace(
        cache, k=cache.k.clone(), v=cache.v.clone(), k_scale=cache.k_scale.clone(),
        v_scale=cache.v_scale.clone())
    (mk, mtok), _ = decoder.forward(llm.params, llm.config, tok, clone(),
                                    megakernel=True, return_token=True)
    ref, _ = decoder.forward(llm.params, llm.config, tok, clone(), megakernel=False)
    paths = rel_l2(mk, ref)
    check(paths <= PARITY_REL, f"parity: whole-model kernel vs per-layer path "
          f"rel-L2 {paths:.3g} > {PARITY_REL}")
    check(int(mtok[0]) == int(decode_model.lowest_argmax(mk)[0]),
          "parity: the kernel's token is not the lowest argmax of its logits")
    print(f"  whole-model kernel vs per-layer path on the card: rel-L2 {paths:.2e}",
          flush=True)
    # the prefill with prefill_act_bits=16 (the 32-row bucket on the tile kernel)
    rt16 = dataclasses.replace(llm.rt, prefill_act_bits=16)
    ids = torch.tensor([reqs[0]], dtype=torch.int64)
    before = dequant_matmul.KERNEL_BF16_TILE.launches
    card16, _ = generate.run_prefill(llm.params, llm.config, rt16, ids.to(llm.device),
                                     llm._new_cache())
    check(dequant_matmul.KERNEL_BF16_TILE.launches > before,
          "parity: the act16 prefill did not run the tile kernel")
    cpu16, _ = generate.run_prefill(cpu_llm.params, cpu_llm.config, rt16, ids,
                                    cpu_llm._new_cache())
    act16 = rel_l2(card16.float().cpu(), cpu16.float())
    check(bool(torch.isfinite(card16).all()) and act16 <= PARITY_REL,
          f"parity: act16 prefill logits rel-L2 {act16:.3g} > {PARITY_REL}")
    print(f"  prefill_act_bits=16, card vs cpu: prefill logits rel-L2 {act16:.2e}", flush=True)
    return dict(out, megakernel_vs_per_layer_rel_l2=paths, act16_prefill_rel_l2=act16)


# --------------------------------------------------------------------------

KERNEL_INFO = {  # kernel -> (source, TPU kernel it replaces, C entry)
    "dequant_matmul": ("mnn_tpu_torch/csrc/dequant_matmul.cu",
                       "mnn_tpu/kernels/dequant_matmul.py:156", "mnn_dequant_matmul"),
    "dequant_matmul_a8": ("mnn_tpu_torch/csrc/dequant_matmul.cu",
                          "mnn_tpu/kernels/dequant_matmul.py:67", "mnn_dequant_matmul_a8"),
    "flash_prefill": ("mnn_tpu_torch/csrc/flash_prefill.cu",
                      "mnn_tpu/kernels/flash_attention.py:86", "mnn_flash_prefill"),
    "decode_step": ("mnn_tpu_torch/csrc/decode_step.cu",
                    "mnn_tpu/kernels/decode_step.py:57", "mnn_decode_step"),
    "flash_decode": ("mnn_tpu_torch/csrc/flash_decode.cu",
                     "mnn_tpu/kernels/flash_attention.py:252", "mnn_flash_decode"),
    "decode_model": ("mnn_tpu_torch/csrc/decode_model.cuh",
                     "mnn_tpu/kernels/decode_model.py:581", "mnn_decode_model"),
    "dequant_matmul_deq": ("mnn_tpu_torch/csrc/dequant_matmul.cu",
                           "mnn_tpu/kernels/dequant_matmul.py:115", "mnn_dequant_matmul_deq"),
    "moe_decode": ("mnn_tpu_torch/csrc/moe_decode.cu",
                   "mnn_tpu/kernels/moe_decode.py:115", "mnn_moe_decode"),
    "moe_prefill": ("mnn_tpu_torch/csrc/moe_prefill.cu",
                    "mnn_tpu/kernels/moe_prefill.py:80", "mnn_moe_prefill"),
}
# the sub-phase of phase 3 whose run gives a kernel its launch count
COUNTED_IN = {"mnn_decode_step": "per_layer_int8", "mnn_flash_decode": "per_layer_int4",
              "mnn_moe_decode": "moe_int8", "mnn_moe_prefill": "moe_int8",
              "mnn_dequant_matmul_deq": "moe_deq_switch",
              "mnn_dequant_matmul_bf16_tile": "dense_act16"}


def row_sums(rows) -> dict:
    """A kernel's numbers in the kernels line: sums of one call at each shape."""
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=(None if rows[0]["library_ms"] is None
                            else sum(r["library_ms"] for r in rows)),
                shapes=len(rows))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    check(Path(mnn_tpu_torch.__file__).resolve().is_relative_to(HERE),
          f"mnn_tpu_torch imported from {mnn_tpu_torch.__file__}, not this checkout")
    for mod in ("jax", "mnn_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card_line = smi[0] if smi else "unknown"
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (nvcc sm_90a, {build.lib_path})",
          flush=True)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "nvcc_log.txt").write_text(build.build_log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results: dict = {}
    print("phase 2: kernels against their plain versions", flush=True)
    phase_gemm(dev, g, results, a8=False)
    phase_gemm(dev, g, results, a8=True)
    phase_flash(dev, g, results)
    phase_decode(dev, g, results)
    phase_flash_decode(dev, g, results)
    phase_gemm_deq(dev, g, results)
    phase_moe_decode(dev, g, results)
    phase_moe_prefill(dev, g, results)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llm = Llm.synthetic("qwen2-0.5b", rt=serving_rt(), seed=SEED, device=dev)
    cfg = llm.config
    print(f"  model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, vocab "
          f"{cfg.vocab_size}; built in {time.perf_counter() - t0:.1f} s; "
          f"info {json.dumps(llm.info())}", flush=True)
    phase_decode_model(dev, g, results, llm.params)
    torch.cuda.empty_cache()

    print("phase 3: serving qwen2-0.5b on the card", flush=True)
    reqs, outs, perf, counts = phase_serve(llm)
    perf["dense_act16"], counts["dense_act16"] = phase_serve_act16(llm, reqs)

    print("phase 4: the first request on the card and on the cpu", flush=True)
    parity = phase_parity(llm, reqs, outs)
    del llm
    torch.cuda.empty_cache()

    print(f"phase 3 (d, e): serving {MOE_PRESET} on the card", flush=True)
    t0 = time.perf_counter()
    moe = Llm.synthetic(MOE_PRESET, rt=serving_rt(), seed=SEED, device=dev)
    mcfg = moe.config
    print(f"  model: {mcfg.num_layers} layers, hidden {mcfg.hidden_size}, "
          f"{mcfg.num_experts} experts top-{mcfg.num_experts_per_tok} of "
          f"{mcfg.moe_intermediate_size}, shared {mcfg.shared_expert_intermediate_size}; "
          f"built in {time.perf_counter() - t0:.1f} s; info {json.dumps(moe.info())}",
          flush=True)
    moe_perf, moe_counts, moe_extra = phase_serve_moe(moe)
    perf["moe_int8"] = moe_perf
    counts.update(moe_counts)
    launches = {k: counts[COUNTED_IN.get(k, "megakernel_int8")][k] for k in
                counts["megakernel_int8"]}
    del moe
    torch.cuda.empty_cache()
    print(f"phase 4, {MOE_PRESET}: the first request on the card and on the cpu",
          flush=True)
    parity["moe"] = dict(phase_parity_moe(dev), **moe_extra)

    gen_tokens = sum(len(o) for o in outs) + sum(p["gen_len"] for p in moe_perf)
    kernels = []
    for kname, (src, repl, entry) in KERNEL_INFO.items():
        rows = results[kname]
        k = dict(name=kname, route="cuda", source=src, replaces=repl,
                 launches=launches[entry], **row_sums(rows))
        if kname == "decode_step":
            # the first four rows alone, so a table compares like with like
            k["four_shapes"] = row_sums(rows[:DECODE_FIRST_ROWS])
            k["added_rows"] = row_sums(rows[DECODE_FIRST_ROWS:])
        if kname == "flash_decode":
            k["six_shapes"] = row_sums(rows[:FLASH_DECODE_FIRST_ROWS])
            k["added_rows"] = row_sums(rows[FLASH_DECODE_FIRST_ROWS:])
        if kname == "decode_model":
            k["seven_shapes"] = row_sums(rows[:DECODE_MODEL_FIRST_ROWS])
            k["added_rows"] = row_sums(rows[DECODE_MODEL_FIRST_ROWS:])
        if kname == "dequant_matmul":
            # one TPU kernel, two CUDA kernels: the GEMV kernel at M = 1 (the
            # decode GEMVs and the head) and the tensor-core tile kernel above
            k["launches"] += launches["mnn_dequant_matmul_bf16_tile"]
            for key, sub, ent in (
                    ("m1", [r for r in rows if r["m"] == 1], "mnn_dequant_matmul"),
                    ("m_gt1", [r for r in rows if r["m"] > 1], "mnn_dequant_matmul_bf16_tile")):
                k[key] = dict(entry=ent, launches=launches[ent], **row_sums(sub))
        kernels.append(k)
    detail = dict(card=card_line, torch=torch.__version__, build_s=build_s,
                  kernels=results, serve=perf, launches=launches,
                  launches_by_path=counts,
                  generated_tokens=gen_tokens, parity=parity,
                  note="kernel ms/plain_ms/library_ms/bound_ms in the kernels "
                       "line are sums of one call at each listed shape")
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(card_line, flush=True)             # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
