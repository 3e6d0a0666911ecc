#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mnn_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. the card (`nvidia-smi` name and power limit) and the build of the
   hand-written kernels from `mnn_tpu_torch/csrc/` with nvcc for sm_90a;
2. every kernel of the serving path at the shapes that path gives it,
   held against its plain PyTorch version on the same inputs on the card,
   with its time, the plain version's time, one PyTorch library call's time
   as a yardstick, and the least time the card could take (bound);
3. the serving path itself: `Llm.synthetic("qwen2-0.5b")` at full width and
   depth (W4 block-128 weights, int4 lm head, int8 KV cache, int8 prefill
   activations) answers three greedy requests of 17, 300 and 600 prompt
   tokens and 32 new tokens each; every kernel's launch count must rise;
4. the first request again, prefill and 8 decode steps, on the card and
   through the plain versions on the CPU with the same weights: logits
   within rel-L2 5e-2 and equal tokens wherever the CPU's top-2 margin
   exceeds the largest logit difference seen.

It then prints one JSON line with every kernel's numbers and, last, the
device line. Details go to `chiprun_out/chip_smoke.json`. It imports no JAX
and nothing of the JAX package.
"""

from __future__ import annotations

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
from mnn_tpu_torch.kernels import build, decode_step, dequant_matmul, flash_attention
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import RuntimeConfig
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
PARITY_REL = 5e-2           # JAX megakernel logits bound, tests/test_decode_model.py:97
SEED = 0                    # weights and inputs


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


PROJ = {  # qwen2-0.5b: (K, N, has out_bias) per projection
    "qkv": (896, 1152, True),
    "wo": (896, 896, False),
    "wgu": (896, 9728, False),
    "wdown": (4864, 896, False),
}


def phase_gemm(dev, g, results, *, a8: bool):
    """K1 (bf16 rows, M = 1: decode GEMVs and the lm head) or K2 (int8
    rows, M = 512: prefill GEMMs)."""
    name = "dequant_matmul_a8" if a8 else "dequant_matmul"
    shapes = [(p, k, n, b, 512 if a8 else 1) for p, (k, n, b) in PROJ.items()]
    if not a8:
        shapes.append(("lm_head", 896, 151936, False, 1))
    tol = 1e-2
    rows = []
    for proj, k, n, with_bias, m in shapes:
        out_dtype = torch.float32 if proj == "lm_head" else torch.bfloat16
        wbytes = k * n // 2 + 2 * (k // 128) * n * 2 + (n * 4 if with_bias else 0)
        nl = copies_for(wbytes)
        ql = rand_quantized(g, dev, k, n, layers=nl,
                            with_bias=with_bias, act_bits=8 if a8 else 16)
        x = (torch.randn((m, k), device=dev, generator=g)).to(torch.bfloat16)
        got = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
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
        if a8:
            nbytes = m * k + m * 4 + wbytes + out_b
            bound = max(2 * m * k * n / INT8_OPS_S, nbytes / HBM_BYTES_S) * 1e3
            bound_by = "operations" if 2 * m * k * n / INT8_OPS_S > nbytes / HBM_BYTES_S else "bytes"
        else:
            nbytes = m * k * 2 + wbytes + out_b
            bound = nbytes / HBM_BYTES_S * 1e3
            bound_by = "bytes"
        row = dict(shape=f"{proj} M={m} K={k} N={n}", max_abs_err=err, rel_l2=rel,
                   tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   l2_rotation=nl)
        rows.append(row)
        print(f"  {name:18s} {row['shape']:32s} rel {rel:.2e} max_abs {err:.3g} | "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} lib {lib_ms:.4f} "
              f"bound {bound:.4f} ({bound_by})", flush=True)
        del ql, x, got, want
        torch.cuda.empty_cache()
    results[name] = rows


def phase_flash(dev, g, results):
    """K3 at the prefill chunks of the three requests (cache capacity 1024)."""
    h, hkv, d, cap = 14, 2, 64, 1024
    tol = 2e-2
    rows = []
    # (bucket, kv_len after append, q_offset): 17 -> 32, 300 -> 512,
    # 600 -> 512 + 128
    for t, kv_len, q_off in ((32, 17, 0), (512, 300, 0), (512, 512, 0),
                             (128, 600, 512)):
        q = torch.randn((1, h, t, d), device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn((1, hkv, cap, d), device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn((1, hkv, cap, d), device=dev, generator=g).to(torch.bfloat16)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
        got = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
        want = flash_attention.flash_attention_plain(q, k, v, kl, qo)
        torch.cuda.synchronize()
        # rows past the prompt (padded bucket tail) are rolled back; the
        # kernel's contract still covers them, so they are compared too
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), "flash_prefill: non-finite output")
        check(rel <= tol, f"flash_prefill T={t} kv={kv_len}: rel-L2 {rel:.3g} > {tol}")
        ms = time_ms(lambda i: flash_attention.flash_attention(
            q, k, v, kv_len=kl, q_offset=qo), calls=24)
        plain_ms = time_ms(lambda i: flash_attention.flash_attention_plain(
            q, k, v, kl, qo), calls=4, replays=2)
        mask = flash_attention._mask(1, t, cap, kl, qo, True, 0, 0, dev)
        kr = k.repeat_interleave(h // hkv, dim=1)
        vr = v.repeat_interleave(h // hkv, dim=1)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask), calls=24)
        visible = sum(min(kv_len, q_off + r + 1) for r in range(t))
        flops = 4 * h * d * visible
        nbytes = 2 * (2 * h * t * d + 2 * hkv * kv_len * d)
        bound = max(flops / BF16_OPS_S, nbytes / HBM_BYTES_S) * 1e3
        bound_by = "operations" if flops / BF16_OPS_S > nbytes / HBM_BYTES_S else "bytes"
        row = dict(shape=f"H=14 Hkv=2 T={t} kv_len={kv_len} q_offset={q_off} S={cap}",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=bound_by)
        rows.append(row)
        print(f"  flash_prefill      {row['shape']:40s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} lib {lib_ms:.4f} bound {bound:.5f} ({bound_by})",
              flush=True)
    results["flash_prefill"] = rows


def phase_decode(dev, g, results):
    """K4 at the last decode step of each request: 24-layer int8 cache."""
    L, hkv, grp, d, cap = 24, 2, 7, 64, 1024
    tol = 3e-2
    rows = []
    kf = torch.randn((L, 1, hkv, cap, d), device=dev, generator=g)
    vf = torch.randn((L, 1, hkv, cap, d), device=dev, generator=g)
    kq, ks = kvcache.quantize_kv(kf)
    vq, vs = kvcache.quantize_kv(vf)
    del kf, vf
    for len_old in (17 + NEW_TOKENS - 1, 300 + NEW_TOKENS - 1, 600 + NEW_TOKENS - 1):
        qkv = torch.randn((1, hkv, grp + 2, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor([len_old], dtype=torch.int32, device=dev)
        ang = torch.rand((1, d // 2), device=dev, generator=g) * 6.28
        cos = torch.cat([ang.cos(), ang.cos()], -1)
        sin = torch.cat([ang.sin(), ang.sin()], -1)
        got = decode_step.fused_decode_attention(qkv, kq, vq, ks, vs, 3, lengths, cos, sin)
        want = decode_step.fused_decode_attention_plain(qkv, kq, vq, ks, vs, 3, lengths, cos,
                                               sin, None, None, 1e-6, d ** -0.5, 0, 0, 0.0)
        torch.cuda.synchronize()
        err, rel = max_abs(got[0], want[0]), rel_l2(got[0], want[0])
        check(bool(torch.isfinite(got[0]).all()), "decode_step: non-finite output")
        check(rel <= tol, f"decode_step len={len_old}: att rel-L2 {rel:.3g} > {tol}")
        for j, nm in ((1, "k_row"), (2, "v_row")):
            lv = max_abs(got[j], want[j])
            check(lv <= 1.0, f"decode_step {nm}: {lv} int8 levels apart")
        for j, nm in ((3, "k_scale"), (4, "v_scale")):
            check(rel_l2(got[j], want[j]) <= 1e-6, f"decode_step {nm} differs")
        ms = time_ms(lambda i: decode_step.fused_decode_attention(
            qkv, kq, vq, ks, vs, i % L, lengths, cos, sin), calls=48)
        plain_ms = time_ms(lambda i: decode_step.fused_decode_attention_plain(
            qkv, kq, vq, ks, vs, i % L, lengths, cos, sin, None, None, 1e-6,
            d ** -0.5, 0, 0, 0.0), calls=8, replays=2)
        # yardstick: SDPA of the 14 query rows over the dequantized rows
        q = qkv[:, :, :grp].reshape(1, hkv * grp, 1, d)
        kd = kvcache.dequant_kv(kq[3], ks[3], 8)[:, :, :len_old + 1].repeat_interleave(grp, 1)
        vd = kvcache.dequant_kv(vq[3], vs[3], 8)[:, :, :len_old + 1].repeat_interleave(grp, 1)
        mask = torch.ones((1, 1, 1, len_old + 1), dtype=torch.bool, device=dev)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), calls=48)
        nbytes = (hkv * (grp + 2) * d * 2 + 2 * d * 4             # qkv, cos/sin
                  + 2 * hkv * len_old * (d + 4)                    # int8 K/V + scales
                  + hkv * grp * d * 2 + 2 * hkv * (d + 1) * 4)     # att, rows, scales
        bound = nbytes / HBM_BYTES_S * 1e3
        row = dict(shape=f"B=1 Hkv=2 G=7 D=64 len_old={len_old} S={cap} int8",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by="bytes")
        rows.append(row)
        print(f"  decode_step        {row['shape']:40s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} lib {lib_ms:.4f} bound {bound:.5f}", flush=True)
    results["decode_step"] = rows


# --------------------------------------------------------------------------
# phases 3 and 4: the serving path, and its parity with the CPU
# --------------------------------------------------------------------------

def serving_rt():
    return RuntimeConfig(
        max_seq_len=1024, prefill_chunk=512, decode_block=NEW_TOKENS,
        sampler="greedy", kv_quant=True, kv_bits=8, quant_bits=4,
        quant_block=128, lm_head_bits=4, prefill_act_bits=8,
        max_new_tokens=NEW_TOKENS)


def prompts(vocab):
    rng = np.random.default_rng(1234)
    return [rng.integers(0, vocab, size=n).tolist() for n in PREFILL_LENS]


def phase_serve(llm):
    vocab = llm.config.vocab_size
    reqs = prompts(vocab)
    # warm-up request (allocator, cuBLAS handles), not counted
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))
    llm.reset()
    torch.cuda.synchronize()
    build.reset_launches()
    outs, perf = [], []
    t0 = time.perf_counter()
    for ids in reqs:
        llm.reset()
        toks = list(llm.stream(token_ids=ids, max_new_tokens=NEW_TOKENS))
        check(bool(torch.isfinite(llm.last_prefill_logits).all()),
              "serve: non-finite prefill logits")
        check(0 < len(toks) <= NEW_TOKENS, f"serve: {len(toks)} tokens")
        check(all(0 <= t < vocab for t in toks), "serve: token out of range")
        p = llm.perf
        perf.append(dict(prompt_len=p.prompt_len, gen_len=p.gen_len,
                         prefill_s=p.prefill_s, decode_s=p.decode_s,
                         prefill_tok_s=p.prefill_tok_s,
                         decode_tok_s=p.decode_tok_s))
        outs.append(toks)
        print(f"  request {len(ids):4d} prompt tokens: prefill {p.prefill_tok_s:10.1f} tok/s "
              f"({p.prefill_s * 1e3:.2f} ms) | decode {p.gen_len} tok "
              f"{p.decode_tok_s:8.1f} tok/s", flush=True)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in build.KERNELS}
    for kname, n in launches.items():
        check(n > 0, f"serve: kernel {kname} was never launched")
    print(f"  launches in the serving phase: {launches} ({wall:.2f} s)", flush=True)
    return reqs, outs, perf, launches


def greedy_trace(llm, ids, feed):
    """Prefill + PARITY_STEPS decode steps on llm's device. `feed`: the
    tokens to feed (teacher forcing), or None for the own argmax."""
    cache = llm._new_cache()
    tokens = torch.tensor([ids], dtype=torch.int64, device=llm.device)
    logits, cache = generate.run_prefill(llm.params, llm.config, llm.rt, tokens, cache)
    rows = [logits.float().cpu()]
    fed = []
    for s in range(PARITY_STEPS):
        tok = feed[s] if feed is not None else int(rows[-1].argmax())
        fed.append(tok)
        t = torch.tensor([[tok]], dtype=torch.int64, device=llm.device)
        logits, cache = decoder.forward(llm.params, llm.config, t, cache)
        rows.append(logits.float().cpu())
    return rows, fed


def phase_parity(llm, reqs, outs):
    card, fed = greedy_trace(llm, reqs[0], None)
    n = min(len(outs[0]), PARITY_STEPS)
    check(fed[:n] == outs[0][:n], f"parity: the card's Llm tokens {outs[0][:n]} "
          f"differ from its own decode trace {fed[:n]}")
    cpu_llm = Llm.synthetic(llm.config.name, rt=llm.rt, seed=SEED, device="cpu")
    t0 = time.perf_counter()
    cpu, _ = greedy_trace(cpu_llm, reqs[0], fed)
    cpu_s = time.perf_counter() - t0
    rels = [rel_l2(a, b) for a, b in zip(card, cpu)]
    diff = max(max_abs(a, b) for a, b in zip(card, cpu))
    checked = 0
    for s, (a, b) in enumerate(zip(card, cpu)):
        check(bool(torch.isfinite(a).all()), f"parity: non-finite card logits at {s}")
        check(rels[s] <= PARITY_REL, f"parity: step {s} rel-L2 {rels[s]:.3g} > {PARITY_REL}")
        top2 = b[0].topk(2).values
        if float(top2[0] - top2[1]) > diff:
            checked += 1
            check(int(a.argmax()) == int(b.argmax()),
                  f"parity: step {s} token {int(a.argmax())} != cpu {int(b.argmax())}")
    print(f"  card vs cpu: rel-L2 per step {[f'{r:.2e}' for r in rels]}, "
          f"max |diff| {diff:.3g}, tokens compared at {checked}/{len(rels)} steps, "
          f"cpu run {cpu_s:.1f} s", flush=True)
    return dict(rel_l2=rels, max_abs_diff=diff, tokens_checked=checked)


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
}


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
    torch.cuda.empty_cache()

    print("phase 3: serving qwen2-0.5b on the card", flush=True)
    t0 = time.perf_counter()
    llm = Llm.synthetic("qwen2-0.5b", rt=serving_rt(), seed=SEED, device=dev)
    cfg = llm.config
    print(f"  model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, vocab "
          f"{cfg.vocab_size}; built in {time.perf_counter() - t0:.1f} s; "
          f"info {json.dumps(llm.info())}", flush=True)
    reqs, outs, perf, launches = phase_serve(llm)

    print("phase 4: the first request on the card and on the cpu", flush=True)
    parity = phase_parity(llm, reqs, outs)

    gen_tokens = sum(len(o) for o in outs)
    kernels = []
    for kname, (src, repl, entry) in KERNEL_INFO.items():
        rows = results[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=repl,
            launches=launches[entry],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=sum(r["library_ms"] for r in rows),
            shapes=len(rows)))
    detail = dict(card=card_line, torch=torch.__version__, build_s=build_s,
                  kernels=results, serve=perf, launches=launches,
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
