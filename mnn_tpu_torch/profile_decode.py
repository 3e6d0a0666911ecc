"""Where the time of one greedy decode step, or of a prefill, goes, on the card.

    python -m mnn_tpu_torch.profile_decode [--preset qwen2-0.5b] [--prompt 300]
                                           [--kv-bits 8] [--steps 16] [--w-bits 4]
    python -m mnn_tpu_torch.profile_decode --prefill [--act-bits 16] [--w-bits 3]

Builds `Llm.synthetic(preset)` in the serving configuration of the port's
main path (W4 block-128 weights, int4 lm head, int8 or int4 KV cache, int8
prefill activations; `--w-bits 2|3|8` weights of that many bits and a head
of min(bits, 4), as bench.py's --w-bits rows), prefills a random prompt, and then, for each decode
path in turn (the whole-model decode kernel, and the per-layer fallback
`forward(megakernel=False)`), warms the decode loop and traces `--steps`
greedy decode steps with `torch.profiler`. It prints, per decode step and
path: the wall time (of an untraced run of as many steps), the device's busy
time in the traced run (the sum of the kernels' device times; one stream, so
they do not overlap), the idle share of the untraced wall time, the number of
kernel launches, and the device time of each kernel by name (where the
whole-model kernel's time goes inside it: `profile_a8 --kernel model
--clocks`, a build with stamps). A mixture-of-experts preset
(`--preset qwen1.5-moe-a2.7b`) has the per-layer path only: its expert MLP
runs in the fused expert kernel, one entry a layer.

`--prefill` times the prefill of the prompt instead (every chunk, from an
empty cache, with `--act-bits` 8 or 16 for the prefill projections): the
wall time of five untraced runs, each ending in a synchronize, then
one traced run's device busy time, idle share against the median wall time,
launches and kernels by name. The JSON goes to `chiprun_out/decode_profile.json`
(`prefill_profile.json` with `--prefill`) as well. Needs a card; it never
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from mnn_tpu_torch.models.config import RuntimeConfig
from mnn_tpu_torch.runtime import generate as gen
from mnn_tpu_torch.runtime import kvcache, sampler
from mnn_tpu_torch.runtime.llm import Llm

PATHS = {"megakernel": None, "per_layer": False}   # forward's `megakernel`
PREFILL_REPEATS = 5


def profile_path(llm, rt, ids, n_steps: int, megakernel) -> dict:
    """Prefill `ids`, then time and trace `n_steps` greedy steps of one path."""
    logits, cache = gen.run_prefill(llm.params, llm.config, rt, ids,
                                    kvcache.reset(llm.cache))
    state = sampler.make_state(1, device=llm.device)

    def steps(n, logits, cache, state):
        _, logits, cache, state = gen.decode_steps(
            llm.params, llm.config, cache, logits, state, llm.generator,
            steps=n, megakernel=megakernel)
        torch.cuda.synchronize()
        return logits, cache, state

    logits, cache, state = steps(4, logits, cache, state)       # warm-up
    t0 = time.perf_counter()                  # wall time with the tracer off
    logits, cache, state = steps(n_steps, logits, cache, state)
    wall = (time.perf_counter() - t0) / n_steps
    by_name, (logits, cache, state), wall_traced = traced(
        lambda: steps(n_steps, logits, cache, state), n_steps)
    busy = sum(ms for _, ms, _ in by_name)
    return dict(wall_ms_per_step=wall * 1e3,
                wall_ms_per_step_traced=wall_traced * 1e3,
                device_busy_ms_per_step=busy,
                device_idle_share=1 - busy / (wall * 1e3),
                kernel_launches_per_step=sum(n for _, _, n in by_name),
                kernels=[dict(name=k, ms_per_step=ms, launches_per_step=n)
                         for k, ms, n in by_name])


def traced(fn, n: int):
    """One traced `fn()`: ([(kernel name, device ms, launches)] per 1/n of
    it, longest first; what `fn` returned; its wall seconds per 1/n)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        wall = (time.perf_counter() - t0) / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise SystemExit("the profiler recorded no device time")
    return sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                   for e in kernels), key=lambda r: -r[1]), result, wall


def profile_prefill(llm, rt, ids) -> dict:
    """Time PREFILL_REPEATS prefills of `ids` from an empty cache, then trace one."""
    def run():
        gen.run_prefill(llm.params, llm.config, rt, ids, kvcache.reset(llm.cache))
        torch.cuda.synchronize()

    run()                                     # warm-up
    walls = []
    for _ in range(PREFILL_REPEATS):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    by_name, _, _ = traced(run, 1)
    busy = sum(ms for _, ms, _ in by_name)
    median = sorted(walls)[len(walls) // 2]
    return dict(wall_ms=walls, wall_ms_median=median, device_busy_ms=busy,
                device_idle_share=1 - busy / median,
                kernel_launches=sum(n for _, _, n in by_name),
                chunks=gen.prefill_buckets(ids.shape[1], rt.prefill_chunk),
                kernels=[dict(name=k, ms=ms, launches=n) for k, ms, n in by_name])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen2-0.5b")
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--kv-bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--prefill", action="store_true",
                    help="profile the prefill of the prompt, not decode steps")
    ap.add_argument("--act-bits", type=int, default=8, choices=(8, 16),
                    help="prefill activations: int8 rows (the serving path) or bf16")
    ap.add_argument("--w-bits", type=int, default=4, choices=(2, 3, 4, 8),
                    help="weight bits of the projections (head: min(bits, 4))")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rt = RuntimeConfig(max_seq_len=1024, prefill_chunk=512, sampler="greedy",
                       kv_quant=True, kv_bits=args.kv_bits, quant_bits=args.w_bits,
                       quant_block=128, lm_head_bits=min(args.w_bits, 4),
                       prefill_act_bits=args.act_bits)
    llm = Llm.synthetic(args.preset, rt=rt, seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, llm.config.vocab_size, (1, args.prompt),
                        generator=g).to(llm.device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    info = llm.info()
    res = dict(card=smi, preset=args.preset, prompt=args.prompt,
               steps=args.steps, kv_bits=args.kv_bits, w_bits=args.w_bits,
               decode_megakernel=info["decode_megakernel"],
               decode_fused_head=info["decode_fused_head"],
               decode_moe_fused=info["decode_moe_fused"], paths={})
    print(f"card: {smi}")
    out = Path(args.out or "chiprun_out/" + ("prefill" if args.prefill else "decode")
               + "_profile.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.prefill:
        r = res["prefill"] = profile_prefill(llm, rt, ids)
        res["act_bits"] = args.act_bits
        print(f"prefill of {args.prompt} tokens ({args.preset}, W{args.w_bits}, "
              f"act_bits {args.act_bits}, "
              f"chunks {r['chunks']}): wall {r['wall_ms_median']:.2f} ms (median of "
              f"{PREFILL_REPEATS}: {', '.join(f'{w:.2f}' for w in r['wall_ms'])}), device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['device_idle_share']:.3f}, "
              f"{r['kernel_launches']:.0f} kernel launches")
        for k in r["kernels"][:12]:
            print(f"  {k['ms']:8.4f} ms  x{k['launches']:5.0f}  {k['name'][:100]}")
        out.write_text(json.dumps(res, indent=1))
        return
    for name, flag in PATHS.items():
        if flag is None and not info["decode_megakernel"]:
            print(f"{name}: not eligible for {args.preset}")
            continue
        r = res["paths"][name] = profile_path(llm, rt, ids, args.steps, flag)
        print(f"{name} decode step (W{args.w_bits}): wall {r['wall_ms_per_step']:.3f} ms, device "
              f"busy {r['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{r['device_idle_share']:.3f}, "
              f"{r['kernel_launches_per_step']:.0f} kernel launches")
        for k in r["kernels"][:12]:
            print(f"  {k['ms_per_step']:8.4f} ms  x{k['launches_per_step']:5.1f}  "
                  f"{k['name'][:100]}")
    out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
