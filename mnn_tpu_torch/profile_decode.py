"""Where the time of one greedy decode step goes, on the card.

    python -m mnn_tpu_torch.profile_decode [--preset qwen2-0.5b] [--prompt 300]
                                           [--kv-bits 8] [--steps 16]

Builds `Llm.synthetic(preset)` in the serving configuration of the port's
main path (W4 block-128 weights, int4 lm head, int8 or int4 KV cache, int8
prefill activations), prefills a random prompt, and then, for each decode
path in turn (the whole-model decode kernel, and the per-layer fallback
`forward(megakernel=False)`), warms the decode loop and traces `--steps`
greedy decode steps with `torch.profiler`. It prints, per decode step and
path: the wall time (of an untraced run of as many steps), the device's busy
time in the traced run (the sum of the kernels' device times; one stream, so
they do not overlap), the idle share of the untraced wall time, the number of
kernel launches, and the device time of each kernel by name; for the
whole-model kernel also the share of its time that each kind of phase takes
(block 0's clock at the end of every phase). A mixture-of-experts preset
(`--preset qwen1.5-moe-a2.7b`) has the per-layer path only: its expert MLP
runs in the fused expert kernel, one entry a layer. The JSON goes to
`chiprun_out/decode_profile.json` as well. Needs a card; it never runs on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from mnn_tpu_torch.kernels import decode_model
from mnn_tpu_torch.models.config import RuntimeConfig
from mnn_tpu_torch.models.decoder import forward
from mnn_tpu_torch.runtime import generate as gen
from mnn_tpu_torch.runtime import kvcache, sampler
from mnn_tpu_torch.runtime.llm import Llm

PATHS = {"megakernel": None, "per_layer": False}   # forward's `megakernel`


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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache, state = steps(n_steps, logits, cache, state)
        wall_traced = (time.perf_counter() - t0) / n_steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise SystemExit("the profiler recorded no device time")
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps,
                       e.count / n_steps) for e in kernels),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in by_name)
    extra = {}
    if megakernel is None:
        extra["phase_shares"] = phase_shares(
            llm, cache, torch.zeros((1, 1), dtype=torch.int64, device=llm.device))
    return dict(**extra, wall_ms_per_step=wall * 1e3,
                wall_ms_per_step_traced=wall_traced * 1e3,
                device_busy_ms_per_step=busy,
                device_idle_share=1 - busy / (wall * 1e3),
                kernel_launches_per_step=sum(n for _, _, n in by_name),
                kernels=[dict(name=k, ms_per_step=ms, launches_per_step=n)
                         for k, ms, n in by_name])


def phase_shares(llm, cache, token) -> dict:
    """One more step of the whole-model kernel with its phase clocks on:
    {phase kind: share of the kernel's time}, summed over the layers. A
    phase's time includes the grid barrier that ends it."""
    c = llm.config
    names = decode_model.phase_names(
        c.num_layers, decode_model.supports_head(c, llm.params))
    clocks = torch.zeros((len(names),), dtype=torch.int64, device=llm.device)
    decode_model.PHASE_CLOCKS = clocks
    try:
        forward(llm.params, c, token, cache, megakernel=True)
        torch.cuda.synchronize()
    finally:
        decode_model.PHASE_CLOCKS = None
    t = clocks.tolist()
    total = t[-1] - t[0]
    shares: dict = {}
    for name, a, b in zip(names[1:], t[:-1], t[1:]):
        shares[name] = shares.get(name, 0.0) + (b - a) / total
    return shares


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen2-0.5b")
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--kv-bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--out", default="chiprun_out/decode_profile.json")
    args = ap.parse_args(argv)

    rt = RuntimeConfig(max_seq_len=1024, prefill_chunk=512, sampler="greedy",
                       kv_quant=True, kv_bits=args.kv_bits, quant_bits=4,
                       quant_block=128, lm_head_bits=4, prefill_act_bits=8)
    llm = Llm.synthetic(args.preset, rt=rt, seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, llm.config.vocab_size, (1, args.prompt),
                        generator=g).to(llm.device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    info = llm.info()
    res = dict(card=smi, preset=args.preset, prompt=args.prompt,
               steps=args.steps, kv_bits=args.kv_bits,
               decode_megakernel=info["decode_megakernel"],
               decode_fused_head=info["decode_fused_head"],
               decode_moe_fused=info["decode_moe_fused"], paths={})
    print(f"card: {smi}")
    for name, flag in PATHS.items():
        if flag is None and not info["decode_megakernel"]:
            print(f"{name}: not eligible for {args.preset}")
            continue
        r = res["paths"][name] = profile_path(llm, rt, ids, args.steps, flag)
        print(f"{name} decode step: wall {r['wall_ms_per_step']:.3f} ms, device "
              f"busy {r['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{r['device_idle_share']:.3f}, "
              f"{r['kernel_launches_per_step']:.0f} kernel launches")
        for k in r["kernels"][:12]:
            print(f"  {k['ms_per_step']:8.4f} ms  x{k['launches_per_step']:5.1f}  "
                  f"{k['name'][:100]}")
        if "phase_shares" in r:
            print("  whole-model kernel, share of its time by phase: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["phase_shares"].items()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
