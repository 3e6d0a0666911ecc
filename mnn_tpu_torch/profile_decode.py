"""Where the time of one greedy decode step goes, on the card.

    python -m mnn_tpu_torch.profile_decode [--preset qwen2-0.5b] [--prompt 300]

Builds `Llm.synthetic(preset)` in the serving configuration of the port's
main path (W4 block-128 weights, int4 lm head, int8 KV cache, int8 prefill
activations), prefills a random prompt, warms the decode loop, then traces
`--steps` decode steps with `torch.profiler`. It prints, per decode step:
the wall time (of an untraced run of as many steps), the device's busy
time in the traced run (the sum of the kernels' device times; one stream,
so they do not overlap), the idle share of the untraced wall time, the
number of kernel launches, and the device time of each kernel by name.
The JSON goes to `chiprun_out/decode_profile.json` as well. Needs a card;
it never runs on the CPU.
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
from mnn_tpu_torch.runtime import sampler
from mnn_tpu_torch.runtime.llm import Llm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen2-0.5b")
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default="chiprun_out/decode_profile.json")
    args = ap.parse_args(argv)

    rt = RuntimeConfig(max_seq_len=1024, prefill_chunk=512, sampler="greedy",
                       kv_quant=True, kv_bits=8, quant_bits=4, quant_block=128,
                       lm_head_bits=4, prefill_act_bits=8)
    llm = Llm.synthetic(args.preset, rt=rt, seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, llm.config.vocab_size, (1, args.prompt), generator=g)
    logits, cache = gen.run_prefill(llm.params, llm.config, rt,
                                    ids.to(llm.device), llm.cache)
    state = sampler.make_state(1, device=llm.device)

    def steps(n, logits, cache, state):
        _, logits, cache, state = gen.decode_steps(
            llm.params, llm.config, cache, logits, state, llm.generator, steps=n)
        torch.cuda.synchronize()
        return logits, cache, state

    logits, cache, state = steps(4, logits, cache, state)       # warm-up
    t0 = time.perf_counter()                  # wall time with the tracer off
    logits, cache, state = steps(args.steps, logits, cache, state)
    wall = (time.perf_counter() - t0) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache, state = steps(args.steps, logits, cache, state)
        wall_traced = (time.perf_counter() - t0) / args.steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / args.steps,
                       e.count / args.steps) for e in kernels),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in by_name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    res = dict(card=smi, preset=args.preset, prompt=args.prompt,
               steps=args.steps, wall_ms_per_step=wall * 1e3,
               wall_ms_per_step_traced=wall_traced * 1e3,
               device_busy_ms_per_step=busy,
               device_idle_share=1 - busy / (wall * 1e3),
               kernel_launches_per_step=sum(n for _, _, n in by_name),
               kernels=[dict(name=k, ms_per_step=ms, launches_per_step=n)
                        for k, ms, n in by_name])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"card: {smi}")
    print(f"decode step: wall {res['wall_ms_per_step']:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {res['device_idle_share']:.3f}, "
          f"{res['kernel_launches_per_step']:.0f} kernel launches")
    for k, ms, n in by_name[:15]:
        print(f"  {ms:8.4f} ms  x{n:5.1f}  {k[:100]}")
    if not kernels:
        raise SystemExit("the profiler recorded no device time")


if __name__ == "__main__":
    main()
