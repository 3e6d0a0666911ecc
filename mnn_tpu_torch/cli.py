"""mnn-tpu-torch CLI: the `run` subcommand of `mnn_tpu/cli.py` on the port.

    python -m mnn_tpu_torch.cli run --synthetic qwen2-0.5b "prompt"
    python -m mnn_tpu_torch.cli run --synthetic qwen1.5-moe-a2.7b "prompt"

Runs on the CUDA card by default; `--device cpu` runs the kernels' plain
PyTorch versions instead. Synthetic random-weight presets only: loading a
converted checkpoint (`--model`) is not ported yet. The defaults are the
serving configuration of the port's main path: W4 block-128 weights, an
int4 lm head, an int8 KV cache (`--kv-bits 4` packs it to int4) and int8
prefill activations. Decode steps run through the whole-model decode kernel
whenever the config is eligible; the mixture-of-experts presets
(`qwen1.5-moe-a2.7b`, `qwen3-moe-30b-a3b`) decode layer by layer through the
fused expert kernel and prefill through the grouped one.
"""

from __future__ import annotations

import argparse
import sys


def _add_model_args(p):
    p.add_argument("--synthetic", default="qwen2-0.5b",
                   help="synthetic preset (e.g. qwen2-0.5b, qwen1.5-moe-a2.7b)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    p.add_argument("--max-seq-len", type=int, default=4096)
    p.add_argument("--decode-block", type=int, default=32)
    p.add_argument("--prefill-chunk", type=int, default=512)
    p.add_argument("--sampler", default="mixed")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--penalty", type=float, default=1.0)
    p.add_argument("--no-kv-quant", action="store_true")
    p.add_argument("--kv-bits", type=int, default=8, choices=(4, 8),
                   help="quantized KV cache: int8 or nibble-packed int4")
    p.add_argument("--lm-head-bits", type=int, default=4,
                   help="quantized output projection (0 = bf16 head)")
    p.add_argument("--prefill-act-bits", type=int, default=8,
                   help="8 = dynamic int8 prefill activations (W4A8)")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)


def _build_llm(args):
    from mnn_tpu_torch.models.config import RuntimeConfig
    from mnn_tpu_torch.runtime.llm import Llm

    rt = RuntimeConfig(
        max_seq_len=args.max_seq_len, decode_block=args.decode_block,
        prefill_chunk=args.prefill_chunk, sampler=args.sampler,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        penalty=args.penalty, kv_quant=not args.no_kv_quant,
        kv_bits=args.kv_bits,
        lm_head_bits=args.lm_head_bits,
        prefill_act_bits=args.prefill_act_bits,
        max_new_tokens=args.max_new_tokens, seed=args.seed,
    )
    print(f"[mnn-tpu-torch] synthetic random-weight '{args.synthetic}'",
          file=sys.stderr)
    return Llm.synthetic(args.synthetic, rt=rt, seed=args.seed,
                         device=args.device)


def cmd_run(args):
    llm = _build_llm(args)
    out = llm.generate(args.prompt, use_template=not args.raw)
    print(out)
    p = llm.perf
    print(f"[{llm.info()['device']}] prefill {p.prompt_len} tok @ "
          f"{p.prefill_tok_s:.1f} tok/s | decode {p.gen_len} tok @ "
          f"{p.decode_tok_s:.1f} tok/s", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mnn-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="single prompt")
    _add_model_args(p)
    p.add_argument("prompt")
    p.add_argument("--raw", action="store_true", help="no chat template")
    p.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
