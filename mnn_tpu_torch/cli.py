"""mnn-tpu-torch CLI: the `chat`, `run`, `serve`, `convert`, `eval`,
`txt2img`, `bench-cnn`, `eval-cls`, `download`, `search` and `list`
subcommands of `mnn_tpu/cli.py` on the port.

    python -m mnn_tpu_torch.cli convert --hf HF_DIR --out OUT --lm-head-bits 4
    python -m mnn_tpu_torch.cli run --model OUT "prompt"
    python -m mnn_tpu_torch.cli chat --model OUT
    python -m mnn_tpu_torch.cli serve --model OUT --batch 4
    python -m mnn_tpu_torch.cli eval --model OUT --file text.txt
    python -m mnn_tpu_torch.cli run --synthetic qwen1.5-moe-a2.7b "prompt"
    python -m mnn_tpu_torch.cli serve --preset gemma2-2b --batch 4
    python -m mnn_tpu_torch.cli txt2img --model SD_DIR "a red bicycle" --out out.png
    python -m mnn_tpu_torch.cli bench-cnn --models resnet50 --batch 32
    python -m mnn_tpu_torch.cli eval-cls --dir IMAGENET_VAL --net resnet50 --weights r50.pt
    python -m mnn_tpu_torch.cli download qwen2-0.5b
    python -m mnn_tpu_torch.cli list

Runs on the CUDA card by default; `--device cpu` runs the kernels' plain
PyTorch versions instead. `--model DIR` loads a converted checkpoint (from
`convert`, or from the JAX package's converter) and wins over
`--synthetic` (also `--preset`), a random-weight preset. `convert` reads a HuggingFace
directory (`--hf`) or a llama.cpp GGUF file (`--gguf`) and quantizes on the
device; `--awq` runs the activation-aware scale search and clipping first,
on the lines of `--calib-data FILE` (at most 16, 256 tokens each) or,
without it, on seeded random tokens [4, 128], as the JAX CLI does. The
model defaults are the serving configuration of the port's main path: W4
block-128 weights, an int4 lm head (a loaded checkpoint keeps the head it
was converted with), an int8 KV cache (`--kv-bits 4` packs it to int4,
`--kv-bits 3` gives the TQ3 codebook cache) and int8 prefill activations.
Decode steps run through the whole-model decode kernel whenever the config
is eligible; the mixture-of-experts models
decode layer by layer through the fused expert kernel and prefill through
the grouped one. `serve` answers OpenAI chat and completions requests
(`serve/server.py`), one at a time through `Llm.stream`, or with `--batch`
> 1 side by side through the continuous-batching engine; `--dp` > 1 is not
ported. `eval` prints {"tokens": n, "perplexity": p} of a text. `txt2img`
runs Stable Diffusion from a diffusers-format directory (bf16, classifier-
free guidance) and saves a PNG, or `<out>.npy` when PIL is missing.
`bench-cnn` converts each vision model (`models/vision.py`, seeded torch
init) through the torch.fx frontend, casts its f32 params to bf16 and times
it on a seeded bf16 batch with `utils/benchit.chain`, one JSON line per
model: model, batch, latency_ms, images_per_s. `eval-cls` prints the top-1
/ top-k accuracy of a vision model in bf16 over an ImageFolder tree.
`download` fetches a model from the hub by alias or repo id into the local
registry and prints its directory, `search` lists hub models, `list` the
registry's (offline); the first two need `huggingface_hub` and a network,
and say so when either is missing (`convert/download.py`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _add_model_args(p):
    p.add_argument("--model", help="converted checkpoint directory")
    p.add_argument("--synthetic", "--preset", default="qwen2-0.5b",
                   help="synthetic preset when no --model is given "
                        "(e.g. qwen2-0.5b, qwen1.5-moe-a2.7b, gemma2-2b, gemma3-4b)")
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
    p.add_argument("--kv-bits", type=int, default=8, choices=(3, 4, 8),
                   help="quantized KV cache: int8, nibble-packed int4, or the "
                        "TQ3 codebook (3)")
    p.add_argument("--lm-head-bits", type=int, default=4, choices=(0, 4, 8),
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
    if args.model:
        return Llm.from_pretrained(args.model, rt=rt, device=args.device)
    print(f"[mnn-tpu-torch] no --model given; synthetic random-weight "
          f"'{args.synthetic}'", file=sys.stderr)
    return Llm.synthetic(args.synthetic, rt=rt, seed=args.seed,
                         device=args.device)


def cmd_chat(args):
    llm = _build_llm(args)
    print("mnn-tpu-torch chat: /reset clears the context, /exit quits",
          file=sys.stderr)
    while True:
        try:
            prompt = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if prompt.strip() == "/exit":
            break
        if prompt.strip() == "/reset":
            llm.reset()
            print("[context cleared]", file=sys.stderr)
            continue
        buf = []
        for tok in llm.stream(prompt, use_template=True):
            buf.append(tok)
            text = llm.tokenizer.decode(buf)
            if not text.endswith("\ufffd"):     # hold an incomplete UTF-8 tail
                sys.stdout.write(text)
                sys.stdout.flush()
                buf.clear()
        p = llm.perf
        print(f"\n[prefill {p.prefill_tok_s:.1f} tok/s | decode "
              f"{p.decode_tok_s:.1f} tok/s]", file=sys.stderr)


def cmd_run(args):
    llm = _build_llm(args)
    out = llm.generate(args.prompt, use_template=not args.raw)
    print(out)
    p = llm.perf
    print(f"[{llm.info()['device']}] prefill {p.prompt_len} tok @ "
          f"{p.prefill_tok_s:.1f} tok/s | decode {p.gen_len} tok @ "
          f"{p.decode_tok_s:.1f} tok/s", file=sys.stderr)


def cmd_serve(args):
    from mnn_tpu_torch.serve.server import serve

    llm = _build_llm(args)
    serve(llm, host=args.host, port=args.port, batch=args.batch,
          snapshot_path=args.snapshot, dp=args.dp)


def cmd_convert(args):
    if not (args.hf or args.gguf):
        raise SystemExit("convert: provide --hf DIR or --gguf FILE")
    t0 = time.time()
    kw = dict(bits=args.bits, block_size=args.block, sym=args.sym,
              tp_shards=args.tp, act_bits=args.act_bits,
              lm_head_bits=args.lm_head_bits, device=args.device)
    if args.awq:
        kw.update(awq=True, calib_tokens=_calib_tokens(args))
    if args.gguf:
        from mnn_tpu_torch.convert.gguf import convert_gguf

        convert_gguf(args.gguf, args.out, **kw)
        src = args.gguf
    else:
        from mnn_tpu_torch.convert.hf import convert_hf

        convert_hf(args.hf, args.out, **kw)
        src = args.hf
    print(f"converted {src} -> {args.out} "
          f"(int{args.bits}, block {args.block}, {time.time() - t0:.1f}s)")


def _calib_tokens(args):
    """AWQ calibration ids [B, T] int32: the first 16 non-empty lines of
    `--calib-data`, tokenized with the source model's tokenizer (256 ids
    at most each, zero-padded), or seeded random ids [4, 128]."""
    import numpy as np

    if not args.calib_data:
        return np.random.default_rng(0).integers(0, 1000, (4, 128)).astype(np.int32)
    from mnn_tpu_torch.runtime.tokenizer import load_tokenizer

    tok = load_tokenizer(args.hf)
    with open(args.calib_data) as f:
        lines = [ln.strip() for ln in f if ln.strip()][:16]
    ids = [tok.encode(ln)[:256] for ln in lines]
    calib = np.zeros((len(ids), max(len(i) for i in ids)), np.int32)
    for r, i in enumerate(ids):
        calib[r, :len(i)] = i
    return calib


def cmd_eval(args):
    from mnn_tpu_torch.runtime.evaluate import perplexity

    llm = _build_llm(args)
    if args.file:
        with open(args.file) as f:
            text = f.read()
    else:
        text = args.text or ""
    ids = llm.tokenizer.encode(text)[:args.max_tokens_eval]
    ppl = perplexity(llm.params, llm.config, ids, chunk=args.prefill_chunk)
    print(json.dumps({"tokens": len(ids), "perplexity": round(ppl, 4)}))


def cmd_txt2img(args):
    import numpy as np

    from mnn_tpu_torch.diffusion import StableDiffusion

    sd = StableDiffusion.from_pretrained(args.model, scheduler=args.scheduler,
                                         device=args.device)
    t0 = time.time()
    img = sd.txt2img(args.prompt, negative_prompt=args.negative, num_steps=args.steps,
                     seed=args.seed, guidance_scale=args.cfg, height=args.size,
                     width=args.size,
                     callback=lambda i, _: print(f"step {i + 1}/{args.steps}", flush=True))
    dt = time.time() - t0
    try:
        from PIL import Image

        Image.fromarray(img).save(args.out)
    except ImportError:
        np.save(args.out + ".npy", img)
    print(f"saved {args.out} ({dt:.1f}s, {args.steps / dt:.2f} it/s)")


def _bf16_params(params):
    """f32 tensors of a converted model's params as bf16, as the JAX CLI
    casts its pytree."""
    if isinstance(params, dict):
        return {k: _bf16_params(v) for k, v in params.items()}
    return params.to(torch.bfloat16) if params.dtype == torch.float32 else params


def cmd_bench_cnn(args):
    import numpy as np

    from mnn_tpu_torch.convert.torch_fx import convert_torch_module
    from mnn_tpu_torch.kernels.common import resolve_device
    from mnn_tpu_torch.models.vision import VISION_MODELS
    from mnn_tpu_torch.utils.benchit import chain

    dev = resolve_device(args.device)
    names = args.models.split(",") if args.models else list(VISION_MODELS)
    for name in names:
        torch.manual_seed(0)
        mod = VISION_MODELS[name]().eval()
        fn, params = convert_torch_module(mod, device=dev)
        params = _bf16_params(params)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (args.batch, 3, args.size, args.size)).astype(np.float32)).to(dev, torch.bfloat16)
        with torch.no_grad():
            t = chain(lambda xx: fn(params, xx), x, iters=20, warmup=2)
        print(json.dumps({
            "model": name, "batch": args.batch,
            "latency_ms": round(t * 1e3, 3),
            "images_per_s": round(args.batch / t, 1),
        }), flush=True)


def cmd_eval_cls(args):
    from mnn_tpu_torch.convert.torch_fx import convert_torch_module
    from mnn_tpu_torch.kernels.common import resolve_device
    from mnn_tpu_torch.models.vision import VISION_MODELS
    from mnn_tpu_torch.runtime.classify import eval_folder

    dev = resolve_device(args.device)
    torch.manual_seed(0)
    mod = VISION_MODELS[args.net]().eval()
    if args.weights:
        mod.load_state_dict(torch.load(args.weights, map_location="cpu"))
    fn, params = convert_torch_module(mod, device=dev)
    params = _bf16_params(params)
    r = eval_folder(lambda x: fn(params, x.to(torch.bfloat16)), args.dir, size=args.size,
                    k=args.k, batch_size=args.batch, limit=args.limit, device=dev)
    print(json.dumps({"net": args.net, **r}))


def cmd_download(args):
    from mnn_tpu_torch.convert.download import download

    print(download(args.name, out=args.out))


def cmd_search(args):
    from mnn_tpu_torch.convert.download import search

    for hit in search(args.query, limit=args.limit):
        print(f"{hit['id']}  (downloads {hit['downloads']}, likes {hit['likes']})")


def cmd_list(args):
    from mnn_tpu_torch.convert.download import list_local

    for name in list_local():
        print(name)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mnn-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("chat", help="interactive chat")
    _add_model_args(p)
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser("run", help="single prompt")
    _add_model_args(p)
    p.add_argument("prompt")
    p.add_argument("--raw", action="store_true", help="no chat template")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("serve", help="OpenAI-compatible server")
    _add_model_args(p)
    p.add_argument("--snapshot", default="",
                   help="engine state file: resume from it on start, "
                        "write it on shutdown (restartable serving)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9090)
    p.add_argument("--batch", type=int, default=1,
                   help=">1 enables continuous batching (a mixture-of-experts "
                   "model: keep it <= 8, the fused expert kernel's rows)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree (not ported: only 1)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("convert", help="convert a HF or GGUF checkpoint")
    p.add_argument("--hf", help="HF model directory")
    p.add_argument("--gguf", help="llama.cpp GGUF file (dequantized and "
                                  "requantized on this package's grid)")
    p.add_argument("--out", required=True)
    p.add_argument("--bits", type=int, default=4, choices=(2, 3, 4, 8))
    p.add_argument("--block", type=int, default=128)
    p.add_argument("--sym", action="store_true")
    p.add_argument("--act-bits", type=int, default=16, choices=(8, 16),
                   help="8 = dynamic int8 activations (W4A8)")
    p.add_argument("--lm-head-bits", type=int, default=0, choices=(0, 4, 8),
                   help="quantize the output projection (0 = keep bf16)")
    p.add_argument("--tp", type=int, default=1,
                   help="target tensor-parallel shards (affects block sizes)")
    p.add_argument("--awq", action="store_true",
                   help="activation-aware scale search and clipping before "
                        "quantizing (dense pre-norm models)")
    p.add_argument("--calib-data",
                   help="--awq calibration text, one sample a line (default: "
                        "seeded random tokens)")
    p.add_argument("--device", default=None,
                   help="where to quantize: cuda (default) or cpu")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("eval", help="perplexity over a text file")
    _add_model_args(p)
    p.add_argument("--file")
    p.add_argument("--text")
    p.add_argument("--max-tokens-eval", type=int, default=4096)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("txt2img", help="diffusion text-to-image")
    p.add_argument("--model", required=True, help="diffusers-format SD checkpoint dir")
    p.add_argument("prompt")
    p.add_argument("--negative", default="")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg", type=float, default=7.5)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--scheduler", default="ddim",
                   choices=["ddim", "ddpm", "euler", "flow_match"])
    p.add_argument("--out", default="out.png")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    p.set_defaults(fn=cmd_txt2img)

    p = sub.add_parser("bench-cnn", help="vision model latency (bf16)")
    p.add_argument("--models", help="comma list (default: all)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench_cnn)

    p = sub.add_parser("eval-cls", help="top-k classification accuracy over "
                                        "an ImageFolder tree")
    p.add_argument("--dir", required=True)
    p.add_argument("--net", default="mobilenet_v2")
    p.add_argument("--weights", default="", help="torch state_dict .pt")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval_cls)

    p = sub.add_parser("download", help="fetch a model from the hub")
    p.add_argument("name", help="alias (e.g. qwen2-0.5b) or HF repo id")
    p.add_argument("--out", help="target dir (default: the local registry)")
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("search", help="search the model hub")
    p.add_argument("query")
    p.add_argument("--limit", type=int, default=20)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("list", help="list the models of the local registry")
    p.set_defaults(fn=cmd_list)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
