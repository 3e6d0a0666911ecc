"""The int8-row matmul kernel against another version of it, on the card.

    python -m mnn_tpu_torch.profile_a8 --against OLD/dequant_matmul.cu

Builds `csrc/dequant_matmul.cu` and the given other version of that source
(for example the parent commit's, `git show HEAD~1:mnn_tpu_torch/csrc/
dequant_matmul.cu`) into two libraries, then times `mnn_dequant_matmul_a8`
of each on rows quantized beforehand, at the shapes of `chip_smoke.py`
phase 2: qwen2-0.5b's qkv, wo, gate/up and down and qwen1.5-moe-a2.7b's qkv
and wo at M = 512, and gate/up at M = 32 and 128 (W4, block 128). Each
version runs twice, in the order other, this, this, other, in one process on
one card; a call rotates over weight copies larger than L2, as the serving
path finds them. It prints both versions' times per shape and whether the
two give the same bits (both compute the exact int32 algebra), with the
card's name and power limit; the JSON goes to
`chiprun_out/a8_against.json` as well. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
from pathlib import Path

import torch

from mnn_tpu_torch.kernels import build
from mnn_tpu_torch.quant.quantize import quantize_activations_int8

SHAPES = [  # (M, K, N)
    (512, 896, 1152), (512, 896, 896), (512, 896, 9728), (512, 4864, 896),
    (512, 2048, 6144), (512, 2048, 2048), (32, 896, 9728), (128, 896, 9728)]
L2_ROTATE_BYTES = 128 << 20


def _library(src: Path, out_dir: Path, name: str) -> ctypes.CDLL:
    """One source, with the port's headers beside it, into its own library."""
    work = out_dir / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    shutil.copy(src, work / "dequant_matmul.cu")
    so = work / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(work),
                    "-o", str(so), str(work / "dequant_matmul.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.mnn_dequant_matmul_a8.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return lib


def _time_us(fn, calls: int) -> float:
    """Device time of one call, from a CUDA graph of `calls` calls."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * calls) * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="another version of csrc/dequant_matmul.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_a8 needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out_dir = build.BUILD_ROOT / "profile_a8"
    libs = {"this": _library(build.CSRC / "dequant_matmul.cu", out_dir, "this"),
            "other": _library(args.against, out_dir, "other")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    times = {"other": [], "this": []}
    same = True
    for m, k, n in SHAPES:
        nl = max(1, min(256, math.ceil(L2_ROTATE_BYTES / (k * n // 2))))
        packed = torch.randint(-128, 128, (nl, k // 2, n), dtype=torch.int8, device=dev,
                               generator=g)
        scale = (torch.rand((nl, k // 128, n), device=dev, generator=g) * 2e-3
                 + 1e-3).to(torch.bfloat16)
        bias = (-7.5 * scale.float() + torch.randn((nl, k // 128, n), device=dev,
                                                    generator=g) * 1e-3).to(torch.bfloat16)
        xq, xs = quantize_activations_int8(
            torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16))
        xs = xs.reshape(m).contiguous()
        outs, row = {}, {"other": [], "this": []}
        for version in ("other", "this", "this", "other"):
            fn = libs[version].mnn_dequant_matmul_a8
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)

            def call(i, fn=fn, out=out):   # on the current stream: graph capture has its own
                err = fn(xq.data_ptr(), xs.data_ptr(), packed[i % nl].data_ptr(),
                         scale[i % nl].data_ptr(), bias[i % nl].data_ptr(), None,
                         out.data_ptr(), m, k, n, 4, 128, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{version}: CUDA launch error {err}")
            call(0)
            torch.cuda.synchronize()
            outs[version] = out.clone()
            row[version].append(_time_us(call, max(8, nl)))
        same = same and torch.equal(outs["this"], outs["other"])
        for version in times:
            times[version].append(row[version])
        print(f"M={m} K={k} N={n}: other {row['other'][0]:.2f} / {row['other'][1]:.2f} us, "
              f"this {row['this'][0]:.2f} / {row['this'][1]:.2f} us", flush=True)
    print(f"same bits: {same}")
    print(card)
    result = dict(card=card, shapes=SHAPES, us=times, same_bits=same,
                  against=str(args.against))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "a8_against.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
