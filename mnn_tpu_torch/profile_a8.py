"""A kernel against another version of its source, on the card.

    python -m mnn_tpu_torch.profile_a8 --against OLD/dequant_matmul.cu
    python -m mnn_tpu_torch.profile_a8 --kernel rows --against OLD/dequant_matmul.cu
    python -m mnn_tpu_torch.profile_a8 --kernel flash --against OLD/flash_prefill.cu \
        [--warps 4x1,2x2,1x4,4x2]
    python -m mnn_tpu_torch.profile_a8 --kernel step --against OLD/decode_step.cu \
        [--splits 8,4,1]

Builds `csrc/dequant_matmul.cu` and the given other version of that source
(for example the parent commit's, `git show HEAD~1:mnn_tpu_torch/csrc/
dequant_matmul.cu`) into two libraries, then times one C entry of each, in
the order other, this, this, other, in one process on one card; a call
rotates over weight copies larger than L2, as the serving path finds them.
W4, block 128.

* `--kernel a8` (the default): `mnn_dequant_matmul_a8` of both, on rows
  quantized beforehand, at the shapes of `chip_smoke.py` phase 2:
  qwen2-0.5b's qkv, wo, gate/up and down and qwen1.5-moe-a2.7b's qkv and wo
  at M = 512, and gate/up at M = 32 and 128. Both compute the exact int32
  algebra, so it checks that the two give the same bits.
* `--kernel rows`: bf16 rows. This version's `mnn_dequant_matmul_bf16_tile`
  (the tensor-core tile kernel) against the other's `mnn_dequant_matmul`
  (the row kernel, at M > 1 in a source older than the tile kernel), at
  qwen1.5-moe-a2.7b's shared expert (gate/up, and down with its f32 output)
  at M = 32, 128 and 512, qwen2-0.5b's qkv, wo, gate/up and down at M = 512,
  and the crossover rows M = 2, 4, 8, 16 and 32 at four of those shapes.
  The two sum in other orders, so it checks that each pair is within
  rel-L2 1e-2 and prints the value.
* `--kernel flash`: `mnn_flash_prefill` of `csrc/flash_prefill.cu` and of
  the other version, at the shapes of `chip_smoke.py` phase 2 (the prefill
  chunks of 17, 300 and 600-token prompts over a cache of 1024, with
  qwen2-0.5b's heads and, for three of them, qwen1.5-moe-a2.7b's; the short
  chunk at batch 2; the chunk serving sends for the 300-token prompt),
  checked to rel-L2 2e-2 a pair. `--warps 4x1,2x2,1x4,4x2` also builds this
  source once for each listed block shape (`-DMNN_FP_WQ=q -DMNN_FP_WK=k`: q
  query warps of 16 rows, k groups of them splitting the positions) and
  times those between the two, so one call compares the tilings.
* `--kernel step`: `mnn_decode_step` of `csrc/decode_step.cu` and of the
  other version, at the shapes of `chip_smoke.py` phase 2 (the last decode
  step of the 17-, 300- and 600-token requests over a 24-layer int8 cache of
  1024, with qwen2-0.5b's and qwen1.5-moe-a2.7b's heads, and batch 2), a
  call rotating over the layers. The attention rows are checked to rel-L2
  3e-2 a pair, the quantized rows and scales for the same bits.
  `--splits 8,4,1` also builds this source once for each listed cap on the
  blocks a cluster (`-DMNN_DS_PMAX=p`) and times those between the two.
  `--clocks` builds it once more with `-DMNN_DS_CLOCKS` and prints, a shape,
  the kernel's steps on the SM clock (thread 0 of blocks 0 and 1; the slots
  are listed in `csrc/decode_step.cu`), in cycles from the block's start.

It prints both versions' times per shape, with the card's name and power
limit; the JSON goes to `chiprun_out/{a8,rows,flash,step}_against.json` as well.
Needs a card and nvcc.
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
ROWS_SHAPES = [  # (M, K, N, out f32)
    (32, 2048, 11264, False), (128, 2048, 11264, False), (512, 2048, 11264, False),
    (32, 5632, 2048, True), (128, 5632, 2048, True), (512, 5632, 2048, True),
    (512, 896, 1152, False), (512, 896, 896, False), (512, 896, 9728, False),
    (512, 4864, 896, False)]
CROSSOVER_M = (2, 4, 8, 16, 32)
CROSSOVER_SHAPES = [(896, 1152, False), (896, 9728, False), (4864, 896, False),
                    (5632, 2048, True)]
ROWS_SHAPES += [(m, k, n, f32) for k, n, f32 in CROSSOVER_SHAPES for m in CROSSOVER_M]
# (B, H, Hkv, D, Tq, kv_len, q_offset), cache capacity FLASH_S: chip_smoke.py phase 2
FLASH_SHAPES = [(1, 14, 2, 64, 32, 17, 0), (1, 14, 2, 64, 512, 300, 0),
                (1, 14, 2, 64, 512, 512, 0), (1, 14, 2, 64, 128, 600, 512),
                (1, 16, 16, 128, 512, 300, 0), (1, 16, 16, 128, 128, 600, 512),
                (2, 16, 16, 128, 128, 600, 512), (1, 16, 16, 128, 512, 512, 0)]
FLASH_S = 1024
# (B, Hkv, G, D, len_old per sequence), 24 layers of capacity STEP_S: chip_smoke.py phase 2
STEP_SHAPES = [(1, 2, 7, 64, (48,)), (1, 2, 7, 64, (331,)), (1, 2, 7, 64, (631,)),
               (1, 16, 1, 128, (331,)), (1, 16, 1, 128, (48,)), (1, 16, 1, 128, (631,)),
               (2, 2, 7, 64, (331, 631))]
STEP_S, STEP_LAYERS = 1024, 24
L2_ROTATE_BYTES = 128 << 20
ENTRY = {"a8": ("mnn_dequant_matmul_a8", "mnn_dequant_matmul_a8"),   # (this, other)
         "rows": ("mnn_dequant_matmul_bf16_tile", "mnn_dequant_matmul"),
         "flash": ("mnn_flash_prefill", "mnn_flash_prefill"),
         "step": ("mnn_decode_step", "mnn_decode_step")}
SOURCE = {"a8": "dequant_matmul.cu", "rows": "dequant_matmul.cu", "flash": "flash_prefill.cu",
          "step": "decode_step.cu"}


LIBS: dict = {}      # name -> the loaded library of `_libraries`


def _libraries(specs, out_dir: Path, kind: str) -> dict:
    """{name: C entry} for specs of (name, source, entry, defines): each
    source, with the port's headers beside it, into its own library; the
    nvcc runs side by side."""
    cmds, sos = [], {}
    for name, src, entry, defines in specs:
        work = out_dir / name
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, work / h.name)
        cu = work / SOURCE[kind]
        shutil.copy(src, cu)
        sos[name] = (work / "lib.so", entry)
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                     "-shared", "-I", str(work), "-o", str(work / "lib.so"), str(cu)])
    build._run_all(cmds)
    fns = {}
    for name, (so, entry) in sos.items():
        LIBS[name] = ctypes.CDLL(str(so))
        fn = getattr(LIBS[name], entry)
        if kind == "flash":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
                           + [ctypes.c_void_p])
        elif kind == "step":
            fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                           + [ctypes.c_void_p])
        else:
            pointers = 7 if entry.endswith("_a8") else 6
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


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


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


def _flash(fns: dict, order: list, card: str, args) -> None:
    """--kernel flash: every version in `order` at the phase-2 shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    versions = list(dict.fromkeys(order))
    times = {ver: [] for ver in versions}
    rels = []
    for b, h, hkv, d, t, kv_len, q_off in FLASH_SHAPES:
        mk = lambda *shape: torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = mk(b, h, t, d), mk(b, hkv, FLASH_S, d), mk(b, hkv, FLASH_S, d)
        lens = torch.tensor([kv_len, q_off], dtype=torch.int32, device=dev)
        outs, row = {}, {ver: [] for ver in versions}
        for ver in order:
            fn, out = fns[ver], torch.empty_like(q)

            def call(i, fn=fn, out=out, ver=ver):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         lens.data_ptr(), b, h, hkv, t, FLASH_S, d, 1, 0, 0, d ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{ver}: CUDA launch error {err}")
            call(0)
            torch.cuda.synchronize()
            outs[ver] = out.clone()
            row[ver].append(_time_us(call, 24))
        rel = max(_rel(outs[ver], outs["other"]) for ver in versions)
        rels.append(rel)
        for ver in versions:
            times[ver].append(row[ver])
        print(f"B={b} H={h} Hkv={hkv} D={d} T={t} kv_len={kv_len} q_offset={q_off}: " + ", ".join(
            f"{ver} {' / '.join(f'{x:.2f}' for x in row[ver])} us" for ver in versions)
            + f", largest rel-L2 to other {rel:.3e}", flush=True)
    ok = max(rels) <= 2e-2
    print(f"every version within rel-L2 2e-2 of the other: {ok} (largest {max(rels):.3e})")
    print(card)
    result = dict(card=card, kernel="flash", shapes=FLASH_SHAPES, cache=FLASH_S, order=order,
                  us=times, rel_l2=rels, agree=ok, against=str(args.against))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "flash_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the versions disagree")


def _step_clocks(fn, qkv, kq, vq, ks, vs, cos, sin, lengths, b, hkv, grp, d) -> list:
    """The `-DMNN_DS_CLOCKS` build's stamps for one call at layer 3 (after
    two warm calls): per block, the slots' cycles from the block's start,
    None where a slot was not reached."""
    out = [torch.empty((b, hkv * grp, d), dtype=torch.bfloat16, device=qkv.device)]
    out += [torch.empty((b, hkv, 1, d), device=qkv.device) for _ in range(2)]
    out += [torch.empty((b, hkv, 1), device=qkv.device) for _ in range(2)]
    stamps = (ctypes.c_longlong * 48)()
    for _ in range(3):
        torch.cuda.synchronize()
        LIBS["clk"].mnn_decode_step_clocks(stamps)      # and zero them
        fn(qkv.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(), vs.data_ptr(),
           cos.data_ptr(), sin.data_ptr(), None, None, lengths.data_ptr(),
           *(t.data_ptr() for t in out), b, hkv, grp, d, STEP_S, 3, 1, 0, 0, 0.0, d ** -0.5,
           1e-6, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
    if LIBS["clk"].mnn_decode_step_clocks(stamps):
        raise RuntimeError("mnn_decode_step_clocks failed")
    rows = []
    for blk in range(2):
        raw = list(stamps[24 * blk:24 * blk + 24])
        rows.append([None if x == 0 else x - raw[0] for x in raw])
    return rows


def _step(fns: dict, order: list, card: str, args) -> None:
    """--kernel step: every version in `order` at the phase-2 shapes."""
    from mnn_tpu_torch.runtime.kvcache import quantize_kv
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    versions = list(dict.fromkeys(order))
    times = {ver: [] for ver in versions}
    rels, same, clocks = [], True, []
    kq = None
    for b, hkv, grp, d, lens in STEP_SHAPES:
        if kq is None or kq.shape[1:4] != (b, hkv, STEP_S):
            kq = vq = None
            shape = (STEP_LAYERS, b, hkv, STEP_S, d)
            kq, ks = quantize_kv(torch.randn(shape, device=dev, generator=g))
            vq, vs = quantize_kv(torch.randn(shape, device=dev, generator=g))
        qkv = torch.randn((b, hkv, grp + 2, d), device=dev, generator=g).to(torch.bfloat16)
        ang = torch.rand((b, d // 2), device=dev, generator=g) * 6.28
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        outs, row = {}, {ver: [] for ver in versions}
        for ver in order:
            fn = fns[ver]
            out = (torch.empty((b, hkv * grp, d), dtype=torch.bfloat16, device=dev),
                   torch.empty((b, hkv, 1, d), device=dev), torch.empty((b, hkv, 1, d), device=dev),
                   torch.empty((b, hkv, 1), device=dev), torch.empty((b, hkv, 1), device=dev))

            def call(i, fn=fn, out=out, ver=ver):
                err = fn(qkv.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                         vs.data_ptr(), cos.data_ptr(), sin.data_ptr(), None, None,
                         lengths.data_ptr(), *(t.data_ptr() for t in out), b, hkv, grp, d,
                         STEP_S, i % STEP_LAYERS, 1, 0, 0, 0.0, d ** -0.5, 1e-6,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{ver}: CUDA launch error {err}")
            call(3)
            torch.cuda.synchronize()
            outs[ver] = [t.clone() for t in out]
            row[ver].append(_time_us(call, 48))
        if "clk" in fns:
            clocks.append(_step_clocks(fns["clk"], qkv, kq, vq, ks, vs, cos, sin, lengths,
                                       b, hkv, grp, d))
            print(f"  clocks, cycles from the start of block 0 / block 1: "
                  f"{clocks[-1][0]} / {clocks[-1][1]}", flush=True)
        rel = max(_rel(outs[ver][0], outs["other"][0]) for ver in versions)
        same = same and all(torch.equal(x, y) for ver in versions
                            for x, y in zip(outs[ver][1:], outs["other"][1:]))
        rels.append(rel)
        for ver in versions:
            times[ver].append(row[ver])
        print(f"B={b} Hkv={hkv} G={grp} D={d} len_old={lens}: " + ", ".join(
            f"{ver} {' / '.join(f'{x:.2f}' for x in row[ver])} us" for ver in versions)
            + f", largest att rel-L2 to other {rel:.3e}", flush=True)
    ok = max(rels) <= 3e-2 and same
    print(f"every version within att rel-L2 3e-2 of the other: {max(rels) <= 3e-2} "
          f"(largest {max(rels):.3e}); rows and scales the same bits: {same}")
    print(card)
    result = dict(card=card, kernel="step", shapes=STEP_SHAPES, cache=STEP_S,
                  layers=STEP_LAYERS, order=order, us=times, rel_l2=rels, same_rows=same,
                  agree=ok, against=str(args.against), clocks=clocks)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "step_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the versions disagree")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="another version of the kernel's source")
    ap.add_argument("--kernel", choices=sorted(ENTRY), default="a8",
                    help="a8: the int8-row kernel; rows: bf16 rows, the tensor-core "
                         "tile kernel against the other's row kernel; flash: the "
                         "causal flash prefill kernel; step: the fused decode step")
    ap.add_argument("--warps", default="",
                    help="flash only: comma-separated block shapes, query warps x "
                         "position groups (4x1, 2x2, 1x4, 4x2), to build and time this "
                         "source at, besides its own choice")
    ap.add_argument("--clocks", action="store_true",
                    help="step only: also build with -DMNN_DS_CLOCKS and print the "
                         "kernel's steps on the SM clock a shape")
    ap.add_argument("--splits", default="",
                    help="step only: comma-separated caps on the blocks a cluster "
                         "(8, 4, 1) to build and time this source at, besides its own")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_a8 needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    a8 = args.kernel == "a8"
    out_dir = build.BUILD_ROOT / "profile_a8"
    src = build.CSRC / SOURCE[args.kernel]
    specs = [("this", src, ENTRY[args.kernel][0], ()),
             ("other", args.against, ENTRY[args.kernel][1], ())]
    forced = [w for w in args.warps.split(",") if w] if args.kernel == "flash" else []
    specs += [(w, src, ENTRY["flash"][0], (f"MNN_FP_WQ={w.split('x')[0]}",
                                           f"MNN_FP_WK={w.split('x')[1]}")) for w in forced]
    caps = [p for p in args.splits.split(",") if p] if args.kernel == "step" else []
    specs += [(f"p{p}", src, ENTRY["step"][0], (f"MNN_DS_PMAX={p}",)) for p in caps]
    if args.kernel == "step" and args.clocks:
        specs.append(("clk", src, ENTRY["step"][0], ("MNN_DS_CLOCKS",)))
    fns = _libraries(specs, out_dir, args.kernel)
    if args.kernel in ("flash", "step"):
        mid = ["this"] + forced + [f"p{p}" for p in caps]
        run = _flash if args.kernel == "flash" else _step
        return run(fns, ["other"] + mid + mid[::-1] + ["other"], card, args)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(m, k, n, False) for m, k, n in SHAPES] if a8 else ROWS_SHAPES
    times = {"other": [], "this": []}
    rels, same = [], True
    for m, k, n, f32 in shapes:
        nl = max(1, min(256, math.ceil(L2_ROTATE_BYTES / (k * n // 2))))
        packed = torch.randint(-128, 128, (nl, k // 2, n), dtype=torch.int8, device=dev,
                               generator=g)
        scale = (torch.rand((nl, k // 128, n), device=dev, generator=g) * 2e-3
                 + 1e-3).to(torch.bfloat16)
        bias = (-7.5 * scale.float() + torch.randn((nl, k // 128, n), device=dev,
                                                    generator=g) * 1e-3).to(torch.bfloat16)
        x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
        if a8:
            xq, xs = quantize_activations_int8(x)
            rows = (xq.data_ptr(), xs.reshape(m).contiguous().data_ptr())
        else:
            rows = (x.data_ptr(),)
        outs, row = {}, {"other": [], "this": []}
        for version in ("other", "this", "this", "other"):
            fn = fns[version]
            out = torch.empty((m, n), dtype=torch.float32 if f32 else torch.bfloat16,
                              device=dev)

            def call(i, fn=fn, out=out):   # on the current stream: graph capture has its own
                err = fn(*rows, packed[i % nl].data_ptr(), scale[i % nl].data_ptr(),
                         bias[i % nl].data_ptr(), None, out.data_ptr(), m, k, n, 4, 128,
                         int(f32), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{version}: CUDA launch error {err}")
            call(0)
            torch.cuda.synchronize()
            outs[version] = out.clone()
            row[version].append(_time_us(call, max(8, nl)))
        same = same and torch.equal(outs["this"], outs["other"])
        rels.append(_rel(outs["this"], outs["other"]))
        for version in times:
            times[version].append(row[version])
        print(f"M={m} K={k} N={n}: other {row['other'][0]:.2f} / {row['other'][1]:.2f} us, "
              f"this {row['this'][0]:.2f} / {row['this'][1]:.2f} us, "
              f"rel-L2 {rels[-1]:.3e}", flush=True)
    ok = same if a8 else max(rels) <= 1e-2
    print(f"same bits: {same}" if a8 else f"every pair within rel-L2 1e-2: {ok} "
          f"(largest {max(rels):.3e})")
    print(card)
    result = dict(card=card, kernel=args.kernel, shapes=shapes, us=times, same_bits=same,
                  rel_l2=rels, agree=ok, against=str(args.against))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"{args.kernel}_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the two versions disagree")


if __name__ == "__main__":
    main()
