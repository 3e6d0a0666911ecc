"""A kernel against another version of its source, on the card.

    python -m mnn_tpu_torch.profile_a8 --against OLD/dequant_matmul.cu
    python -m mnn_tpu_torch.profile_a8 --kernel rows --against OLD/dequant_matmul.cu \
        [--splits 1,4]
    python -m mnn_tpu_torch.profile_a8 --kernel flash --against OLD/flash_prefill.cu \
        [--warps 4x1,2x2,1x4,4x2]
    python -m mnn_tpu_torch.profile_a8 --kernel step --against OLD/decode_step.cu \
        [--splits 8,4,1]
    python -m mnn_tpu_torch.profile_a8 --kernel fdec --against OLD/csrc [--splits 4,1]
    python -m mnn_tpu_torch.profile_a8 --kernel moe --against OLD/csrc [--tiles 0,1,2,3]
    python -m mnn_tpu_torch.profile_a8 --kernel deq --against OLD/csrc
    python -m mnn_tpu_torch.profile_a8 --kernel rows --against OLD/csrc

Builds this tree's source of the kernel (`csrc/dequant_matmul.cu`,
`flash_prefill.cu`, `decode_step.cu`, `flash_decode.cu` or `moe_prefill.cu`) and another
version of it into two libraries, then times one C entry of each, in the
order other, this, this, other, in one process on one card; a call rotates
over weight copies larger than L2, as the serving path finds them. W4,
block 128. `--against` is either that one source file, built with this
tree's headers (`git show HEAD~1:mnn_tpu_torch/csrc/dequant_matmul.cu`),
or a directory that holds another version of the whole `csrc/`, built with
its own headers (`git archive HEAD~1 mnn_tpu_torch/csrc | tar -x -C DIR`,
then `DIR/mnn_tpu_torch/csrc`): a source whose headers changed since needs
the directory.

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
  rel-L2 1e-2 and prints the value. Where the other version has the tile
  kernel too (`mnn_dequant_matmul_bf16_tile`), the two are timed against
  each other and must give the same bits. At M = 1 (the six decode
  projections of qwen2-0.5b and qwen1.5-moe-a2.7b and the two lm heads,
  f32 out) both versions' `mnn_dequant_matmul` are timed, each pair within
  rel-L2 1e-2, with the split this version takes printed; `--splits 1,4`
  also builds this source once for each listed cap on the K ranges a tile
  (`-DMNN_GV_RMAX=r`) and times those between the two at M = 1.
* `--kernel deq`: `mnn_dequant_matmul_deq` of both (the dequantize-tile
  matmul), at the shapes of `chip_smoke.py` phase 2 (qwen1.5-moe-a2.7b's
  shared expert, gate/up and down, and qkv, at M = 512; no output bias),
  checked to rel-L2 1e-2 a pair; whether they give the same bits is printed.
* `--kernel moe`: `mnn_moe_prefill` of both (the grouped expert MLP, two
  launches a call), at the shapes of `chip_smoke.py` phase 2:
  qwen1.5-moe-a2.7b's 60 experts at C = 8, 24, 72 and 144 and
  qwen3-moe-30b-a3b's 128 at C = 64, empty slots in each, checked to rel-L2
  2e-2 a pair with the empty slots zero; the tile this version picks is
  printed. `--tiles 0,1,2,3` also builds this source once for each listed
  tile of `MNN_MP_TILES` (`-DMNN_MP_TILE=t`: 80, 64, 32 and 16 rows) and
  times those between the two.
* For `moe` and `deq`, `--variant NAME:DEFINE[+DEFINE]` builds this source
  with other macros and times it between the two (`nopipe:MNN_DD_PIPE=0`:
  one unpacked buffer and two barriers a quant block); `--clocks` builds it
  once more with `-DMNN_DD_CLOCKS` and prints, a shape, the cycles a quant
  block of thread 0 of block (0, 0, 0) in each step of `csrc/deq_dot.cuh`'s
  K loop (waiting for the stage and the barrier, the unpack, the second
  barrier, the products and the f32 step).
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
* `--kernel fdec`: `mnn_flash_decode` of `csrc/flash_decode.cu` and of the
  other version (a directory: an older source includes `attn_common.cuh`),
  at the shapes of `chip_smoke.py` phase 2 (the last decode step of the
  17-, 300- and 600-token requests over a 24-layer cache of 1024 at int8 and
  int4, with qwen2-0.5b's and qwen1.5-moe-a2.7b's heads; batch 2 ragged;
  kv_len 4000 of 4096 at int4), a call rotating over the layers, each pair
  within rel-L2 3e-2 and this version the same bits on two calls; the split
  it takes is printed. `--splits 4,1` also builds this source once for each
  listed cap on the blocks a KV head (`-DMNN_FD_PMAX=p`) and times those
  between the two.

It prints both versions' times per shape, with the card's name and power
limit; the JSON goes to `chiprun_out/{a8,rows,flash,step,fdec,moe,deq}_against.json`
as well.
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
# M = 1: the decode projections of qwen2-0.5b and qwen1.5-moe-a2.7b, then the two lm heads
ROWS_SHAPES += [(1, 896, 1152, False), (1, 896, 896, False), (1, 896, 9728, False),
                (1, 4864, 896, False), (1, 2048, 6144, False), (1, 2048, 2048, False),
                (1, 896, 151936, True), (1, 2048, 151936, True)]
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
# (B, Hkv, G, D, kv bits, kv_len per sequence, capacity), 24 layers: chip_smoke.py phase 2
FDEC_SHAPES = [(1, 2, 7, 64, b, (n,), 1024) for b in (8, 4) for n in (49, 332, 632)]
FDEC_SHAPES += [(1, 16, 1, 128, b, (n,), 1024) for b in (8, 4) for n in (49, 332, 632)]
FDEC_SHAPES += [(2, 2, 7, 64, 8, (332, 632), 1024), (1, 16, 1, 128, 4, (4000,), 4096)]
# (E, C, H, mi): chip_smoke.py phase 2's grouped expert rows
MOE_SHAPES = [(60, 8, 2048, 1408), (60, 24, 2048, 1408), (60, 72, 2048, 1408),
              (60, 144, 2048, 1408), (128, 64, 2048, 768)]
DEQ_SHAPES = [(512, 2048, 11264, False), (512, 5632, 2048, False), (512, 2048, 6144, False)]
L2_ROTATE_BYTES = 128 << 20
ENTRY = {"a8": ("mnn_dequant_matmul_a8", "mnn_dequant_matmul_a8"),   # (this, other)
         "rows": ("mnn_dequant_matmul_bf16_tile", "mnn_dequant_matmul"),
         "flash": ("mnn_flash_prefill", "mnn_flash_prefill"),
         "step": ("mnn_decode_step", "mnn_decode_step"),
         "fdec": ("mnn_flash_decode", "mnn_flash_decode"),
         "moe": ("mnn_moe_prefill", "mnn_moe_prefill"),
         "deq": ("mnn_dequant_matmul_deq", "mnn_dequant_matmul_deq")}
SOURCE = {"a8": "dequant_matmul.cu", "rows": "dequant_matmul.cu", "flash": "flash_prefill.cu",
          "step": "decode_step.cu", "fdec": "flash_decode.cu", "moe": "moe_prefill.cu",
          "deq": "dequant_matmul.cu"}


LIBS: dict = {}      # name -> the loaded library of `_libraries`


def _libraries(specs, out_dir: Path, kind: str) -> dict:
    """{name: C entry} for specs of (name, source, entry, defines): each
    source into its own library, the nvcc runs side by side. A source file
    is built with this tree's headers beside it, a directory (another
    version of `csrc/`) with its own headers; `entry` may name several C
    entries, separated by `|`, of which the first the library has is taken."""
    cmds, sos = [], {}
    for name, src, entry, defines in specs:
        work = out_dir / name
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        if Path(src).is_dir():
            cu, inc = Path(src) / SOURCE[kind], Path(src)
        else:
            for h in build.CSRC.glob("*.cuh"):
                shutil.copy(h, work / h.name)
            cu, inc = work / SOURCE[kind], work
            shutil.copy(src, cu)
        sos[name] = (work / "lib.so", entry)
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                     "-shared", "-I", str(inc), "-o", str(work / "lib.so"), str(cu)])
    build._run_all(cmds)
    fns = {}
    for name, (so, entry) in sos.items():
        LIBS[name] = ctypes.CDLL(str(so))
        entry = next(e for e in entry.split("|") if hasattr(LIBS[name], e))
        fn = getattr(LIBS[name], entry)
        fn.entry = entry
        if kind == "flash":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
                           + [ctypes.c_void_p])
        elif kind == "step":
            fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                           + [ctypes.c_void_p])
        elif kind == "fdec":
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float]
                           + [ctypes.c_void_p])
        elif kind == "moe":
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        else:
            pointers = 7 if entry.endswith("_a8") else 6
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            if kind == "rows":      # M = 1: the GEMV (or row) kernel
                fn.m1 = LIBS[name].mnn_dequant_matmul
                fn.m1.argtypes = fn.argtypes
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


def _fdec(fns: dict, order: list, card: str, args) -> None:
    """--kernel fdec: every version in `order` at the phase-2 shapes."""
    from mnn_tpu_torch.runtime.kvcache import quantize_for
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    versions = list(dict.fromkeys(order))
    times = {ver: [] for ver in versions}
    rels, splits, same = [], [], True
    for b, hkv, grp, d, bits, lens, cap in FDEC_SHAPES:
        shape = (STEP_LAYERS, b, hkv, cap, d)
        kq, ks = quantize_for(bits, torch.randn(shape, device=dev, generator=g))
        vq, vs = quantize_for(bits, torch.randn(shape, device=dev, generator=g))
        q = torch.randn((b, hkv * grp, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out4 = (ctypes.c_int * 4)()
        LIBS["this"].mnn_flash_decode_split(b, hkv, grp, cap, d, bits, out4)
        splits.append(tuple(out4))
        outs, row = {}, {ver: [] for ver in versions}
        for ver in order:
            fn, out = fns[ver], torch.empty_like(q)

            def call(i, fn=fn, out=out, ver=ver):
                err = fn(q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                         vs.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, hkv, grp, d,
                         cap, i % STEP_LAYERS, bits, 0, 0, d ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{ver}: CUDA launch error {err}")
            call(3)
            torch.cuda.synchronize()
            outs[ver] = out.clone()
            if ver == "this":
                call(3)
                torch.cuda.synchronize()
                same = same and torch.equal(out, outs[ver])
            row[ver].append(_time_us(call, 48))
        rel = max(_rel(outs[ver], outs["other"]) for ver in versions)
        rels.append(rel)
        for ver in versions:
            times[ver].append(row[ver])
        print(f"B={b} Hkv={hkv} G={grp} D={d} int{bits} kv_len={lens} S={cap}, this split "
              f"{splits[-1]}: " + ", ".join(
                  f"{ver} {' / '.join(f'{x:.2f}' for x in row[ver])} us" for ver in versions)
              + f", largest rel-L2 to other {rel:.3e}", flush=True)
    ok = max(rels) <= 3e-2 and same
    print(f"every version within rel-L2 3e-2 of the other: {max(rels) <= 3e-2} "
          f"(largest {max(rels):.3e}); this version the same bits twice: {same}")
    print(card)
    result = dict(card=card, kernel="fdec", shapes=FDEC_SHAPES, layers=STEP_LAYERS,
                  order=order, us=times, rel_l2=rels, same_twice=same, splits=splits,
                  agree=ok, against=str(args.against))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "fdec_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the versions disagree")


CLOCK_SLOTS = ("wait and barrier", "unpack", "second barrier", "products and f32 step")


def _dd_clocks(call, reader) -> dict:
    """The `-DMNN_DD_CLOCKS` build's cycles of each step of block (0, 0, 0)'s
    quant blocks, per quant block, for one `call()` after two warm ones."""
    stamps = (ctypes.c_longlong * 8)()
    call()
    call()
    torch.cuda.synchronize()
    reader(stamps)                  # and zero them
    call()
    torch.cuda.synchronize()
    if reader(stamps):
        raise RuntimeError("reading the clock stamps failed")
    blocks = max(stamps[4], 1)
    res = {name: stamps[i] / blocks for i, name in enumerate(CLOCK_SLOTS)}
    res.update(quant_blocks=stamps[4], loop_cycles=stamps[5])
    return res


def _clock_line(c: dict) -> str:
    return ("  clocks of block 0, cycles a quant block: " + ", ".join(
        f"{name} {c[name]:.0f}" for name in CLOCK_SLOTS)
        + f" ({c['quant_blocks']} blocks, {c['loop_cycles']} cycles in the K loops)")


def _moe_weights(g, lead, k, n):
    """A W4 block-128 expert stack [*lead, ...] as chip_smoke.py makes them."""
    packed = torch.randint(-128, 128, (*lead, k // 2, n), dtype=torch.int8, device=g.device,
                           generator=g)
    scale = (torch.rand((*lead, k // 128, n), device=g.device, generator=g) * 2e-3
             + 1e-3).to(torch.bfloat16)
    bias = (-7.5 * scale.float() + torch.randn((*lead, k // 128, n), device=g.device,
                                                generator=g) * 1e-3).to(torch.bfloat16)
    return packed, scale, bias


def _moe(fns: dict, order: list, card: str, args) -> None:
    """--kernel moe: every version in `order` at the phase-2 shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    versions = list(dict.fromkeys(order))
    times = {ver: [] for ver in versions}
    rels, tiles, same, zeros, clocks = [], [], [], True, []
    for e, cap, h, mi in MOE_SHAPES:
        gp, gs, gb = _moe_weights(g, (e,), h, 2 * mi)
        dp, ds, db = _moe_weights(g, (e,), mi, h)
        xe = (torch.randn((e, cap, h), device=dev, generator=g) * 0.5).to(torch.bfloat16)
        w_e = torch.rand((e, cap), device=dev, generator=g)
        xe[:, -cap // 8:] = 0              # empty slots: zero rows, weight 0
        w_e[:, -cap // 8:] = 0
        act = torch.empty((e, cap, mi), dtype=torch.bfloat16, device=dev)
        out = (ctypes.c_int * 3)()
        LIBS["this"].mnn_moe_prefill_tile(e, cap, h, mi, 4, out)
        tiles.append(tuple(out))
        outs, row = {}, {ver: [] for ver in versions}
        for ver in order:
            fn, y = fns[ver], torch.empty((e, cap, h), device=dev)

            def call(i, fn=fn, y=y, ver=ver):
                err = fn(xe.data_ptr(), w_e.data_ptr(), gp.data_ptr(), gs.data_ptr(),
                         gb.data_ptr(), dp.data_ptr(), ds.data_ptr(), db.data_ptr(),
                         act.data_ptr(), y.data_ptr(), e, cap, h, mi, 4, 128, 128,
                         int(cap < 128), int(cap < 128), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{ver}: CUDA launch error {err}")
            call(0)
            torch.cuda.synchronize()
            outs[ver] = y.clone()
            row[ver].append(_time_us(call, 4))
        if "clk" in fns:
            clocks.append(_dd_clocks(lambda: call(0, fns["clk"], torch.empty_like(y), "clk"),
                                     LIBS["clk"].mnn_moe_prefill_clocks))
            print(_clock_line(clocks[-1]), flush=True)
        rel = max(_rel(outs[ver], outs["other"]) for ver in versions)
        rels.append(rel)
        same.append(all(torch.equal(outs[ver], outs["other"]) for ver in versions))
        zeros = zeros and all(bool((outs[ver][:, -cap // 8:] == 0).all()) for ver in versions)
        for ver in versions:
            times[ver].append(row[ver])
        print(f"E={e} C={cap} H={h} mi={mi} ({'partial' if cap < 128 else 'dequant'}), this "
              f"tile {tiles[-1]}: " + ", ".join(
                  f"{ver} {' / '.join(f'{x:.2f}' for x in row[ver])} us" for ver in versions)
              + f", largest rel-L2 to other {rel:.3e}, same bits {same[-1]}", flush=True)
    ok = max(rels) <= 2e-2 and zeros
    print(f"every version within rel-L2 2e-2 of the other: {max(rels) <= 2e-2} "
          f"(largest {max(rels):.3e}); empty slots zero: {zeros}")
    print(card)
    result = dict(card=card, kernel="moe", shapes=MOE_SHAPES, order=order, us=times,
                  rel_l2=rels, same_bits=same, empty_zero=zeros, tiles=tiles, agree=ok,
                  against=str(args.against), clocks=clocks)
    outp = Path("chiprun_out")
    outp.mkdir(exist_ok=True)
    (outp / "moe_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the versions disagree")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="another version of the kernel's source: the file, or a "
                         "directory holding another version of csrc/")
    ap.add_argument("--kernel", choices=sorted(ENTRY), default="a8",
                    help="a8: the int8-row kernel; rows: bf16 rows, the tensor-core "
                         "tile kernel against the other's tile or row kernel, and the "
                         "M = 1 GEMV; flash: the causal flash prefill kernel; step: the "
                         "fused decode step; fdec: flash decode; moe: the grouped expert "
                         "prefill MLP; deq: the dequantize-tile matmul")
    ap.add_argument("--warps", default="",
                    help="flash only: comma-separated block shapes, query warps x "
                         "position groups (4x1, 2x2, 1x4, 4x2), to build and time this "
                         "source at, besides its own choice")
    ap.add_argument("--clocks", action="store_true",
                    help="step, moe, deq: also build with -DMNN_DS_CLOCKS (step) or "
                         "-DMNN_DD_CLOCKS (moe, deq) and print the kernel's steps on the "
                         "SM clock a shape")
    ap.add_argument("--variant", action="append", default=[],
                    help="moe, deq: NAME:DEFINE[+DEFINE...], this source built with those "
                         "macros and timed beside it, e.g. nopipe:MNN_DD_PIPE=0")
    ap.add_argument("--splits", default="",
                    help="step, fdec: comma-separated caps on the blocks a KV head "
                         "(8, 4, 1); rows: on the K ranges a tile at M = 1; each built "
                         "and timed beside this source's own choice")
    ap.add_argument("--tiles", default="",
                    help="moe only: comma-separated indices into MNN_MP_TILES (0 to 3) "
                         "to build and time this source at, besides its own choice")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_a8 needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    a8 = args.kernel == "a8"
    out_dir = build.BUILD_ROOT / "profile_a8"
    src = build.CSRC / SOURCE[args.kernel]
    other_entry = ENTRY[args.kernel][1]
    if args.kernel == "rows":      # the other's tile kernel where it has one
        other_entry = f"{ENTRY['rows'][0]}|{other_entry}"
    specs = [("this", src, ENTRY[args.kernel][0], ()),
             ("other", args.against, other_entry, ())]
    forced = [w for w in args.warps.split(",") if w] if args.kernel == "flash" else []
    specs += [(w, src, ENTRY["flash"][0], (f"MNN_FP_WQ={w.split('x')[0]}",
                                           f"MNN_FP_WK={w.split('x')[1]}")) for w in forced]
    cap_macro = {"step": "MNN_DS_PMAX", "fdec": "MNN_FD_PMAX", "rows": "MNN_GV_RMAX"}
    caps = [p for p in args.splits.split(",") if p] if args.kernel in cap_macro else []
    specs += [(f"p{p}", src, ENTRY[args.kernel][0], (f"{cap_macro[args.kernel]}={p}",))
              for p in caps]
    if args.kernel == "step" and args.clocks:
        specs.append(("clk", src, ENTRY["step"][0], ("MNN_DS_CLOCKS",)))
    tiles = [t for t in args.tiles.split(",") if t] if args.kernel == "moe" else []
    specs += [(f"t{t}", src, ENTRY["moe"][0], (f"MNN_MP_TILE={t}",)) for t in tiles]
    variants = [v.split(":", 1) for v in args.variant] if args.kernel in ("moe", "deq") else []
    specs += [(name, src, ENTRY[args.kernel][0], tuple(d for d in defs.split("+") if d))
              for name, defs in variants]
    if args.kernel in ("moe", "deq") and args.clocks:
        specs.append(("clk", src, ENTRY[args.kernel][0], ("MNN_DD_CLOCKS",)))
    fns = _libraries(specs, out_dir, args.kernel)
    extra = [name for name, _ in variants]
    if args.kernel in ("flash", "step", "fdec", "moe"):
        mid = (["this"] + forced + [f"p{p}" for p in caps] + [f"t{t}" for t in tiles]
               + extra)
        run = {"flash": _flash, "step": _step, "fdec": _fdec, "moe": _moe}[args.kernel]
        return run(fns, ["other"] + mid + mid[::-1] + ["other"], card, args)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = ([(m, k, n, False) for m, k, n in SHAPES] if a8
              else DEQ_SHAPES if args.kernel == "deq" else ROWS_SHAPES)
    # the same bits where both compute the same algebra in the same order
    exact = a8 or fns["other"].entry == ENTRY["rows"][0]
    mid = ["this"] + extra
    mid1 = mid + [f"p{p}" for p in caps]            # the split caps at M = 1
    versions = list(dict.fromkeys(["other"] + mid1))
    times = {ver: [] for ver in versions}
    rels, same, m1_rels, m1_same, clocks, gemv_splits = [], True, [], True, [], []
    for m, k, n, f32 in shapes:
        inner = mid1 if m == 1 else mid
        order = ["other"] + inner + inner[::-1] + ["other"]
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
        outs, row = {}, {ver: [] for ver in versions}
        if m == 1 and args.kernel == "rows":
            split4 = (ctypes.c_int * 4)()
            LIBS["this"].mnn_dequant_matmul_gemv_split(k, n, 4, 128, split4)
            gemv_splits.append(tuple(split4))
        for version in order:
            fn = fns[version]
            if m == 1 and args.kernel == "rows":
                fn = fn.m1
            out = torch.empty((m, n), dtype=torch.float32 if f32 else torch.bfloat16,
                              device=dev)

            def call(i, fn=fn, out=out, version=version):   # on the current stream
                err = fn(*rows, packed[i % nl].data_ptr(), scale[i % nl].data_ptr(),
                         bias[i % nl].data_ptr(), None, out.data_ptr(), m, k, n, 4, 128,
                         int(f32), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{version}: CUDA launch error {err}")
            call(0)
            torch.cuda.synchronize()
            outs[version] = out.clone()
            row[version].append(_time_us(call, max(8, nl)))
        if "clk" in fns:
            clocks.append(_dd_clocks(lambda: call(0, fns["clk"], out, "clk"),
                                     LIBS["clk"].mnn_dequant_matmul_clocks))
            print(_clock_line(clocks[-1]), flush=True)
        here = list(dict.fromkeys(order))
        rel = max(_rel(outs[ver], outs["other"]) for ver in here)
        if m == 1 and args.kernel == "rows":
            # the GEMV sums in another order than the other version's row kernel
            m1_rels.append(rel)
            m1_same = m1_same and all(torch.equal(outs[ver], outs["other"]) for ver in here)
        else:
            same = same and all(torch.equal(outs[ver], outs["other"]) for ver in here)
            rels.append(rel)
        for version in here:
            times[version].append(row[version])
        print(f"M={m} K={k} N={n}: " + ", ".join(
            f"{ver} {' / '.join(f'{t:.2f}' for t in row[ver])} us" for ver in here)
            + f", rel-L2 {rel:.3e}"
            + (f", this split {gemv_splits[-1]}" if m == 1 and args.kernel == "rows" else ""),
            flush=True)
    ok = same if exact else max(rels) <= 1e-2
    print(f"same bits: {same}" if exact else f"every pair within rel-L2 1e-2: {ok} "
          f"(largest {max(rels):.3e}); same bits {same}")
    if m1_rels:
        ok = ok and max(m1_rels) <= 1e-2
        print(f"M = 1: every pair within rel-L2 1e-2: {max(m1_rels) <= 1e-2} "
              f"(largest {max(m1_rels):.3e}); same bits {m1_same}")
    print(card)
    result = dict(card=card, kernel=args.kernel, shapes=shapes, us=times,
                  same_bits=same, rel_l2=rels, m1_rel_l2=m1_rels, m1_same_bits=m1_same,
                  gemv_splits=gemv_splits, agree=ok, against=str(args.against),
                  other_entry=fns["other"].entry, clocks=clocks)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"{args.kernel}_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the two versions disagree")


if __name__ == "__main__":
    main()
