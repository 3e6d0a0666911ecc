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
    python -m mnn_tpu_torch.profile_a8 --kernel model --against OLD/csrc [--clocks] [--deep]
    python -m mnn_tpu_torch.profile_a8 --kernel mdec --against OLD/csrc [--clocks]

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

* `--kernel model`: the whole-model decode kernel (`mnn_decode_model`, the
  five sources `decode_model.cu` and `decode_model_b{1,2,4,8}.cu` with
  their headers; `--against` a directory) of both, through
  `decode_model.fused_decode_model`, at the shapes of `chip_smoke.py`
  phase 2: full-size qwen2-0.5b at batch 1 over an int8 cache at len_old
  48, 331 and 631, over an int4 and a bf16 cache at 331, batch 4 (48, 331,
  631, 5), and two layers at qwen2-7b widths (`--deep` adds the 28-layer
  qwen2-7b row). A call is timed with CUDA events around a loop of 20
  launches. Each version is held against the other within
  `decode_model.PARITY_BOUNDS` (logits, rows, scales; int4 rows within one
  level, as `chip_smoke.py` holds them), and must give the same bits on two
  calls. An older source without the schedule takes the older C signature
  (its first 61 arguments). `--clocks` builds both once more with
  `-DMNN_DM_CLOCKS` and prints, at the 331-position int8 row, the stamps of
  one call by phase kind (`clock_summary`: the mean cycles between the
  steps of an item, over the layers after the first) and the barriers'
  waits (the least wait is what the last block to arrive pays, the spread
  the most less the least).

* `--kernel mdec`: the fused expert decode kernel (`mnn_moe_decode` of
  `moe_decode.cu`; `--against` a directory whose source has the one-launch
  entry, `mnn_moe_decode_limits` and `md_clocks.cuh`) of both, through
  `moe_decode.moe_decode_mlp`, at the rows of `chip_smoke.py` phase 2:
  qwen1.5-moe-a2.7b (4 layers, shared expert under its gate) and
  qwen3-moe-30b-a3b (8 layers) at n = 1 and 4, W4
  block 128; a call rotates over the layers, 147 and 302 MB, more than
  L2. Each row prints both versions' device time a call (a CUDA graph of
  16 calls), the host's time a call (the wrapper and its launch, 100 calls
  queued without a synchronize), each kernel's device time by name
  (torch.profiler, 8 calls), rel-L2 to the plain version and between the
  versions, and whether each gives the same bits twice. `--clocks` builds
  both once more with `-DMNN_MD_CLOCKS` and prints, a row, the mean cycles between the steps
  of an item by kind (`epi_*`: the epilogue warp's), the cycles an item's
  compute warps waited for full ring slots and its producer for free ones,
  and the blocks' spans (`md_clock_summary`).

It prints both versions' times per shape, with the card's name and power
limit; the JSON goes to `chiprun_out/{a8,rows,flash,step,fdec,moe,deq,model,mdec}_against.json`
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
import time
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
         "deq": ("mnn_dequant_matmul_deq", "mnn_dequant_matmul_deq"),
         "model": ("mnn_decode_model", "mnn_decode_model"),
         "mdec": ("mnn_moe_decode", "mnn_moe_decode")}
SOURCE = {"a8": "dequant_matmul.cu", "rows": "dequant_matmul.cu", "flash": "flash_prefill.cu",
          "step": "decode_step.cu", "fdec": "flash_decode.cu", "moe": "moe_prefill.cu",
          "deq": "dequant_matmul.cu", "mdec": "moe_decode.cu",
          "model": ("decode_model.cu", "decode_model_b1.cu", "decode_model_b2.cu",
                    "decode_model_b4.cu", "decode_model_b8.cu")}


LIBS: dict = {}      # name -> the loaded library of `_libraries`


def _libraries(specs, out_dir: Path, kind: str) -> dict:
    """{name: C entry} for specs of (name, source, entry, defines): each
    source into its own library, the nvcc runs side by side. A source file
    is built with this tree's headers beside it, a directory (another
    version of `csrc/`) with its own headers; `entry` may name several C
    entries, separated by `|`, of which the first the library has is taken."""
    cmds, links, sos = [], [], {}
    for name, src, entry, defines in specs:
        work = out_dir / name
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        flags = [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        sos[name] = (work / "lib.so", entry)
        if isinstance(SOURCE[kind], tuple):     # several sources: objects, then a link
            objs = [work / (Path(cu).stem + ".o") for cu in SOURCE[kind]]
            cmds += [[*flags, "-Xptxas", "-v", "-I", str(src), "-c", "-o", str(o),
                      str(Path(src) / cu)] for cu, o in zip(SOURCE[kind], objs)]
            links.append([*flags, "-shared", "-o", str(work / "lib.so"), *map(str, objs)])
            continue
        if Path(src).is_dir():
            cu, inc = Path(src) / SOURCE[kind], Path(src)
        else:
            for h in build.CSRC.glob("*.cuh"):
                shutil.copy(h, work / h.name)
            cu, inc = work / SOURCE[kind], work
            shutil.copy(src, cu)
        cmds.append([*flags, "-shared", "-I", str(inc), "-o", str(work / "lib.so"), str(cu)])
    if links:       # each object's nvcc output under its path: registers, stack, spills
        procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)) for c in cmds]
        log = "".join(f"$ {c[-1]}\n{p.communicate()[0]}" for c, p in procs)
        out = Path("chiprun_out")
        out.mkdir(exist_ok=True)
        (out / f"{kind}_nvcc_log.txt").write_text(log)
        if any(p.returncode for _, p in procs):
            raise RuntimeError("CUDA kernel build failed:\n" + log)
        build._run_all(links)
    else:
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
        elif kind == "model":
            fn = _ModelEntry(LIBS[name], name)
        elif kind == "mdec":
            fn = _MdecEntry(LIBS[name], name)
        else:
            pointers = 7 if entry.endswith("_a8") else 6
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            if kind == "rows":      # M = 1: the GEMV (or row) kernel
                fn.m1 = LIBS[name].mnn_dequant_matmul
                fn.m1.argtypes = fn.argtypes
        fns[name] = fn
    return fns


class _ModelEntry:
    """`mnn_decode_model` of one library, called as the wrapper calls its
    KERNEL. A source older than the schedule (no `mnn_decode_model_limits`)
    takes the older signature, the first 61 arguments, and gets scratch and
    counters of its own: it carves more scratch than the wrapper sizes, and
    expects its counters at zero."""

    OLD_TYPES = [ctypes.c_void_p] * 39 + [ctypes.c_int] * 20 + [ctypes.c_float] * 2
    WS, COUNTERS, B, WS_FLOATS, N_COUNTERS = 36, 37, 39, 57, 58   # argument positions

    def __init__(self, lib, name: str):
        from mnn_tpu_torch.kernels import decode_model
        self.name, self.entry, self.launches = name, "mnn_decode_model", 0
        self.scheduled = hasattr(lib, "mnn_decode_model_limits")
        types = decode_model.KERNEL.argtypes[:-1] if self.scheduled else self.OLD_TYPES
        self.n = len(types)
        self.fn = lib.mnn_decode_model
        self.fn.argtypes = list(types) + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.ws = self.counters = None
        self.lib = lib

    def limits(self, batch: int, head_dim: int) -> tuple:
        """This library's `mnn_decode_model_limits` (decode_model.LIMITS)."""
        out = (ctypes.c_int * 8)()
        self.lib.mnn_decode_model_limits.argtypes = [ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_void_p]
        err = self.lib.mnn_decode_model_limits(batch, head_dim, out)
        if err:
            raise RuntimeError(f"{self.name}: mnn_decode_model_limits: CUDA error {err}")
        return tuple(out)

    def __call__(self, *args):
        args = list(args[:self.n])
        if not self.scheduled:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            ws_floats = args[self.WS_FLOATS] + 2 * sms * 128 * args[self.B]
            n_counters = args[self.N_COUNTERS] + 4096
            if self.ws is None or self.ws.numel() < ws_floats:
                self.ws = torch.empty((ws_floats,), dtype=torch.float32, device="cuda")
            if self.counters is None or self.counters.numel() < n_counters:
                self.counters = torch.zeros((n_counters,), dtype=torch.int32, device="cuda")
            args[self.WS], args[self.COUNTERS] = self.ws.data_ptr(), self.counters.data_ptr()
            args[self.WS_FLOATS], args[self.N_COUNTERS] = ws_floats, n_counters
        err = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: mnn_decode_model: CUDA launch error {err}")
        self.launches += 1


EV_TAGS = ("start", "barrier_in", "barrier_out", "item", "weights", "x", "published",
           "merged", "done", "rows", "prep", "cached", "waited")
EV_KINDS = ("prologue", "qkv", "attention", "wo", "gate_up", "down", "head", "argmax")
EV_MAX = 2048           # int64 a block in the -DMNN_DM_CLOCKS log (DM_EV_MAX)
EV_CLOCK_BITS = 40


def decode_events(row) -> list:
    """One block's row of the -DMNN_DM_CLOCKS log -> [(tag, kind, layer,
    clock)]: entry 0 is the count, each event tag << 56 | kind << 52 |
    layer << 40 | the clock's low 40 bits."""
    n = int(row[0])
    if not 0 <= n < len(row):      # not a log (a source that wrote something else)
        return []
    out = []
    for v in row[1:1 + n]:
        v = int(v)
        out.append(((v >> 56) & 0xFF, (v >> 52) & 0xF, (v >> 40) & 0xFFF,
                    v & ((1 << EV_CLOCK_BITS) - 1)))
    return out


def _cycles(a: int, b: int) -> int:
    return (b - a) % (1 << EV_CLOCK_BITS)


def clock_summary(log, first_layer: int = 1) -> dict:
    """The -DMNN_DM_CLOCKS log of one call (rows of `EV_MAX` int64 a block)
    read by phase kind. A block's clock is its SM's, so only differences
    within a block are taken.

    `steps`: for each phase kind, the mean cycles from each step of an item
    to the next (item -> waited -> weights -> ...; the tags each kernel
    logs), over the items of layers >= `first_layer` in every block, and
    the item count. `block0`: block 0's first item of each kind at
    `first_layer`, as [step, cycles from the item's start]. `sm_of_block`:
    the SM each block ran on, where its first event (start) names it. `barriers`: for
    each grid-wide wait, by the kind of phase it closes, the mean over its
    instances of the least wait of a block (what the last block to arrive
    pays: the barrier's own cost), of the most (the spread of the arrivals
    adds to it), and of the median."""
    steps: dict = {}
    block0: dict = {}
    waits: dict = {}
    for blk, row in enumerate(log):
        evs = decode_events(row)
        item = None          # [kind, layer, start clock, last clock, last step, steps]
        bars = 0
        for i, (tag, kind, layer, clk) in enumerate(evs):
            name = EV_TAGS[tag] if tag < len(EV_TAGS) else str(tag)
            if name == "barrier_in":
                if i + 1 < len(evs) and evs[i + 1][0] == EV_TAGS.index("barrier_out"):
                    waits.setdefault((bars, EV_KINDS[kind], layer), []).append(
                        _cycles(clk, evs[i + 1][3]))
                bars += 1
                continue
            if name == "item":
                item = [kind, layer, clk, clk, "item", []]
                continue
            if item is None or kind != item[0] or name == "barrier_out":
                continue
            item[5].append((name, _cycles(item[2], clk)))
            if item[1] >= first_layer:
                d = steps.setdefault(EV_KINDS[kind], {"items": 0})
                d.setdefault(f"{item[4]}->{name}", []).append(_cycles(item[3], clk))
                d["items"] += name == "done"
            item[3], item[4] = clk, name
            if name == "done":
                if blk == 0 and item[1] == first_layer and EV_KINDS[kind] not in block0:
                    block0[EV_KINDS[kind]] = item[5]
                item = None
    sms = [ev[2] for row in log for ev in decode_events(row)[:1] if ev[0] == 0]
    out_steps = {}
    for kind, d in steps.items():
        out_steps[kind] = {k: (v if k == "items" else sum(v) / len(v)) for k, v in d.items()}
    by_kind: dict = {}
    for (_, kind, layer), w in sorted(waits.items()):
        if layer < first_layer and kind not in ("head", "argmax"):
            continue
        w = sorted(w)
        e = by_kind.setdefault(kind, {"instances": 0, "least": 0.0, "most": 0.0,
                                      "median": 0.0, "blocks": len(w)})
        e["instances"] += 1
        e["least"] += w[0]
        e["most"] += w[-1]
        e["median"] += w[len(w) // 2]
    for e in by_kind.values():
        for k in ("least", "most", "median"):
            e[k] /= e["instances"]
    return dict(steps=out_steps, block0=block0, barriers=by_kind, sm_of_block=sms)


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


# (preset, layers or None for all, kv bits, len_old per sequence): chip_smoke.py phase 2
MODEL_ROWS = [("qwen2-0.5b", None, 8, (48,)), ("qwen2-0.5b", None, 8, (331,)),
              ("qwen2-0.5b", None, 8, (631,)), ("qwen2-0.5b", None, 4, (331,)),
              ("qwen2-0.5b", None, 16, (331,)), ("qwen2-0.5b", None, 8, (48, 331, 631, 5)),
              ("qwen2-7b", 2, 8, (331,))]
MODEL_DEEP_ROW = ("qwen2-7b", None, 8, (331,))
MODEL_CLOCK_ROW = 1          # the row whose stamps --clocks prints
MODEL_S = 1024


def _model_case(dev, g, params, cfg, kv_bits, lengths):
    """(positional args, keyword args) of one decode step as `forward` gives
    them: a random cache of MODEL_S positions, embedding rows, rope phases."""
    from mnn_tpu_torch.models.layers import rope_cos_sin
    from mnn_tpu_torch.runtime import kvcache
    b = len(lengths)
    shape = (cfg.num_layers, b, cfg.num_kv_heads, MODEL_S, cfg.head_dim)
    kf = torch.randn(shape, device=dev, generator=g)
    vf = torch.randn(shape, device=dev, generator=g)
    if kv_bits == 16:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    else:
        (kc, ks), (vc, vs) = kvcache.quantize_for(kv_bits, kf), kvcache.quantize_for(kv_bits, vf)
    del kf, vf
    tok = torch.randint(0, cfg.vocab_size, (b,), device=dev, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(lens[:, None].long(), cfg.head_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling)
    cos_f = torch.cat([cos[:, 0], cos[:, 0]], dim=-1)
    sin_f = torch.cat([sin[:, 0], sin[:, 0]], dim=-1)
    args = (params.embedding[tok], params.layers, kc, vc, ks, vs, lens, cos_f, sin_f)
    return args, dict(config=cfg, head=params.lm_head, final_norm=params.final_norm)


def _event_ms(fn, calls: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _model_clocks(call, dev) -> dict:
    """One call's -DMNN_DM_CLOCKS log (after two warm calls), read by
    `clock_summary`; the log goes in through the wrapper's EVENT_LOG."""
    from mnn_tpu_torch.kernels import decode_model
    log = torch.zeros((1024, EV_MAX), dtype=torch.int64, device=dev)
    decode_model.EVENT_LOG = log
    try:
        call()
        call()
        log.zero_()
        call()
        torch.cuda.synchronize()
    finally:
        decode_model.EVENT_LOG = None
    return clock_summary(log.cpu().numpy())


def _model(fns: dict, order: list, card: str, args) -> None:
    """--kernel model: every version in `order` at the phase-2 shapes."""
    from mnn_tpu_torch.kernels import decode_model
    from mnn_tpu_torch.models import decoder
    from mnn_tpu_torch.models.config import PRESETS
    import dataclasses
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    versions = list(dict.fromkeys(order))
    times = {ver: [] for ver in versions}
    rows_out, params, clocks = [], {}, {}
    own, own_limits = decode_model.KERNEL, decode_model.LIMITS
    for name, fn in fns.items():
        if fn.scheduled:
            print(f"{name}: (blocks an SM, shared bytes, ring slots, SMs, registers, most "
                  f"threads, static shared, local bytes) at B = 1 "
                  f"{fn.limits(1, 64)} (D 64), {fn.limits(1, 128)} (D 128); B = 8 "
                  f"{fn.limits(8, 128)}", flush=True)
    model_rows = MODEL_ROWS + ([MODEL_DEEP_ROW] if args.deep else [])
    try:
        for idx, (preset, layers, kv_bits, lengths) in enumerate(model_rows):
            cfg = PRESETS[preset]
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            if (preset, layers) not in params:
                params.clear()
                torch.cuda.empty_cache()
                params[(preset, layers)] = decoder.init_random_params(
                    cfg, torch.Generator().manual_seed(0), lm_head_bits=4, device=dev)
            prm = params[(preset, layers)]
            pos, kw = _model_case(dev, g, prm, cfg, kv_bits, lengths)
            outs, row = {}, {ver: [] for ver in versions}
            same = True
            for ver in order:
                decode_model.KERNEL = fns.get(ver, fns["this"])
                decode_model.LIMITS = (decode_model.KERNEL.limits if decode_model.KERNEL.scheduled
                                       else fns["this"].limits)
                call = lambda: decode_model.fused_decode_model(*pos, **kw)
                if ver not in outs:
                    outs[ver] = call()
                    again = call()
                    torch.cuda.synchronize()
                    same = same and all(a is None or torch.equal(a, c)
                                        for a, c in zip(outs[ver], again))
                row[ver].append(_event_ms(call))
            deep4 = dict(rows_levels=1.0, rows_rel=1.5e-1) if kv_bits == 4 else {}
            bad = []
            for ver in versions[1:]:      # each against the other version
                mv = decode_model.parity_metrics(outs[ver], outs["other"], kv_bits)
                bad += [f"{ver}:{k}" for k in
                        decode_model.parity_failures(mv, skip=("x_rel",), **deep4)]
                if ver == "this":
                    m = mv
            shape = (f"{preset}{f' x{layers} layers' if layers else ''} B={len(lengths)} "
                     f"kv{kv_bits} len_old={','.join(map(str, lengths))}")
            if idx == MODEL_CLOCK_ROW and args.clocks:
                for ver, clk in (("this", "clk"), ("other", "oclk")):
                    decode_model.KERNEL = fns[clk]
                    decode_model.LIMITS = (fns[clk].limits if fns[clk].scheduled
                                           else fns["this"].limits)
                    clocks[ver] = _model_clocks(
                        lambda: decode_model.fused_decode_model(*pos, **kw), dev)
                    print(f"  clocks, {ver}: {json.dumps(clocks[ver])}", flush=True)
            rows_out.append(dict(shape=shape, parity=m, failures=bad, same_twice=same))
            for ver in versions:
                times[ver].append(row[ver])
            print(f"{shape}: " + ", ".join(
                f"{ver} {' / '.join(f'{x:.4f}' for x in row[ver])} ms" for ver in versions)
                + f"; this against other: logits rel {m['logits_rel']:.2e}, rows "
                  f"{m['rows_rel']:.2e}, failures {bad}; same bits twice {same}",
                flush=True)
            del pos, kw, outs
            torch.cuda.empty_cache()
    finally:
        decode_model.KERNEL, decode_model.LIMITS = own, own_limits
    ok = all(not r["failures"] and r["same_twice"] for r in rows_out)
    print(f"every row within PARITY_BOUNDS of the other and the same bits twice: {ok}")
    print(card)
    result = dict(card=card, kernel="model", rows=rows_out, order=order, ms=times,
                  clocks=clocks, agree=ok, against=str(args.against))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "model_against.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise SystemExit("the versions disagree")


# (preset, E, k, mi, si, layers, n): chip_smoke.py phase 2's fused expert decode rows
MDEC_ROWS = [("qwen1.5-moe-a2.7b", 60, 4, 1408, 5632, 4, 1),
             ("qwen1.5-moe-a2.7b", 60, 4, 1408, 5632, 4, 4),
             ("qwen3-moe-30b-a3b", 128, 8, 768, 0, 8, 1),
             ("qwen3-moe-30b-a3b", 128, 8, 768, 0, 8, 4)]
MDEC_H = 2048
MD_EV_MAX, MD_CLK_ROWS = 256, 4096      # csrc/md_clocks.cuh
MD_TAGS = ("start", "item", "weights", "waited", "x", "products", "published", "merged",
           "done", "exit", "full_wait", "empty_wait")
MD_KINDS = ("gu_routed", "gu_shared", "dn_routed", "dn_shared", "epi_gu_routed",
            "epi_gu_shared", "epi_dn_routed", "epi_dn_shared")
def md_clock_summary(log) -> dict:
    """The -DMNN_MD_CLOCKS log of one call read by item kind: for each kind
    the items and the mean cycles from each step of an item to the next
    (the steps a source logs: item -> weights -> waited -> x -> products ->
    published -> merged -> done), the mean cycles an item's consumers waited
    for full ring slots and its producer for free ones (`full_wait`,
    `empty_wait`, where the source logs them), and over the blocks that
    logged steps, the mean and largest cycles from a block's start to its
    last event and the mean and largest item count a block. A stamp inside
    an item takes the kind of the item's own stamp."""
    steps: dict = {}
    spans, counts = [], []
    for row in log:
        evs = decode_events(row)     # (tag, kind, aux, clock)
        timed = [ev for ev in evs if MD_TAGS[ev[0]] not in ("full_wait", "empty_wait")
                 if ev[0] < len(MD_TAGS)]
        item, items = None, 0
        for tag, kind, _, clk in evs:
            name = MD_TAGS[tag] if tag < len(MD_TAGS) else str(tag)
            kname = MD_KINDS[kind] if kind < len(MD_KINDS) else str(kind)
            if name in ("full_wait", "empty_wait"):
                steps.setdefault(kname, {"items": 0}).setdefault(name, []).append(clk)
                continue
            if name == "item":
                item = [kname, clk, "item"]
                items += 1
                steps.setdefault(item[0], {"items": 0})["items"] += 1
                continue
            if item is None or name in ("start", "exit"):
                continue
            d = steps[item[0]]
            d.setdefault(f"{item[2]}->{name}", []).append(_cycles(item[1], clk))
            item[1], item[2] = clk, name
        if timed:
            spans.append(_cycles(timed[0][3], timed[-1][3]))
            counts.append(items)
    out = {kind: {k: (v if k == "items" else sum(v) / len(v)) for k, v in d.items()}
           for kind, d in steps.items()}
    if spans:
        out["blocks"] = dict(count=len(spans), span_mean=sum(spans) / len(spans),
                             span_max=max(spans), items_mean=sum(counts) / len(counts),
                             items_max=max(counts))
    return out


class _MdecEntry:
    """`mnn_moe_decode` of one library, called by `moe_decode.moe_decode_mlp`
    with this entry in place of its KERNEL and LIMITS."""

    def __init__(self, lib, name: str):
        from mnn_tpu_torch.kernels import moe_decode
        self.name, self.entry, self.launches, self.lib = name, "mnn_moe_decode", 0, lib
        if not hasattr(lib, "mnn_moe_decode_limits"):
            raise SystemExit(f"{name}: no mnn_moe_decode_limits: --kernel mdec times "
                             "sources with the one-launch entry only")
        self.fn = lib.mnn_moe_decode
        self.fn.argtypes = list(moe_decode.KERNEL.argtypes[:-1]) + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.argtypes = self.fn.argtypes
        self.lib.mnn_moe_decode_limits.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        self.clocks = hasattr(lib, "mnn_moe_decode_clocks")
        if self.clocks:
            lib.mnn_moe_decode_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def limits(self, n: int, bits: int) -> tuple:
        out = (ctypes.c_int * 10)()
        err = self.lib.mnn_moe_decode_limits(n, bits, out)
        if err:
            raise RuntimeError(f"{self.name}: mnn_moe_decode_limits: CUDA error {err}")
        return tuple(out)

    def __call__(self, *args):
        err = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: mnn_moe_decode: CUDA launch error {err}")
        self.launches += 1


def _mdec_case(dev, g, preset, e, k, mi, si, nl, n):
    """(config, LayerParams, x, sel, wsel, gate) of one phase-2 row, W4
    block 128, as chip_smoke.py makes them."""
    from mnn_tpu_torch.models import decoder
    from mnn_tpu_torch.models.config import PRESETS
    from mnn_tpu_torch.quant.quantize import QuantizedLinear
    cfg = PRESETS[preset]
    h = cfg.hidden_size

    def stack(lead, kd, nd):
        p, s, b = _moe_weights(g, lead, kd, nd)
        return QuantizedLinear(packed=p, scale=s, bias=b, out_bias=None, bits=4,
                               block_size=128, act_bits=16)
    lay = decoder.LayerParams(
        wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
        wgu_e=stack((nl, e), h, 2 * mi), wdown_e=stack((nl, e), mi, h),
        wgu_shared=stack((nl,), h, 2 * si) if si else None,
        wdown_shared=stack((nl,), si, h) if si else None)
    x = torch.randn((n, h), device=dev, generator=g) * 0.5
    sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k]
                       for _ in range(n)]).to(torch.int32)
    wsel = torch.softmax(torch.randn((n, k), device=dev, generator=g), -1)
    gate = torch.rand((n,), device=dev, generator=g) if si else None
    return cfg, lay, x, sel, wsel, gate


def _mdec_read_clocks(entry) -> "numpy.ndarray":
    import numpy as np
    log = np.zeros((MD_CLK_ROWS, MD_EV_MAX), dtype=np.int64)
    err = entry.lib.mnn_moe_decode_clocks(log.ctypes.data, MD_CLK_ROWS)
    if err:
        raise RuntimeError(f"{entry.name}: mnn_moe_decode_clocks: CUDA error {err}")
    return log


def _host_us(call, calls: int = 100) -> float:
    """The host's µs a call of `call(i)`: `calls` calls queued without a
    synchronize (few enough that the launch queue never blocks)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        call(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _mdec(fns: dict, order: list, card: str, args) -> None:
    """--kernel mdec: every version in `order` at phase 2's rows."""
    from mnn_tpu_torch.kernels import moe_decode
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    versions = list(dict.fromkeys(order))
    times = {ver: [] for ver in versions}
    own = (moe_decode.KERNEL, getattr(moe_decode, "LIMITS", None))
    rows_out, ok = [], True

    def caller(fn, cfg, lay, x, sel, wsel, gate, nl):
        def call(i):
            moe_decode.KERNEL, moe_decode.LIMITS = fn, fn.limits
            return moe_decode.moe_decode_mlp(x, lay, sel, wsel, i % nl, gate, config=cfg)
        return call

    try:
        for preset, e, k, mi, si, nl, n in MDEC_ROWS:
            cfg, lay, x, sel, wsel, gate = _mdec_case(dev, g, preset, e, k, mi, si, nl, n)
            want = moe_decode.moe_decode_mlp_plain(x, lay, sel, wsel, 1, gate, config=cfg)
            outs, same, by_name, clocks = {}, {}, {}, {}
            row, host = {ver: [] for ver in versions}, {ver: [] for ver in versions}
            for ver in order:
                call = caller(fns[ver], cfg, lay, x, sel, wsel, gate, nl)
                if ver not in outs:
                    outs[ver] = call(1)
                    again = call(1)
                    torch.cuda.synchronize()
                    same[ver] = bool(torch.equal(outs[ver], again))
                    acts = [torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]
                    with torch.profiler.profile(activities=acts) as prof:
                        for i in range(8):
                            call(i)
                        torch.cuda.synchronize()
                    by_name[ver] = {ev.key: ev.self_device_time_total / 8
                                    for ev in prof.key_averages()
                                    if ev.device_type == torch.autograd.DeviceType.CUDA
                                    and ev.self_device_time_total > 0}
                row[ver].append(_time_us(call, 16))
                host[ver].append(_host_us(call))
            if args.clocks:
                for ver, clk in (("this", "clk"), ("other", "oclk")):
                    call = caller(fns[clk], cfg, lay, x, sel, wsel, gate, nl)
                    call(0)
                    call(1)
                    _mdec_read_clocks(fns[clk])          # and zero the log
                    call(2)
                    clocks[ver] = md_clock_summary(_mdec_read_clocks(fns[clk]))
                    print(f"  clocks, {ver}: {json.dumps(clocks[ver])}", flush=True)
            rel_plain = {ver: _rel(outs[ver], want) for ver in versions}
            rel_other = {ver: _rel(outs[ver], outs["other"]) for ver in versions}
            bits_other = {ver: bool(torch.equal(outs[ver], outs["other"])) for ver in versions}
            good = all(r <= 2e-2 for r in rel_plain.values()) and all(same.values())
            ok = ok and good
            shape = f"{preset} n={n} E={e} k={k} mi={mi} si={si}"
            rows_out.append(dict(shape=shape, us=row, host_us=host, rel_plain=rel_plain,
                                 rel_other=rel_other,
                                 same_bits_as_other=bits_other, same_twice=same,
                                 kernels_us=by_name, clocks=clocks))
            for ver in versions:
                times[ver].append(row[ver])
            print(f"{shape}: " + ", ".join(
                f"{ver} {' / '.join(f'{t:.2f}' for t in row[ver])} us" for ver in versions)
                + f"; rel-L2 to plain {json.dumps({v: f'{r:.2e}' for v, r in rel_plain.items()})}"
                  f", this to other {rel_other.get('this', 0.0):.2e} (same bits "
                  f"{bits_other.get('this')}); same bits twice {same}", flush=True)
            print("  host us a call: " + ", ".join(
                f"{ver} {' / '.join(f'{t:.2f}' for t in host[ver])}" for ver in versions),
                flush=True)
            for ver in versions:
                print(f"  kernels of {ver}, us a call: " + ", ".join(
                    f"{name} {t:.2f}" for name, t in sorted(by_name[ver].items())), flush=True)
            del lay, outs
            torch.cuda.empty_cache()
    finally:
        moe_decode.KERNEL, moe_decode.LIMITS = own
    print(f"every version within rel-L2 2e-2 of the plain version and the same bits twice: {ok}")
    print(card)
    result = dict(card=card, kernel="mdec", rows=rows_out, order=order, us=times, agree=ok,
                  against=str(args.against))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "mdec_against.json").write_text(json.dumps(result, indent=1))
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
                         "prefill MLP; deq: the dequantize-tile matmul; model: the "
                         "whole-model decode kernel; mdec: the fused expert decode kernel")
    ap.add_argument("--warps", default="",
                    help="flash only: comma-separated block shapes, query warps x "
                         "position groups (4x1, 2x2, 1x4, 4x2), to build and time this "
                         "source at, besides its own choice")
    ap.add_argument("--clocks", action="store_true",
                    help="step, moe, deq, model, mdec: also build with -DMNN_DS_CLOCKS "
                         "(step), -DMNN_DD_CLOCKS (moe, deq), -DMNN_DM_CLOCKS (model, both "
                         "versions) or -DMNN_MD_CLOCKS (mdec, both versions) and print the "
                         "kernel's steps on the SM clock")
    ap.add_argument("--deep", action="store_true",
                    help="model only: add the 28-layer qwen2-7b row")
    ap.add_argument("--variant", action="append", default=[],
                    help="moe, deq, model: NAME:DEFINE[+DEFINE...], this source built with "
                         "those macros and timed beside it, e.g. nopipe:MNN_DD_PIPE=0")
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
    if args.kernel == "model":
        if not args.against.is_dir():
            raise SystemExit("--kernel model needs --against DIR (another csrc/)")
        specs = [("this", build.CSRC, "mnn_decode_model", ()),
                 ("other", args.against, "mnn_decode_model", ())]
        if args.clocks:
            specs += [("clk", build.CSRC, "mnn_decode_model", ("MNN_DM_CLOCKS",)),
                      ("oclk", args.against, "mnn_decode_model", ("MNN_DM_CLOCKS",))]
        variants = [v.split(":", 1) for v in args.variant]
        specs += [(name, build.CSRC, "mnn_decode_model", tuple(d for d in defs.split("+") if d))
                  for name, defs in variants]
        fns = _libraries(specs, out_dir, "model")
        mid = ["this"] + [name for name, _ in variants]
        return _model(fns, ["other"] + mid + mid[::-1] + ["other"], card, args)
    if args.kernel == "mdec":
        if not args.against.is_dir():
            raise SystemExit("--kernel mdec needs --against DIR (another csrc/)")
        specs = [("this", build.CSRC, "mnn_moe_decode", ()),
                 ("other", args.against, "mnn_moe_decode", ())]
        if args.clocks:
            specs += [("clk", build.CSRC, "mnn_moe_decode", ("MNN_MD_CLOCKS",)),
                      ("oclk", args.against, "mnn_moe_decode", ("MNN_MD_CLOCKS",))]
        fns = _libraries(specs, out_dir, "mdec")
        return _mdec(fns, ["other", "this", "this", "other"], card, args)
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
