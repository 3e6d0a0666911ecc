"""Routed mixture-of-experts MLP of a decode step: every (token, expert)
pair of a layer and the shared expert in one kernel entry.

Replaces the TPU kernel `mnn_tpu/kernels/moe_decode.py::_kernel`. CUDA
source: `csrc/moe_decode.cu`.

For n <= 8 tokens (post-norm hidden states x [n, H]) and this layer's routing
(sel, wsel [n, k], from `models/decoder.py::_route`),

    y[r] = sum_k wsel[r, k] * expert_{sel[r, k]}(x[r]) + gate[r] * shared(x[r])

with expert(x) = down(act(gate_up(x))) over W4/W8 weights. Rounding points,
as the TPU kernel's: x rounded to bf16 (the row sums are taken over the
rounded x), part * s + rowsum * m per quant block in f32, the gate/up result
rounded to bf16, split by the 64-block interleave, bf16(bf16(g * sigmoid(g))
* u), the down product in f32, pair terms added in the order 0 .. k-1, then
the shared term times its gate (1 when there is a shared expert and no
gate). Output f32 [n, H].

What bounds it on the H100, and what the design does about it: bytes. A
token reads k of E experts and the shared expert once, 36.8 MB a layer at
qwen1.5-moe-a2.7b's widths, and does two operations per weight.

* The expert ids never leave the device: the kernel reads `sel` and
  computes its weight pointers into the flat [L * E] stacks itself, so a
  layer costs no host round trip and no expert is copied.
* One launch. `schedule()` lists the work as items, from the shapes only:
  K ranges of the gate/up tiles (128 columns: 64 gate and their 64 up
  columns) of the shared expert and of every pair, then K ranges of the
  down products' 128-column tiles of y. Persistent blocks take the items by
  an atomic ticket, every gate/up item before every down item; a down item
  waits only on the gate/up tiles that feed its K range. In a block a
  producer warp streams the next items' weights into shared memory, eight
  warps compute, and an epilogue warp merges K ranges, applies SwiGLU and
  combines y off their path.
* The same bits from run to run: K ranges meet in device memory and the
  last block to arrive (a counter per tile) adds them in a fixed order; no
  floating-point atomics. The last block to finish leaves the ticket and
  every counter at zero, so no call needs a reset from the host.
* The scratch and counters are one set per device and shape (`_scratch`):
  two calls on two streams at once would corrupt each other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from mnn_tpu_torch.kernels import build
from mnn_tpu_torch.kernels.build import I, P, kernel
from mnn_tpu_torch.kernels.common import cdiv, check, use_kernel
from mnn_tpu_torch.kernels.dequant_matmul import deq_dot_plain
from mnn_tpu_torch.kernels.moe_prefill import _split_act
from mnn_tpu_torch.quant.quantize import QuantizedLinear

# int mnn_moe_decode(x, sel, wsel, gate, gu_p, gu_s, gu_b, dn_p, dn_s, dn_b,
#                    sgu_p, sgu_s, sgu_b, sdn_p, sdn_s, sdn_b, y, table, fscratch,
#                    counters, n, k, E, layer, H, mi, si, bits, bs_h, bs_mi, bs_sh,
#                    bs_sd, n_items, n_ready, rd, sd, part_a, part_b, f_floats, stream)
KERNEL = kernel("mnn_moe_decode", [P] * 20 + [I] * 19)

MAX_TOKENS = 8
TILE = 128          # columns of a tile
UNIT_ROWS = 64      # packed rows of a unit: one ring slot
SCALE_ROWS = 4      # quant blocks a unit may touch
XS_PAD = 8          # values a stage row is padded by
MAGIC = 0x4D443132
HDR = REC = 16      # int32 of the table's header, of a record
NREL = 4            # arrival counters a gate/up item may release
# item kinds (csrc/md_clocks.cuh) and the fields of a record (csrc/moe_decode.cu):
# a gate/up item releases R_REL.. (up to NREL), a down item waits on R_WAIT
GU_R, GU_S, DN_R, DN_S = range(4)
(R_KIND, R_JOB, R_TILE, R_U0, R_U1, R_PIECE, R_NPIECES, R_MERGE, R_PART, R_REL) = range(10)
R_WAIT, R_TARGET, R_BASE = R_REL, R_REL + 1, R_REL + 2
C_TICKET, C_DONE, C_READY = range(3)       # the first counters

_scratch: dict = {}
_tables: dict = {}
_blocks: dict = {}


def _limits(n: int, bits: int) -> tuple:
    """The launch limits of this library's kernel for n rows at W`bits`:
    (blocks an SM, shared bytes, ring slots, SMs, registers, most threads,
    static shared bytes, local bytes, x stage values, values of a block's
    copy of x)."""
    fn = build.library().mnn_moe_decode_limits
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 10)()
    err = fn(n, bits, out)
    if err:
        raise RuntimeError(f"mnn_moe_decode_limits: CUDA error {err}")
    return tuple(out)


LIMITS = _limits     # a profiler puts another build's in its place


def launch_shape(device, n: int, bits: int) -> tuple:
    """(blocks a launch has on `device`: the occupancy calculator's count an
    SM times the SMs; the x stage's values; the values of a block's copy of
    x), schedule()'s last three arguments."""
    key = (LIMITS, device, n, bits)
    if key not in _blocks:
        lim = LIMITS(n, bits)
        _blocks[key] = (lim[0] * lim[3], lim[8], lim[9])
    return _blocks[key]


def supports(c, layers, n_tokens: int) -> bool:
    """Whether the fused kernel takes this config, these stacks and this
    many tokens: the JAX package's contract (W4/W8 and the same everywhere,
    bf16 rows, no output bias, quant blocks dividing K, the 64-block gate/up
    layout, at most 8 tokens) and the kernel's own limit, quant blocks that
    32-value K chunks tile."""
    if not c.is_moe or layers.wgu_e is None or layers.wdown_e is None:
        return False
    if n_tokens > MAX_TOKENS:
        return False
    ql = layers.wgu_e
    if ql.bits not in (4, 8) or ql.act_bits != 16 or ql.out_bias is not None:
        return False
    if layers.wdown_e.bits != ql.bits:
        return False
    if layers.wdown_e.act_bits != 16 or layers.wdown_e.out_bias is not None:
        return False
    h, mi = c.hidden_size, c.moe_intermediate_size
    blocks = [ql.block_size, layers.wdown_e.block_size]
    if h % ql.block_size or mi % layers.wdown_e.block_size:
        return False
    if mi % 64 or h % 128:
        return False
    si = c.shared_expert_intermediate_size
    if si:
        sq, sd = layers.wgu_shared, layers.wdown_shared
        if sq is None or sd is None or sq.bits != ql.bits or sd.bits != ql.bits:
            return False
        if sq.out_bias is not None or sd.out_bias is not None:
            return False
        if h % sq.block_size or si % sd.block_size or si % 64:
            return False
        blocks += [sq.block_size, sd.block_size]
    return all(bs % 32 == 0 for bs in blocks)


def _expert_dot(x: torch.Tensor, ql: QuantizedLinear, layer_index: int,
                ids: Optional[torch.Tensor]) -> torch.Tensor:
    """x [J, M, K] @ dequant of experts `ids` [J] of one layer (None: the
    layer's one shared matrix, J = 1) -> f32 [J, M, N], in the kernel's
    algebra: x rounded to bf16, part * s + rowsum * m per quant block. The
    experts are gathered by a device index: nothing crosses to the host."""
    pick = lambda t: t[layer_index][None] if ids is None else t[layer_index][ids]
    return deq_dot_plain(x, pick(ql.packed), pick(ql.scale), pick(ql.bias),
                         ql.bits, ql.block_size, True)


def moe_decode_mlp_plain(x: torch.Tensor, layers, sel: torch.Tensor,
                         wsel: torch.Tensor, layer_index: int,
                         gate: Optional[torch.Tensor], *, config) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same algebra, rounding points
    and order of the final sum."""
    c = config
    n, h = x.shape
    k = c.num_experts_per_tok
    xf = x.float()
    ids = sel.reshape(-1).long()
    rows = xf.repeat_interleave(k, dim=0)[:, None, :]            # [n*k, 1, H]
    act = _split_act(_expert_dot(rows, layers.wgu_e, layer_index, ids))
    term = _expert_dot(act, layers.wdown_e, layer_index, ids)
    term = term.reshape(n, k, h) * wsel.float()[:, :, None]
    y = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for kk in range(k):
        y = y + term[:, kk]
    if c.shared_expert_intermediate_size:
        act = _split_act(_expert_dot(xf[None], layers.wgu_shared, layer_index, None))
        sh = _expert_dot(act, layers.wdown_shared, layer_index, None)[0]
        y = y + (sh if gate is None else sh * gate.float()[:, None])
    return y


def rows_held(n: int) -> int:
    """Batch rows the kernel holds in registers for n tokens (its BM)."""
    return 1 if n == 1 else 2 if n == 2 else 4 if n <= 4 else 8


def stage_values(n: int) -> int:
    """Values of the kernel's x stage for n tokens (rows x (K range + pad)),
    as csrc/moe_decode.cu sizes it."""
    return (16384 if rows_held(n) == 8 else 8192) + 8 * XS_PAD


def copy_values(n: int) -> int:
    """Values of a block's copy of x for n tokens: where n (H + pad) fit,
    gate/up items read x there and need no stage."""
    return rows_held(n) * (2048 + XS_PAD)


def k_span(r0: int, r1: int, bits: int, bs: int) -> tuple:
    """(first K value, K values spanned) of packed rows [r0, r1) of a matrix:
    W4 packs a quant block's K values j and j + bs / 2 into one row."""
    if bits == 8:
        return r0, r1 - r0
    half = bs // 2
    lo = lambda r: (r // half) * bs + r % half
    return lo(r0), lo(r1 - 1) + half + 1 - lo(r0)


def _cut(units: int, pieces: int) -> list:
    """[(u0, u1)] of `units` cut into `pieces` contiguous ranges, the longer first."""
    q, extra = divmod(units, pieces)
    out, at = [], 0
    for i in range(pieces):
        w = q + (i < extra)
        out.append((at, at + w))
        at += w
    return out


def _fits(units, pieces, kp, bits, bs, rows, xs) -> bool:
    """Whether each K range fits the x stage with its rows."""
    return all((k_span(u0 * UNIT_ROWS, min(u1 * UNIT_ROWS, kp), bits, bs)[1] + XS_PAD) * rows
               <= xs for u0, u1 in _cut(units, pieces))


class Schedule(NamedTuple):
    table: np.ndarray     # int32: the header, then a record an item in ticket order
    n_items: int
    gu_items: int         # tickets [0, gu_items) are gate/up items
    n_ready: int          # arrival counters of the down ranges
    rd: int               # down K ranges of a pair
    sd: int               # of the shared expert (0: none)
    part_a: int           # f32 of the gate/up K ranges' partial sums
    part_b: int           # f32 of the down shares
    n_counters: int


def items_a_block(units: float) -> int:
    """Items a mean block's `units` (64-row units of weights) are cut into:
    three, or two where a block has fewer than 12 units (96 KB at W4), where
    an item's fixed trips (its record and x, the K-range merge) would
    outweigh a third of the block's stream."""
    return 2 if units < 12 else 3


def schedule(n: int, k: int, h: int, mi: int, si: int, bits: int, bs_h: int, bs_mi: int,
             bs_sh: int, bs_sd: int, blocks: int, xs: Optional[int] = None,
             xall: Optional[int] = None) -> Schedule:
    """The kernel's items for n tokens, k pairs each, from the shapes, the
    blocks a launch has, the x stage's values and those of a block's copy
    of x (`launch_shape()`; xs and xall default to `stage_values(n)` and
    `copy_values(n)`), never the expert ids.

    Gate/up: the shared expert's 128-column tiles, then each pair's
    (pair-major); down: the shared expert's and each pair's tiles of y, in
    the same order, so that a down item's inputs were claimed early. A unit
    is 64 packed rows of a tile (8 KB at W4). A tile is cut along K into
    about a mean block's units over `items_a_block()`; the down ranges of a
    matrix are the same for every tile of y, so that one arrival counter a
    (pair, range) or (shared, range) serves them all. A range never spans
    more K values than the x stage holds for its rows (gate/up items read
    the block's copy of x where n rows fit it).

    Counters: the ticket, the finished blocks, one arrival counter a down
    range (pair-major, then the shared ranges), the merge counter of each
    cut gate/up tile, the combine counter of each tile of y."""
    nk, bm = n * k, rows_held(n)
    xs = stage_values(n) if xs is None else xs
    xall = copy_values(n) if xall is None else xall
    gu_xs = 1 << 30 if n * (h + XS_PAD) <= xall else xs   # gate/up items read the copy
    kp_h, kp_mi, kp_si = h * bits // 8, mi * bits // 8, si * bits // 8
    ug, ur, us = (cdiv(kp, UNIT_ROWS) for kp in (kp_h, kp_mi, kp_si))
    tr, ts, yt = 2 * mi // TILE, 2 * si // TILE, h // TILE
    total = (nk * tr + ts) * ug + yt * (nk * ur + us)
    q = max(1.0, total / blocks / items_a_block(total / blocks))   # units an item aims at
    cut = lambda units: max(1, min(units, round(units / q)))

    # down ranges: the same for every tile of y
    rd = cut(ur)
    while not _fits(ur, rd, kp_mi, bits, bs_mi, 1, xs):
        rd += 1
    sd = cut(us) if si else 0
    while si and not _fits(us, sd, kp_si, bits, bs_sd, bm, xs):
        sd += 1
    ranges_r, ranges_s = _cut(ur, rd), (_cut(us, sd) if si else [])
    n_ready = nk * rd + sd
    span = lambda rg, kp, bs: [k_span(u0 * UNIT_ROWS, min(u1 * UNIT_ROWS, kp), bits, bs)
                               for u0, u1 in rg]
    spans_r, spans_s = span(ranges_r, kp_mi, bs_mi), span(ranges_s, kp_si, bs_sd)
    feeds = lambda spans, t: [j for j, (k0, w) in enumerate(spans)
                              if 64 * t < k0 + w and 64 * t + 64 > k0]
    gu_tiles = [(GU_S, 0, t) for t in range(ts)] + \
               [(GU_R, p, t) for p in range(nk) for t in range(tr)]
    recs, merge_at, part_a = [], C_READY + n_ready, 0
    released: dict = {}
    for kind, job, t in gu_tiles:
        rows, bs = (1, bs_h) if kind == GU_R else (bm, bs_sh)
        pieces = cut(ug)
        while not _fits(ug, pieces, kp_h, bits, bs, rows, gu_xs):
            pieces += 1
        if kind == GU_R:
            rel = [C_READY + job * rd + j for j in feeds(spans_r, t)]
        else:
            rel = [C_READY + nk * rd + j for j in feeds(spans_s, t)]
        if not 1 <= len(rel) <= NREL:
            raise AssertionError(f"a gate/up tile feeds {len(rel)} down ranges")
        for ctr in rel:
            released[ctr] = released.get(ctr, 0) + 1
        for piece, (u0, u1) in enumerate(_cut(ug, pieces)):
            r = [-1] * REC
            r[R_KIND], r[R_JOB], r[R_TILE], r[R_U0], r[R_U1] = kind, job, t, u0, u1
            r[R_PIECE], r[R_NPIECES] = piece, pieces
            if pieces > 1:
                r[R_MERGE], r[R_PART] = merge_at, part_a
            r[R_REL:R_REL + len(rel)] = rel
            recs.append(r)
        if pieces > 1:
            merge_at += 1
            part_a += pieces * (1 if kind == GU_R else n) * TILE
    gu_items = len(recs)
    combine_at, per_tile = merge_at, (nk * rd + sd * n) * TILE

    def down(kind, job, y, j, u0, u1, share, wait):
        r = [-1] * REC
        r[R_KIND], r[R_JOB], r[R_TILE], r[R_U0], r[R_U1] = kind, job, y, u0, u1
        r[R_PIECE], r[R_NPIECES] = j, rd if kind == DN_R else sd
        r[R_MERGE], r[R_PART] = combine_at + y, y * per_tile + share * TILE
        r[R_WAIT], r[R_TARGET], r[R_BASE] = wait, released[wait], y * per_tile
        return r
    # down items of the shared expert (its ranges in order, tiles of y
    # within), then of the pairs, pair-major: in the order of the gate/up
    # tiles they wait on
    recs += [down(DN_S, 0, y, j, u0, u1, nk * rd + j * n, C_READY + nk * rd + j)
             for j, (u0, u1) in enumerate(ranges_s) for y in range(yt)]
    recs += [down(DN_R, p, y, j, u0, u1, p * rd + j, C_READY + p * rd + j)
             for p in range(nk) for j, (u0, u1) in enumerate(ranges_r) for y in range(yt)]
    n_items = len(recs)
    n_counters = combine_at + yt
    hdr = [MAGIC, n_items, n, k, h, mi, si, bits, rd, sd, n_ready, merge_at - C_READY - n_ready,
           part_a, yt * per_tile, yt, gu_items]
    table = np.array(hdr + [v for r in recs for v in r], dtype=np.int32)
    return Schedule(table, n_items, gu_items, n_ready, rd, sd, part_a, yt * per_tile,
                    n_counters)


def _table_for(device, key: tuple):
    """The schedule of `key` (schedule()'s arguments) and its table on
    `device`, made once."""
    at = (device, key)
    if at not in _tables:
        s = schedule(*key)
        _tables[at] = (s, torch.from_numpy(s.table).to(device))
    return _tables[at]


def _scratch_for(device, n_float: int, n_int: int):
    """Scratch that lives across calls, one set per device and size: the
    counters must start at zero and every launch leaves them there."""
    key = (device, n_float, n_int)
    if key not in _scratch:
        _scratch[key] = (torch.empty((n_float,), dtype=torch.float32, device=device),
                         torch.zeros((n_int,), dtype=torch.int32, device=device))
    return _scratch[key]


def moe_decode_mlp(x: torch.Tensor, layers, sel: torch.Tensor,
                   wsel: torch.Tensor, layer_index: int,
                   gate: Optional[torch.Tensor], *, config) -> torch.Tensor:
    """y [n, H] f32 = sum_k wsel * expert_sel(x) + gate * shared(x).

    x [n, H] post-norm hidden states (n <= 8); layers: LayerParams whose
    expert stacks carry [L, E, ...]; sel [n, k] expert ids and wsel [n, k]
    f32 weights of layer `layer_index`; gate [n] f32 or None. The stacks are
    read in place, experts addressed as layer_index * E + sel."""
    c = config
    n, h = x.shape
    if not supports(c, layers, n):
        raise ValueError("moe_decode_mlp: unsupported config; ask supports() first")
    gu, dn = layers.wgu_e, layers.wdown_e
    if not use_kernel(x, sel, wsel, gate, gu.packed, dn.packed):
        return moe_decode_mlp_plain(x, layers, sel, wsel, layer_index, gate,
                                    config=c)
    k, e, mi = c.num_experts_per_tok, c.num_experts, c.moe_intermediate_size
    si = c.shared_expert_intermediate_size
    nl = gu.packed.shape[0]
    if not 0 <= layer_index < nl:
        raise ValueError(f"layer_index {layer_index} outside [0, {nl})")
    for ql, kd, nd in ((gu, h, 2 * mi), (dn, mi, h)):
        check(ql.packed, "packed", torch.int8, 4)
        check(ql.scale, "scale", torch.bfloat16, 4)
        check(ql.bias, "bias", torch.bfloat16, 4)
        if ql.packed.shape != (nl, e, kd * ql.bits // 8, nd) \
                or ql.scale.shape != (nl, e, kd // ql.block_size, nd) \
                or ql.bias.shape != ql.scale.shape:
            raise ValueError("expert stack shapes disagree with L, E, K, N")
    xf = x.float().contiguous()
    sel32 = sel.to(torch.int32).contiguous()
    wf = wsel.float().contiguous()
    if sel32.shape != (n, k) or wf.shape != (n, k):
        raise ValueError(f"sel/wsel: expected {(n, k)}")
    gf = None
    if gate is not None:
        if not si:
            raise ValueError("a gate without a shared expert")
        gf = gate.float().contiguous()
        check(gf, "gate", torch.float32, 1)
    bs_sh = layers.wgu_shared.block_size if si else 0
    bs_sd = layers.wdown_shared.block_size if si else 0
    sch, table = _table_for(x.device, (n, k, h, mi, si, gu.bits, gu.block_size,
                                       dn.block_size, bs_sh, bs_sd,
                                       *launch_shape(x.device, n, gu.bits)))
    n_float = n * k * mi + n * si + sch.part_a + sch.part_b
    fbuf, ibuf = _scratch_for(x.device, n_float, sch.n_counters)
    shared = [None] * 6
    if si:
        sq, sd = layers.wgu_shared.layer(layer_index), layers.wdown_shared.layer(layer_index)
        for ql, kd, nd in ((sq, h, 2 * si), (sd, si, h)):
            check(ql.packed, "shared packed", torch.int8, 2)
            check(ql.scale, "shared scale", torch.bfloat16, 2)
            check(ql.bias, "shared bias", torch.bfloat16, 2)
            if ql.packed.shape != (kd * ql.bits // 8, nd) \
                    or ql.scale.shape != (kd // ql.block_size, nd) \
                    or ql.bias.shape != ql.scale.shape:
                raise ValueError("shared expert shapes disagree with K, N")
        shared = [t.data_ptr() for t in (sq.packed, sq.scale, sq.bias,
                                         sd.packed, sd.scale, sd.bias)]
    y = torch.empty((n, h), dtype=torch.float32, device=x.device)
    KERNEL(xf.data_ptr(), sel32.data_ptr(), wf.data_ptr(),
           None if gf is None else gf.data_ptr(),
           gu.packed.data_ptr(), gu.scale.data_ptr(), gu.bias.data_ptr(),
           dn.packed.data_ptr(), dn.scale.data_ptr(), dn.bias.data_ptr(),
           *shared, y.data_ptr(), table.data_ptr(), fbuf.data_ptr(), ibuf.data_ptr(),
           n, k, e, layer_index, h, mi, si, gu.bits, gu.block_size, dn.block_size,
           bs_sh, bs_sd, sch.n_items, sch.n_ready, sch.rd, sch.sd, sch.part_a, sch.part_b,
           n_float)
    return y
