"""Whole-model decode step in one kernel: every layer of one decode position,
then the final norm, the lm-head GEMV and the greedy argmax.

Replaces the TPU kernel `mnn_tpu/kernels/decode_model.py::_kernel` (launched
by `fused_decode_model`). CUDA source: `csrc/decode_model.cuh`, entry in
`csrc/decode_model.cu`.

Per layer: RMS norm -> qkv GEMV (+ out-bias) -> rope, optional QK-norm,
quantization of the new K/V row and a softmax seeded with that row's
dequantized round trip -> attention over the cached positions [0, len_old)
-> wo GEMV + residual -> RMS norm -> gate/up GEMV -> SwiGLU -> down GEMV +
residual. Gemma's flags (`model_flags`): sandwich norms (the wo and down
outputs RMS-normed before their residual adds, the MLP input by
`pre_ffn_norm`), GeGLU-tanh, the score softcap, gemma2's alternating and
gemma3's N:1 sliding windows, and gemma3's local rope phases (`cos_l`,
`sin_l`) on its sliding layers; head_dim 256 holds up to 4 query heads a
KV head. Weights are the stacked `QuantizedLinear` tensors as they lie
(W4 or W8, uniform over the layer); the cache holds bf16, int8 or
nibble-packed int4 rows. The new rows and scales of every layer come back,
and the residual stream leaves as f32.

The contract is the TPU kernel's, rounding point for rounding point. The
quantized product is x rounded to bf16, dotted with the unsigned pattern,
`part * s + rowsum(x) * b` per quant block with f32 accumulation. Values are
rounded to bf16 where the per-layer path crosses a kernel boundary: qkv
after its bias, o, x after each residual, gate/up, silu(gate) and its
product with up, the down output, and (sandwich) the normed o and d. q
stays f32 after rope; logits are f32 and not rounded (gemma2's logit
softcap is the caller's); the argmax takes the lowest index among equal
maxima.

What bounds it on the H100, and what the design does about it: one decode
token reads every weight byte once and does two operations per weight, far
below the card's operations-per-byte balance, so the floor is bytes; at
qwen2-0.5b's size a layer's bytes take 2.4 us, and what a layer costs is the
chain of dependent steps between its phases. The kernel is one cooperative
launch of a persistent grid. `schedule()` gives every block its ordered list
of work items for the whole step (GEMV tiles and K ranges, attention splits,
grid-wide waits) from the shapes and the grid only, as an int32 table the
kernel reads; a producer warp per block streams the weights of the block's
items into a ring of shared-memory slots ahead of any dependency, across
phase and layer boundaries; qkv -> attention, attention -> wo and gate/up ->
down are arrival counters, so only the two RMS norms and the argmax merge
wait on the whole grid. A phase of at most one item an SM stands on blocks
of distinct SMs. Where a tile's K ranges are split, their partial sums meet
in device memory and the last block to arrive adds them in a fixed order,
so results do not depend on timing. Activations sit in small scratch
buffers that stay in L2. Lengths are read from device memory: no launch
parameter and no table entry depends on them.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np
import torch

from mnn_tpu_torch.kernels.build import F, I, P, kernel, library
from mnn_tpu_torch.kernels.common import cdiv, check, use_kernel
from mnn_tpu_torch.kernels.decode_step import NEG_INF, _rms, _rope_full
from mnn_tpu_torch.kernels.dequant_matmul import dequant_matmul_plain
from mnn_tpu_torch.models.layers import split_gate_up
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache

MAX_BATCH = 8
MAX_GROUP = 8     # query heads per KV head held in registers (4 at head_dim 256)
COL_TILE = 128    # output columns per GEMV work item
K_CHUNK = 32      # quant blocks are whole multiples of this
ATT_SPLIT = 16    # most blocks that share one (batch row, KV head)
ATT_POSITIONS = 64  # cached positions a block of a (batch row, KV head) takes

# The schedule and the kernel's shared memory; the same numbers as
# csrc/decode_model.cuh (DM_*), which checks the table's header.
UNIT_ROWS = 64                               # packed rows of a tile a unit (ring slot)
SCALE_ROWS = 4                               # quant blocks a W4/W8 unit can touch
SCALE_ROWS_SUB4 = 8                          # the same at W2/W3 (8 at W2 with blocks of 32)
RING_MAX = 12
XS_K = {1: 4096, 2: 2048, 4: 1024, 8: 1024}  # K values an item's x stage holds, by BM
REC, HDR = 16, 32                            # int32 a record, the header
TAIL = 16 + 2 * REC * 4                      # stamps' count, place, two records (shared)
MAGIC = 0x444D3131
BLOCK_SMEM = {1: 232448, 2: 115712}          # a block's shared bytes at 1 or 2 blocks an SM
# How `schedule` cuts a tile's K (`_cuts`): what an item costs beside its
# units (its x stage, merge and epilogue), in units.
ITEM_UNITS = 1
CONSUMERS = 256
# counters: [0] the grid-wide wait's word, then the blocks' claims of their
# places (2 + one an SM id), then the table's arrival counters
FIRST_COUNTER = 1 + 2 + 256
KINDS = ("prologue", "qkv", "attention", "wo", "gate_up", "down", "head", "argmax",
         "barrier", "fold")
PRO, QKV, ATT, WO, GU, DN, HEAD, ARGMAX, BAR, FOLD = range(10)
(R_KIND, R_LAYER, R_TILE, R_U0, R_U1, R_PIECE, R_NPIECES, R_WAIT, R_NWAIT, R_TARGET,
 R_RELEASE, R_MERGE, R_MERGE_LAST, R_PART) = range(14)
(H_MAGIC, H_GRID, H_SLOTS, H_COUNTERS, H_PART, H_ITEMS, H_NS, H_B, H_L, H_H, H_NQ, H_I,
 H_V, H_BITS, H_HEAD_BITS, H_D, H_FLAGS, H_SWA_P) = range(18)
# the config's flags, as the header and the kernel take them
F_SANDWICH, F_GELU, F_SOFTCAP, F_SWA_ALT, F_SWA_P = 1, 2, 4, 8, 16

# int mnn_decode_model(x, lengths, cos, sin,
#     wqkv_p, wqkv_s, wqkv_b, qkv_bias, wo_p, wo_s, wo_b, wgu_p, wgu_s, wgu_b,
#     wdn_p, wdn_s, wdn_b, in_norm, post_norm, q_norm, k_norm,
#     k_cache, v_cache, k_scale, v_scale, final_norm, head_p, head_s, head_b,
#     x_out, k_rows, v_rows, k_sc, v_sc, logits, token, ws, counters, clocks,
#     pre_ffn_norm, post_ffn_norm, cos_l, sin_l,
#     B, L, H, NH, Hkv, D, I, S, V, bits, bs_h, bs_i, head_bits, bs_head,
#     kv_bits, window, sink, write_cache, ws_floats, n_counters, flags, swa_p,
#     sm_scale, eps, softcap, sched, sched_hdr, stream)
KERNEL = kernel("mnn_decode_model", [P] * 43 + [I] * 22 + [F] * 3 + [P, P])

_counters: dict = {}      # device -> int32 arrival counters, reused
_schedules: dict = {}     # (shape, grid, slots, device) -> (table, header, info)

# Set to a CUDA int64 tensor [blocks, 2048] to have a kernel built with
# -DMNN_DM_CLOCKS log its steps there (`profile_a8 --kernel model --clocks`).
EVENT_LOG: Optional[torch.Tensor] = None


def bucket(batch: int) -> int:
    """The batch rows the kernel instance holds in registers (BM)."""
    return 1 if batch == 1 else 2 if batch == 2 else 4 if batch <= 4 else 8


def max_group(head_dim: int) -> int:
    """Query heads a KV head that the attention state holds at this head dim
    (attn_common.cuh's at_gmax): 8, or 4 at head_dim 256, whose state would
    otherwise leave the ring two slots."""
    return 4 if head_dim > 128 else MAX_GROUP


def model_flags(config) -> int:
    """The config's flags for the kernel and its schedule's header."""
    c = config
    return ((F_SANDWICH if c.sandwich_norm else 0)
            | (F_GELU if c.mlp_act == "gelu_tanh" else 0)
            | (F_SOFTCAP if c.attn_softcap else 0)
            | (F_SWA_ALT if c.swa_every_other else 0)
            | (F_SWA_P if c.swa_pattern else 0))


def work_bytes(bm: int, head_dim: int) -> int:
    """A block's work area: the largest of a GEMV item's reduction and x
    stage, an attention item's state (attn_common.cuh's AttnSmem), the argmax
    merge; a multiple of 128 bytes."""
    gemv = 4 * (8 * bm * COL_TILE + bm * COL_TILE + bm * XS_K[bm] + MAX_BATCH + 4)
    g, d = max_group(head_dim), head_dim
    attn = 4 * ((g + 2) * d + 4 * d + g + 3 + 8 * g * 32 + 2 * 8 * g + 8 * g * d)
    return -(-max(gemv, attn, 2 * CONSUMERS * 4) // 128) * 128


def blocks_per_sm(bm: int) -> int:
    return 1 if bm == 8 else 2


def scale_rows(bits: int) -> int:
    """Quant blocks a unit can touch, so scale and bias rows a ring slot
    holds, for the layers' weight bits: a 64-row unit of W2 at blocks of 32
    (8 packed rows each) touches 8, of W3 at blocks of 32 (12 rows) 6."""
    return SCALE_ROWS_SUB4 if bits < 4 else SCALE_ROWS


def slot_bytes(bits: int = 4) -> int:
    """A ring slot: a unit's packed rows, then its scale and bias rows in
    pairs (the scale row of a quant block, then its bias row)."""
    return UNIT_ROWS * COL_TILE + 2 * scale_rows(bits) * COL_TILE * 2


def ring_slots(bm: int, head_dim: int, bits: int = 4) -> int:
    """Weight slots a block's ring holds beside its work area."""
    free = BLOCK_SMEM[blocks_per_sm(bm)] - work_bytes(bm, head_dim) - 16 * RING_MAX - TAIL
    return min(RING_MAX, free // slot_bytes(bits))


def smem_bytes(bm: int, head_dim: int, slots: int, bits: int = 4) -> int:
    """A block's dynamic shared memory: ring, work area, the slots'
    mbarriers, the tail (the stamps' count in MNN_DM_CLOCKS builds, the
    block's place, the current and next schedule records)."""
    return slots * slot_bytes(bits) + work_bytes(bm, head_dim) + 16 * slots + TAIL


def records_at(grid: int) -> int:
    """Where a table's records start, in int32: after the header and the
    blocks' starts (grid + 1), rounded up to a record (64-byte aligned)."""
    return HDR + -(-(grid + 1) // REC) * REC


def _library_limits(batch: int, head_dim: int, bits: int = 4) -> tuple:
    """(blocks an SM, shared bytes a block, ring slots, SMs, registers a
    thread, most threads a block, static shared bytes, local bytes a thread)
    that the built kernel gets on the current card for the layers' weight
    bits (`mnn_decode_model_limits`)."""
    fn = library().mnn_decode_model_limits
    fn.argtypes, fn.restype = [I, I, I, P], I
    out = (I * 8)()
    err = fn(batch, head_dim, bits, out)
    if err:
        raise RuntimeError(f"mnn_decode_model_limits: CUDA error {err}")
    return tuple(out)


# The kernel's limits on the card (`profile_a8` swaps it with KERNEL).
LIMITS = _library_limits
_limits: dict = {}


def _k_range(r0: int, r1: int, bs: int, bits: int) -> tuple:
    """[first K value, one past the last) of packed rows [r0, r1): a W4 row
    holds K values k and k + bs/2 of its quant block; a W2 or W3 row holds
    K values spread over its whole block, so the range is whole blocks."""
    if bits == 8:
        return r0, r1
    if bits < 4:
        rpb = bs * bits // 8
        return (r0 // rpb) * bs, ((r1 - 1) // rpb + 1) * bs
    half = bs // 2
    lo = lambda r: (r // half) * bs + r % half
    return lo(r0), lo(r1 - 1) + half + 1


def _pieces(k: int, bs: int, bits: int, tiles: int, grid: int, xs_k: int) -> list:
    """The K ranges of each tile of a phase with fewer tiles than blocks, as
    unit ranges [u0, u1), each inside the x stage of `xs_k` values: n even
    ranges, chosen for the least ceil(tiles * n / grid) * (ceil(units / n) +
    ITEM_UNITS), the items the busiest block takes times what each costs;
    more ranges on a tie (finer items even out the phases that share a
    grid-wide wait)."""
    kp = k * bits // 8
    units = -(-kp // UNIT_ROWS)

    def fits(u0, u1):
        lo, hi = _k_range(u0 * UNIT_ROWS, min(u1 * UNIT_ROWS, kp), bs, bits)
        return hi - lo <= xs_k

    best = None
    for n in range(1, units + 1):
        pieces = [(units * j // n, units * (j + 1) // n) for j in range(n)]
        if not all(fits(a, b) for a, b in pieces):
            continue
        cost = -(-tiles * n // grid) * (-(-units // n) + ITEM_UNITS)
        if best is None or cost <= best[0]:
            best = (cost, pieces)
    return best[1]


def _cuts(k: int, bs: int, bits: int, tiles: int, grid: int, xs_k: int) -> list:
    """Each tile's K ranges, a list of unit ranges [u0, u1) a tile. A phase
    with at least a tile for every block, whose tiles fit the x stage whole:
    whole tiles, `grid` of them a round, and the tiles left over (fewer than
    the grid) each cut into grid // left even ranges, one a block, so that
    every block ends the phase with about as many units and one merge at
    most. Otherwise every tile as `_pieces` cuts it."""
    units = -(-(k * bits // 8) // UNIT_ROWS)
    if tiles >= grid and _k_range(0, k * bits // 8, bs, bits)[1] <= xs_k:
        left = tiles % grid
        n = max(1, min(grid // max(left, 1), units))
        cut = [(units * j // n, units * (j + 1) // n) for j in range(n)]
        return [[(0, units)]] * (tiles - left) + [cut] * left
    return [_pieces(k, bs, bits, tiles, grid, xs_k)] * tiles


def schedule(batch: int, layers: int, hidden: int, heads: int, kv_heads: int,
             head_dim: int, inter: int, capacity: int, vocab: int, bits: int,
             bs_h: int, bs_i: int, head_bits: int, bs_head: int, grid: int,
             slots: int, sms: Optional[int] = None, flags: int = 0, swa_p: int = 0):
    """The kernel's work for one step, block by block: (table int32 numpy,
    info dict). `vocab` 0: no fused head. `flags` (`model_flags`) and
    `swa_p` go into the header; with F_SANDWICH the last layer is closed by
    a grid-wide wait too, and fold items (one a 128-column tile of the
    residual) add its normed MLP output to the residual stream that leaves.

    Items, in the order every block walks them: a grid-wide wait (the
    prologue's residual and sums of squares), then per layer the qkv tiles,
    the attention splits (b, KV head, split), the wo tiles, a grid-wide wait
    (the RMS norm needs the whole row), the gate/up tiles, the down tiles and
    another wait (before the next norm); then the head tiles, a wait and the
    argmax merge of each batch row. A GEMV tile is one item over all of K,
    or several K ranges (`_cuts`) merged by the last to arrive. Items of a
    phase go to distinct places (blocks) as far as the grid goes, each to the
    place with the fewest weight bytes since the last grid-wide wait, then
    over the step; a phase of at most `sms`
    items takes places below `sms` first, which the kernel gives to blocks
    on distinct SMs (the first block to start on each SM).

    Waits: an attention item on the qkv tiles of its KV head's columns, a wo
    range on the attention of the KV heads it reads (every batch row), a down
    range on the gate/up tiles whose outputs it reads; each counter counts
    one release a layer (the tile's last range, the KV head's last split), so
    the target is layer + 1. Merge counters count a tile's ranges (a KV
    head's active splits) a layer. The table holds a header (HDR ints:
    `H_*`), the first record of each block and one past the last (grid + 1
    ints, zero-padded to `records_at(grid)`), then REC ints a record
    (`R_*`). Nothing depends on the lengths."""
    b, d, h = batch, head_dim, hidden
    nq, dq, grp = (heads + 2 * kv_heads) * d, heads * d, heads // kv_heads
    ns = max(1, min(grid // (b * kv_heads), -(-capacity // ATT_POSITIONS), ATT_SPLIT))
    counters = [FIRST_COUNTER]

    def alloc(n):
        c = counters[0]
        counters[0] += n
        return c

    gemvs = {QKV: (h, nq, bs_h, bits), WO: (dq, h, bs_h, bits),
             GU: (h, 2 * inter, bs_h, bits), DN: (inter, h, bs_i, bits)}
    if vocab:
        gemvs[HEAD] = (h, vocab, bs_head, head_bits)
    plan, part = {}, 0
    for kind, (k, n, bs, wb) in gemvs.items():
        tiles = -(-n // COL_TILE)
        cuts = _cuts(k, bs, wb, tiles, grid, XS_K[bucket(b)])
        most = max(len(c) for c in cuts)
        merge = alloc(tiles) if most > 1 else -1
        plan[kind] = dict(k=k, n=n, bs=bs, bits=wb, kp=k * wb // 8, tiles=tiles,
                          cuts=cuts, merge=merge, part=part)
        if most > 1:
            part += most * b * n
    qkv_done = alloc(plan[QKV]["tiles"])
    gu_done = alloc(plan[GU]["tiles"])
    att_done = alloc(kv_heads * b)                  # [KV head][batch row]
    att_merge = alloc(b * kv_heads)                 # [batch row][KV head]

    lists = [[] for _ in range(grid)]
    load = [0] * grid                               # weight bytes so far, a block
    seg = [0] * grid                                # the same since the last grid-wide wait

    def rec(kind, layer, tile, u0=0, u1=0, piece=0, npieces=1, wait=0, nwait=0,
            target=0, release=-1, merge=-1, merge_last=-1, part_off=0):
        r = [kind, layer, tile, u0, u1, piece, npieces, wait, nwait, target, release,
             merge, merge_last, part_off]
        return r + [0] * (REC - len(r))

    sm_count = sms or grid

    def place(items):
        """items: [(bytes, record)], one phase: to distinct places while they
        last, each to the one with the fewest bytes since the last grid-wide
        wait (the blocks that wait there together), then over the step; a
        phase that fits the SMs on places below `sms` (one block an SM)
        first."""
        low = len(items) <= sm_count
        heap = [(0, low and i >= sm_count, seg[i], load[i], i) for i in range(grid)]
        heapq.heapify(heap)
        for nbytes, r in sorted(items, key=lambda it: -it[0]):
            cnt, high, _, _, i = heapq.heappop(heap)
            lists[i].append(r)
            load[i] += nbytes
            seg[i] += nbytes
            heapq.heappush(heap, (cnt + 1, high, seg[i], load[i], i))

    def barrier(layer, closes):
        for i, lst in enumerate(lists):
            lst.append(rec(BAR, layer, closes))
            seg[i] = 0

    def gemv_items(kind, layer):
        pl = plan[kind]
        unit_bytes = UNIT_ROWS * COL_TILE + 2 * COL_TILE * 2   # a unit's rows and planes
        items = []
        for t in range(pl["tiles"]):
            n_p = len(pl["cuts"][t])
            for j, (u0, u1) in enumerate(pl["cuts"][t]):
                lo, hi = _k_range(u0 * UNIT_ROWS, min(u1 * UNIT_ROWS, pl["kp"]), pl["bs"],
                                  pl["bits"])
                wait = nwait = 0
                if kind == WO:          # the KV heads whose outputs it reads, every row
                    h0, h1 = lo // d // grp, (hi - 1) // d // grp
                    wait, nwait = att_done + h0 * b, (h1 - h0 + 1) * b
                elif kind == DN:        # the gate/up tiles whose outputs it reads
                    t0, t1 = lo // (COL_TILE // 2), (hi - 1) // (COL_TILE // 2)
                    wait, nwait = gu_done + t0, t1 - t0 + 1
                release = {QKV: qkv_done + t, GU: gu_done + t}.get(kind, -1)
                rnd = 0 if kind == HEAD else layer
                items.append(((u1 - u0) * unit_bytes, rec(
                    kind, layer, t, u0, u1, j, n_p, wait, nwait, layer + 1, release,
                    pl["merge"] + t if n_p > 1 else -1, (rnd + 1) * n_p - 1, pl["part"])))
        place(items)

    row = d * 2                      # a cached position's K or V row, about
    barrier(0, PRO)
    for layer in range(layers):
        gemv_items(QKV, layer)
        att = []
        for bb in range(b):
            for hi in range(kv_heads):
                t0, t1 = hi * (grp + 2) * d // COL_TILE, ((hi + 1) * (grp + 2) * d - 1) // COL_TILE
                for split in range(ns):
                    att.append((2 * row * (capacity // ns), rec(
                        ATT, layer, bb * kv_heads + hi, split, ns, 0, 1, qkv_done + t0,
                        t1 - t0 + 1, layer + 1, att_done + hi * b + bb,
                        att_merge + bb * kv_heads + hi)))
        place(att)
        gemv_items(WO, layer)
        barrier(layer, WO)
        gemv_items(GU, layer)
        gemv_items(DN, layer)
        if layer + 1 < layers or vocab or flags & F_SANDWICH:
            barrier(layer, DN)
    if flags & F_SANDWICH:
        place([(0, rec(FOLD, layers, t)) for t in range(-(-h // COL_TILE))])
    if vocab:
        gemv_items(HEAD, layers)
        barrier(layers, HEAD)
        place([(0, rec(ARGMAX, layers, bb)) for bb in range(b)])

    starts = np.zeros(records_at(grid) - HDR, dtype=np.int64)
    starts[1:grid + 1] = np.cumsum([len(lst) for lst in lists])
    hdr = [0] * HDR
    hdr[H_MAGIC], hdr[H_GRID], hdr[H_SLOTS], hdr[H_COUNTERS] = MAGIC, grid, slots, counters[0]
    hdr[H_PART], hdr[H_ITEMS], hdr[H_NS] = part, int(starts[grid]), ns
    hdr[H_B], hdr[H_L] = b, layers
    hdr[H_H], hdr[H_NQ], hdr[H_I], hdr[H_V] = h, nq, inter, vocab
    hdr[H_BITS], hdr[H_HEAD_BITS], hdr[H_D] = bits, head_bits if vocab else 0, d
    hdr[H_FLAGS], hdr[H_SWA_P] = flags, swa_p
    records = [r for lst in lists for r in lst]
    table = np.concatenate([np.asarray(hdr, dtype=np.int64), starts,
                            np.asarray(records, dtype=np.int64).reshape(-1)]).astype(np.int32)
    per_kind = {}
    for r in records:
        if r[R_KIND] != BAR and (r[R_KIND] == HEAD or r[R_LAYER] == 0):
            per_kind[KINDS[r[R_KIND]]] = per_kind.get(KINDS[r[R_KIND]], 0) + 1
    info = dict(grid=grid, slots=slots, ring_bytes=slots * slot_bytes(bits),
                bytes_in_flight=grid * slots * slot_bytes(bits),
                items_a_layer=per_kind, grid_waits_a_layer=2,
                att_split=ns,
                k_ranges={KINDS[k]: len(v["cuts"][-1]) for k, v in plan.items()},
                cut_tiles={KINDS[k]: sum(len(c) > 1 for c in v["cuts"])
                           for k, v in plan.items()},
                units={KINDS[k]: [u1 - u0 for u0, u1 in v["cuts"][-1]] for k, v in plan.items()},
                counters=counters[0], part_floats=part, items=int(starts[grid]),
                max_block_bytes=max(load), mean_block_bytes=sum(load) / grid)
    return table, info


def _schedule_for(config, batch: int, capacity: int, lay, head, dev):
    """`schedule` for a call on `dev`, cached per shape and device: (the
    table on the device, its header on the host, info). The grid is every
    block co-resident: 2 an SM (1 at 8 batch rows), or 1 where the card
    holds no more; below one block an SM the kernel cannot run, and this
    raises."""
    c = config
    bm = bucket(batch)
    bits = lay.wqkv.bits
    lk = (LIMITS, bm, c.head_dim, bits, str(dev))
    if lk not in _limits:
        with torch.cuda.device(dev):
            _limits[lk] = LIMITS(bm, c.head_dim, bits)
    per_sm, _, slots, sms = _limits[lk][:4]
    planned = ring_slots(bm, c.head_dim, bits)
    if per_sm < 1 or slots != planned:
        raise RuntimeError(f"the decode kernel does not fit the card: {per_sm} blocks an "
                           f"SM, {slots} ring slots (planned {planned})")
    grid = sms * min(per_sm, blocks_per_sm(bm))
    args = (batch, c.num_layers, c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim,
            c.intermediate_size, capacity, head.out_features if head is not None else 0,
            lay.wqkv.bits, lay.wqkv.block_size, lay.wdown.block_size,
            head.bits if head is not None else 0, head.block_size if head is not None else 0,
            grid, slots, sms, model_flags(c), c.swa_pattern)
    key = args + (str(dev),)
    hit = _schedules.get(key)
    if hit is None:
        table, info = schedule(*args)
        hit = _schedules[key] = (torch.from_numpy(table).to(dev), table[:HDR].copy(), info)
    return hit


def schedule_info(config, layers, head, batch: int, capacity: int, dev) -> dict:
    """What `schedule` gives a call of these shapes on `dev`: grid, ring
    slots and bytes, items a phase in a layer, grid-wide waits a layer, the
    K ranges of a phase's last tile (the cut ones stand last) and its units,
    the tiles cut, counters and the bytes a block streams."""
    return _schedule_for(config, batch, capacity, layers, head, dev)[2]


def supports(config, params, cache, batch: int) -> bool:
    """Can the whole-model kernel serve a decode step of this (config,
    weights, cache, batch)? False sends `forward` down the per-layer path.
    Gemma's flags (gelu-tanh, sandwich norms, score softcap, alternating and
    N:1 windows, dual rope) are kernel flags; head_dim 256 takes an int8 or
    bf16 cache and up to 4 query heads a KV head. Weights: W2, W3, W4 or
    W8, the same for all four projections. Multimodal rope needs nothing of
    the kernel (its phases come in as cos/sin), as in the JAX package."""
    c = config
    if c.is_moe or c.kv_rotate:
        return False
    if c.mlp_act not in ("silu", "gelu_tanh"):
        return False
    # a TQ3 or TQ4 codebook cache is refused, as in the JAX package: TQ4
    # shares int4's layout, and the kernel's unpack knows no codebook
    if cache.bits not in (4, 8, 16) or getattr(cache, "codebook", False) \
            or not 1 <= batch <= MAX_BATCH:
        return False
    if c.head_dim not in (64, 128, 256) or (c.head_dim == 256 and cache.bits == 4):
        return False
    if c.num_heads % c.num_kv_heads or c.num_heads // c.num_kv_heads > max_group(c.head_dim):
        return False
    lay = params.layers
    if c.sandwich_norm and (lay.pre_ffn_norm is None or lay.post_ffn_norm is None):
        return False
    for ql in (lay.wqkv, lay.wo, lay.wgu, lay.wdown):
        if ql.act_bits != 16 or ql.bits not in (2, 3, 4, 8) or ql.bits != lay.wqkv.bits:
            return False
        if ql.out_bias is not None and ql is not lay.wqkv:
            return False
        if ql.block_size % K_CHUNK or ql.out_features % 4:
            return False
    bs_h, bs_i = lay.wqkv.block_size, lay.wdown.block_size
    if lay.wo.block_size != bs_h or lay.wgu.block_size != bs_h:
        return False
    if c.hidden_size % bs_h or c.q_dim % bs_h or c.intermediate_size % bs_i:
        return False
    # the in-kernel gate/up split assumes the 64-block interleave
    if c.intermediate_size % 64:
        return False
    return cache.capacity % min(512, cache.capacity) == 0


def supports_head(config, params) -> bool:
    """Can the final norm, the lm-head GEMV and the greedy argmax run inside
    the kernel? Needs a quantized (int4/int8) head with bf16 rows and no
    out-bias over a 128-aligned vocabulary (gemma2's 256,000: yes; gemma3's
    262,208: no, its head runs on the GEMV kernel). A logit softcap is the
    caller's, after the kernel: it moves no argmax. A W2 or W3 head stays on
    the GEMV kernel, as the JAX package keeps sub-4-bit heads out of its
    kernel's head fusion."""
    head = params.lm_head
    if not isinstance(head, QuantizedLinear):
        return False
    if head.bits not in (4, 8) or head.act_bits != 16 or head.out_bias is not None:
        return False
    if head.packed.dim() != 2 or head.block_size % K_CHUNK:
        return False
    return config.vocab_size % 128 == 0 and config.hidden_size % head.block_size == 0


def _bf16r(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _qmm(x: torch.Tensor, ql: QuantizedLinear) -> torch.Tensor:
    """x [B, K] f32 @ one layer's packed weights -> f32 [B, N], unrounded:
    the kernel's algebra (`dequant_matmul_plain` without bias or rounding)."""
    no_bias = QuantizedLinear(packed=ql.packed, scale=ql.scale, bias=ql.bias,
                              out_bias=None, bits=ql.bits,
                              block_size=ql.block_size, act_bits=16)
    return dequant_matmul_plain(x, no_bias, torch.float32)


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 levels [..., D] f32 -> packed bytes [..., D/2] held in f32."""
    d = q.shape[-1]
    qi = q.to(torch.int32) + 8
    byte = qi[..., :d // 2] | (qi[..., d // 2:] << 4)
    return torch.where(byte > 127, byte - 256, byte).float()


def _quant_kv(x: torch.Tensor, qmax: float):
    """A new K or V row [..., D] f32 -> (levels, scale [..., 1]) on the row's
    absolute maximum, as the kernel stores it."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    sc = torch.where(amax == 0, torch.ones_like(amax), amax / qmax)
    return (x / sc).round().clamp(-qmax - 1, qmax), sc


def _attend_plain(qkv, k_cache, v_cache, k_scale, v_scale, layer, lengths,
                  cos, sin, q_norm, k_norm, eps, sm_scale, window, sink, bits,
                  softcap=0.0):
    """One layer's attention phase on grouped rows qkv [B, Hkv, G+2, D] f32:
    (att [B, H*D] f32, stored K row, V row [B, Hkv, 1, D or D/2] f32,
    scales [B, Hkv, 1] or None)."""
    b, hkv, r, d = qkv.shape
    g = r - 2
    q, kr, vr = qkv[:, :, :g], qkv[:, :, g:g + 1], qkv[:, :, g + 1:]
    if q_norm is not None:
        q = _rms(q, q_norm.float(), eps)
        kr = _rms(kr, k_norm.float(), eps)
    c = cos.float()[:, None, None]
    s_ = sin.float()[:, None, None]
    q = _rope_full(q, c, s_)
    kr = _rope_full(kr, c, s_)
    if bits < 16:
        qmax = 127.0 if bits == 8 else 7.0
        kq, ksc = _quant_kv(kr, qmax)
        vq, vsc = _quant_kv(vr, qmax)
        k_att, v_att = kq * ksc, vq * vsc
        k_row, v_row = (_pack4(kq), _pack4(vq)) if bits == 4 else (kq, vq)
        ksc, vsc = ksc[..., 0], vsc[..., 0]
    else:
        k_row = k_att = _bf16r(kr)
        v_row = v_att = _bf16r(vr)
        ksc = vsc = None
    def cap(v):
        return torch.tanh(v / softcap) * softcap if softcap else v

    s_new = cap((q @ k_att.transpose(-1, -2)) * sm_scale)         # [B,Hkv,G,1]
    if bits == 4:
        kt = kvcache.unpack_kv4(k_cache[layer])
        vt = kvcache.unpack_kv4(v_cache[layer])
    else:
        kt, vt = k_cache[layer].float(), v_cache[layer].float()   # [B,Hkv,S,D]
    s = q @ kt.transpose(-1, -2)                                  # [B,Hkv,G,S]
    if bits < 16:
        s = s * k_scale[layer][:, :, None, :]
    s = cap(s * sm_scale)
    col = torch.arange(kt.shape[2], device=qkv.device)
    len_old = lengths.to(torch.int64)[:, None, None, None]
    mask = col < len_old
    if window:
        in_window = col > len_old - window
        if sink:
            in_window = in_window | (col < sink)
        mask = mask & in_window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.maximum(s_new, s.amax(dim=-1, keepdim=True))
    p_new = torch.exp(s_new - m)
    p = torch.exp(s - m)
    pv = p * v_scale[layer][:, :, None, :] if bits < 16 else p
    l = p_new + p.sum(dim=-1, keepdim=True)
    att = (p_new * v_att + pv @ vt) / l
    return att.reshape(b, hkv * g * d), k_row, v_row, ksc, vsc


def lowest_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis that takes the lowest index among equal
    maxima, as the kernel does (`torch.argmax` does not promise that)."""
    m = logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    big = torch.full_like(idx, logits.shape[-1])
    return torch.where(logits == m, idx, big).amin(dim=-1).to(torch.int32)


def _kv_bits(config, k_cache: torch.Tensor) -> int:
    if k_cache.dtype == torch.int8:
        return 4 if k_cache.shape[-1] * 2 == config.head_dim else 8
    return 16


def fused_decode_model_plain(x, layers, k_cache, v_cache, k_scale, v_scale,
                             lengths, cos, sin, *, config, head=None,
                             final_norm=None, cos_l=None, sin_l=None):
    """Plain PyTorch version of the kernel, on whole rows: the same algebra
    and rounding points, f32 sums in another order."""
    from mnn_tpu_torch.models.decoder import layer_window, local_rope

    c = config
    b = x.shape[0]
    hkv, d = c.num_kv_heads, c.head_dim
    g = c.num_heads // hkv
    bits = _kv_bits(c, k_cache)
    sm_scale = c.query_scale if c.query_scale else 1.0 / (d ** 0.5)
    eps = c.rms_norm_eps
    xs = x.float()
    k_rows, v_rows, k_scs, v_scs = [], [], [], []
    for i in range(c.num_layers):
        rn = _rms(xs, layers.input_norm[i].float(), eps)
        qkv = _qmm(rn, layers.wqkv.layer(i))
        if layers.wqkv.out_bias is not None:
            qkv = qkv + layers.wqkv.out_bias[i]
        qkv = _bf16r(qkv).reshape(b, hkv, g + 2, d)
        local = local_rope(c, i)
        att, k_row, v_row, ksc, vsc = _attend_plain(
            qkv, k_cache, v_cache, k_scale, v_scale, i, lengths,
            cos_l if local else cos, sin_l if local else sin,
            layers.q_norm[i] if c.qk_norm else None,
            layers.k_norm[i] if c.qk_norm else None,
            eps, sm_scale, layer_window(c, i), c.attention_sink, bits,
            c.attn_softcap)
        k_rows.append(k_row)
        v_rows.append(v_row)
        k_scs.append(ksc)
        v_scs.append(vsc)
        o = _bf16r(_qmm(att, layers.wo.layer(i)))
        if c.sandwich_norm:     # the attention output normed before its add
            o = _bf16r(_rms(o, layers.post_norm[i].float(), eps))
        xs = _bf16r(xs + o)
        rn2 = _rms(xs, (layers.pre_ffn_norm if c.sandwich_norm
                        else layers.post_norm)[i].float(), eps)
        gate, up = split_gate_up(_bf16r(_qmm(rn2, layers.wgu.layer(i))))
        if c.mlp_act == "gelu_tanh":
            act = _bf16r(_bf16r(torch.nn.functional.gelu(gate, approximate="tanh")) * up)
        else:
            act = _bf16r(_bf16r(gate * torch.sigmoid(gate)) * up)
        dn = _bf16r(_qmm(act, layers.wdown.layer(i)))
        if c.sandwich_norm:
            dn = _bf16r(_rms(dn, layers.post_ffn_norm[i].float(), eps))
        xs = _bf16r(xs + dn)
    outs = (xs, torch.stack(k_rows), torch.stack(v_rows),
            torch.stack(k_scs) if bits < 16 else None,
            torch.stack(v_scs) if bits < 16 else None)
    if head is None:
        return outs
    logits = _qmm(_rms(xs, final_norm.float(), eps), head)
    return outs + (logits, lowest_argmax(logits))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_decode_model(
    x: torch.Tensor,                 # [B, hidden] embedding rows
    layers,                          # LayerParams, stacked [L, ...]
    k_cache: torch.Tensor,           # [L, B, Hkv, S, D] bf16/int8, [.., D/2] int4
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [L, B, Hkv, S] f32 (quantized cache)
    v_scale: Optional[torch.Tensor],
    lengths: torch.Tensor,           # [B] int32 pre-append lengths
    cos: torch.Tensor,               # [B, D] f32 full-width rope phases
    sin: torch.Tensor,
    *,
    config,
    head: Optional[QuantizedLinear] = None,   # [hidden, vocab] to fuse
    final_norm: Optional[torch.Tensor] = None,  # [hidden] (with head)
    write_cache: bool = False,
    cos_l: Optional[torch.Tensor] = None,   # [B, D] gemma3's local rope phases
    sin_l: Optional[torch.Tensor] = None,
):
    """Run all decoder layers for one decode position in one kernel.

    Returns (x_out [B, hidden] f32, k_rows [L, B, Hkv, 1, D or D/2] f32,
    v_rows, k_sc [L, B, Hkv, 1] f32 or None, v_sc): the rows are the stored
    values of the new token (int4 rows as packed bytes held in f32). With
    `head` (gate: `supports_head`) two more results follow: logits [B, vocab]
    f32 and the greedy token [B] int32. With `write_cache` the kernel also
    writes the rows into the cache at each sequence's clamped length, in
    place (CUDA tensors only); otherwise `scatter_rows` does it. A config
    with `swa_pattern` (gemma3) needs `cos_l`/`sin_l`, the phases of its
    sliding layers."""
    c = config
    if head is not None and final_norm is None:
        raise ValueError("head fusion requires final_norm")
    if c.swa_pattern and (cos_l is None or sin_l is None):
        raise ValueError("a swa_pattern config needs the local rope phases cos_l/sin_l")
    if not use_kernel(x, layers.wqkv.packed, k_cache, lengths, cos):
        if write_cache:
            raise ValueError("write_cache is the CUDA kernel's; on the CPU "
                             "use scatter_rows")
        return fused_decode_model_plain(
            x, layers, k_cache, v_cache, k_scale, v_scale, lengths, cos, sin,
            config=c, head=head, final_norm=final_norm, cos_l=cos_l, sin_l=sin_l)
    b, h = x.shape
    nl, hkv, d, inter = c.num_layers, c.num_kv_heads, c.head_dim, c.intermediate_size
    g = c.num_heads // hkv
    nq = (c.num_heads + 2 * hkv) * d
    kv_bits = _kv_bits(c, k_cache)
    s, d_store = k_cache.shape[3], k_cache.shape[4]
    lay = layers
    bits, bs_h, bs_i = lay.wqkv.bits, lay.wqkv.block_size, lay.wdown.block_size
    if (d not in (64, 128, 256) or not 1 <= g <= max_group(d) or not 1 <= b <= MAX_BATCH
            or h != c.hidden_size or inter % 64 or bits not in (2, 3, 4, 8)
            or (d == 256 and kv_bits == 4)):
        raise ValueError(f"{c.name}: shapes outside the decode kernel's range")
    for ql, k_dim, n_dim, bs in ((lay.wqkv, h, nq, bs_h), (lay.wo, c.q_dim, h, bs_h),
                                 (lay.wgu, h, 2 * inter, bs_h),
                                 (lay.wdown, inter, h, bs_i)):
        if ql.bits != bits or ql.act_bits != 16 or ql.block_size != bs \
                or bs % K_CHUNK or k_dim % bs or n_dim % 4:
            raise ValueError("the decode kernel needs uniform W2/W3/W4/W8 weights "
                             "with bf16 rows and 32-aligned quant blocks")
        check(ql.packed, "packed", torch.int8, 3)
        check(ql.scale, "scale", torch.bfloat16, 3)
        check(ql.bias, "bias", torch.bfloat16, 3)
        if ql.packed.shape != (nl, k_dim * bits // 8, n_dim) \
                or ql.scale.shape != (nl, k_dim // bs, n_dim) \
                or ql.bias.shape != ql.scale.shape:
            raise ValueError("stacked weight shapes disagree with the config")
        if ql.out_bias is not None and ql is not lay.wqkv:
            raise ValueError("only the qkv projection may carry an out-bias")
    if lay.wqkv.out_bias is not None:
        check(lay.wqkv.out_bias, "qkv out_bias", torch.float32, 2)
    check(k_cache, "k_cache", torch.bfloat16 if kv_bits == 16 else torch.int8, 5)
    check(v_cache, "v_cache", k_cache.dtype, 5)
    if k_cache.shape != (nl, b, hkv, s, d_store) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} disagrees with the config")
    if kv_bits < 16:
        check(k_scale, "k_scale", torch.float32, 4)
        check(v_scale, "v_scale", torch.float32, 4)
    norms = [(lay.input_norm, "input_norm"), (lay.post_norm, "post_norm")]
    if c.sandwich_norm:
        norms += [(lay.pre_ffn_norm, "pre_ffn_norm"), (lay.post_ffn_norm, "post_ffn_norm")]
    for t, name in norms:
        check(t, name, torch.float32, 2)
    qn = kn = None
    if c.qk_norm:
        qn, kn = lay.q_norm.float().contiguous(), lay.k_norm.float().contiguous()
    vocab = head_bits = bs_head = 0
    fnorm = None
    if head is not None:
        vocab, head_bits, bs_head = head.out_features, head.bits, head.block_size
        if head_bits not in (4, 8) or head.act_bits != 16 or head.out_bias is not None \
                or bs_head % K_CHUNK or h % bs_head or vocab % 4:
            raise ValueError("lm head outside the decode kernel's range "
                             "(see supports_head)")
        check(head.packed, "head packed", torch.int8, 2)
        check(head.scale, "head scale", torch.bfloat16, 2)
        check(head.bias, "head bias", torch.bfloat16, 2)
        fnorm = final_norm.float().contiguous()
    dev = x.device
    x = x.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    if c.swa_pattern:
        cos_l, sin_l = cos_l.float().contiguous(), sin_l.float().contiguous()
    else:
        cos_l = sin_l = None
    f32 = dict(dtype=torch.float32, device=dev)
    x_out = torch.empty((b, h), **f32)
    k_rows = torch.empty((nl, b, hkv, 1, d_store), **f32)
    v_rows = torch.empty_like(k_rows)
    k_sc = torch.empty((nl, b, hkv, 1), **f32) if kv_bits < 16 else None
    v_sc = torch.empty_like(k_sc) if kv_bits < 16 else None
    logits = torch.empty((b, vocab), **f32) if head is not None else None
    token = torch.empty((b,), dtype=torch.int32, device=dev) if head is not None else None
    table, hdr, _ = _schedule_for(c, b, s, lay, head, dev)
    # scratch: qkv, att, act, the sandwich rows (o, d, the mid-layer
    # residual), the per-tile sums of squares (x, o, d), the head's maxima,
    # the attention splits' states, the K ranges' partial sums
    ws_floats = (b * (nq + c.q_dim + inter + 3 * h) + 3 * MAX_BATCH * cdiv(h, COL_TILE)
                 + 2 * b * cdiv(max(vocab, 1), COL_TILE)
                 + b * hkv * int(hdr[H_NS]) * MAX_GROUP * (d + 2) + int(hdr[H_PART]) + 64)
    ws = torch.empty((ws_floats,), **f32)
    n_counters = int(hdr[H_COUNTERS])
    cnt = _counters.get(dev)
    if cnt is None or cnt.numel() < n_counters:
        cnt = _counters[dev] = torch.zeros((n_counters,), dtype=torch.int32, device=dev)
    clocks = EVENT_LOG
    if clocks is not None and (clocks.dtype != torch.int64 or clocks.device != dev
                               or clocks.numel() < int(hdr[H_GRID]) * 2048):
        raise ValueError("EVENT_LOG: an int64 tensor on the kernel's device, "
                         "2048 entries a block")
    KERNEL(x.data_ptr(), lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(),
           lay.wqkv.packed.data_ptr(), lay.wqkv.scale.data_ptr(),
           lay.wqkv.bias.data_ptr(), _ptr(lay.wqkv.out_bias),
           lay.wo.packed.data_ptr(), lay.wo.scale.data_ptr(), lay.wo.bias.data_ptr(),
           lay.wgu.packed.data_ptr(), lay.wgu.scale.data_ptr(), lay.wgu.bias.data_ptr(),
           lay.wdown.packed.data_ptr(), lay.wdown.scale.data_ptr(),
           lay.wdown.bias.data_ptr(), lay.input_norm.data_ptr(),
           lay.post_norm.data_ptr(), _ptr(qn), _ptr(kn),
           k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
           _ptr(fnorm), _ptr(None if head is None else head.packed),
           _ptr(None if head is None else head.scale),
           _ptr(None if head is None else head.bias),
           x_out.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(), _ptr(k_sc),
           _ptr(v_sc), _ptr(logits), _ptr(token), ws.data_ptr(), cnt.data_ptr(),
           _ptr(clocks), _ptr(lay.pre_ffn_norm if c.sandwich_norm else None),
           _ptr(lay.post_ffn_norm if c.sandwich_norm else None), _ptr(cos_l), _ptr(sin_l),
           b, nl, h, c.num_heads, hkv, d, inter, s, vocab, bits, bs_h, bs_i,
           head_bits, bs_head, kv_bits, int(c.sliding_window), int(c.attention_sink),
           int(write_cache), ws_floats, cnt.numel(), model_flags(c), int(c.swa_pattern),
           float(c.query_scale if c.query_scale else 1.0 / (d ** 0.5)),
           float(c.rms_norm_eps), float(c.attn_softcap), table.data_ptr(), hdr.ctypes.data)
    outs = (x_out, k_rows, v_rows, k_sc, v_sc)
    return outs if head is None else outs + (logits, token)


scatter_rows = kvcache.scatter_rows


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def parity_metrics(got, want, kv_bits: int) -> dict:
    """How far two results of `fused_decode_model` (kernel and plain, or two
    packages) lie apart, from the same state. The f32 sums run in another
    order, which can flip a bf16 rounding and with it a quantization level,
    so rows are compared as levels only in layer 0, whose input is identical,
    and as dequantized values (level x scale) over all layers.

    x_rel, logits_rel, rows_rel: rel-L2; row0_levels, rows_levels: largest
    level difference in layer 0 and in all layers (value difference for a
    bf16 cache); scale0_rel: largest relative scale difference in layer 0;
    token_ok: tokens equal, or the top-2 margin of `want` is within the
    largest logit difference."""
    def levels(rows):
        if kv_bits == 4:
            return kvcache.unpack_kv4(rows.to(torch.int8))
        return rows.float()

    out = dict(x_rel=_rel(got[0], want[0]))
    row0, rows_lv, scale0, rows_rel = 0.0, 0.0, 0.0, 0.0
    for j in (1, 2):
        lg, lw = levels(got[j]), levels(want[j])
        row0 = max(row0, float((lg[0] - lw[0]).abs().max()))
        rows_lv = max(rows_lv, float((lg - lw).abs().max()))
        if kv_bits < 16:
            sg, sw = got[j + 2], want[j + 2]
            scale0 = max(scale0, float(((sg[0] - sw[0]).abs() / sw[0].abs()).max()))
            lg, lw = lg * sg[..., None], lw * sw[..., None]
        rows_rel = max(rows_rel, _rel(lg, lw))
    out.update(row0_levels=row0, rows_levels=rows_lv, scale0_rel=scale0,
               rows_rel=rows_rel)
    if len(want) == 7:
        diff = float((got[5] - want[5]).abs().max())
        top2 = want[5].float().topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > diff
        out.update(logits_rel=_rel(got[5], want[5]), logits_max_abs=diff,
                   tokens_compared=int(clear.sum()),
                   token_ok=bool((got[6] == want[6])[clear].all()))
    return out


# the bounds the tests and the smoke run hold parity_metrics to
PARITY_BOUNDS = dict(x_rel=2e-2, logits_rel=5e-2, row0_levels=1.0,
                     scale0_rel=8e-3, rows_rel=3e-2)


def parity_failures(metrics: dict, skip=(), **bounds) -> list:
    """The names of the metrics outside PARITY_BOUNDS (empty: all hold),
    leaving out those named in `skip`; `bounds` replaces or adds limits."""
    bad = [k for k, lim in {**PARITY_BOUNDS, **bounds}.items()
           if k in metrics and k not in skip and not metrics[k] <= lim]
    if not metrics.get("token_ok", True):
        bad.append("token_ok")
    return bad
