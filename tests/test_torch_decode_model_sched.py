"""The whole-model decode kernel's static schedule, on the CPU.

`decode_model.schedule()` builds the int32 table the CUDA kernel walks: every
block's ordered list of items for one decode step (GEMV tiles and K ranges,
attention splits, grid-wide waits, the argmax merge) with the arrival
counters each item waits on, releases and merges through. The kernel cannot
run here, so these tests hold the table itself, at every shape serving
gives the kernel (qwen2-0.5b, qwen2-7b, llama3.2-1b and 3b, the 3-layer
`mk-test` shape, with and without the fused head, batch 1, 2, 4 and 8, grids
of 132 and 264 blocks):

* coverage: every (phase, layer, tile, K range) and (layer, batch row, KV
  head, split) item appears exactly once, the K ranges of a tile cover its
  units in order, and every block holds the same grid-wide waits;
* order: each block's list runs in phase order, and every wait names
  counters released by items of an earlier phase;
* no deadlock: a simulation walks the blocks' lists in order, releasing a
  counter when a tile's last range (a KV head's last split) is done, with
  all or one of a head's splits active; every block reaches its end;
* counts: a wait's target is the number of releases its counter gets up to
  that layer, a merge's last arrival the number of ranges up to that layer;
* resources: the ring and the work area fit a block's shared memory, an
  item's x range fits the x stage, the scratch regions do not overlap;
* lengths: the schedule takes none, and the same shapes give the same table.
"""

import inspect

import numpy as np
import pytest

from mnn_tpu_torch.kernels import decode_model as dm
from mnn_tpu_torch.models.config import PRESETS, ModelConfig

MK = ModelConfig(name="mk-test", vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=10000.0, attention_bias=True, tie_word_embeddings=True)
MODELS = {"qwen2-0.5b": (PRESETS["qwen2-0.5b"], 1024), "qwen2-7b": (PRESETS["qwen2-7b"], 1024),
          "llama3.2-1b": (PRESETS["llama3.2-1b"], 1024),
          "llama3.2-3b": (PRESETS["llama3.2-3b"], 1024), "mk-test": (MK, 128)}
# phase order inside a layer (a grid-wide wait closes wo and down)
ORDER = {dm.QKV: 0, dm.ATT: 1, dm.WO: 2, dm.GU: 4, dm.DN: 5}


def build(model, batch, grid, head, bits=4):
    cfg, cap = MODELS[model]
    bm = dm.bucket(batch)
    slots = dm.ring_slots(bm, cfg.head_dim)
    args = (batch, cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.intermediate_size, cap, cfg.vocab_size if head else 0, bits,
            128, 128, 4 if head else 0, 128 if head else 0, grid, slots, 132)
    table, info = dm.schedule(*args)
    return cfg, cap, args, table, info


def split_table(table):
    hdr = table[:dm.HDR]
    grid = int(hdr[dm.H_GRID])
    starts = table[dm.HDR:dm.HDR + grid + 1].astype(np.int64)
    assert not table[dm.HDR + grid + 1:dm.records_at(grid)].any()   # padding
    recs = table[dm.records_at(grid):].reshape(-1, dm.REC).astype(np.int64)
    assert starts[0] == 0 and starts[-1] == len(recs) == hdr[dm.H_ITEMS]
    recs = recs.tolist()
    return hdr, [recs[starts[i]:starts[i + 1]] for i in range(grid)]


def phase(r, layers):
    """The rank of a record's phase over the whole step."""
    kind, layer = int(r[dm.R_KIND]), int(r[dm.R_LAYER])
    if kind == dm.BAR:
        closes = int(r[dm.R_TILE])
        if closes == dm.PRO:
            return -1
        if closes == dm.HEAD:
            return 8 * layers + 1
        return 8 * layer + (3 if closes == dm.WO else 6)
    if kind == dm.HEAD:
        return 8 * layers
    if kind == dm.ARGMAX:
        return 8 * layers + 2
    return 8 * layer + ORDER[kind]


def plan_of(cfg, bits, grid, batch, head):
    """Each GEMV kind's (K, N, block, bits, each tile's K ranges) as
    `schedule` plans them."""
    h, nq = cfg.hidden_size, (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    kinds = {dm.QKV: (h, nq, 128, bits), dm.WO: (cfg.q_dim, h, 128, bits),
             dm.GU: (h, 2 * cfg.intermediate_size, 128, bits),
             dm.DN: (cfg.intermediate_size, h, 128, bits)}
    if head:
        kinds[dm.HEAD] = (h, cfg.vocab_size, 128, 4)
    return {k: (kk, n, bs, wb, dm._cuts(kk, bs, wb, -(-n // 128), grid,
                                        dm.XS_K[dm.bucket(batch)]))
            for k, (kk, n, bs, wb) in kinds.items()}


CASES = [(model, head, batch, grid) for model in MODELS for head in (True, False)
         for batch in (1, 2, 4, 8) for grid in (132, 264)]


@pytest.mark.parametrize("model,head,batch,grid", CASES)
def test_schedule_covers_orders_and_cannot_deadlock(model, head, batch, grid):
    cfg, cap, args, table, info = build(model, batch, grid, head)
    hdr, lists = split_table(table)
    layers, hkv, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    slots, ns = int(hdr[dm.H_SLOTS]), int(hdr[dm.H_NS])
    grp = cfg.num_heads // hkv
    plan = plan_of(cfg, 4, grid, batch, head)
    assert hdr[dm.H_MAGIC] == dm.MAGIC and hdr[dm.H_GRID] == grid and hdr[dm.H_B] == batch
    assert hdr[dm.H_L] == layers and hdr[dm.H_V] == (cfg.vocab_size if head else 0)
    assert 1 <= ns <= dm.ATT_SPLIT and ns <= max(1, grid // (batch * hkv))

    # resources: ring and work area in a block's shared memory, x ranges in the stage
    bm = dm.bucket(batch)
    assert slots >= 2
    assert dm.smem_bytes(bm, d, slots) <= dm.BLOCK_SMEM[dm.blocks_per_sm(bm)]
    for kind, (k, n, bs, wb, cuts) in plan.items():
        kp = k * wb // 8
        units, tiles = -(-kp // dm.UNIT_ROWS), -(-n // 128)
        assert len(cuts) == tiles
        for u0, u1 in {p for cut in cuts for p in cut}:
            lo, hi = dm._k_range(u0 * dm.UNIT_ROWS, min(u1 * dm.UNIT_ROWS, kp), bs, wb)
            assert 0 < hi - lo <= dm.XS_K[bm]

    # coverage: each item exactly once; the same grid-wide waits in every block
    seen = {}
    bars = None
    for blk, recs in enumerate(lists):
        mine = [tuple(int(v) for v in r[:3]) for r in recs if r[dm.R_KIND] == dm.BAR]
        bars = mine if bars is None else bars
        assert mine == bars, blk
        for r in recs:
            kind = int(r[dm.R_KIND])
            if kind == dm.BAR:
                continue
            key = tuple(int(v) for v in r[:4]) + (int(r[dm.R_PIECE]),)
            assert key not in seen, key
            seen[key] = (blk, r)
    want = 0
    for kind, (k, n, bs, wb, cuts) in plan.items():
        rounds = [layers] if kind == dm.HEAD else range(layers)
        for layer in rounds:
            for t, pieces in enumerate(cuts):
                for j, (u0, u1) in enumerate(pieces):
                    _, r = seen[(kind, layer, t, u0, j)]
                    assert r[dm.R_U1] == u1 and r[dm.R_NPIECES] == len(pieces)
                    want += 1
        for pieces in cuts:
            assert [p[0] for p in pieces] == [0] + [p[1] for p in pieces[:-1]]
            assert pieces[-1][1] == -(-(k * wb // 8) // dm.UNIT_ROWS)

    # balance: no block takes more of a phase's units (and ITEM_UNITS an
    # item) than whole tiles dealt in turn would give the busiest one
    for kind, (k, n, bs, wb, cuts) in plan.items():
        units, tiles = -(-(k * wb // 8) // dm.UNIT_ROWS), len(cuts)
        if _k_range_fits(k, bs, wb, bm):
            layer = layers if kind == dm.HEAD else 0
            per_block = [sum(int(r[dm.R_U1] - r[dm.R_U0]) + dm.ITEM_UNITS for r in recs
                             if r[dm.R_KIND] == kind and r[dm.R_LAYER] == layer)
                         for recs in lists]
            assert max(per_block) <= -(-tiles // grid) * (units + dm.ITEM_UNITS), kind
    for layer in range(layers):
        for bh in range(batch * hkv):
            for split in range(ns):
                assert (dm.ATT, layer, bh, split, 0) in seen
                want += 1
    if head:
        for b in range(batch):
            assert (dm.ARGMAX, layers, b, 0, 0) in seen
            want += 1
    assert len(seen) == want
    assert len(bars) == (2 * layers + 2 if head else 2 * layers)   # 2 a layer, 1 + 1 around

    # order: phases in order in every list; waits on earlier phases' releases
    released = {}                   # counter -> {layer: {(phase, kind, tile)}}
    for _, r in seen.values():
        if r[dm.R_RELEASE] >= 0:
            released.setdefault(r[dm.R_RELEASE], {}).setdefault(r[dm.R_LAYER], set()).add(
                (phase(r, layers), r[dm.R_KIND], r[dm.R_TILE]))
    for by_layer in released.values():
        # one producer unit a layer, in every layer: the target (layer + 1)
        # counts the releases up to the waiting item's layer
        assert sorted(by_layer) == list(range(layers))
        assert all(len({u[1:] for u in units}) == 1 for units in by_layer.values())
    for recs in lists:
        ranks = [phase(r, layers) for r in recs]
        assert ranks == sorted(ranks)
    producer_kind = {dm.ATT: dm.QKV, dm.WO: dm.ATT, dm.DN: dm.GU}
    for key, (blk, r) in seen.items():
        kind, layer, nwait = r[dm.R_KIND], r[dm.R_LAYER], r[dm.R_NWAIT]
        if kind not in producer_kind:
            assert nwait == 0, key
            continue
        assert nwait >= 1 and r[dm.R_TARGET] == layer + 1
        me = phase(r, layers)
        tiles = set()
        for c in range(r[dm.R_WAIT], r[dm.R_WAIT] + nwait):
            (ph, pk, tile), = {u for u in released[c][layer]}
            assert pk == producer_kind[kind] and ph < me
            tiles.add(tile)
        # the waits name what the item reads: its KV head's qkv columns, the
        # wo range's KV heads in every batch row, the down range's gate/up tiles
        if kind == dm.ATT:
            hi = r[dm.R_TILE] % hkv
            cols = range(hi * (grp + 2) * d, (hi + 1) * (grp + 2) * d)
            assert tiles == {c // 128 for c in cols}
        else:
            k, n, bs, wb, _ = plan[kind]
            lo, hi = dm._k_range(r[dm.R_U0] * dm.UNIT_ROWS,
                                 min(r[dm.R_U1] * dm.UNIT_ROWS, k * wb // 8), bs, wb)
            if kind == dm.DN:
                assert tiles == set(range(lo // 64, (hi - 1) // 64 + 1))
            else:
                heads = set(range(lo // d // grp, (hi - 1) // d // grp + 1))
                assert tiles == {b * hkv + h for b in range(batch) for h in heads}

    # merges: a tile's ranges share a counter whose last arrival is the
    # number of ranges up to this layer; partial regions apart
    regions = []
    for kind, (k, n, bs, wb, cuts) in plan.items():
        recs = [r for key, (_, r) in seen.items() if key[0] == kind]
        most = max(len(pieces) for pieces in cuts)
        if most == 1:
            assert all(r[dm.R_MERGE] == -1 for r in recs)
            continue
        offs = {int(r[dm.R_PART]) for r in recs}
        assert len(offs) == 1
        regions.append((offs.pop(), most * batch * n))
        for r in recs:
            rnd = 0 if kind == dm.HEAD else int(r[dm.R_LAYER])
            assert r[dm.R_MERGE_LAST] == (rnd + 1) * len(cuts[int(r[dm.R_TILE])]) - 1
            assert (r[dm.R_MERGE] == -1) == (len(cuts[int(r[dm.R_TILE])]) == 1)
        by_tile = {}
        for r in recs:
            if r[dm.R_MERGE] >= 0:
                by_tile.setdefault(int(r[dm.R_TILE]), set()).add(int(r[dm.R_MERGE]))
        assert all(len(v) == 1 for v in by_tile.values())
        assert len({next(iter(v)) for v in by_tile.values()}) == len(by_tile)
    regions.sort()
    for (a, na), (b2, _) in zip(regions, regions[1:]):
        assert a + na <= b2
    assert sum(n for _, n in regions) == hdr[dm.H_PART]
    used = {int(r[f]) + i for _, r in seen.values() for f, nf in
            ((dm.R_WAIT, dm.R_NWAIT), (dm.R_RELEASE, None), (dm.R_MERGE, None))
            for i in range(int(r[nf]) if nf is not None else 1) if int(r[f]) >= 0}
    assert used and min(used) >= dm.FIRST_COUNTER and max(used) < hdr[dm.H_COUNTERS]

    for active in (ns, 1):
        simulate(lists, layers, active)


def _k_range_fits(k, bs, bits, bm):
    """Does a tile's whole K fit the x stage of a BM-row kernel?"""
    return dm._k_range(0, k * bits // 8, bs, bits)[1] <= dm.XS_K[bm]


def simulate(lists, layers, active):
    """Walk every block's list in order as the kernel does: an item runs when
    every counter it waits on has its target; a tile's counter is released
    when its last K range is done, a KV head's when its `active` splits are;
    a grid-wide wait passes when every block stands at it. Fails on a state
    where no block can move."""
    counters, pieces_done, splits_done = {}, {}, {}
    pos = [0] * len(lists)
    while True:
        moved = False
        for blk, recs in enumerate(lists):
            while pos[blk] < len(recs):
                r = recs[pos[blk]]
                kind = int(r[dm.R_KIND])
                if kind == dm.BAR:
                    break
                if kind == dm.ATT and int(r[dm.R_U0]) >= active:
                    pos[blk] += 1                 # an idle split: nothing to do
                    moved = True
                    continue
                w0, nw, target = int(r[dm.R_WAIT]), int(r[dm.R_NWAIT]), int(r[dm.R_TARGET])
                if any(counters.get(c, 0) < target for c in range(w0, w0 + nw)):
                    break
                rel = int(r[dm.R_RELEASE])
                if rel >= 0:
                    key = (rel, int(r[dm.R_LAYER]))
                    need = active if kind == dm.ATT else int(r[dm.R_NPIECES])
                    done = pieces_done if kind != dm.ATT else splits_done
                    done[key] = done.get(key, 0) + 1
                    if done[key] == need:
                        counters[rel] = counters.get(rel, 0) + 1
                pos[blk] += 1
                moved = True
        if all(p == len(recs) for p, recs in zip(pos, lists)):
            return
        at_bar = [p < len(recs) and recs[p][dm.R_KIND] == dm.BAR for p, recs in zip(pos, lists)]
        if all(at_bar):
            pos = [p + 1 for p in pos]
            continue
        assert moved, f"deadlock: blocks stand at {pos[:8]}..."


@pytest.mark.parametrize("model", ["qwen2-0.5b", "mk-test"])
def test_schedule_w8_and_small_blocks(model):
    """W8 weights (a unit is 64 K values) and 32-value quant blocks (4
    scale rows a unit) plan K ranges that fit the stage and cover K."""
    cfg, cap = MODELS[model]
    for bits, bs in ((8, 128), (4, 32), (8, 32)):
        table, info = dm.schedule(1, cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size, cap,
                                  cfg.vocab_size, bits, bs, bs, 4, 128, 264,
                                  dm.ring_slots(1, cfg.head_dim))
        hdr, lists = split_table(table)
        assert hdr[dm.H_BITS] == bits and info["items"] == hdr[dm.H_ITEMS]
        for k in (cfg.hidden_size, cfg.intermediate_size):
            kp = k * bits // 8
            units = -(-kp // dm.UNIT_ROWS)
            for u in range(units):
                r0, r1 = u * dm.UNIT_ROWS, min((u + 1) * dm.UNIT_ROWS, kp)
                # quant blocks a unit touches: within the slot's scale rows
                rpb = bs * bits // 8
                assert (r1 - 1) // rpb - r0 // rpb + 1 <= dm.SCALE_ROWS
        simulate(lists, cfg.num_layers, int(hdr[dm.H_NS]))


def test_schedule_takes_no_lengths_and_is_deterministic():
    """The table depends on shapes and the grid only, so a captured CUDA
    graph stays valid while the lengths change on the device."""
    params = inspect.signature(dm.schedule).parameters
    assert not any("len" in name for name in params)
    a = build("qwen2-0.5b", 4, 264, True)[3]
    b = build("qwen2-0.5b", 4, 264, True)[3]
    assert np.array_equal(a, b)


def test_schedule_at_qwen2_0_5b():
    """At qwen2-0.5b's widths a tile of qkv or wo (7 units of 64 packed rows,
    9 and 7 tiles) is cut into 7 one-unit ranges, gate/up's 76 tiles into
    2, 2, 3 and down's 38 units into 37 ranges: each phase one item a block
    at most, of the fewest units. The head, a tile for every block, streams
    whole tiles four rounds over, and its 131 tiles left over go in two
    ranges each (3 and 4 units). The latency-bound phases stand on distinct
    SMs."""
    _, _, _, table, info = build("qwen2-0.5b", 1, 264, True)
    assert info["k_ranges"] == dict(qkv=7, wo=7, gate_up=3, down=37, head=2)
    assert info["cut_tiles"]["head"] == 131 and info["units"]["head"] == [3, 4]
    assert info["items_a_layer"]["head"] == 4 * 264 + 2 * 131
    assert info["units"]["qkv"] == [1] * 7 and info["units"]["gate_up"] == [2, 2, 3]
    assert sorted(info["units"]["down"]) == [1] * 36 + [2]
    assert info["items_a_layer"]["qkv"] == 63 and info["items_a_layer"]["wo"] == 49
    assert info["items_a_layer"]["down"] == 7 * 37
    assert info["grid_waits_a_layer"] == 2 and info["slots"] == 8
    hdr, lists = split_table(table)
    # the items of a phase stand on distinct places; a phase that fits the
    # 132 SMs on places below 132, which the kernel gives to distinct SMs
    for kind in (dm.QKV, dm.ATT, dm.WO, dm.GU, dm.DN):
        places = [blk for blk, recs in enumerate(lists) for r in recs
                  if r[dm.R_KIND] == kind and r[dm.R_LAYER] == 5]
        assert len(places) == len(set(places))
        if len(places) <= 132:
            assert max(places) < 132, kind


def test_schedule_at_qwen2_7b():
    """At qwen2-7b's widths gate/up has 296 tiles of 28 units for 264
    blocks: 264 go whole and the 32 left over are cut into 8 ranges each, so
    every block takes one whole tile and at most one range (32 units at
    most, where whole tiles alone would leave 32 blocks with 56). The head's
    1,188 tiles: four whole a block, the 132 left over in halves."""
    _, _, _, table, info = build("qwen2-7b", 1, 264, True)
    assert info["cut_tiles"]["gate_up"] == 32 and info["k_ranges"]["gate_up"] == 8
    assert info["items_a_layer"]["gate_up"] == 264 + 32 * 8
    assert info["cut_tiles"]["head"] == 132 and info["units"]["head"] == [14, 14]
    hdr, lists = split_table(table)
    for recs in lists:
        gu = [int(r[dm.R_U1] - r[dm.R_U0]) for r in recs
              if r[dm.R_KIND] == dm.GU and r[dm.R_LAYER] == 3]
        assert sorted(gu, reverse=True)[:1] == [28] and len(gu) <= 2 and sum(gu) <= 32
        head = [int(r[dm.R_U1] - r[dm.R_U0]) for r in recs if r[dm.R_KIND] == dm.HEAD]
        assert sorted(head) in ([28] * 4, [14] + [28] * 4)


def test_wrapper_sizes_match_the_kernel():
    """The shared-memory plan the schedule is built for, against the
    kernel's structs (decode_model.cuh's GemvSmem and attn_common.cuh's
    AttnSmem, counted field by field)."""
    attn64 = 4 * (10 * 64 + 4 * 64 + 8 + 2 + 1 + 8 * 8 * 32 + 2 * 8 * 8 + 8 * 8 * 64)
    assert attn64 == 28716
    assert dm.work_bytes(1, 64) == -(-attn64 // 128) * 128
    gemv8 = 4 * (8 * 8 * 128 + 8 * 128 + 8 * 1024 + 8 + 4)
    assert dm.work_bytes(8, 64) == -(-gemv8 // 128) * 128
    gemv1 = 4 * (8 * 128 + 128 + 4096 + 8 + 4)    # the x stage of 4096 K values
    assert gemv1 < attn64 and dm.XS_K == {1: 4096, 2: 2048, 4: 1024, 8: 1024}
    assert [dm.ring_slots(bm, 64) for bm in (1, 2, 4, 8)] == [8, 8, 7, 12]
    assert [dm.ring_slots(bm, 128) for bm in (1, 2, 4, 8)] == [6, 6, 6, 12]
    for bm in (1, 2, 4, 8):
        for d in (64, 128):
            assert (dm.smem_bytes(bm, d, dm.ring_slots(bm, d))
                    <= dm.BLOCK_SMEM[dm.blocks_per_sm(bm)])


def test_clock_summary_reads_the_log():
    """`profile_a8 --kernel model --clocks` reads the -DMNN_DM_CLOCKS log
    (a row of int64 a block: the count, then tag << 56 | kind << 52 | layer
    << 40 | clock): the mean cycles between an item's steps over the layers
    after the first, block 0's first item at layer 1, and each grid-wide
    wait's least, most and median wait; a row that is not a log is skipped;
    the clock's 40 bits wrap."""
    from mnn_tpu_torch import profile_a8 as pa
    tag = {n: i for i, n in enumerate(pa.EV_TAGS)}
    kind = {n: i for i, n in enumerate(pa.EV_KINDS)}

    def ev(t, k, layer, clk):
        return (tag[t] << 56) | (kind[k] << 52) | (layer << 40) | (clk % (1 << 40))

    rows = []
    for blk in range(3):
        evs = [ev("start", "prologue", 7, 100)]
        c = (1 << 40) - 500 if blk == 2 else 1000      # block 2's clock wraps
        for layer in range(3):
            evs += [ev("item", "qkv", layer, c), ev("waited", "qkv", layer, c + 10),
                    ev("weights", "qkv", layer, c + 60), ev("done", "qkv", layer, c + 160),
                    ev("barrier_in", "wo", layer, c + 200 + 10 * blk),
                    ev("barrier_out", "wo", layer, c + 300)]
            c += 1000
        rows.append([len(evs)] + evs + [0] * 4)
    rows.append([10 ** 12, 5, 6])                          # not a log
    got = pa.clock_summary(rows)
    assert got["steps"]["qkv"] == {"items": 6, "item->waited": 10.0, "waited->weights": 50.0,
                                   "weights->done": 100.0}
    assert got["block0"]["qkv"] == [("waited", 10), ("weights", 60), ("done", 160)]
    bar = got["barriers"]["wo"]
    assert bar["instances"] == 2 and bar["blocks"] == 3
    assert (bar["least"], bar["most"], bar["median"]) == (80.0, 100.0, 90.0)
    assert pa.decode_events([0]) == [] and pa.decode_events([3, 1]) == []
