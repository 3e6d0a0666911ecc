"""The fused expert decode kernel's item table (`kernels/moe_decode.py`
`schedule()`), on the CPU.

The kernel takes its items by ticket in table order, so the table carries
everything that makes it right: at the served shapes (qwen1.5-moe-a2.7b at
n = 1, 2, 4, 8; qwen3-moe-30b-a3b at n = 1, 4) and at the edges (W8, down
quant blocks of 64, no shared expert) every wait refers to earlier tickets
and its target is exactly the number of tiles that release it, each
activation column and each share of y is produced once, the combine of a
tile of y reads its pairs in the plain version's order, the scratch and
counter sizes hold every index, an item's K range fits the x stage, and the
busiest block of a launch (items taken in ticket order by whichever block
is free first) stays within 30 % of the mean units a block (about half a
block's work an item at the smallest shape, where a block takes two). A
plain-torch
run of the table in ticket order, with the kernel's merges and roundings,
meets `moe_decode_mlp_plain` within rel-L2 2e-2 (the bound of
`tests/test_moe_decode.py`).
"""

import heapq

import numpy as np
import pytest
import torch

from mnn_tpu_torch.kernels import moe_decode as md
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.quant.quantize import QuantizedLinear, dequantize

# the busiest block's units over the mean, at most: an item's units over a
# block's mean, at the smallest shape (qwen3-moe-30b-a3b n=1: items of 4 to 6
# units, 8.7 a block)
BUSIEST_SHARE = 0.30
TOL = 2e-2                # tests/test_moe_decode.py

# (name, n, k, H, mi, si, bits, bs_h, bs_mi, blocks): the card's blocks, two
# an SM up to 4 rows
SHAPES = [("qwen1.5-moe-a2.7b", n, 4, 2048, 1408, 5632, 4, 128, 128, 132 if n > 4 else 264)
          for n in (1, 2, 4, 8)]
SHAPES += [("qwen3-moe-30b-a3b", n, 8, 2048, 768, 0, 4, 128, 128, 264) for n in (1, 4)]
SHAPES += [("qwen1.5-moe-a2.7b w8", 1, 4, 2048, 1408, 5632, 8, 128, 128, 264),
           ("qwen1.5-moe-a2.7b bs_mi 64", 4, 4, 2048, 1408, 5632, 4, 128, 64, 264),
           ("qwen3-moe-30b-a3b w8 bs_mi 64", 8, 8, 2048, 768, 0, 8, 128, 64, 132),
           ("qwen1.5-moe-a2.7b one block an SM", 1, 4, 2048, 1408, 5632, 4, 128, 128, 132),
           ("H 4096, x staged an item", 4, 8, 4096, 768, 0, 4, 128, 128, 264)]
IDS = [f"{s[0]} n={s[1]}" for s in SHAPES]


def sched_of(shape):
    _, n, k, h, mi, si, bits, bs_h, bs_mi, blocks = shape
    return md.schedule(n, k, h, mi, si, bits, bs_h, bs_mi, bs_h if si else 0,
                       bs_mi if si else 0, blocks)


def records(s):
    return s.table[md.HDR:].reshape(-1, md.REC)


def rows_of(r, kp):
    """Packed rows [r0, r1) of a record's units (64 rows each)."""
    return int(r[md.R_U0]) * 64, min(int(r[md.R_U1]) * 64, kp)


def geometry(shape, kind):
    """(K, quant block) of the matrix an item kind reads."""
    _, n, k, h, mi, si, bits, bs_h, bs_mi, _ = shape
    return {md.GU_R: (h, bs_h), md.GU_S: (h, bs_h), md.DN_R: (mi, bs_mi),
            md.DN_S: (si, bs_mi)}[int(kind)]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_schedule_waits_and_coverage(shape):
    name, n, k, h, mi, si, bits, bs_h, bs_mi, blocks = shape
    s = sched_of(shape)
    recs = records(s)
    hdr = s.table[:md.HDR]
    assert hdr[0] == md.MAGIC and hdr[1] == s.n_items == len(recs)
    nk, tr, ts, yt = n * k, 2 * mi // 128, 2 * si // 128, h // 128
    kinds = recs[:, md.R_KIND]
    gu, dn = recs[:s.gu_items], recs[s.gu_items:]
    # every gate/up ticket before every down ticket
    assert set(kinds[:s.gu_items]) <= {md.GU_R, md.GU_S}
    assert set(kinds[s.gu_items:]) <= {md.DN_R, md.DN_S}
    # each activation column once: every tile of every job once, its K
    # ranges covering its packed rows in order
    tiles = {}
    for r in gu:
        tiles.setdefault((r[md.R_KIND], r[md.R_JOB], r[md.R_TILE]), []).append(r)
    want = {(md.GU_R, p, t) for p in range(nk) for t in range(tr)}
    want |= {(md.GU_S, 0, t) for t in range(ts)}
    assert set(tiles) == want
    released = {}
    kp = h * bits // 8
    for key, pieces in tiles.items():
        pieces.sort(key=lambda r: r[md.R_PIECE])
        assert [r[md.R_PIECE] for r in pieces] == list(range(pieces[0][md.R_NPIECES]))
        assert rows_of(pieces[0], kp)[0] == 0 and rows_of(pieces[-1], kp)[1] == kp
        assert all(rows_of(a, kp)[1] == rows_of(b, kp)[0] for a, b in zip(pieces, pieces[1:]))
        rel = list(pieces[0][md.R_REL:md.R_REL + md.NREL])
        assert all(list(r[md.R_REL:md.R_REL + md.NREL]) == rel for r in pieces)
        for ctr in (c for c in rel if c >= 0):        # one release a tile
            released[ctr] = released.get(ctr, 0) + 1
    # every wait: released by gate/up tickets only (all earlier), by exactly
    # `target` tiles, each of which writes activations the range reads; each
    # K range of the down product covered once for every tile of y
    covered = {}
    for r in dn:
        assert 0 <= r[md.R_WAIT] - md.C_READY < s.n_ready
        assert released[r[md.R_WAIT]] == r[md.R_TARGET] >= 1
        kdim, bs = geometry(shape, r[md.R_KIND])
        kpd = kdim * bits // 8
        k0, w = md.k_span(*rows_of(r, kpd), bits, bs)
        src = md.GU_R if r[md.R_KIND] == md.DN_R else md.GU_S
        feeding = [key for key in tiles if key[0] == src and key[1] == r[md.R_JOB]
                   and 64 * key[2] < k0 + w and 64 * key[2] + 64 > k0]
        assert len(feeding) == r[md.R_TARGET]
        covered.setdefault((r[md.R_KIND], r[md.R_JOB], r[md.R_TILE]), []).append(
            rows_of(r, kpd))
    want = {(md.DN_R, p, y): mi * bits // 8 for p in range(nk) for y in range(yt)}
    want.update({(md.DN_S, 0, y): si * bits // 8 for y in range(yt)} if si else {})
    assert set(covered) == set(want)
    for key, ranges in covered.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == want[key]
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert s.n_ready == nk * s.rd + s.sd and set(released) == set(
        range(md.C_READY, md.C_READY + s.n_ready))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_schedule_combine_order_sizes_and_balance(shape):
    name, n, k, h, mi, si, bits, bs_h, bs_mi, blocks = shape
    s = sched_of(shape)
    recs = records(s)
    nk, yt = n * k, h // 128
    down = recs[s.gu_items:]
    per_tile = (nk * s.rd + s.sd * n) * 128
    assert s.part_b == yt * per_tile
    merges = {r[md.R_MERGE] for r in recs[:s.gu_items] if r[md.R_NPIECES] > 1}
    assert s.n_counters == md.C_READY + s.n_ready + len(merges) + yt
    # each share of y once, pair-major in the plain version's order, then
    # the shared expert's ranges of n rows each, from the tile's base
    for y in range(yt):
        shares = sorted((r[md.R_PART], r[md.R_KIND], r[md.R_JOB], r[md.R_PIECE], r[md.R_BASE],
                         r[md.R_MERGE]) for r in down if r[md.R_TILE] == y)
        assert len(shares) == nk * s.rd + s.sd
        assert {sh[4] for sh in shares} == {y * per_tile}
        assert {sh[5] for sh in shares} == {md.C_READY + s.n_ready + len(merges) + y}
        rows = [1] * (nk * s.rd) + [n] * s.sd
        assert [sh[0] for sh in shares] == [y * per_tile + 128 * sum(rows[:i])
                                             for i in range(len(rows))]
        assert [(sh[1], sh[2], sh[3]) for sh in shares] == (
            [(md.DN_R, p, j) for p in range(nk) for j in range(s.rd)]
            + [(md.DN_S, 0, j) for j in range(s.sd)])
    # gate/up partial sums: within part_a, one region a cut tile
    regions = sorted({(r[md.R_PART], r[md.R_NPIECES] * (1 if r[md.R_KIND] == md.GU_R else n))
                      for r in recs[:s.gu_items] if r[md.R_NPIECES] > 1})
    at = 0
    for off, rows in regions:
        assert off == at
        at += rows * 128
    assert at == s.part_a
    # every counter index inside the counters; every K range inside the x
    # stage (gate/up: or read from the block's copy of x); every unit's
    # scale and bias rows inside their slot planes
    for r in recs:
        gate_up = r[md.R_KIND] in (md.GU_R, md.GU_S)
        idx = [r[md.R_MERGE]] + (list(r[md.R_REL:md.R_REL + md.NREL]) if gate_up
                                 else [r[md.R_WAIT]])
        assert all(-1 <= c < s.n_counters for c in idx)
        kdim, bs = geometry(shape, r[md.R_KIND])
        kp, rpb = kdim * bits // 8, bs * bits // 8
        rows = md.rows_held(n) if r[md.R_KIND] in (md.GU_S, md.DN_S) else 1
        copy = gate_up and n * (h + md.XS_PAD) <= md.copy_values(n)
        assert copy or (md.k_span(*rows_of(r, kp), bits, bs)[1] + md.XS_PAD) * rows \
            <= md.stage_values(n)
        for u in range(r[md.R_U0], r[md.R_U1]):
            r0, r1 = u * 64, min(u * 64 + 64, kp)
            assert (r1 - 1) // rpb - r0 // rpb + 1 <= md.SCALE_ROWS
    # items in ticket order to whichever block is free first: the busiest
    # block's units (64 packed rows of a tile each) within BUSIEST_SHARE of
    # the mean
    units = recs[:, md.R_U1] - recs[:, md.R_U0]
    load = [(0, b) for b in range(blocks)]
    for u in units:
        t, b = heapq.heappop(load)
        heapq.heappush(load, (t + int(u), b))
    busiest, mean = max(t for t, _ in load), units.sum() / blocks
    print(f"{name} n={n}: {s.n_items} items ({s.gu_items} gate/up), rd {s.rd}, sd {s.sd}, "
          f"busiest {busiest} units against a mean of {mean:.2f}")
    assert busiest <= (1 + BUSIEST_SHARE) * mean


@pytest.mark.parametrize("shape", SHAPES[:6], ids=IDS[:6])
def test_schedule_items_a_block(shape):
    """At the served shapes a block takes two items where its mean work is
    under 12 units (qwen3-moe-30b-a3b at n = 1, 8.7 units), else three."""
    name, n, k, h, mi, si, bits, bs_h, bs_mi, blocks = shape
    recs = records(sched_of(shape))
    units = int((recs[:, md.R_U1] - recs[:, md.R_U0]).sum())
    want = 2 if units / blocks < 12 else 3
    assert md.items_a_block(units / blocks) == want
    assert (want == 2) == (name == "qwen3-moe-30b-a3b" and n == 1)
    # the pieces a gate/up tile is cut into follow from that count
    q = max(1.0, units / blocks / want)
    ug = -(-h * bits // 8 // 64)
    assert recs[0, md.R_NPIECES] == max(1, min(ug, round(ug / q)))


def test_schedule_simulated_launch_ends():
    """A launch of G blocks, each taking the next ticket when it is free and
    holding a down item until the gate/up tiles it waits on are done,
    finishes every item at the served shapes: no wait outlives the items it
    needs."""
    for shape in SHAPES:
        s = sched_of(shape)
        recs = records(s)
        free = [(0.0, b) for b in range(shape[-1])]
        done_at = {}          # counter -> end times of the tiles that release it
        finished = 0
        for r in recs:
            t, b = heapq.heappop(free)
            units = int(r[md.R_U1] - r[md.R_U0])
            if r[md.R_KIND] in (md.GU_R, md.GU_S):
                end = t + units
                if r[md.R_PIECE] == r[md.R_NPIECES] - 1:
                    for c in r[md.R_REL:md.R_REL + md.NREL]:
                        if c >= 0:
                            done_at.setdefault(int(c), []).append(end)
            else:
                ready = sorted(done_at.get(int(r[md.R_WAIT]), []))
                assert len(ready) == r[md.R_TARGET]
                end = max(t, ready[-1]) + units
            heapq.heappush(free, (end, b))
            finished += 1
        assert finished == s.n_items


# ---------------------------------------------------------------------------
# the table run in ticket order, in plain torch, against the plain version

def moe_cfg(h, e, k, mi, si):
    return ModelConfig(name="moe-test", vocab_size=256, hidden_size=h, intermediate_size=256,
                       num_layers=3, num_heads=2, num_kv_heads=1, head_dim=64, num_experts=e,
                       num_experts_per_tok=k, moe_intermediate_size=mi,
                       shared_expert_intermediate_size=si)


def rand_stack(rng, lead, kdim, ndim, bits, bs):
    qmax = (1 << bits) - 1
    packed = rng.integers(-128, 128, size=(*lead, kdim * bits // 8, ndim), dtype=np.int8)
    scale = (rng.random((*lead, kdim // bs, ndim)) + 0.5) * 0.1 / qmax
    bias = -(qmax / 2) * scale + rng.standard_normal((*lead, kdim // bs, ndim)) * 2e-3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return QuantizedLinear(packed=torch.from_numpy(packed), scale=t(scale), bias=t(bias),
                           out_bias=None, bits=bits, block_size=bs)


def k_rows(r0, r1, bits, bs):
    """The K values of packed rows [r0, r1) of a matrix."""
    rows = range(r0, r1)
    if bits == 8:
        return list(rows)
    half = bs // 2
    lo = [(r // half) * bs + r % half for r in rows]
    return lo + [v + half for v in lo]


def run_table(x, lay, sel, wsel, li, gate, cfg, blocks):
    """The kernel's item table executed one ticket after another: each item
    a K range of one tile over bf16-rounded inputs, K ranges of a gate/up
    tile added in range order by the last to arrive, SwiGLU with the
    kernel's roundings, the shares of a tile of y combined in the plain
    version's order by the last to arrive."""
    n, h = x.shape
    k, mi, si = cfg.num_experts_per_tok, cfg.moe_intermediate_size, \
        cfg.shared_expert_intermediate_size
    gu, dn = lay.wgu_e, lay.wdown_e
    bits = gu.bits
    bs_sh = lay.wgu_shared.block_size if si else 0
    bs_sd = lay.wdown_shared.block_size if si else 0
    s = md.schedule(n, k, h, mi, si, bits, gu.block_size, dn.block_size, bs_sh, bs_sd, blocks)
    nk = n * k
    ids = sel.reshape(-1).long()

    def matrix(kind, job):
        if kind == md.GU_R:
            return dequantize(gu.layer(li).layer(int(ids[job]))), gu.block_size, h
        if kind == md.DN_R:
            return dequantize(dn.layer(li).layer(int(ids[job]))), dn.block_size, mi
        if kind == md.GU_S:
            return dequantize(lay.wgu_shared.layer(li)), bs_sh, h
        return dequantize(lay.wdown_shared.layer(li)), bs_sd, si

    bf = lambda t: t.to(torch.bfloat16).float()
    act_r, act_s = torch.zeros(nk, mi), torch.zeros(n, max(si, 1))
    part_a, part_b = torch.zeros(max(s.part_a, 1)), torch.zeros(s.part_b)
    counters = np.zeros(s.n_counters, dtype=np.int64)
    y = torch.zeros(n, h)
    for r in records(s):
        kind, job, tile, ct = int(r[md.R_KIND]), int(r[md.R_JOB]), int(r[md.R_TILE]), 1
        w, bs, kdim = matrix(kind, job)
        kk = k_rows(*rows_of(r, kdim * bits // 8), bits, bs)
        cols = slice(tile * 128, (tile + ct) * 128)
        if kind in (md.GU_R, md.GU_S):
            xin = bf(x.float()) if kind == md.GU_S else bf(x.float())[job // k][None]
        else:
            assert counters[r[md.R_WAIT]] >= r[md.R_TARGET]
            xin = act_s[:, :si] if kind == md.DN_S else act_r[job][None]
        partial = xin[:, kk] @ w[kk, cols]
        rows, width = partial.shape
        if kind in (md.GU_R, md.GU_S):
            if r[md.R_NPIECES] > 1:
                at = int(r[md.R_PART]) + int(r[md.R_PIECE]) * rows * width
                part_a[at:at + rows * width] = partial.reshape(-1)
                counters[r[md.R_MERGE]] += 1
                if counters[r[md.R_MERGE]] < r[md.R_NPIECES]:
                    continue
                counters[r[md.R_MERGE]] = 0
                fin = torch.zeros(rows * width)
                for p in range(int(r[md.R_NPIECES])):
                    at = int(r[md.R_PART]) + p * rows * width
                    fin = fin + part_a[at:at + rows * width]
                partial = fin.reshape(rows, width)
            dst = act_s if kind == md.GU_S else act_r[job][None]
            for j in range(ct):
                g, u = bf(partial[:, 128 * j:128 * j + 64]), bf(partial[:, 128 * j + 64:128 * j + 128])
                dst[:, (tile + j) * 64:(tile + j) * 64 + 64] = bf(bf(g * torch.sigmoid(g)) * u)
            for c in r[md.R_REL:md.R_REL + md.NREL]:
                if c >= 0:
                    counters[c] += 1
            continue
        at = int(r[md.R_PART])
        part_b[at:at + rows * width] = partial.reshape(-1)
        counters[r[md.R_MERGE]] += 1
        if counters[r[md.R_MERGE]] < nk * s.rd + s.sd:
            continue
        counters[r[md.R_MERGE]] = 0
        base = int(r[md.R_BASE])
        for row in range(n):
            v = torch.zeros(width)
            for kk_ in range(k):
                pr = row * k + kk_
                term = sum(part_b[base + (pr * s.rd + j) * width:][:width] for j in range(s.rd))
                v = v + term * wsel[row, kk_].float()
            if si:
                sh = sum(part_b[base + (nk * s.rd + j * n + row) * width:][:width]
                         for j in range(s.sd))
                v = v + sh * (1.0 if gate is None else gate[row].float())
            y[row, cols] = v
    assert not counters[md.C_READY + s.n_ready:].any()     # merges left at zero
    return y, s


# (bits, n, H, E, k, mi, si, bs_mi, gate, blocks): tiny, with every cut the
# table makes (K ranges of gate/up tiles, several down ranges, partial units)
TINY = [(4, 1, 256, 6, 2, 128, 256, 64, True, 12), (4, 3, 256, 6, 2, 192, 0, 64, False, 24),
        (8, 2, 256, 4, 2, 128, 128, 128, True, 16), (4, 5, 512, 6, 3, 192, 128, 64, False, 64)]


@pytest.mark.parametrize("bits,n,h,e,k,mi,si,bs_mi,with_gate,blocks", TINY)
def test_table_run_matches_plain(bits, n, h, e, k, mi, si, bs_mi, with_gate, blocks):
    rng = np.random.default_rng(n * 100 + h + e)
    cfg = moe_cfg(h, e, k, mi, si)
    nl = cfg.num_layers
    lay = decoder.LayerParams(
        wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
        wgu_e=rand_stack(rng, (nl, e), h, 2 * mi, bits, 128),
        wdown_e=rand_stack(rng, (nl, e), mi, h, bits, bs_mi),
        wgu_shared=rand_stack(rng, (nl,), h, 2 * si, bits, 128) if si else None,
        wdown_shared=rand_stack(rng, (nl,), si, h, bits, 128) if si else None)
    x = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32) * 0.5)
    sel = torch.from_numpy(np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32))
    wsel = torch.from_numpy(rng.random((n, k)).astype(np.float32))
    gate = torch.from_numpy(rng.random(n).astype(np.float32)) if with_gate else None
    got, s = run_table(x, lay, sel, wsel, 2, gate, cfg, blocks)
    recs = records(s)
    assert (recs[:s.gu_items, md.R_NPIECES] > 1).any() or s.rd > 1 or s.sd > 1
    want = md.moe_decode_mlp_plain(x, lay, sel, wsel, 2, gate, config=cfg)
    err = float((got - want).norm() / want.norm())
    print(f"n={n} H={h} mi={mi} si={si} W{bits}: {s.n_items} items, rel-L2 {err:.2e}")
    assert err <= TOL, err
