"""Speculative decoding: n-gram lookahead, draft models (EAGLE chain and
tree, MTP heads, DFlash), and one-pass verification.

Counterpart of `mnn_tpu/runtime/speculative.py`. A draft proposes tokens,
ONE target forward verifies them all (T = draft + 1 positions, or the 1 +
K x depth nodes of a token tree under its ancestor mask), and greedy
acceptance keeps the longest prefix that matches the target's own argmax,
plus the target's token after it: the output is the plain greedy stream's,
whatever the draft proposes. Rejected rows are rolled back (`kvcache.
rollback`); a tree keeps its accepted path's rows (`kvcache.compact_tail`).

The bookkeeping is the JAX package's: the same padding of lookahead drafts,
the same trimming at the token budget, the same `spec_stats` keys. Draft
tokens stay on the device until the round's one host read, which takes the
draft and the targets together (the JAX drafters read each draft token on
its own). Lookahead takes the native n-gram index (`utils/native.py`) when
that library builds, else `NgramDraft`, as the JAX package does; both
propose the same tokens.

Precision as in the JAX package: `lookahead_generate` prefills through
`generate.run_prefill` (which honours `prefill_act_bits`), while
`prefill_with_features` runs the layers' own weights, bf16 rows, because
the draft models need every prompt position's feature.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from mnn_tpu_torch.kernels.decode_model import lowest_argmax
from mnn_tpu_torch.models import eagle as eagle_mod
from mnn_tpu_torch.models.decoder import forward, head_logits
from mnn_tpu_torch.models.dflash import dflash_block_logits, fc_forward
from mnn_tpu_torch.models.layers import rms_norm
from mnn_tpu_torch.runtime import generate as gen
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.utils import native


class NgramDraft:
    """Suffix n-gram table over prompt + generated tokens."""

    def __init__(self, ngram: int = 3, draft_len: int = 7, max_n: int = 4):
        self.ngram = ngram
        self.draft_len = draft_len
        self.history: List[int] = []
        self.index = {}  # tuple -> position after its first occurrence
        self.max_n = max_n

    def extend(self, tokens: List[int]):
        for t in tokens:
            self.history.append(int(t))
            n = len(self.history)
            for k in range(2, self.max_n + 1):
                if n >= k:
                    # keep the first occurrence: the current suffix is always
                    # the latest, and would otherwise shadow every match
                    self.index.setdefault(tuple(self.history[n - k:]), n)

    def propose(self) -> Optional[List[int]]:
        """Longest n-gram match wins; up to draft_len draft tokens."""
        n = len(self.history)
        for k in range(self.max_n, 1, -1):
            if n < k:
                continue
            pos = self.index.get(tuple(self.history[n - k:]))
            if pos is not None and pos < n:
                draft = self.history[pos:pos + self.draft_len]
                if draft:
                    return draft
        return None


def _stats(drafted: int, accepted: int) -> dict:
    return {"drafted": drafted, "accepted": accepted,
            "accept_rate": accepted / drafted if drafted else 0.0}


def _accept(draft: List[int], targets: List[int]) -> int:
    """The longest prefix of `draft` that the greedy targets confirm."""
    n = 0
    for d, t in zip(draft, targets):
        if d != t:
            break
        n += 1
    return n


def verify_step(params, config, cache, tokens: List[int]):
    """Forward [last emitted + draft ...] (T tokens) and take the greedy
    target at every position. Returns (targets [T] host list, the cache
    with T positions appended): the round's one host read."""
    arr = torch.tensor([tokens], dtype=torch.int64, device=cache.k.device)
    logits, cache = forward(params, config, arr, cache, all_logits=True)
    return lowest_argmax(logits[0]).tolist(), cache


def lookahead_generate(llm, token_ids: List[int], max_new_tokens: int, *,
                       ngram: int = 3, draft_len: int = 7):
    """Greedy lookahead decoding: yields the accepted tokens of each round.

    llm: `runtime.llm.Llm` (its params, config, runtime and cache)."""
    if native.available():
        draft_tab = native.NativeNgramIndex(max_n=4, draft_len=draft_len)
    else:
        draft_tab = NgramDraft(ngram=ngram, draft_len=draft_len)
    draft_tab.extend(token_ids)

    tokens = torch.tensor([token_ids], dtype=torch.int64, device=llm.device)
    logits, cache = gen.run_prefill(llm.params, llm.config, llm.rt, tokens, llm.cache)
    llm.cache = cache
    llm.last_prefill_logits = logits
    last = int(lowest_argmax(logits)[0])
    draft_tab.extend([last])
    produced = [last]
    yield [last]
    accepted_total = drafted_total = 0

    while len(produced) < max_new_tokens:
        draft = draft_tab.propose() or []
        budget = max_new_tokens - len(produced)
        draft = draft[:max(min(len(draft), budget), 0)]
        # padded to a fixed shape: every verify has T = draft_len + 1
        step_tokens = [last] + draft + [last] * (draft_len - len(draft))
        targets, cache = verify_step(llm.params, llm.config, cache, step_tokens)
        n_accept = _accept(draft, targets)
        emitted = list(draft[:n_accept]) + [targets[n_accept]]
        drafted_total += len(draft)
        accepted_total += n_accept
        # the cache holds len(step_tokens) new rows; keep accepted + 1
        extra = len(step_tokens) - (n_accept + 1)
        if extra > 0:
            cache = kvcache.rollback(cache, extra)
        # the verify bonus token can overshoot the budget by one: trim the
        # emission and its cache row so exactly max_new_tokens come out
        budget_now = max_new_tokens - len(produced)
        if len(emitted) > budget_now:
            cache = kvcache.rollback(cache, len(emitted) - budget_now)
            emitted = emitted[:budget_now]
        produced.extend(emitted)
        draft_tab.extend(emitted)
        last = emitted[-1]
        # keep the engine's cache current even if the consumer stops early
        llm.cache = cache
        llm.spec_stats = _stats(drafted_total, accepted_total)
        yield emitted

    llm.cache = cache
    llm.spec_stats = _stats(drafted_total, accepted_total)


# ---------------------------------------------------------------------------
# draft-model speculative decoding (EAGLE / MTP heads / DFlash)
# ---------------------------------------------------------------------------

def verify_forward(params, config, tokens: torch.Tensor, cache, tree=None):
    """Target forward returning (greedy targets [B, T] int32, features
    [B, T, hidden], cache): the features are the post-final-norm hidden
    states, what EAGLE takes as the previous position's feature. `tree`:
    `forward`'s token-tree verify (the T rows are appended in node order;
    compact them with `kvcache.compact_tail`)."""
    hidden, cache = forward(params, config, tokens, cache, return_hidden=True, tree=tree)
    feats = rms_norm(hidden, params.final_norm, config.rms_norm_eps)
    return lowest_argmax(head_logits(params, feats)), feats, cache


def prefill_with_features(params, config, rt, tokens: torch.Tensor, cache):
    """Chunked, bucketed prefill that keeps every position's feature.
    Returns (last logits [B, V], features [B, T, hidden], cache). Only the
    last position goes through the head."""
    t = tokens.shape[1]
    feats = []
    off = 0
    for bucket in gen.prefill_buckets(t, rt.prefill_chunk):
        valid = min(bucket, t - off)
        chunk = gen.pad_tokens(tokens[:, off:off + valid], bucket)
        hidden, cache = forward(params, config, chunk, cache, return_hidden=True)
        if bucket > valid:
            cache = kvcache.rollback(cache, bucket - valid)
        feats.append(rms_norm(hidden[:, :valid], params.final_norm, config.rms_norm_eps))
        off += valid
    features = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
    return head_logits(params, features[:, -1]), features, cache


def _token(tok, device) -> torch.Tensor:
    """A token (an int or a device tensor of one element) as [1, 1] int64."""
    return torch.as_tensor(tok, dtype=torch.int64, device=device).reshape(1, 1)


class EagleDraft:
    """Chain-mode EAGLE drafter: a 1-layer draft net with its own KV cache.

    Cache invariant: position j holds the pair (token s_{j+1}, feature f_j),
    always the TARGET's features. `propose` writes its speculative rows past
    the cache's length, where every reader masks them; `commit` writes the
    verified pairs over them."""

    kind = "eagle"

    def __init__(self, eparams, draft_len: int = 4, capacity: int = 2048):
        self.ep = eparams
        self.draft_len = draft_len
        self.capacity = capacity
        self.cache = None

    def start(self, params, config, prompt_ids: List[int], feats: torch.Tensor):
        """feats: [1, T, hidden] target features of the prompt."""
        self.params, self.config = params, config
        dev = feats.device
        self.cache = eagle_mod.create_draft_cache(config, self.capacity, device=dev)
        n = len(prompt_ids)
        if n < 2:
            return
        # pairs (s_1..s_{n-1}, f_0..f_{n-2}), padded to a multiple of 32 as
        # the JAX package pads them (the pad is rolled back afterwards)
        t = n - 1
        bucket = max(32, -(-t // 32) * 32)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :t] = torch.tensor(prompt_ids[1:])
        f = torch.zeros((1, bucket, feats.shape[-1]), dtype=feats.dtype, device=dev)
        f[:, :t] = feats[:, :n - 1]
        _, cache = eagle_mod.eagle_forward(self.ep, params, config, toks.to(dev), f,
                                           self.cache)
        self.cache = kvcache.rollback(cache, bucket - t)

    def propose(self, last_token, last_feat: torch.Tensor) -> torch.Tensor:
        """`draft_len` tokens by chaining the draft net, [draft_len] int32
        on the device; self.cache keeps its length."""
        cache = self.cache
        tok = _token(last_token, last_feat.device)
        feat = last_feat[:, None]                       # [1, 1, hidden]
        out = []
        for _ in range(self.draft_len):
            nxt, h, cache = eagle_mod.eagle_next_token(self.ep, self.params, self.config,
                                                       tok, feat, cache)
            out.append(nxt[0])
            tok = nxt[:, None].long()
            feat = h[:, -1:]
        return torch.stack(out)

    def commit(self, prev_token, prev_feat, emitted, vfeats, n_accept: int):
        """Append the verified pairs: tokens [prev] + emitted[:n_accept]
        with features [prev_feat] + vfeats[:, :n_accept], padded to
        draft_len + 1 rows (the pad rolled back). `prev_token` and `emitted`
        may be ints or device tensors (emitted[:n_accept] are the accepted
        draft tokens)."""
        width = self.draft_len + 1
        m = n_accept + 1                                # true pairs
        dev = vfeats.device
        toks = torch.zeros((1, width), dtype=torch.int64, device=dev)
        toks[0, :1] = torch.as_tensor(prev_token, dtype=torch.int64, device=dev).reshape(1)
        if m > 1:
            toks[0, 1:m] = torch.as_tensor(emitted[:m - 1], dtype=torch.int64, device=dev)
        f = torch.cat([prev_feat[:, None], vfeats[:, :width - 1]], dim=1)
        _, cache = eagle_mod.eagle_forward(self.ep, self.params, self.config, toks, f,
                                           self.cache)
        self.cache = kvcache.rollback(cache, width - m)

    def rollback(self, n: int):
        if self.cache is not None:
            self.cache = kvcache.rollback(self.cache, n)


class DFlashDraft:
    """Block-diffusion drafter: a small NON-CAUSAL draft net emits a whole
    `block_size`-token draft in one forward over [fc(target features) |
    mask-token block]; no draft KV cache, no chaining. Context rows live in
    a fixed-capacity buffer that slides when full."""

    kind = "dflash"

    def __init__(self, dparams, capacity: int = 512):
        self.dp = dparams
        self.draft_len = dparams.block_size
        self.capacity = capacity
        self.ctx = None            # [1, cap, hidden] f32
        self.n = 0                 # valid rows
        self.start_pos = 0         # rope position of ctx row 0

    def _push(self, rows: torch.Tensor):
        """Append fc-projected rows [1, m, hidden]; slide the window when
        full (the draft attends to the newest `capacity` positions)."""
        m = rows.shape[1]
        if self.n + m > self.capacity:
            shift = self.n + m - self.capacity
            self.ctx = torch.cat([self.ctx[:, shift:], torch.zeros_like(self.ctx[:, :shift])],
                                 dim=1)
            self.n -= shift
            self.start_pos += shift
        self.ctx[:, self.n:self.n + m] = rows.float()
        self.n += m

    def start(self, params, config, prompt_ids: List[int], feats: torch.Tensor):
        self.params, self.config = params, config
        self.ctx = torch.zeros((1, self.capacity, config.hidden_size), dtype=torch.float32,
                               device=feats.device)
        self.n = 0
        self.start_pos = 0
        rows = fc_forward(self.dp, feats)
        if rows.shape[1] > self.capacity:
            self.start_pos = rows.shape[1] - self.capacity
            rows = rows[:, -self.capacity:]
        self._push(rows)

    def propose(self, last_token, last_feat) -> torch.Tensor:
        logits = dflash_block_logits(self.dp, self.params, self.config, self.ctx,
                                     self.n, self.start_pos)
        return lowest_argmax(logits[0])

    def commit(self, prev_token, prev_feat, emitted, vfeats, n_accept: int):
        # context rows track produced positions one for one (start pushed
        # every prompt position); the verify keeps n_accept + 1 new ones
        self._push(fc_forward(self.dp, vfeats[:, :n_accept + 1]))

    def rollback(self, n: int):
        self.n = max(0, self.n - n)


class MtpDraft:
    """MTP/Medusa-style drafter: K residual heads off the last feature.
    Stateless (no draft KV), so start and commit only record the target."""

    kind = "mtp"

    def __init__(self, heads, draft_len: Optional[int] = None):
        self.heads = heads
        self.draft_len = min(draft_len or heads.num_heads, heads.num_heads)

    def start(self, params, config, prompt_ids, feats):
        self.params, self.config = params, config

    def propose(self, last_token, last_feat) -> torch.Tensor:
        return eagle_mod.mtp_propose(self.heads, self.params, last_feat)[0, :self.draft_len]

    def commit(self, *a, **kw):
        pass

    def rollback(self, n: int):
        pass


class TreeEagleDraft(EagleDraft):
    """Static K x depth token-TREE drafter: K sibling chains off the top-K
    first-step candidates, each continued greedily to `depth`. The tree's
    shape is fixed (one verify shape); its mask and positions are data."""

    kind = "eagle-tree"

    def __init__(self, eparams, draft_len: int = 4, capacity: int = 2048,
                 fanout: int = 3):
        super().__init__(eparams, draft_len=draft_len, capacity=capacity)
        self.fanout = fanout

    @property
    def n_nodes(self) -> int:
        return 1 + self.fanout * self.draft_len

    def tree_layout(self):
        """(depths [N] int32, mask [N, N] bool) for the root and K chains."""
        k, d = self.fanout, self.draft_len
        n = self.n_nodes
        depths = torch.zeros((n,), dtype=torch.int32)
        mask = torch.zeros((n, n), dtype=torch.bool)
        mask[0, 0] = True
        for c in range(k):
            for j in range(d):
                i = 1 + c * d + j
                depths[i] = 1 + j
                mask[i, 0] = True                       # the root
                mask[i, 1 + c * d:i + 1] = True         # its chain's ancestors, itself
        return depths, mask

    def propose_tree(self, last_token, last_feat: torch.Tensor) -> torch.Tensor:
        """[K, depth] candidate chains on the device: row c starts at the
        c-th best first-step candidate (among equal logits the lower id
        first, as `jax.lax.top_k` orders them). self.cache keeps its
        length; the chains write their rows past it in turn."""
        tok = _token(last_token, last_feat.device)
        h, cache1 = eagle_mod.eagle_forward(self.ep, self.params, self.config, tok,
                                            last_feat[:, None], self.cache)
        logits = head_logits(self.params, h[:, -1])
        idx = torch.sort(logits[0], descending=True, stable=True).indices[:self.fanout]
        chains = []
        for c in range(self.fanout):
            chain = [idx[c]]
            tok_c, feat_c, cache_c = idx[c].reshape(1, 1), h[:, -1:], cache1
            for _ in range(1, self.draft_len):
                nxt, hh, cache_c = eagle_mod.eagle_next_token(
                    self.ep, self.params, self.config, tok_c, feat_c, cache_c)
                chain.append(nxt[0].long())
                tok_c, feat_c = nxt[:, None].long(), hh[:, -1:]
            chains.append(torch.stack(chain))
        return torch.stack(chains)


def _first_round(llm, token_ids: List[int], drafter):
    """Prefill with features and start the drafter: (last token on the
    host, the same on the device [1], its feature [1, hidden], cache)."""
    tokens = torch.tensor([token_ids], dtype=torch.int64, device=llm.device)
    logits, feats, cache = prefill_with_features(llm.params, llm.config, llm.rt, tokens,
                                                 llm.cache)
    llm.cache = cache
    llm.last_prefill_logits = logits
    drafter.start(llm.params, llm.config, token_ids, feats)
    last_dev = lowest_argmax(logits)
    return int(last_dev[0]), last_dev, feats[:, -1], cache


def tree_draft_generate(llm, token_ids: List[int], max_new_tokens: int, *,
                        drafter: TreeEagleDraft):
    """Greedy token-TREE speculative decoding; lossless against plain greedy
    decode. A round: one K x depth tree proposal, ONE tree-masked target
    forward over its 1 + K x depth nodes, the accepted root-to-leaf path
    retrieved, its KV rows compacted in place (`kvcache.compact_tail`) and
    committed to the drafter. Yields the accepted tokens of each round."""
    d, kf = drafter.draft_len, drafter.fanout
    depths, tmask = (a.to(llm.device) for a in drafter.tree_layout())
    last, last_dev, prev_feat, cache = _first_round(llm, token_ids, drafter)
    produced = [last]
    yield [last]
    accepted_total = drafted_total = rounds = 0

    while len(produced) < max_new_tokens:
        chains_dev = drafter.propose_tree(last_dev, prev_feat)           # [K, d]
        nodes = torch.cat([last_dev.long(), chains_dev.reshape(-1)])[None]
        start = cache.length[0]
        targets, vfeats, cache = verify_forward(llm.params, llm.config, nodes, cache,
                                                tree=(depths, tmask))
        host = torch.cat([chains_dev.reshape(-1), targets[0].long()]).tolist()
        chains = [host[c * d:(c + 1) * d] for c in range(kf)]
        tg = host[kf * d:]
        # retrieve: the first chain whose head is the root's target, walked
        # while its tokens are their parents' targets
        best_c, n_accept = 0, 0
        for c in range(kf):
            if chains[c][0] == tg[0]:
                best_c, n_accept = c, 1
                while n_accept < d and chains[c][n_accept] == tg[1 + c * d + n_accept - 1]:
                    n_accept += 1
                break
        path_nodes = [0] + [1 + best_c * d + j for j in range(d)]
        tail_i = path_nodes[n_accept]
        emitted = chains[best_c][:n_accept] + [tg[tail_i]]
        drafted_total += d
        accepted_total += n_accept
        rounds += 1

        # keep the root and the accepted path's rows
        cache = kvcache.compact_tail(cache, start, path_nodes, 1 + n_accept)
        # the path's features, root first (as chain verify gives them)
        vf_lin = torch.cat([vfeats[:, :1], vfeats[:, 1 + best_c * d:1 + (best_c + 1) * d]],
                           dim=1)
        drafter.commit(last_dev, prev_feat, chains_dev[best_c], vf_lin, n_accept)
        budget = max_new_tokens - len(produced)
        if len(emitted) > budget:
            over = len(emitted) - budget
            emitted = emitted[:budget]
            cache = kvcache.rollback(cache, over)
            drafter.rollback(over)
        prev_feat = vf_lin[:, n_accept]
        last_dev = targets[0, tail_i:tail_i + 1]
        produced.extend(emitted)
        llm.cache = cache
        llm.spec_stats = dict(_stats(drafted_total, accepted_total),
                              tokens_per_round=len(produced) / rounds)
        yield emitted

    llm.cache = cache


def draft_generate(llm, token_ids: List[int], max_new_tokens: int, *, drafter):
    """Greedy draft-model speculative decoding (EAGLE chain, MTP, DFlash, or
    any object with the drafters' start / propose / commit / rollback);
    lossless against plain greedy decode. Yields the accepted tokens of
    each verify round. `propose` may return a list or a device tensor."""
    last, last_dev, prev_feat, cache = _first_round(llm, token_ids, drafter)
    produced = [last]
    yield [last]
    accepted_total = drafted_total = 0

    while len(produced) < max_new_tokens:
        draft_dev = torch.as_tensor(drafter.propose(last_dev, prev_feat), dtype=torch.int64,
                                    device=llm.device).reshape(-1)
        step = torch.cat([last_dev.long(), draft_dev])[None]     # T = k + 1
        targets, vfeats, cache = verify_forward(llm.params, llm.config, step, cache)
        k = draft_dev.shape[0]
        host = torch.cat([draft_dev, targets[0].long()]).tolist()
        draft, tg = host[:k], host[k:]
        n_accept = _accept(draft, tg)
        emitted = draft[:n_accept] + [tg[n_accept]]
        drafted_total += k
        accepted_total += n_accept
        # the target cache holds k + 1 new rows; keep accepted + 1
        extra = k - n_accept
        if extra > 0:
            cache = kvcache.rollback(cache, extra)
        drafter.commit(last_dev, prev_feat, draft_dev, vfeats, n_accept)
        budget = max_new_tokens - len(produced)
        if len(emitted) > budget:
            over = len(emitted) - budget
            emitted = emitted[:budget]
            cache = kvcache.rollback(cache, over)
            drafter.rollback(over)
        prev_feat = vfeats[:, n_accept]
        last_dev = targets[0, n_accept:n_accept + 1]
        produced.extend(emitted)
        llm.cache = cache
        llm.spec_stats = _stats(drafted_total, accepted_total)
        yield emitted

    llm.cache = cache
