"""Continuous batching engine: slots over one shared KV cache.

Counterpart of `mnn_tpu/runtime/batch_engine.py`, with its design:

* fixed slots, the batch rows of one [L, B, Hkv, S, D] cache: a request
  takes a free slot, its prompt is prefilled into that slot alone, and it
  frees the slot when it finishes;
* decode runs the whole batch every step, each slot reading and writing at
  its own length. Idle slots decode filler that is never read; their
  lengths grow to the capacity, where every write is clamped;
* prefill admits one request at a time between decode blocks
  (`prefill_priority` says before or after the block, never whether);
* a request goes WAITING -> PREFILL -> DECODE -> DONE, or ends CANCELLED
  or TIMEOUT.

Nothing here is per model family: a gemma slot's sliding layers mask their
window over that slot's own length inside `forward` (the whole-model
kernel, the decode step and the eager path all take per-row lengths).

In PyTorch's idiom: every tensor lives on the device of the weights, draws
come from one `torch.Generator` on that device, and prefill writes the
shared cache in place through a slot view (`kvcache.slot_view`), with no
copy of the slot's rows. A decode block is a Python loop of `steps` forward
and sample steps; the host reads the slots' lengths and the block's tokens
once a block, and the first token once an admission. Prefill takes the
runtime's `prefill_act_bits` as `Llm.stream` does: both run
`generate.run_prefill`.

One stream, one device thread. Flash decode, the M = 1 GEMV and the fused
expert kernel each keep one workspace and one set of counters per device,
so two of their launches on two streams at once would corrupt each other.
All device work of an engine runs on the thread that calls `step` (under
the engine's lock, on the current stream); other threads only `submit`,
`cancel` and read the requests' queues. Nothing here sets a non-default
stream.

Serve a mixture-of-experts model at `max_batch` <= 8
(`kernels/moe_decode.MAX_TOKENS`): up to 8 slots, a decode step runs the
experts in the fused expert kernel; more send every step through the
capacity-grouped dispatch that prefill chunks take. Nothing enforces this,
as the JAX engine enforces nothing.

The cache is created as the JAX engine creates it: `rt.kv_bits` (3 for
TQ3, 4, 8, or bf16 without `kv_quant`) and no codebook, so
`rt.kv_codebook` is ignored here as it is there (the model's config carries
`kv_rotate`: `Llm` sets it from `rt.kv_rotate`).

Not ported: the JAX engine's `mesh` / `dp_axis` (the batch sharded over a
data-parallel mesh). Sampled (non-greedy) ids differ from the JAX engine's:
the two packages draw from different generators (`runtime/sampler.py`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import queue
import threading
import time
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
import torch

from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.decoder import Params, forward
from mnn_tpu_torch.runtime import kvcache, sampler
from mnn_tpu_torch.runtime.generate import run_prefill
from mnn_tpu_torch.runtime.kvcache import KVCache
from mnn_tpu_torch.runtime.prefix_cache import _from_np, _to_np
from mnn_tpu_torch.runtime.sampler import SamplerState


class Status(Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"
    TIMEOUT = "timeout"   # deadline expired


@dataclasses.dataclass
class Request:
    rid: int
    token_ids: List[int]
    max_new_tokens: int
    status: Status = Status.WAITING
    slot: int = -1
    out: "queue.SimpleQueue[Optional[int]]" = dataclasses.field(
        default_factory=queue.SimpleQueue
    )
    generated: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # absolute wall-clock deadline (perf_counter timebase); None = unlimited
    deadline: Optional[float] = None
    # per-request (token_id, bias) pairs (OpenAI logit_bias semantics)
    logit_bias: Optional[tuple] = None
    # OpenAI logprobs: -1 = off; 0 = chosen-token logprob only; k > 0 =
    # chosen + top-k alternatives. When on, out-queue items are
    # (token, logprob, [(alt_id, alt_logprob), ...]) tuples instead of ints.
    logprobs: int = -1


def prefill_slot(params: Params, config: ModelConfig, rt: RuntimeConfig,
                 cache: KVCache, ids: List[int], slot: int) -> torch.Tensor:
    """Chunked, bucketed prefill of `ids` into slot `slot` (which the caller
    has reset), in place through a slot view: the counterpart of the JAX
    engine's `_prefill_into_slot` loop. Returns the last position's logits
    [1, V]."""
    if rt.prefill_chunk < 2:
        # a chunk of T = 1 would take forward's decode path, whose kernels
        # take the whole stacked cache; a slot view of it is not contiguous
        raise ValueError("a slot prefill chunk needs at least 2 positions")
    sub = kvcache.slot_view(cache, slot)
    tokens = torch.tensor([ids], dtype=torch.int64, device=cache.length.device)
    logits, sub = run_prefill(params, config, rt, tokens, sub)
    kvcache.write_back(cache, slot, sub)
    return logits


def _decode_block(
    params: Params,
    config: ModelConfig,
    cache: KVCache,
    last_tokens: torch.Tensor,   # [B] the newest token per slot (not yet forwarded)
    state: SamplerState,
    generator: torch.Generator,
    *,
    steps: int,
    sampler_name: str,
    temperature: float,
    top_k: int,
    top_p: float,
    min_p: float,
    penalty: float,
    logit_bias: Optional[torch.Tensor] = None,   # [V] or [B, V] additive
    n_top_lp: int = -1,  # -1 off; 0 chosen logprob; k>0 chosen + top-k
):
    """Forward + sample `steps` times for the whole batch.

    Unlike `generate.decode_steps` (which samples first from given logits),
    this forwards `last_tokens` first: every slot always has a newest token,
    from its prefill or the previous block. Returns (tokens [B, steps],
    cache, state[, lp [B, steps], top_ids / top_lps [B, steps, k]]);
    logprobs are of the raw model distribution (log-softmax of the unbiased
    logits), as OpenAI reports them, not of the sampler's."""
    toks, lps, tids, tvals = [], [], [], []
    tok = last_tokens
    for _ in range(steps):
        logits, cache = forward(params, config, tok[:, None], cache)
        tok, state = sampler.sample(
            logits, generator, state, sampler=sampler_name,
            temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
            penalty=penalty, logit_bias=logit_bias)
        toks.append(tok)
        if n_top_lp >= 0:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            lps.append(lsm.gather(1, tok[:, None].long())[:, 0])
            top = torch.topk(lsm, max(n_top_lp, 1), dim=-1)
            tvals.append(top.values)
            tids.append(top.indices)
    out = (torch.stack(toks, dim=1), cache, state)
    if n_top_lp < 0:
        return out
    return out + (torch.stack(lps, dim=1), torch.stack(tids, dim=1),
                  torch.stack(tvals, dim=1))


class BatchEngine:
    """Multi-request serving engine over one model instance, on the device
    that holds its weights."""

    def __init__(
        self,
        config: ModelConfig,
        params: Params,
        rt: RuntimeConfig,
        tokenizer=None,
        eos_ids=frozenset(),
    ):
        self.config = config
        self.params = params
        self.rt = rt
        self.tokenizer = tokenizer
        self.eos_ids = set(eos_ids)
        self.device = params.embedding.device
        b = rt.max_batch
        self.cache = kvcache.create(
            config.num_layers, b, config.num_kv_heads, rt.max_seq_len,
            config.head_dim, quantized=rt.kv_quant, kv_bits=rt.kv_bits,
            device=self.device)
        self.state = sampler.make_state(b, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rt.seed)
        self.last_tokens = torch.zeros((b,), dtype=torch.int32, device=self.device)
        # dense [V] additive logit bias from rt.logit_bias (id, bias) pairs,
        # kept on the host too for the per-slot rows
        self._global_bias = None
        self._logit_bias = None
        if rt.logit_bias:
            lb = np.zeros((config.vocab_size,), np.float32)
            for tid, bias in rt.logit_bias:
                if 0 <= int(tid) < lb.shape[0]:
                    lb[int(tid)] = float(bias)
            self._global_bias = lb
            self._logit_bias = torch.from_numpy(lb).to(self.device)
        # lazily-materialized [B, V] per-slot bias (global + per-request)
        self._bias_rows: Optional[torch.Tensor] = None
        self.slots: List[Optional[Request]] = [None] * b
        self.waiting: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        self.requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self.prefill_priority = True
        self.steps_per_block = max(rt.decode_block, 1)

    # -- submission --------------------------------------------------------

    def submit(self, token_ids: List[int], max_new_tokens: Optional[int] = None,
               timeout_s: Optional[float] = None,
               logit_bias=None, logprobs: int = -1) -> Request:
        """timeout_s (default rt.timeout_s, 0 = unlimited): wall-clock
        deadline; expired requests finish with Status.TIMEOUT between
        decode blocks. logprobs: -1 off, 0 chosen-token logprob, k > 0
        chosen + top-k alternatives per token (out-queue items become
        (token, logprob, [(alt, lp)...]) tuples)."""
        t = timeout_s if timeout_s is not None else self.rt.timeout_s
        req = Request(
            rid=next(self._rid),
            token_ids=list(token_ids) or [0],
            max_new_tokens=max_new_tokens or self.rt.max_new_tokens,
            deadline=(time.perf_counter() + t) if t else None,
            logit_bias=tuple(logit_bias) if logit_bias else None,
            logprobs=max(-1, min(int(logprobs), 20)),
        )
        with self._lock:
            self.requests[req.rid] = req
        self.waiting.put(req)
        return req

    def cancel(self, rid: int):
        req = self.requests.get(rid)
        if req and req.status not in (Status.DONE, Status.CANCELLED):
            req.status = Status.CANCELLED
            req.out.put(None)

    # -- scheduling --------------------------------------------------------

    def _set_bias_row(self, slot: int, pairs: Optional[tuple]):
        """Write slot `slot`'s [V] bias row = global rt bias + request
        pairs (None = reset to global), in place. Materializes the [B, V]
        rows on first use: global-only serving never pays for them."""
        v = self.config.vocab_size
        base = (self._global_bias if self._global_bias is not None
                else np.zeros((v,), np.float32))
        if self._bias_rows is None:
            self._bias_rows = torch.from_numpy(base).to(self.device).expand(
                self.rt.max_batch, v).clone()
        row = base.copy()
        for tid, bias in (pairs or ()):
            if 0 <= int(tid) < v:
                row[int(tid)] += float(bias)
        self._bias_rows[slot] = torch.from_numpy(row).to(self.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _admit_one(self) -> bool:
        free = self._free_slots()
        if not free:
            return False
        try:
            req = self.waiting.get_nowait()
        except queue.Empty:
            return False
        if req.status == Status.CANCELLED:
            return True
        if req.deadline is not None and time.perf_counter() > req.deadline:
            # expired while queued: do not pay prefill + a decode block
            # just to time it out on the next step
            req.status = Status.TIMEOUT
            req.finished_at = time.perf_counter()
            req.out.put(None)
            return True
        slot = free[0]
        req.slot = slot
        req.status = Status.PREFILL
        self.slots[slot] = req

        kvcache.reset_slot(self.cache, slot)
        self.state.recent[slot] = -1
        if req.logit_bias or self._bias_rows is not None:
            self._set_bias_row(slot, req.logit_bias)
        # truncate over-long prompts to leave decode room
        limit = self.rt.max_seq_len - req.max_new_tokens - 1
        ids = req.token_ids[-max(limit, 1):]
        logits = prefill_slot(self.params, self.config, self.rt, self.cache, ids, slot)
        if req.status == Status.CANCELLED:  # cancelled mid-prefill
            self._free_slot(req)
            return True
        # first token: sampled through the configured chain on this slot's
        # logits row. It is recorded at ring position pos - 1, so that the
        # repetition penalty sees it without moving the batch's ring pointer.
        row_state = SamplerState(recent=self.state.recent[slot:slot + 1],
                                 pos=self.state.pos)
        row_bias = (self._bias_rows[slot] if self._bias_rows is not None
                    else self._logit_bias)
        tok1, _ = sampler.sample(
            logits, self.generator, row_state, sampler=self.rt.sampler,
            temperature=self.rt.temperature, top_k=self.rt.top_k,
            top_p=self.rt.top_p, min_p=self.rt.min_p, penalty=self.rt.penalty,
            logit_bias=row_bias)
        first = int(tok1[0])                 # the admission's one host read
        w = self.state.recent.shape[1]
        self.state.recent[slot, (self.state.pos - 1) % w] = first
        self.last_tokens[slot] = first
        req.generated.append(first)
        req.first_token_at = time.perf_counter()
        if req.logprobs >= 0:
            # host-side log-softmax for the single prefill-sampled token
            row = logits[0].float().cpu().numpy()
            mx = float(row.max())
            lse = mx + float(np.log(np.exp(row - mx).sum()))
            tops = []
            if req.logprobs > 0:
                top_idx = np.argpartition(-row, req.logprobs)[:req.logprobs]
                top_idx = top_idx[np.argsort(-row[top_idx])]
                tops = [(int(i), float(row[i] - lse)) for i in top_idx]
            req.out.put((first, float(row[first] - lse), tops))
        else:
            req.out.put(first)
        req.status = Status.DECODE
        self._maybe_finish(req, first, ctx=len(ids))
        return True

    def _free_slot(self, req: Request):
        if req.slot >= 0:
            if self._bias_rows is not None and req.logit_bias:
                self._set_bias_row(req.slot, None)
            self.slots[req.slot] = None
            req.slot = -1

    def _maybe_finish(self, req: Request, tok: int, ctx: int):
        if req.status == Status.CANCELLED:
            self._free_slot(req)
            return
        if req.status == Status.DONE:
            return
        if (
            tok in self.eos_ids
            or len(req.generated) >= req.max_new_tokens
            or ctx >= self.rt.max_seq_len - 1
        ):
            req.status = Status.DONE
            req.finished_at = time.perf_counter()
            req.out.put(None)
            self._free_slot(req)

    def step(self) -> bool:
        """One scheduling iteration. Returns True if any work was done.

        prefill_priority decides WHEN waiting requests are admitted (before
        or after the decode block), never WHETHER: decode-priority mode
        still admits once the in-flight block has been stepped."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        admitted = False
        # expire deadlines (checked once per block)
        now = time.perf_counter()
        for req in list(self.slots):
            if (req is not None and req.deadline is not None
                    and now > req.deadline
                    and req.status in (Status.PREFILL, Status.DECODE)):
                req.status = Status.TIMEOUT
                req.finished_at = now
                req.out.put(None)
        # reap cancellations/timeouts so their slots free up
        for req in list(self.slots):
            if req is not None and req.status in (Status.CANCELLED,
                                                  Status.TIMEOUT):
                self._free_slot(req)
        if self.prefill_priority:
            while self._admit_one():
                admitted = True
        active = [r for r in self.slots if r is not None]
        if not active:
            if not self.prefill_priority:
                while self._admit_one():
                    admitted = True
            return admitted

        steps = self.steps_per_block
        # context lengths are derived host-side: one device read per block
        base_lens = {r.rid: n for r, n in zip(self.slots, self.cache.length.tolist())
                     if r is not None}
        # logprobs are computed for the whole block when ANY active
        # request asked
        n_top_lp = max((r.logprobs for r in active), default=-1)
        outs = _decode_block(
            self.params, self.config, self.cache, self.last_tokens,
            self.state, self.generator,
            steps=steps, sampler_name=self.rt.sampler,
            temperature=self.rt.temperature, top_k=self.rt.top_k,
            top_p=self.rt.top_p, min_p=self.rt.min_p, penalty=self.rt.penalty,
            logit_bias=(self._bias_rows if self._bias_rows is not None
                        else self._logit_bias),
            n_top_lp=n_top_lp,
        )
        toks, self.cache, self.state = outs[:3]
        lp_np = tid_np = tval_np = None
        if n_top_lp >= 0:
            lp_np, tid_np, tval_np = (t.cpu().numpy() for t in outs[3:])
        toks_np = toks.cpu().numpy()             # the block's one token read
        self.last_tokens = toks[:, -1].contiguous()
        for req in list(self.slots):
            if req is None:
                continue
            for j in range(steps):
                tok = int(toks_np[req.slot, j])
                req.generated.append(tok)
                if req.logprobs >= 0 and lp_np is not None:
                    tops = [(int(tid_np[req.slot, j, t]),
                             float(tval_np[req.slot, j, t]))
                            for t in range(req.logprobs)]
                    req.out.put((tok, float(lp_np[req.slot, j]), tops))
                else:
                    req.out.put(tok)
                self._maybe_finish(req, tok, ctx=base_lens[req.rid] + j + 1)
                if req.status != Status.DECODE:
                    break
        if not self.prefill_priority:  # decode-priority: admit after
            while self._admit_one():
                pass
        return True

    def run_until_idle(self):
        while True:
            busy = self.step()
            if not busy and self.waiting.empty() and not any(self.slots):
                break

    def run_forever(self, stop_event: threading.Event, idle_sleep: float = 0.002):
        """Background scheduler loop (server mode): the one thread that
        runs the engine's device work."""
        while not stop_event.is_set():
            if not self.step():
                time.sleep(idle_sleep)

    # -- serving checkpoint / resume ----------------------------------------
    # The whole engine state (KV cache, sampler ring, generator, per-slot
    # request bookkeeping, waiting queue) round-trips through one .npz with
    # the JAX engine's keys, so a killed server resumes mid-decode without
    # re-prefilling any in-flight request. The JAX engine stores a JAX PRNG
    # key ("rng"); this one stores its generator's state under a key of its
    # own ("torch_generator").

    def snapshot(self, path: str) -> None:
        with self._lock:
            data = {}
            for name in ("k", "v"):
                arr, dt = _to_np(getattr(self.cache, name))
                data[name] = arr
                data[name + "_dtype"] = np.asarray(dt)
            if self.cache.quantized:
                data["k_scale"] = _to_np(self.cache.k_scale)[0]
                data["v_scale"] = _to_np(self.cache.v_scale)[0]
            data["length"] = _to_np(self.cache.length)[0]
            data["bits"] = np.asarray(self.cache.bits)
            data["quantized"] = np.asarray(self.cache.quantized)
            data["last_tokens"] = _to_np(self.last_tokens)[0]
            data["torch_generator"] = self.generator.get_state().numpy()
            data["sampler_recent"] = _to_np(self.state.recent)[0]
            data["sampler_pos"] = np.asarray(self.state.pos, np.int32)

            snap_now = time.perf_counter()

            def req_meta(r: Request):
                return {"rid": r.rid, "token_ids": r.token_ids,
                        "generated": r.generated,
                        "max_new_tokens": r.max_new_tokens,
                        "status": r.status.value, "slot": r.slot,
                        # deadlines are wall-clock in THIS process's
                        # timebase: persist the remaining budget, restored
                        # relative to resume time
                        "remaining_s": (max(r.deadline - snap_now, 0.0)
                                        if r.deadline is not None else None),
                        "logit_bias": (list(map(list, r.logit_bias))
                                       if r.logit_bias else None)}

            # drain + restore the waiting queue to serialize it
            waiting = []
            while not self.waiting.empty():
                waiting.append(self.waiting.get_nowait())
            for r in waiting:
                self.waiting.put(r)
            meta = {
                "slots": [req_meta(r) if r is not None else None
                          for r in self.slots],
                "waiting": [req_meta(r) for r in waiting
                            if r.status == Status.WAITING],
                "next_rid": max([r.rid for r in self.requests.values()],
                                default=-1) + 1,
                "model": self.config.name,
            }
            data["meta"] = np.asarray(json.dumps(meta))
            # write through a file handle: np.savez(str) appends ".npz",
            # which would break resume()'s exact-path lookup
            with open(path, "wb") as fh:
                np.savez(fh, **data)

    @classmethod
    def resume(cls, path: str, config: ModelConfig, params: Params,
               rt: RuntimeConfig, tokenizer=None,
               eos_ids=frozenset()) -> "BatchEngine":
        """Rebuild a snapshotted engine, also from a file the JAX engine
        wrote; in-flight requests continue decoding from their exact KV and
        sampler state (fresh output queues: reconnecting clients
        re-subscribe via `requests[rid].out`). A file without this
        engine's generator state (the JAX engine's) leaves the generator
        seeded from `rt.seed`."""
        eng = cls(config, params, rt, tokenizer=tokenizer, eos_ids=eos_ids)
        with np.load(path, allow_pickle=False) as z:
            if bool(z["quantized"]) != eng.cache.quantized or \
                    int(z["bits"]) != eng.cache.bits:
                raise ValueError("snapshot KV quantization mode mismatch")
            if tuple(z["k"].shape) != tuple(eng.cache.k.shape):
                raise ValueError(f"snapshot cache shape {z['k'].shape} != "
                                 f"engine {tuple(eng.cache.k.shape)}")
            get = lambda key, dt="": _from_np(z[key], dt, eng.device)
            ints = lambda key: get(key).to(torch.int32)
            quant = eng.cache.quantized
            eng.cache = KVCache(
                k=get("k", str(z["k_dtype"])), v=get("v", str(z["v_dtype"])),
                k_scale=get("k_scale") if quant else None,
                v_scale=get("v_scale") if quant else None,
                length=ints("length"), bits=int(z["bits"]),
                codebook=eng.cache.codebook)
            eng.last_tokens = ints("last_tokens")
            if "torch_generator" in z.files:
                eng.generator.set_state(torch.from_numpy(z["torch_generator"]))
            eng.state = SamplerState(recent=ints("sampler_recent"),
                                     pos=int(z["sampler_pos"]))
            meta = json.loads(str(z["meta"]))

        resume_now = time.perf_counter()

        def mk_req(m) -> Request:
            lb = m.get("logit_bias")
            rem = m.get("remaining_s")
            r = Request(rid=m["rid"], token_ids=list(m["token_ids"]),
                        max_new_tokens=m["max_new_tokens"],
                        status=Status(m["status"]), slot=m["slot"],
                        deadline=(resume_now + rem) if rem is not None
                        else None,
                        logit_bias=tuple(
                            (int(t), float(b)) for t, b in lb) if lb
                        else None)
            r.generated = list(m["generated"])
            eng.requests[r.rid] = r
            return r

        for i, m in enumerate(meta["slots"]):
            eng.slots[i] = mk_req(m) if m is not None else None
            # re-materialize per-slot bias rows for in-flight requests
            if eng.slots[i] is not None and eng.slots[i].logit_bias:
                eng._set_bias_row(i, eng.slots[i].logit_bias)
        for m in meta["waiting"]:
            eng.waiting.put(mk_req(m))
        eng._rid = itertools.count(meta["next_rid"])
        return eng

    # -- blocking helper ---------------------------------------------------

    def generate(self, token_ids: List[int], max_new_tokens: int) -> List[int]:
        req = self.submit(token_ids, max_new_tokens)
        out = []
        while True:
            if req.status in (Status.DONE, Status.CANCELLED) and req.out.empty():
                break
            self.step()
            while not req.out.empty():
                t = req.out.get()
                if t is None:
                    return out
                out.append(t)
        return out
