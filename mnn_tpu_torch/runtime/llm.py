"""High-level LLM engine: build -> prefill -> streamed decode.

Counterpart of `mnn_tpu/runtime/llm.py` (`Llm`): the same lifecycle
(synthetic weights -> generate/stream with perf counters -> KV-cache
control) around the port's prefill and decode drivers and a
fixed-capacity KV cache on one device.

The device is chosen by the caller: `device=None` means CUDA, and without
a card that raises instead of running on the CPU. `device="cpu"` runs
every kernel's plain PyTorch version (tests, and the reference run that
the card's output is held against).

`from_pretrained` loads a converted checkpoint directory
(`convert/checkpoint.py`), written by either package, straight onto the
device. `RuntimeConfig.kv_rotate` turns the config's Hadamard KV rotation
on, and `kv_bits=3` / `kv_bits=4, kv_codebook=True` give a TQ3 / TQ4
codebook cache. `shelve_context` / `restore_context` move a context's KV to
a host pool (`runtime/kv_offload.py`) and back without a second prefill.
`RuntimeConfig.speculative` ("lookahead", "eagle", "eagle-tree", "mtp",
"dflash") serves greedy requests through `runtime/speculative.py`, with
random draft weights unless `drafter` is set; any other sampler decodes
plainly, as in the JAX package. `embed` pools the final-normed hidden
states into an L2-normalised vector and `rerank` scores documents by the
yes-token log-probability or by cosine, each on a throwaway bf16 cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from mnn_tpu_torch.kernels import decode_model, moe_decode
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.decoder import Params, forward, init_random_params
from mnn_tpu_torch.models.layers import rms_norm
from mnn_tpu_torch.runtime import generate as gen
from mnn_tpu_torch.runtime import kvcache, sampler
from mnn_tpu_torch.runtime.tokenizer import load_tokenizer


# the modes `stream` serves by speculative decoding (greedy only); any other
# value of rt.speculative decodes plainly, as in the JAX package
SPECULATIVE_MODES = ("lookahead", "eagle", "eagle-tree", "mtp", "dflash")


@dataclasses.dataclass
class PerfContext:
    """Counters of the last request."""

    prompt_len: int = 0
    gen_len: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    status: str = "ok"          # "ok" | "timeout"

    @property
    def prefill_tok_s(self) -> float:
        return self.prompt_len / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.gen_len / self.decode_s if self.decode_s else 0.0


class Llm:
    def __init__(
        self,
        config: ModelConfig,
        params: Params,
        rt: Optional[RuntimeConfig] = None,
        tokenizer=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.rt = rt or RuntimeConfig()
        if self.rt.kv_rotate and not config.kv_rotate:
            config = dataclasses.replace(config, kv_rotate=True)
        self.config = config
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer(None)
        self.cache = self._new_cache()
        self.perf = PerfContext()
        self.drafter = None         # the draft model of rt.speculative, made on first use
        self.spec_stats: dict = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.rt.seed)

    @classmethod
    def synthetic(cls, preset: str = "qwen2-0.5b",
                  rt: Optional[RuntimeConfig] = None, seed: int = 0,
                  device=None) -> "Llm":
        """Random-weight model (benchmarks and smoke runs; no files), any
        preset of `models/config.py` but the multimodal ones (qwen, llama,
        the MoE presets, gemma2-2b, gemma3-4b). The weights come from a CPU
        generator seeded with `seed`, so every device gets the same
        weights."""
        device = resolve_device(device)
        rt = rt or RuntimeConfig()
        g = torch.Generator().manual_seed(seed)
        params = init_random_params(
            PRESETS[preset], g, quant_bits=rt.quant_bits,
            quant_block=rt.quant_block, act_bits=rt.act_bits,
            lm_head_bits=rt.lm_head_bits, device=device)
        return cls(PRESETS[preset], params, rt, device=device)

    @classmethod
    def from_pretrained(cls, model_dir: str, rt: Optional[RuntimeConfig] = None,
                        device=None) -> "Llm":
        """Load a converted checkpoint directory onto `device` (None: the
        card). A given `rt` replaces the saved runtime.json whole; the
        tokenizer comes from the directory's files (`transformers` is
        needed when it has them), else the byte tokenizer."""
        from mnn_tpu_torch.convert.checkpoint import load_checkpoint

        device = resolve_device(device)
        config, params, saved_rt = load_checkpoint(model_dir, device=device)
        return cls(config, params, rt or saved_rt,
                   tokenizer=load_tokenizer(model_dir), device=device)

    def _new_cache(self):
        c = self.config
        return kvcache.create(
            c.num_layers, self.rt.max_batch, c.num_kv_heads,
            self.rt.max_seq_len, c.head_dim, quantized=self.rt.kv_quant,
            kv_bits=self.rt.kv_bits, kv_codebook=self.rt.kv_codebook,
            device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- introspection ---------------------------------------------------

    def info(self) -> dict:
        """Memory (params, KV, allocator), per-token FLOPs, the device and
        which decode path serves a step."""
        def nbytes(obj):
            if obj is None:
                return 0
            if isinstance(obj, torch.Tensor):
                return obj.numel() * obj.element_size()
            if dataclasses.is_dataclass(obj):
                return sum(nbytes(getattr(obj, f.name))
                           for f in dataclasses.fields(obj))
            return 0

        c = self.config
        flops_tok = 2 * c.num_layers * (
            c.hidden_size * (c.num_heads + 2 * c.num_kv_heads) * c.head_dim
            + c.q_dim * c.hidden_size)
        if c.is_moe:     # the k routed experts and the shared one
            inter = (c.num_experts_per_tok * c.moe_intermediate_size
                     + c.shared_expert_intermediate_size)
        else:
            inter = c.intermediate_size
        flops_tok += 2 * c.num_layers * 3 * c.hidden_size * inter
        flops_tok += 2 * c.hidden_size * c.vocab_size
        cuda = self.device.type == "cuda"
        return {
            "model": c.name,
            "device": (torch.cuda.get_device_name(self.device) if cuda
                       else "cpu"),
            "param_bytes": nbytes(self.params),
            "kv_cache_bytes": self.cache.nbytes(),
            "kv_bits": self.cache.bits,
            "kv_codebook": self.cache.codebook,
            "kv_rotate": c.kv_rotate,
            # does the whole-model kernel serve decode steps, and its head?
            "decode_megakernel": decode_model.supports(
                c, self.params, self.cache, self.rt.max_batch),
            "decode_fused_head": decode_model.supports_head(c, self.params),
            # mixture of experts: does the fused expert kernel serve decode
            # steps (else one pair at a time through the matmul kernel)?
            "decode_moe_fused": c.is_moe and moe_decode.supports(
                c, self.params.layers, self.rt.max_batch),
            "kv_capacity": self.cache.capacity,
            "context_len": self.context_len,
            "flops_per_token": int(flops_tok),
            "allocator": {
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.device),
                "bytes_reserved": torch.cuda.memory_reserved(self.device),
            } if cuda else None,
        }

    # -- KV-cache control -------------------------------------------------

    def reset(self):
        self.cache = kvcache.reset(self.cache)

    def rollback(self, n: int):
        self.cache = kvcache.rollback(self.cache, n)

    @property
    def context_len(self) -> int:
        return int(self.cache.length[0])

    # -- KV host offload ---------------------------------------------------

    def shelve_context(self, key: str, pool, token_ids=None) -> int:
        """Copy the current context's KV into the host pool `pool`
        (`kv_offload.KVOffloadPool`) and reset the device cache; returns the
        shelved token count. One device cache then serves many long-lived
        sessions."""
        n = pool.shelve(key, self.cache, token_ids or [0] * self.context_len)
        self.reset()
        return n

    def restore_context(self, key: str, pool) -> bool:
        """Write a shelved context back into the device cache, with no
        second prefill. False if the pool has no such key."""
        got = pool.restore(key, self.cache)
        if got is None:
            return False
        self.cache, _ = got
        return True

    # -- generation -------------------------------------------------------

    def _logit_bias(self):
        """rt.logit_bias (id, bias) pairs -> dense [V] f32 tensor or None."""
        if not self.rt.logit_bias:
            return None
        v = torch.zeros((self.config.vocab_size,), dtype=torch.float32)
        for tid, b in self.rt.logit_bias:
            if 0 <= int(tid) < v.shape[0]:
                v[int(tid)] = float(b)
        return v.to(self.device)

    def stream(
        self,
        prompt: Optional[str] = None,
        *,
        token_ids: Optional[List[int]] = None,
        max_new_tokens: Optional[int] = None,
        use_template: bool = False,
        timeout_s: Optional[float] = None,
    ) -> Iterator[int]:
        """Yield generated token ids as decode blocks complete.

        Tokens reach the host once per block of rt.decode_block steps. On
        EOS inside a block the block's unconsumed tail, already appended to
        the cache, is rolled back. `timeout_s` (default rt.timeout_s, 0 =
        none) is checked between blocks; on expiry perf.status is
        "timeout". Under greedy sampling `rt.speculative` takes the
        speculative loops instead (which check no deadline, as in the JAX
        package)."""
        rt = self.rt
        if token_ids is None:
            text = prompt or ""
            if use_template:
                text = self.tokenizer.apply_chat_template(
                    [{"role": "user", "content": prompt}])
            token_ids = self.tokenizer.encode(text)
        if not token_ids:
            token_ids = [0]
        max_new = max_new_tokens or rt.max_new_tokens
        eos = getattr(self.tokenizer, "eos_ids", set())
        deadline = timeout_s if timeout_s is not None else rt.timeout_s
        t_start = time.perf_counter()
        tokens = torch.tensor([token_ids] * rt.max_batch, dtype=torch.int64,
                              device=self.device)
        self.perf = PerfContext(prompt_len=len(token_ids))
        if rt.sampler == "greedy" and rt.speculative in SPECULATIVE_MODES:
            yield from self._stream_speculative(token_ids, max_new, eos)
            return

        t0 = time.perf_counter()
        logits, cache = gen.run_prefill(self.params, self.config, rt, tokens,
                                        self.cache)
        self._sync()
        self.perf.prefill_s = time.perf_counter() - t0
        self.last_prefill_logits = logits
        yield from self._decode(logits, cache, max_new, eos, deadline, t_start)

    def _decode(self, logits, cache, max_new: int, eos, deadline: float,
                t_start: float) -> Iterator[int]:
        """The decode loop after a prefill that left `logits` and `cache`:
        blocks of rt.decode_block steps, one host read a block, the tail
        rolled back on EOS, the deadline checked between blocks. Leaves the
        cache in `self.cache`."""
        rt = self.rt
        state = sampler.make_state(rt.max_batch, device=self.device)
        bias = self._logit_bias()
        t0 = time.perf_counter()
        produced = 0
        while produced < max_new:
            steps = min(rt.decode_block, max_new - produced)
            toks, logits, cache, state = gen.decode_steps(
                self.params, self.config, cache, logits, state,
                self.generator, steps=steps, sampler=rt.sampler,
                temperature=rt.temperature, top_k=rt.top_k, top_p=rt.top_p,
                min_p=rt.min_p, penalty=rt.penalty, logit_bias=bias)
            block = toks[0].tolist()           # one host sync per block
            produced += steps
            stop = False
            if deadline and time.perf_counter() - t_start > deadline:
                self.perf.status = "timeout"
                stop = True
            consumed = 0
            for t in block:
                consumed += 1
                self.perf.gen_len += 1
                yield t
                if t in eos:
                    stop = True
                    break
            self.perf.decode_s = time.perf_counter() - t0
            if stop:
                if steps - consumed:
                    cache = kvcache.rollback(cache, steps - consumed)
                break
        self.cache = cache

    def _make_drafter(self):
        """The draft model of rt.speculative, from random weights seeded with
        rt.seed + 1 (no draft checkpoint is configured): verification keeps
        the output the plain greedy stream's, only acceptance is low."""
        from mnn_tpu_torch.models import eagle as eagle_mod
        from mnn_tpu_torch.models.dflash import init_random_dflash
        from mnn_tpu_torch.runtime import speculative as spec

        rt, c = self.rt, self.config
        g = torch.Generator().manual_seed(rt.seed + 1)
        if rt.speculative in ("eagle", "eagle-tree"):
            ep = eagle_mod.init_random_eagle(c, g, bits=rt.quant_bits,
                                             block_size=rt.quant_block, device=self.device)
            if rt.speculative == "eagle-tree":
                return spec.TreeEagleDraft(ep, draft_len=rt.draft_len,
                                           capacity=rt.max_seq_len, fanout=rt.tree_fanout)
            return spec.EagleDraft(ep, draft_len=rt.draft_len, capacity=rt.max_seq_len)
        if rt.speculative == "dflash":
            dp = init_random_dflash(c, g, block_size=rt.draft_len, device=self.device)
            return spec.DFlashDraft(dp, capacity=rt.max_seq_len)
        return spec.MtpDraft(eagle_mod.init_random_mtp(
            c, g, num_heads=rt.draft_len, device=self.device))

    def _stream_speculative(self, token_ids, max_new, eos):
        """Greedy speculative decoding: lookahead, or a draft model
        (`self.drafter`, made by `_make_drafter` when unset). Yields tokens
        as each verify round completes; stops at EOS."""
        from mnn_tpu_torch.runtime import speculative as spec

        if self.rt.speculative == "lookahead":
            rounds = spec.lookahead_generate(self, token_ids, max_new,
                                             ngram=self.rt.ngram, draft_len=self.rt.draft_len)
        else:
            if self.drafter is None:
                self.drafter = self._make_drafter()
            gen_fn = (spec.tree_draft_generate if self.drafter.kind == "eagle-tree"
                      else spec.draft_generate)
            rounds = gen_fn(self, token_ids, max_new, drafter=self.drafter)
        t0 = time.perf_counter()
        first = True
        for block in rounds:
            if first:       # the first round's token ends the prefill
                self.perf.prefill_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                first = False
            for t in block:
                self.perf.gen_len += 1
                yield t
                if t in eos:
                    self.perf.decode_s = time.perf_counter() - t0
                    return
            self.perf.decode_s = time.perf_counter() - t0

    def generate(self, prompt: Optional[str] = None, **kw) -> str:
        ids = list(self.stream(prompt, **kw))
        eos = getattr(self.tokenizer, "eos_ids", set())
        if ids and ids[-1] in eos:
            ids = ids[:-1]
        return self.tokenizer.decode(ids)

    def response(self, prompt: str, **kw) -> str:
        """A chat-style single-turn answer: `generate` through the template."""
        return self.generate(prompt, use_template=True, **kw)

    # -- embedding and reranking -------------------------------------------

    def _scratch_cache(self, n: int):
        """A bf16 cache for one sequence of n tokens, of capacity
        max(64, the next power of 2): the chat cache stays as it is."""
        c = self.config
        return kvcache.create(c.num_layers, 1, c.num_kv_heads,
                              max(64, 1 << (n - 1).bit_length()), c.head_dim,
                              quantized=False, device=self.device)

    def embed(self, text: Optional[str] = None, *,
              token_ids: Optional[List[int]] = None,
              pooling: str = "last") -> np.ndarray:
        """Sentence embedding [hidden] f32 from the final-normed hidden
        states: the last token's ("last") or the mean over the tokens
        ("mean"), L2-normalised."""
        if token_ids is None:
            token_ids = self.tokenizer.encode(text or "")
        if not token_ids:
            token_ids = [0]
        tokens = torch.tensor([token_ids], dtype=torch.int64, device=self.device)
        hidden, _ = forward(self.params, self.config, tokens,
                            self._scratch_cache(len(token_ids)), return_hidden=True)
        hidden = rms_norm(hidden, self.params.final_norm, self.config.rms_norm_eps)
        v = hidden[0].float().mean(0) if pooling == "mean" else hidden[0, -1].float()
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-9)
        return v.cpu().numpy()

    def rerank(self, query: str, documents: List[str], *,
               yes_token_id: Optional[int] = None,
               template: str = "Query: {q}\nDocument: {d}\nRelevant:"
               ) -> List[float]:
        """Relevance score of each document to `query`: with `yes_token_id`,
        that token's log-probability after the filled template; otherwise
        the cosine of the two embeddings."""
        if yes_token_id is None:
            qv = self.embed(query)
            return [float(np.dot(qv, self.embed(d))) for d in documents]
        scores = []
        for d in documents:
            ids = self.tokenizer.encode(template.format(q=query, d=d)) or [0]
            logits, _ = forward(self.params, self.config,
                                torch.tensor([ids], dtype=torch.int64, device=self.device),
                                self._scratch_cache(len(ids)))
            logp = torch.log_softmax(logits[0].float(), dim=-1)
            scores.append(float(logp[yes_token_id]))
        return scores
