"""High-level LLM engine: build -> prefill -> streamed decode.

Counterpart of `mnn_tpu/runtime/llm.py` (`Llm`): the same lifecycle
(synthetic weights -> generate/stream with perf counters -> KV-cache
control) around the port's prefill and decode drivers and a
fixed-capacity KV cache on one device.

The device is chosen by the caller: `device=None` means CUDA, and without
a card that raises instead of running on the CPU. `device="cpu"` runs
every kernel's plain PyTorch version (tests, and the reference run that
the card's output is held against).

Not ported yet: `from_pretrained`, speculative decoding, KV offload,
embedding and rerank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import torch

from mnn_tpu_torch.kernels import decode_model, moe_decode
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.decoder import Params, init_random_params
from mnn_tpu_torch.runtime import generate as gen
from mnn_tpu_torch.runtime import kvcache, sampler
from mnn_tpu_torch.runtime.tokenizer import load_tokenizer


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
        self.config = config
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer(None)
        self.cache = self._new_cache()
        self.perf = PerfContext()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.rt.seed)

    @classmethod
    def synthetic(cls, preset: str = "qwen2-0.5b",
                  rt: Optional[RuntimeConfig] = None, seed: int = 0,
                  device=None) -> "Llm":
        """Random-weight model (benchmarks and smoke runs; no files). The
        weights come from a CPU generator seeded with `seed`, so every
        device gets the same weights."""
        device = resolve_device(device)
        rt = rt or RuntimeConfig()
        g = torch.Generator().manual_seed(seed)
        params = init_random_params(
            PRESETS[preset], g, quant_bits=rt.quant_bits,
            quant_block=rt.quant_block, act_bits=rt.act_bits,
            lm_head_bits=rt.lm_head_bits, device=device)
        return cls(PRESETS[preset], params, rt, device=device)

    def _new_cache(self):
        c = self.config
        return kvcache.create(
            c.num_layers, self.rt.max_batch, c.num_kv_heads,
            self.rt.max_seq_len, c.head_dim, quantized=self.rt.kv_quant,
            kv_bits=self.rt.kv_bits, device=self.device)

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
        "timeout"."""
        rt = self.rt
        if rt.speculative != "none":
            raise NotImplementedError("speculative decoding is not ported")
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

        t0 = time.perf_counter()
        logits, cache = gen.run_prefill(self.params, self.config, rt, tokens,
                                        self.cache)
        self._sync()
        self.perf.prefill_s = time.perf_counter() - t0
        self.last_prefill_logits = logits

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

    def generate(self, prompt: Optional[str] = None, **kw) -> str:
        ids = list(self.stream(prompt, **kw))
        eos = getattr(self.tokenizer, "eos_ids", set())
        if ids and ids[-1] in eos:
            ids = ids[:-1]
        return self.tokenizer.decode(ids)
