"""The port's continuous-batching engine against the JAX package's, on the CPU.

The same weights (the JAX package's `init_random_params` with the random
norms and biases of `tests/test_torch_decoder.py`, an int4 lm head) cross to
the port through `params_from_numpy`, and the same requests run through
both engines: `tiny`, capacity 64, prefill chunks of 16, decode blocks of 4,
greedy. The JAX side runs as its own engine tests run it
(`tests/test_batch_engine.py`), every scenario once, in one module-scoped
fixture (XLA:CPU fails after a few hundred compilations in one process),
with logprobs on so that each step's top-2 margin is known.

Rules. Against the JAX engine, tokens agree at every step up to the first
one where they differ, and that step must be one where the JAX engine's
top-2 logprob margin is within 2 * LP_TOL (two rows that each move by at
most LP_TOL can swap there). Logprobs agree within LP_TOL = 3e-2 absolute
(twice the largest difference seen on these weights, 1.6e-2: the two
packages sum bf16 products in other orders); top-k ids are compared where
the JAX row's gaps exceed 2 * LP_TOL. Against the port's own `Llm.stream`
at batch 1 the tokens are equal: the plain versions on the CPU treat every
batch row alone.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.batch_engine import BatchEngine, Status
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import jax_params, numpy_fields

CFG = PRESETS["tiny"]
LP_TOL = 3e-2
RT = dict(max_seq_len=64, prefill_chunk=16, decode_block=4, sampler="greedy",
          kv_quant=False, max_new_tokens=8)
# tests/test_torch_moe.py's config with a shared expert
MOE = dict(name="tiny-moe-d64", vocab_size=256, hidden_size=128,
           intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=64, tie_word_embeddings=True, attention_bias=True,
           num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
           shared_expert_intermediate_size=128, norm_topk_prob=False)

_rng = np.random.default_rng(5)
# 5 (one padded bucket), 20 (a full chunk, then 4 of a 16-bucket), 37
PROMPTS = [_rng.integers(0, 256, n).tolist() for n in (5, 20, 37)]
FIVE = [_rng.integers(0, 256, n).tolist() for n in (3, 9, 17, 4, 12)]
LATE = [_rng.integers(0, 256, n).tolist() for n in (6, 11)]
# three long prompts, each truncated to 64 - 20 - 1 = 43 tokens
LONG = [_rng.integers(0, 256, 50).tolist() for _ in range(3)]


def rt(**kw):
    return dict(RT, **kw)


def drain(req):
    items = []
    while not req.out.empty():
        items.append(req.out.get())
    assert items[-1] is None
    return items[:-1]


def jax_run(cfg, params, kw, prompts, max_new, logprobs=2, late=None,
            one_by_one=False):
    """The JAX engine over `prompts`: all submitted at once, or each run to
    the end before the next (`one_by_one`); `late`: one more submitted
    after the first step. Returns each request's out items."""
    eng = JBatchEngine(cfg, params, JRuntimeConfig(**kw))
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p, max_new, logprobs=logprobs))
        if one_by_one:
            eng.run_until_idle()
    if late is not None:
        eng.step()
        reqs.append(eng.submit(late[0], late[1], logprobs=logprobs))
    eng.run_until_idle()
    assert all(r.status.value == "done" for r in reqs)
    return [drain(r) for r in reqs]


@pytest.fixture(scope="module")
def ref():
    jp = jax_params(J_PRESETS["tiny"])
    mcfg = JModelConfig(**MOE)
    mp = jdec.init_random_params(mcfg, jax.random.PRNGKey(0), scale=0.05)
    tiny = J_PRESETS["tiny"]
    return dict(
        arrays=numpy_fields(jp), moe_arrays=numpy_fields(mp),
        bf16=jax_run(tiny, jp, rt(max_batch=3), PROMPTS, 8),
        int8=jax_run(tiny, jp, rt(max_batch=3, kv_quant=True), PROMPTS, 8),
        single=jax_run(tiny, jp, rt(max_batch=2), PROMPTS[1:2], 8),
        five=jax_run(tiny, jp, rt(max_batch=2), FIVE, 4),
        late=jax_run(tiny, jp, rt(max_batch=2), LATE[:1], 12, late=(LATE[1], 4)),
        lp3=jax_run(tiny, jp, rt(max_batch=2), PROMPTS[1:], 8, logprobs=3),
        full=jax_run(tiny, jp, rt(max_batch=3, decode_block=8), LONG, 20,
                     one_by_one=True),
        moe=jax_run(mcfg, mp, rt(max_batch=2, kv_quant=True), PROMPTS[:2], 8),
    )


@pytest.fixture(scope="module")
def params(ref):
    return decoder.params_from_numpy(ref["arrays"], CFG, "cpu")


def engine(params, cfg=CFG, **kw):
    return BatchEngine(cfg, params, RuntimeConfig(**rt(**kw)))


def held_to_jax(jax_items, port_toks, label) -> int:
    """The margin rule of the module docstring; returns the steps compared
    equal."""
    jtoks = [it[0] for it in jax_items]
    assert len(port_toks) == len(jtoks), label
    for s, (j, p) in enumerate(zip(jtoks, port_toks)):
        if j != p:
            tops = jax_items[s][2]
            margin = tops[0][1] - tops[1][1]
            assert margin <= 2 * LP_TOL, (
                f"{label}: step {s} token {p} != jax {j} at top-2 margin {margin:.3g}")
            return s
    return len(jtoks)


def single_stream(params, prompt, n, cfg=CFG, **kw):
    llm = Llm(cfg, params, RuntimeConfig(**rt(max_batch=1, **kw)), device="cpu")
    return list(llm.stream(token_ids=prompt, max_new_tokens=n))


def test_single_request_matches_jax_and_llm(ref, params):
    eng = engine(params, max_batch=2)
    got = eng.generate(PROMPTS[1], 8)
    assert got == single_stream(params, PROMPTS[1], 8)
    assert held_to_jax(ref["single"][0], got, "single") >= 4
    assert eng.slots == [None, None] and eng.device == torch.device("cpu")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_concurrent_requests_match_sequential(ref, params, kv):
    quant = kv == "int8"
    eng = engine(params, max_batch=3, kv_quant=quant)
    assert eng.cache.bits == (8 if quant else 16)
    reqs = [eng.submit(p, 8) for p in PROMPTS]
    eng.run_until_idle()
    compared = 0
    for i, (req, p) in enumerate(zip(reqs, PROMPTS)):
        assert req.status == Status.DONE and len(req.generated) == 8
        assert req.generated == single_stream(params, p, 8, kv_quant=quant)
        compared += held_to_jax(ref[kv][i], req.generated, f"{kv} request {i}")
    assert compared >= 12


def test_more_requests_than_slots(ref, params):
    eng = engine(params, max_batch=2)
    reqs = [eng.submit(p, 4) for p in FIVE]
    eng.run_until_idle()
    compared = 0
    for i, (req, p) in enumerate(zip(reqs, FIVE)):
        assert req.status == Status.DONE
        assert req.generated == single_stream(params, p, 4)
        compared += held_to_jax(ref["five"][i], req.generated, f"request {i}")
    assert compared >= 10
    assert eng.slots == [None, None] and eng.waiting.empty()


def test_late_arrival_joins_batch(ref, params):
    eng = engine(params, max_batch=2)
    r1 = eng.submit(LATE[0], 12)
    eng.step()                        # r1 admitted and decoding
    assert r1.status == Status.DECODE and len(r1.generated) == 1 + RT["decode_block"]
    r2 = eng.submit(LATE[1], 4)
    eng.run_until_idle()
    assert r1.status == Status.DONE and r2.status == Status.DONE
    assert r1.generated == single_stream(params, LATE[0], 12)
    assert r2.generated == single_stream(params, LATE[1], 4)
    assert held_to_jax(ref["late"][0], r1.generated, "first") \
        + held_to_jax(ref["late"][1], r2.generated, "late") >= 6


def test_cancellation(params):
    eng = engine(params, max_batch=1)
    r1 = eng.submit([1, 2, 3], 8)
    eng.cancel(r1.rid)
    r2 = eng.submit([2, 3, 4], 4)
    eng.run_until_idle()
    assert r1.status == Status.CANCELLED and r1.generated == []
    assert r2.status == Status.DONE and len(r2.generated) == 4
    # a request cancelled while decoding frees its slot at the next step
    r3 = eng.submit([5, 6], 30)
    eng.step()
    eng.cancel(r3.rid)
    eng.step()
    assert r3.status == Status.CANCELLED and eng.slots == [None]


def test_eos_frees_slot(params):
    eng = engine(params, max_batch=1)
    # every generated token is EOS -> finishes after the first token
    eng.eos_ids = set(range(CFG.vocab_size))
    r = eng.submit([1, 2, 3], 8)
    eng.run_until_idle()
    assert r.status == Status.DONE and len(r.generated) == 1
    assert eng.slots[0] is None


def test_slot_runs_to_capacity_beside_idle_rows(ref, params):
    """Three long requests one after another in slot 0, each prompt
    truncated to leave room for its 20 tokens, in decode blocks of 8: the
    slot runs past its capacity in the last block (43 + 24 positions,
    written clamped to the last one) while two idle slots decode filler,
    until their lengths reach the capacity too. Each request's tokens are
    its single-stream ones."""
    eng = engine(params, max_batch=3, decode_block=8)
    compared = 0
    for i, prompt in enumerate(LONG):
        req = eng.submit(prompt, 20)
        eng.run_until_idle()
        assert req.status == Status.DONE and len(req.generated) == 20
        assert req.generated == single_stream(params, prompt[-43:], 20, decode_block=8)
        compared += held_to_jax(ref["full"][i], req.generated, f"long request {i}")
        # 43 + 3 blocks of 8, clamped; the idle rows 24 positions a request
        assert eng.cache.length.tolist() == [64] + [min(24 * (i + 1), 64)] * 2
    assert compared >= 6
    assert all(0 <= t < CFG.vocab_size for t in eng.last_tokens.tolist())


def test_reset_slot_decodes_from_an_empty_row(params):
    """An idle slot reset to length 0 decodes its filler over just the
    positions it writes: its token after a block is the one a fresh cache
    gives from the same token."""
    eng = engine(params, max_batch=2)
    eng.generate([4, 5, 6], 4)
    kvcache.reset_slot(eng.cache, 1)
    tok = eng.last_tokens[1:2].clone()
    eng.submit([9, 9, 9], 8)
    eng.step()
    assert eng.cache.length.tolist()[1] == RT["decode_block"]
    cache = kvcache.create(CFG.num_layers, 1, CFG.num_kv_heads, 64, CFG.head_dim,
                           quantized=False)
    for _ in range(RT["decode_block"]):
        logits, cache = decoder.forward(params, CFG, tok[:, None], cache)
        tok = logits.argmax(dim=-1).to(torch.int32)
    assert int(eng.last_tokens[1]) == int(tok[0])


def test_slot_view_writes_the_shared_cache_in_place():
    cache = kvcache.create(2, 3, 2, 16, 8, quantized=True)
    cache.length[:] = torch.tensor([3, 5, 7], dtype=torch.int32)
    view = kvcache.slot_view(cache, 1)
    assert view.k.shape == (2, 1, 2, 16, 8) and view.k[0].is_contiguous()
    assert view.k.data_ptr() == cache.k[:, 1].data_ptr()
    rows = torch.randn(1, 2, 4, 8)
    kvcache.append_stacked(view, 1, rows, rows, view.length[0])
    assert torch.equal(cache.k[1, 1, :, 5:9], view.k[1, 0, :, 5:9])
    assert cache.k[1, 1].abs().sum() > 0 and cache.k[1, 0].abs().sum() == 0
    view = kvcache.with_length(view, view.length + 4)
    assert cache.length.tolist() == [3, 5, 7]          # until written back
    kvcache.write_back(cache, 1, view)
    assert cache.length.tolist() == [3, 9, 7]
    kvcache.reset_slot(cache, 2)
    assert cache.length.tolist() == [3, 9, 0]


def test_prefill_chunk_of_one_position_is_refused(params):
    from mnn_tpu_torch.runtime import batch_engine

    eng = engine(params, max_batch=2)
    rt = dataclasses.replace(eng.rt, prefill_chunk=1)
    with pytest.raises(ValueError, match="at least 2 positions"):
        batch_engine.prefill_slot(params, CFG, rt, eng.cache, [3, 4], 0)
    assert eng.cache.length.tolist() == [0, 0]


def test_per_request_logit_bias(params):
    """tests/test_timeout_bias.py's case: one request forced to a token, its
    neighbour unbiased, then a token banned; the bias rows are reset when a
    biased request frees its slot."""
    eng = engine(params, max_batch=2, decode_block=2)
    plain_ref = single_stream(params, [1, 2], 3, decode_block=2)
    r_biased = eng.submit([1, 2], max_new_tokens=3, logit_bias=((42, 1000.0),))
    r_plain = eng.submit([1, 2], max_new_tokens=3)
    eng.run_until_idle()
    assert r_biased.generated == [42, 42, 42]
    assert r_plain.generated == plain_ref != [42, 42, 42]
    assert float(eng._bias_rows.abs().max()) == 0.0
    banned = plain_ref[0]
    r_ban = eng.submit([1, 2], max_new_tokens=3, logit_bias=((banned, -1e9),))
    eng.run_until_idle()
    assert banned not in r_ban.generated and len(r_ban.generated) == 3


def test_global_logit_bias_from_runtime(params):
    eng = engine(params, max_batch=2, logit_bias=((17, 1000.0),))
    assert eng.generate([1, 2, 3], 5) == [17] * 5


def test_deadline_gives_timeout(params):
    eng = engine(params, max_batch=1, decode_block=2, max_new_tokens=10_000)
    req = eng.submit([1, 2, 3], max_new_tokens=10_000, timeout_s=1e-9)
    for _ in range(50):
        eng.step()
        if req.status == Status.TIMEOUT:
            break
    assert req.status == Status.TIMEOUT and req.finished_at is not None
    assert all(r is not req for r in eng.slots)
    assert drain(req) == []           # expired while queued: never prefilled


def test_logprobs_match_jax(ref, params):
    """Chosen-token logprobs and the top-3, request 0 with 3 alternatives and
    request 1 with the chosen one only, against the JAX engine's."""
    eng = engine(params, max_batch=2)
    reqs = [eng.submit(PROMPTS[1], 8, logprobs=3), eng.submit(PROMPTS[2], 8, logprobs=0)]
    eng.run_until_idle()
    items = [drain(r) for r in reqs]
    assert all(len(t) == 3 and len(t[2]) == 3 for t in items[0])
    assert all(t[2] == [] for t in items[1])
    checked = ids = 0
    for want, got, label in zip(ref["lp3"], items, ("top-3", "chosen")):
        n = held_to_jax(want, [t[0] for t in got], label)
        for s in range(n):
            assert abs(got[s][1] - want[s][1]) <= LP_TOL, (label, s)
            checked += 1
            jtops, ptops = want[s][2], got[s][2]
            for t in range(len(ptops)):
                gaps = [jtops[t][1] - jtops[t + 1][1]] if t + 1 < len(jtops) else []
                if t > 0:
                    gaps.append(jtops[t - 1][1] - jtops[t][1])
                if all(g > 2 * LP_TOL for g in gaps):
                    assert ptops[t][0] == jtops[t][0], (label, s, t)
                    assert abs(ptops[t][1] - jtops[t][1]) <= LP_TOL
                    ids += 1
    assert checked >= 8 and ids >= 4
    # the top-3 are sorted, and the chosen greedy token is the first
    for tok, lp, tops in items[0]:
        assert tops[0][0] == tok and tops[0][1] == pytest.approx(lp)
        assert tops[0][1] >= tops[1][1] >= tops[2][1]


def test_moe_at_two_slots_matches_jax(ref):
    cfg = ModelConfig(**MOE)
    p = decoder.params_from_numpy(ref["moe_arrays"], cfg, "cpu")
    eng = engine(p, cfg=cfg, max_batch=2, kv_quant=True)
    reqs = [eng.submit(q, 8) for q in PROMPTS[:2]]
    eng.run_until_idle()
    compared = 0
    for i, (req, q) in enumerate(zip(reqs, PROMPTS[:2])):
        assert req.generated == single_stream(p, q, 8, cfg=cfg, kv_quant=True)
        compared += held_to_jax(ref["moe"][i], req.generated, f"moe request {i}")
    assert compared >= 6
    # two rows decode through the fused expert kernel's path
    llm = Llm(cfg, p, RuntimeConfig(**rt(max_batch=2, kv_quant=True)), device="cpu")
    assert llm.info()["decode_moe_fused"]


def test_sampled_decoding_is_reproducible_from_the_seed(params):
    kw = dict(max_batch=2, sampler="mixed", temperature=0.9, seed=11)
    outs = []
    for _ in range(2):
        eng = engine(params, **kw)
        reqs = [eng.submit(p, 8) for p in PROMPTS[:2]]
        eng.run_until_idle()
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1] and all(len(g) == 8 for g in outs[0])


def test_decode_priority_admits_after_the_block(params):
    eng = engine(params, max_batch=2)
    eng.prefill_priority = False
    r1 = eng.submit(PROMPTS[0], 8)
    eng.step()                        # nothing active: admitted, no block
    assert r1.status == Status.DECODE and len(r1.generated) == 1
    r2 = eng.submit(PROMPTS[1], 8)
    eng.step()                        # r1's block first, then r2 admitted
    assert len(r1.generated) == 1 + RT["decode_block"] and len(r2.generated) == 1
    eng.run_until_idle()
    assert r2.generated == single_stream(params, PROMPTS[1], 8)
