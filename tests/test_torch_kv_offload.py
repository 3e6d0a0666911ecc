"""KV host offload (`runtime/kv_offload.py`) and prefix-cache files
(`runtime/prefix_cache.py`) in the port, case for case with the JAX
package's `tests/test_kv_offload.py` and `tests/test_prefix_cache.py`:
quantized and bf16 round trips are exact, generation continues as it would
have without the trip, an unknown key restores nothing, the byte budget
spills the least recently used entry to disk and reloads it, `drop`, a
session switch through `Llm.shelve_context` / `restore_context`, and a
mode mismatch is refused. Also: a TQ3 / TQ4 round trip, an entry larger
than the budget, and the two packages reading each other's prefix files:
a file written by either continues, in the other, with the JAX package's
greedy tokens (logits within rel-L2 5e-2, the tokens equal wherever the
JAX top-2 margin exceeds the largest logit difference). The JAX side runs
without `interpret` (its plain XLA reference on the CPU), once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.runtime import prefix_cache as jprefix
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.kv_offload import KVOffloadPool
from mnn_tpu_torch.runtime.llm import Llm
from mnn_tpu_torch.runtime.prefix_cache import load_prefix, save_prefix
from tests.test_torch_decoder import jax_params, numpy_fields, rel

# tests/test_kv_offload.py's config
CFG = ModelConfig(
    name="kvoff-test", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    tie_word_embeddings=True,
)
CAP = 32
KINDS = {"bf16": dict(quantized=False), "int8": dict(quantized=True, kv_bits=8),
         "tq3": dict(quantized=True, kv_bits=3),
         "tq4": dict(quantized=True, kv_bits=4, kv_codebook=True)}


def params_of(cfg=CFG):
    return decoder.init_random_params(cfg, torch.Generator().manual_seed(0),
                                      scale=0.05, device="cpu")


def new_cache(kind="bf16", cfg=CFG, cap=CAP):
    return kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, cap, cfg.head_dim,
                          device="cpu", **KINDS[kind])


def prefilled(kind, seed=1, n=6):
    params = params_of()
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, 100, (1, n)))
    logits, cache = decoder.forward(params, CFG, toks, new_cache(kind))
    return params, cache, toks, logits


def assert_same_rows(got, want, n):
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
            continue
        assert torch.equal(a[:, 0, :, :n], b[:, 0, :, :n]), name


# --------------------------------------------------------------------------
# KVOffloadPool (tests/test_kv_offload.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_roundtrip_exact(kind):
    params, cache, toks, _ = prefilled(kind)
    pool = KVOffloadPool()
    assert pool.shelve("s1", cache, toks[0].tolist()) == 6
    restored, tokens = pool.restore("s1", new_cache(kind))
    assert tokens == toks[0].tolist()
    assert int(restored.length[0]) == 6
    assert_same_rows(restored, cache, 6)


def test_generation_continues_identically():
    params, cache, toks, _ = prefilled("bf16")
    nxt = torch.tensor([[7]])
    pool = KVOffloadPool()
    pool.shelve("ctx", cache, toks[0].tolist())
    want, _ = decoder.forward(params, CFG, nxt, cache)
    restored, _ = pool.restore("ctx", new_cache())
    got, _ = decoder.forward(params, CFG, nxt, restored)
    assert torch.equal(got, want)


def test_unknown_key():
    pool = KVOffloadPool()
    assert pool.restore("nope", new_cache()) is None
    assert "nope" not in pool


def test_lru_spills_to_disk_and_reloads(tmp_path):
    params, cache, toks, _ = prefilled("bf16")
    probe = KVOffloadPool()
    probe.shelve("probe", cache, toks[0].tolist())
    per = probe.bytes
    pool = KVOffloadPool(max_bytes=2 * per + per // 2, spill_dir=str(tmp_path))
    for i in range(4):
        _, c_i, t_i, _ = prefilled("bf16", seed=10 + i)
        pool.shelve(f"s{i}", c_i, t_i[0].tolist())
    st = pool.stats()
    assert st["entries"] <= 3 and st["spilled"] >= 1
    assert len(list(tmp_path.iterdir())) == st["spilled"]
    # a spilled entry restores transparently
    _, c0, t0, _ = prefilled("bf16", seed=10)
    restored, tokens = pool.restore("s0", new_cache())
    assert tokens == t0[0].tolist()
    assert_same_rows(restored, c0, 6)


def test_entry_above_the_budget_spills_and_reloads(tmp_path):
    """A budget below one entry: the pool keeps its newest entry in memory,
    spills the older one, and reloads it (quantized, scales included)."""
    _, c_a, t_a, _ = prefilled("int8", seed=2)
    _, c_b, t_b, _ = prefilled("int8", seed=3)
    pool = KVOffloadPool(max_bytes=1, spill_dir=str(tmp_path))
    pool.shelve("a", c_a, t_a[0].tolist())
    pool.shelve("b", c_b, t_b[0].tolist())
    assert pool.stats() == {"entries": 1, "bytes": pool.bytes, "spilled": 1}
    restored, tokens = pool.restore("a", new_cache("int8"))
    assert tokens == t_a[0].tolist() and "a" in pool
    assert_same_rows(restored, c_a, 6)
    assert pool.stats()["spilled"] == 1          # "b" went to disk in its turn


def test_drop():
    params, cache, toks, _ = prefilled("bf16")
    pool = KVOffloadPool()
    pool.shelve("x", cache, toks[0].tolist())
    assert pool.drop("x")
    assert "x" not in pool and pool.bytes == 0
    assert not pool.drop("x")


def test_restore_refuses_a_cache_of_other_shapes():
    _, cache, toks, _ = prefilled("int8")
    pool = KVOffloadPool()
    pool.shelve("x", cache, toks[0].tolist())
    other = dataclasses.replace(CFG, num_kv_heads=1, num_heads=2)
    with pytest.raises(ValueError, match="does not fit"):
        pool.restore("x", new_cache("int8", other))


@pytest.mark.parametrize("kind", ["bf16", "int8", "tq3"])
def test_session_switch(kind):
    """Another session served between shelve and restore writes the same
    device cache: the shelved rows and scales must be the pool's own copies."""
    kw = dict(KINDS[kind], kv_quant=KINDS[kind]["quantized"])
    del kw["quantized"]
    rt = RuntimeConfig(max_seq_len=CAP, max_batch=1, prefill_chunk=8, decode_block=2,
                       sampler="greedy", max_new_tokens=4, **kw)
    params = params_of()
    llm = Llm(CFG, params, rt=rt, device="cpu")
    pool = KVOffloadPool()

    list(llm.stream(token_ids=[1, 2, 3], max_new_tokens=3))
    ctx_a = llm.context_len
    snap = dataclasses.replace(llm.cache, **{
        f: getattr(llm.cache, f).clone() for f in ("k", "v", "k_scale", "v_scale")
        if getattr(llm.cache, f) is not None})
    assert llm.shelve_context("A", pool) == ctx_a
    assert llm.context_len == 0

    list(llm.stream(token_ids=[9, 8], max_new_tokens=2))
    llm.shelve_context("B", pool)

    assert llm.restore_context("A", pool)
    assert llm.context_len == ctx_a
    assert_same_rows(llm.cache, snap, ctx_a)
    assert not llm.restore_context("C", pool)
    # continuing session A gives the tokens of a run that was never shelved
    llm2 = Llm(CFG, params, rt=rt, device="cpu")
    list(llm2.stream(token_ids=[1, 2, 3], max_new_tokens=3))
    cont = list(llm.stream(token_ids=[5], max_new_tokens=3))
    cont2 = list(llm2.stream(token_ids=[5], max_new_tokens=3))
    assert cont == cont2


def test_response_is_generate_through_the_template():
    rt = RuntimeConfig(max_seq_len=64, prefill_chunk=32, sampler="greedy",
                       max_new_tokens=4)
    llm = Llm(PRESETS["tiny"], params_of(PRESETS["tiny"]), rt=rt, device="cpu")
    got = llm.response("hi there")
    llm.reset()            # a request continues the context, as in the JAX package
    want = llm.generate("hi there", use_template=True)
    assert got == want
    assert llm.perf.prompt_len == len(llm.tokenizer.encode(
        llm.tokenizer.apply_chat_template([{"role": "user", "content": "hi there"}])))


# --------------------------------------------------------------------------
# prefix-cache files (tests/test_prefix_cache.py)
# --------------------------------------------------------------------------

TINY = PRESETS["tiny"]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_prefix_roundtrip_continuation(tmp_path, kind):
    params = params_of(TINY)
    prompt = [5, 9, 2, 7, 3, 1] if kind == "bf16" else [4, 4, 2, 9]
    _, cache = decoder.forward(params, TINY, torch.tensor([prompt]), new_cache(kind, TINY))
    p = str(tmp_path / "prefix")                 # no extension: the same path loads
    assert save_prefix(p, cache, prompt) == len(prompt)
    restored, toks = load_prefix(p, new_cache(kind, TINY))
    assert toks == prompt and int(restored.length[0]) == len(prompt)
    want, _ = decoder.forward(params, TINY, torch.tensor([[8]]), cache)
    got, _ = decoder.forward(params, TINY, torch.tensor([[8]]), restored)
    assert torch.equal(got, want)


def test_prefix_mode_mismatch_rejected(tmp_path):
    params = params_of(TINY)
    _, cache = decoder.forward(params, TINY, torch.tensor([[1, 2]]), new_cache("int8", TINY))
    p = str(tmp_path / "m.npz")
    save_prefix(p, cache, [1, 2])
    with pytest.raises(ValueError, match="quantization mode"):
        load_prefix(p, new_cache("bf16", TINY))
    with pytest.raises(ValueError, match="kv bits mismatch"):
        load_prefix(p, new_cache("tq3", TINY))
    with pytest.raises(ValueError, match="exceeds capacity"):
        load_prefix(p, new_cache("int8", TINY, cap=1))


# --------------------------------------------------------------------------
# prefix files across the two packages
# --------------------------------------------------------------------------

PROMPT, STEPS, XCAP = 12, 4, 32
XKINDS = ("bf16", "int8", "tq3")


def jax_continue(params, cfg, cache, first_logits, feed=None):
    """STEPS decode steps from a prefilled JAX cache, fed `feed` or the
    greedy tokens."""
    rows, toks = [np.asarray(first_logits, np.float32)], []
    for s in range(STEPS):
        toks.append(int(np.argmax(rows[-1][0])) if feed is None else feed[s])
        logits, cache = jdec.forward(params, cfg, jnp.asarray([[toks[-1]]], jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return rows, toks


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """Per cache kind: the JAX package's prefill of the prompt saved to a
    file and continued greedily; the port's prefill saved to a file, loaded
    by the JAX package and continued."""
    d = tmp_path_factory.mktemp("prefix")
    jcfg = J_PRESETS["tiny"]
    jp = jax_params(jcfg)
    params = decoder.params_from_numpy(numpy_fields(jp), TINY, "cpu")
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, PROMPT).tolist()
    out = dict(params=params, ids=ids)
    for kind in XKINDS:
        kw = KINDS[kind]
        cache = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, XCAP, jcfg.head_dim, **kw)
        logits, cache = jdec.forward(jp, jcfg, jnp.asarray([ids], jnp.int32), cache)
        jax_file = str(d / f"jax_{kind}.npz")
        jprefix.save_prefix(jax_file, cache, ids)
        rows, toks = jax_continue(jp, jcfg, cache, logits)
        # the port's prefill, saved by the port, loaded by the JAX package
        port_file = str(d / f"port_{kind}.npz")
        pl, pc = decoder.forward(params, TINY, torch.tensor([ids]),
                                 new_cache(kind, TINY, XCAP))
        save_prefix(port_file, pc, ids)
        fresh = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, XCAP, jcfg.head_dim, **kw)
        loaded, loaded_ids = jprefix.load_prefix(port_file, fresh)
        from_port = jax_continue(jp, jcfg, loaded, pl.float().numpy(), toks)
        out[kind] = dict(jax_file=jax_file, rows=rows, toks=toks, loaded_ids=loaded_ids,
                         from_port=from_port, port_cache=pc,
                         jax_k=np.asarray(cache.k[:, 0, :, :PROMPT]).view(np.uint8))
    return out


def held_to(got_rows, want_rows, label):
    """Rows fed the JAX package's greedy tokens, against its own: rel-L2 per
    step, and the greedy token wherever the JAX margin is clear."""
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got_rows, want_rows))
    checked = 0
    for s, (a, b) in enumerate(zip(got_rows, want_rows)):
        assert np.isfinite(a).all()
        assert rel(a, b) <= 5e-2, f"{label} step {s}: rel-L2 {rel(a, b):.3g}"
        top2 = np.sort(b[0])[-2:]
        if top2[1] - top2[0] > diff:
            checked += 1
            assert int(a.argmax()) == int(b.argmax()), f"{label} step {s}"
    assert checked >= 1, label


@pytest.mark.parametrize("kind", XKINDS)
def test_jax_prefix_file_continues_in_the_port(cross, kind):
    ref = cross[kind]
    cache, toks = load_prefix(ref["jax_file"], new_cache(kind, TINY, XCAP))
    assert toks == cross["ids"] and int(cache.length[0]) == PROMPT
    # the saved bytes arrived unchanged
    assert np.array_equal(cache.k[:, 0, :, :PROMPT].contiguous().view(torch.uint8).numpy()
                          .reshape(-1), ref["jax_k"].reshape(-1))
    rows = [ref["rows"][0]]
    for tok in ref["toks"]:
        logits, cache = decoder.forward(cross["params"], TINY, torch.tensor([[tok]]), cache)
        rows.append(logits.float().numpy())
    held_to(rows, ref["rows"], f"jax file in the port, {kind}")


@pytest.mark.parametrize("kind", XKINDS)
def test_port_prefix_file_continues_in_jax(cross, kind):
    ref = cross[kind]
    assert ref["loaded_ids"] == cross["ids"]
    rows, toks = ref["from_port"]
    assert toks == ref["toks"]          # fed the JAX package's tokens
    held_to(rows, ref["rows"], f"port file in jax, {kind}")
