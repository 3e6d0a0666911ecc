"""Speculative decoding in the port against the JAX package, on the CPU:
n-gram lookahead, token-tree verify (`forward(tree=...)`), `return_hidden`,
chain verify and the feature prefill, the EAGLE tree drafter's stream, the
oracle drafters, and the rules of `Llm.stream`.

The JAX package's weights (`tests/test_torch_decoder.py::jax_params`: the
`tiny` preset, an int4 head, random norms and qkv bias) cross to the port
through `params_from_numpy`, its draft weights through the new
`*_from_numpy`, and are injected as `llm.drafter`. The runtime is the JAX
tests' (`tests/test_speculative.py`): cache 256, chunk 32, decode blocks
of 4, greedy, a bf16 cache, and here also an int8 one; two prompts, the
JAX tests' repeating `[5, 6, 7]` pattern (the n-grams hit) over the bf16
cache and 45 random tokens (a full chunk, then 13 of a 32-bucket) over the
int8 one.

Bounds:

* `NgramDraft` proposals and `tree_layout`: bit-exact;
* tree verify and `return_hidden`: the post-final-norm features within
  rel-L2 2e-2 (`tests/test_attention.py:59`), the head's logits within
  5e-2 (`tests/test_decode_model.py:97`), the appended K/V rows within
  3e-2 dequantized (`tests/test_attention.py:126`), 1e-1 over a grid of at
  most 4 bits (int4, TQ3: `tests/test_torch_gemma.py`'s int4 bound, where
  one bf16 ulp of a K/V value moves it a level), the greedy targets
  equal wherever the JAX top-2 margin exceeds the largest logit difference;
* a mode's stream: verification is lossless, so each package's stream is
  its own plain greedy stream up to a near-tie between the verify path
  (T > 1: the tile kernel and flash prefill, or the eager attention of a
  tree) and the decode path. The tokens are held to the JAX plain trace up
  to the first step whose JAX top-2 margin is not above the largest
  difference between its logit rows and any of the rows the streams
  compute (the port's decode, chain-verify and tree-verify rows, the JAX
  chain-verify rows), and to the port's own plain stream by the port's own
  margins; at least `MIN_CLEAR` steps must be compared. `drafted` and
  `accepted` equal JAX's wherever the whole stream and every draft agree.

The JAX side is computed once per module (XLA:CPU fails after a few
hundred compilations in one process): its plain traces and each mode's
stream through the JAX `Llm`, with its drafts recorded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime import generate as jgen
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.runtime import speculative as jspec
from mnn_tpu.runtime.llm import Llm as JLlm
from mnn_tpu_torch.models import decoder, eagle
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.runtime import generate, kvcache
from mnn_tpu_torch.runtime import speculative as spec
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import jax_params, numpy_fields, rel

CFG = PRESETS["tiny"]
J_CFG = J_PRESETS["tiny"]
PROMPTS = {"repeat": [5, 6, 7] * 4,
           "random": np.random.default_rng(3).integers(0, 256, 45).tolist()}
CACHES = {"bf16": dict(kv_quant=False), "int8": dict(kv_quant=True, kv_bits=8)}
# the (prompt, cache) pairs the streams run: each prompt and each cache once
COMBOS = [("repeat", "bf16"), ("random", "int8")]
RT_KW = dict(max_seq_len=256, prefill_chunk=32, decode_block=4, sampler="greedy")
NEW = 16            # new tokens a stream
MIN_CLEAR = 8       # the fewest steps a stream's tokens must be compared at
HIDDEN_REL, LOGIT_REL, KV_REL, KV_REL_COARSE = 2e-2, 5e-2, 3e-2, 1e-1
DRAFT_LEN = {"lookahead": 4, "eagle-tree": 3}
FANOUT = 3


def rt_of(kv: str, **kw) -> RuntimeConfig:
    return RuntimeConfig(**RT_KW, **CACHES[kv], **kw)


def jrt_of(kv: str, **kw) -> JRuntimeConfig:
    return JRuntimeConfig(**RT_KW, **CACHES[kv], **kw)


def np_rows(rows) -> np.ndarray:
    return np.stack([np.asarray(r, np.float32).reshape(-1) for r in rows])


def clear_steps(ref: np.ndarray, diff: float) -> int:
    """Leading steps whose reference top-2 margin exceeds `diff`."""
    for s, row in enumerate(ref):
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] <= diff:
            return s
    return len(ref)


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def jax_trace(jp, jcfg, jrt, ids, n):
    """The JAX plain greedy trace: n tokens, the decode-path logit rows that
    chose them (the prefill's first) and the chain-verify rows (one forward
    over the trace from the prompt's cache; row 0 is the prefill's)."""
    def prefill():
        cache = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, jrt.max_seq_len,
                           jcfg.head_dim, quantized=jrt.kv_quant, kv_bits=jrt.kv_bits)
        return jgen.run_prefill(jp, jcfg, jrt, jnp.asarray([ids], jnp.int32), cache)

    logits, cache = prefill()
    rows, toks = [np.asarray(logits[0], np.float32)], []
    for s in range(n):
        toks.append(int(np.argmax(rows[-1])))
        if s < n - 1:
            logits, cache = jdec.forward(jp, jcfg, jnp.asarray([[toks[-1]]], jnp.int32), cache)
            rows.append(np.asarray(logits[0], np.float32))
    logits, cache = prefill()
    chain, _ = jdec.forward(jp, jcfg, jnp.asarray([toks[:-1]], jnp.int32), cache,
                            all_logits=True)
    return dict(toks=toks, dec=np_rows(rows),
                chain=np.concatenate([np_rows(rows[:1]), np.asarray(chain[0], np.float32)]))


def recorded(drafter, method: str):
    """Wrap drafter.<method> so that every proposal is kept as a list."""
    log = []
    orig = getattr(drafter, method)

    def wrapped(*a):
        out = orig(*a)
        log.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out).tolist())
        return out
    setattr(drafter, method, wrapped)
    return log


def jax_stream(jp, mode, kv, ids):
    llm = JLlm(J_CFG, jp, jrt_of(kv, speculative=mode, draft_len=DRAFT_LEN[mode],
                                 tree_fanout=FANOUT))
    out = dict(drafts=None, drafter=None)
    if mode == "eagle-tree":
        llm.drafter = llm._make_drafter()
        out["drafts"] = recorded(llm.drafter, "propose_tree")
        out["drafter"] = numpy_fields(llm.drafter.ep)
    out["toks"] = list(llm.stream(token_ids=ids, max_new_tokens=NEW))
    out["stats"] = dict(llm.spec_stats)
    return out


TREE_CONFIGS = {   # name -> (config changes, cache kwargs)
    "dense-bf16": ({}, dict(quantized=False)),
    "dense-int4": ({}, dict(quantized=True, kv_bits=4)),
    "tq3": ({}, dict(quantized=True, kv_bits=3)),
    "rot-int8": (dict(kv_rotate=True), dict(quantized=True, kv_bits=8)),
    "moe-int8": ("moe", dict(quantized=True, kv_bits=8)),
}
TREE_PROMPT = 20
TREE_DEPTHS = np.array([0, 1, 2, 3, 1, 2, 3, 1, 2, 3], np.int32)   # fanout 3, depth 3


def tree_mask(depths) -> np.ndarray:
    """The ancestor mask of root + chains laid out as `tree_layout` does."""
    t = len(depths)
    mask = np.zeros((t, t), bool)
    for i in range(t):
        mask[i, 0] = True
        j = i
        while j > 0:            # a chain's nodes are consecutive, depth 1 first
            mask[i, j] = True
            if depths[j] == 1:
                break
            j -= 1
    return mask


def tree_config(name):
    from tests.test_torch_moe import FIELDS as MOE_FIELDS

    changes, cache_kw = TREE_CONFIGS[name]
    fields = (MOE_FIELDS if changes == "moe"
              else dict(dataclasses.asdict(J_CFG), **changes))
    return fields, cache_kw


def jax_tree_case(name):
    """JAX: a prefill of TREE_PROMPT tokens, then one tree verify of 10
    nodes; the cache before the verify, the targets, features and the
    appended rows as numpy."""
    fields, cache_kw = tree_config(name)
    jcfg = JModelConfig(**fields)
    jp = jax_params(jcfg)
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, TREE_PROMPT).tolist()
    nodes = np.random.default_rng(6).integers(0, jcfg.vocab_size, len(TREE_DEPTHS)).tolist()
    cache = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, 64, jcfg.head_dim, **cache_kw)
    jrt = JRuntimeConfig(max_seq_len=64, prefill_chunk=32)
    _, cache = jgen.run_prefill(jp, jcfg, jrt, jnp.asarray([ids], jnp.int32), cache)
    before = numpy_fields(cache)
    targets, feats, after = jspec._tree_verify_fwd(
        jp, jcfg, jnp.asarray([nodes], jnp.int32), jnp.asarray(TREE_DEPTHS),
        jnp.asarray(tree_mask(TREE_DEPTHS)), cache)
    return dict(fields=fields, cache_kw=cache_kw, arrays=numpy_fields(jp), nodes=nodes,
                before=before, after=numpy_fields(after),
                targets=np.asarray(targets[0]).tolist(),
                feats=np.asarray(feats.astype(jnp.float32)))


@pytest.fixture(scope="module")
def ref():
    jp = jax_params(J_CFG)
    out = dict(arrays=numpy_fields(jp), trace={}, streams={}, tree={})
    for p, kv in COMBOS:
        out["trace"][p, kv] = jax_trace(jp, J_CFG, jrt_of(kv), PROMPTS[p], NEW)
        for mode in DRAFT_LEN:
            out["streams"][mode, p, kv] = jax_stream(jp, mode, kv, PROMPTS[p])
    for name in TREE_CONFIGS:
        out["tree"][name] = jax_tree_case(name)
    # return_hidden: a 5-token chunk, then one decode step
    cache = jkv.create(J_CFG.num_layers, 1, J_CFG.num_kv_heads, 64, J_CFG.head_dim,
                       quantized=True, kv_bits=8)
    h5, cache = jdec.forward(jp, J_CFG, jnp.asarray([PROMPTS["random"][:5]], jnp.int32),
                             cache, return_hidden=True)
    h1, _ = jdec.forward(jp, J_CFG, jnp.asarray([[7]], jnp.int32), cache, return_hidden=True)
    out["hidden"] = [np.asarray(h.astype(jnp.float32)) for h in (h5, h1)]
    # chain verify (T = 5) and the feature prefill, as draft_generate runs them
    jrt = jrt_of("int8")
    cache = jkv.create(J_CFG.num_layers, 1, J_CFG.num_kv_heads, 256, J_CFG.head_dim,
                       quantized=True, kv_bits=8)
    logits, feats, cache = jspec.prefill_with_features(
        jp, J_CFG, jrt, jnp.asarray([PROMPTS["random"]], jnp.int32), cache)
    targets, vfeats, _ = jspec._verify_fwd(
        jp, J_CFG, jnp.asarray([[9, 4, 250, 3, 77]], jnp.int32), cache)
    out["prefill_feats"] = (np.asarray(logits, np.float32),
                            np.asarray(feats.astype(jnp.float32)))
    out["verify"] = (np.asarray(targets[0]).tolist(), np.asarray(vfeats.astype(jnp.float32)))
    return out


@pytest.fixture(scope="module")
def params(ref):
    return decoder.params_from_numpy(ref["arrays"], CFG, "cpu")


# --------------------------------------------------------------------------
# the port's rows along a trace
# --------------------------------------------------------------------------

def port_rows(params, cfg, rt, ids, toks):
    """The port's logit rows along the tokens `toks` [N, V] three ways, each
    from its own prefill: decode steps (T = 1), one chain verify over the
    trace (T = N - 1) and one tree verify of a single chain."""
    def prefill():
        cache = Llm(cfg, params, rt, device="cpu")._new_cache()
        return generate.run_prefill(params, cfg, rt, torch.tensor([ids]), cache)

    logits, cache = prefill()
    dec = [logits[0]]
    for tok in toks[:-1]:
        logits, cache = decoder.forward(params, cfg, torch.tensor([[tok]]), cache)
        dec.append(logits[0])
    out = dict(dec=np_rows([r.float().numpy() for r in dec]))
    t = len(toks) - 1
    for name, tree in (("chain", None),
                       ("tree", (torch.arange(t), torch.ones(t, t, dtype=torch.bool).tril()))):
        first, cache = prefill()
        logits, _ = decoder.forward(params, cfg, torch.tensor([toks[:-1]]), cache,
                                    all_logits=True, tree=tree)
        out[name] = np.concatenate([first.float().numpy(), logits[0].float().numpy()])
    return out


def check_stream(ref, params, mode, prompt, kv, port_toks, port_stats, port_drafts):
    """A mode's port stream against the JAX stream and trace, and against
    the port's own plain greedy stream, by the margin rule above."""
    ids = PROMPTS[prompt]
    tr, js = ref["trace"][prompt, kv], ref["streams"][mode, prompt, kv]
    mine = port_rows(params, CFG, rt_of(kv), ids, tr["toks"])
    diff = max(float(np.abs(r - tr["dec"]).max())
               for r in (mine["dec"], mine["chain"], mine["tree"], tr["chain"]))
    n = clear_steps(tr["dec"], diff)
    assert n >= MIN_CLEAR, f"only {n} steps clear of a {diff:.3g} logit difference"
    assert js["toks"][:n] == tr["toks"][:n], "the JAX stream left its plain trace"
    assert port_toks[:n] == tr["toks"][:n]
    plain = list(Llm(CFG, params, rt_of(kv), device="cpu").stream(
        token_ids=ids, max_new_tokens=NEW))
    assert plain[:n] == tr["toks"][:n]
    # the port's stream against its own plain stream, by its own margins
    own = max(float(np.abs(mine[k] - mine["dec"]).max()) for k in ("chain", "tree"))
    n_own = clear_steps(mine["dec"], own)
    assert n_own >= MIN_CLEAR
    assert port_toks[:n_own] == plain[:n_own]
    assert len(port_toks) == NEW and all(0 <= t < CFG.vocab_size for t in port_toks)
    if port_toks == js["toks"] and port_drafts == js["drafts"]:
        assert port_stats == js["stats"]
    return n


# --------------------------------------------------------------------------
# n-gram lookahead
# --------------------------------------------------------------------------

NGRAM_HISTORIES = {
    "random": np.random.default_rng(9).integers(0, 6, 200).tolist(),
    "repeating": ([5, 6, 7] * 20 + [1, 2, 3, 4] * 10 + [5, 6, 7, 1, 2]) * 2,
}


@pytest.mark.parametrize("name", NGRAM_HISTORIES)
@pytest.mark.parametrize("draft_len", [1, 4, 7])
def test_ngram_draft_matches_jax(name, draft_len):
    """After every token of the history, the same proposal (or none)."""
    mine, theirs = spec.NgramDraft(draft_len=draft_len), jspec.NgramDraft(draft_len=draft_len)
    proposals = 0
    for t in NGRAM_HISTORIES[name]:
        mine.extend([t])
        theirs.extend([t])
        got, want = mine.propose(), theirs.propose()
        assert got == want
        proposals += want is not None
    assert proposals > 50 and mine.index == theirs.index


def test_ngram_draft_examples():
    """`tests/test_speculative.py`'s three cases."""
    d = spec.NgramDraft(draft_len=4)
    d.extend([1, 2, 3, 4, 5, 1, 2, 3])
    assert d.propose() == [4, 5, 1, 2]
    d = spec.NgramDraft()
    d.extend([1, 2, 3])
    assert d.propose() is None
    d = spec.NgramDraft(draft_len=2, max_n=4)
    d.extend([7, 1, 2, 3, 9, 0, 1, 2, 3])
    assert d.propose() == [9, 0]


# --------------------------------------------------------------------------
# forward: tree verify and return_hidden
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fanout,depth", [(3, 4), (1, 3), (2, 1), (4, 2)])
def test_tree_layout_matches_jax(fanout, depth):
    mine = spec.TreeEagleDraft(None, draft_len=depth, fanout=fanout)
    theirs = jspec.TreeEagleDraft(None, draft_len=depth, fanout=fanout)
    depths, mask = mine.tree_layout()
    jd, jm = theirs.tree_layout()
    assert mine.n_nodes == theirs.n_nodes == 1 + fanout * depth
    np.testing.assert_array_equal(depths.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tree_mask(depths.numpy()), np.asarray(jm))


def dequant_rows(cache: kvcache.KVCache, lo: int, hi: int) -> torch.Tensor:
    """K and V rows lo..hi-1 of every layer, dequantized to f32."""
    def one(vals, scale):
        sl = vals[:, :, :, lo:hi]
        sc = None if scale is None else scale[:, :, :, lo:hi]
        return kvcache.dequant_kv(sl, sc, cache.bits, dtype=torch.float32,
                                  codebook=cache.codebook)
    return torch.cat([one(cache.k, cache.k_scale), one(cache.v, cache.v_scale)])


@pytest.mark.parametrize("name", TREE_CONFIGS)
def test_tree_verify_matches_jax(ref, name):
    """One tree verify of 10 nodes (fanout 3, depth 3) over the JAX cache of
    a 20-token prefill: dense over bf16 / int8 / int4 / TQ3 caches, under
    the Hadamard rotation (int8), and a mixture-of-experts model (int8)."""
    r = ref["tree"][name]
    cfg = ModelConfig(**r["fields"])
    params = decoder.params_from_numpy(r["arrays"], cfg, "cpu")
    bits = 16 if not r["cache_kw"]["quantized"] else r["cache_kw"]["kv_bits"]
    cache = kvcache.cache_from_numpy(r["before"], bits)
    depths = torch.from_numpy(TREE_DEPTHS)
    targets, feats, after = spec.verify_forward(
        params, cfg, torch.tensor([r["nodes"]]), cache,
        tree=(depths, torch.from_numpy(tree_mask(TREE_DEPTHS))))
    t = len(TREE_DEPTHS)
    assert int(after.length[0]) == TREE_PROMPT + t
    assert rel(feats.float().numpy(), r["feats"]) <= HIDDEN_REL
    jfeats = torch.from_numpy(r["feats"].copy()).to(torch.bfloat16)
    got = decoder.head_logits(params, feats[0]).numpy()
    want = decoder.head_logits(params, jfeats[0]).numpy()
    assert rel(got, want) <= LOGIT_REL
    diff = float(np.abs(got - want).max())
    n = 0
    for i in range(t):
        top2 = np.sort(want[i])[-2:]
        if top2[1] - top2[0] > diff:
            n += 1
            assert targets[0, i].item() == r["targets"][i], f"node {i}"
    assert n >= t // 2
    jafter = kvcache.cache_from_numpy(r["after"], bits)
    lo, hi = TREE_PROMPT, TREE_PROMPT + t
    assert rel(dequant_rows(after, lo, hi).numpy(), dequant_rows(jafter, lo, hi).numpy()) \
        <= (KV_REL if bits >= 8 else KV_REL_COARSE)
    # the prefix rows are untouched
    assert torch.equal(dequant_rows(after, 0, lo), dequant_rows(jafter, 0, lo))


def test_tree_verify_one_chain_is_chain_verify(params):
    """A tree of one chain (depths 0..T-1, a causal mask) gives the chain
    verify's logits on the same cache, through the eager attention."""
    rt = rt_of("int8")
    ids = PROMPTS["random"]
    toks = [3, 140, 77, 9, 200, 31]
    outs = []
    for tree in (None, (torch.arange(6), torch.ones(6, 6, dtype=torch.bool).tril())):
        cache = Llm(CFG, params, rt, device="cpu")._new_cache()
        _, cache = generate.run_prefill(params, CFG, rt, torch.tensor([ids]), cache)
        logits, cache = decoder.forward(params, CFG, torch.tensor([toks]), cache,
                                        all_logits=True, tree=tree)
        outs.append(logits[0].numpy())
        assert int(cache.length[0]) == len(ids) + 6
    assert rel(outs[1], outs[0]) <= 1e-2


def test_windowed_config_refuses_tree_verify():
    """A config with a sliding window (`tests/test_torch_gemma.py`'s
    `tiny-gemma2`) refuses tree verify with the JAX package's error type."""
    from tests.test_torch_gemma import G2

    cfg = ModelConfig(**G2)
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(0))
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, 32, cfg.head_dim)
    depths = torch.tensor([0, 1, 1])
    mask = torch.tensor([[1, 0, 0], [1, 1, 0], [1, 0, 1]], dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="tree verify"):
        decoder.forward(params, cfg, torch.tensor([[1, 2, 3]]), cache, tree=(depths, mask))
    jcfg = JModelConfig(**G2)
    jp = jdec.init_random_params(jcfg, jax.random.PRNGKey(0))
    jcache = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, 32, jcfg.head_dim)
    with pytest.raises(NotImplementedError, match="tree verify"):
        jdec.forward(jp, jcfg, jnp.asarray([[1, 2, 3]], jnp.int32), jcache,
                     tree=(jnp.asarray(depths.numpy()), jnp.asarray(mask.numpy())))


def test_return_hidden_matches_jax(ref, params):
    """The hidden states before the final norm: a 5-token chunk, then a
    decode step, over an int8 cache."""
    cache = kvcache.create(CFG.num_layers, 1, CFG.num_kv_heads, 64, CFG.head_dim)
    h5, cache = decoder.forward(params, CFG, torch.tensor([PROMPTS["random"][:5]]), cache,
                                return_hidden=True)
    h1, cache = decoder.forward(params, CFG, torch.tensor([[7]]), cache, return_hidden=True)
    assert int(cache.length[0]) == 6
    for got, want in zip((h5, h1), ref["hidden"]):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert rel(got.float().numpy(), want) <= HIDDEN_REL


MK = ModelConfig(name="mk-test", vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=10000.0, attention_bias=True, tie_word_embeddings=True)


@pytest.mark.parametrize("head_bits", [4, 0])
def test_return_hidden_on_the_whole_model_path(head_bits):
    """A decode step that the whole-model kernel serves returns its x before
    the final norm (the kernel runs without its head), as the per-layer path
    does; the logits of the same step are those hidden states through the
    final norm and the head."""
    from mnn_tpu_torch.kernels import decode_model
    from mnn_tpu_torch.models.layers import rms_norm

    params = decoder.init_random_params(MK, torch.Generator().manual_seed(2), scale=0.05,
                                        lm_head_bits=head_bits)
    mk = kvcache.create(MK.num_layers, 1, MK.num_kv_heads, 64, MK.head_dim)
    assert decode_model.supports(MK, params, mk, 1)
    _, mk = decoder.forward(params, MK, torch.tensor([list(range(3, 20))]), mk)
    clone = lambda: dataclasses.replace(mk, k=mk.k.clone(), v=mk.v.clone(),
                                        k_scale=mk.k_scale.clone(), v_scale=mk.v_scale.clone())
    tok = torch.tensor([[11]])
    h_mk, c1 = decoder.forward(params, MK, tok, clone(), return_hidden=True)
    h_pl, c2 = decoder.forward(params, MK, tok, clone(), return_hidden=True, megakernel=False)
    logits, _ = decoder.forward(params, MK, tok, clone())
    assert h_mk.shape == (1, 1, MK.hidden_size) and h_mk.dtype == torch.bfloat16
    assert int(c1.length[0]) == int(c2.length[0]) == 18
    assert rel(h_mk.float().numpy(), h_pl.float().numpy()) <= decode_model.PARITY_BOUNDS["x_rel"]
    again = decoder.head_logits(params, rms_norm(h_mk[:, 0], params.final_norm,
                                                 MK.rms_norm_eps))
    assert rel(again.numpy(), logits.numpy()) <= 1e-2


# --------------------------------------------------------------------------
# chain verify, the feature prefill, and the streams
# --------------------------------------------------------------------------

def test_prefill_with_features_and_chain_verify_match_jax(ref, params):
    rt = rt_of("int8")
    cache = Llm(CFG, params, rt, device="cpu")._new_cache()
    ids = PROMPTS["random"]
    logits, feats, cache = spec.prefill_with_features(params, CFG, rt, torch.tensor([ids]),
                                                      cache)
    jlogits, jfeats = ref["prefill_feats"]
    assert feats.shape == (1, len(ids), CFG.hidden_size) and int(cache.length[0]) == len(ids)
    assert rel(feats.float().numpy(), jfeats) <= HIDDEN_REL
    assert rel(logits.numpy(), jlogits) <= LOGIT_REL
    targets, vfeats, cache = spec.verify_forward(params, CFG, torch.tensor([[9, 4, 250, 3, 77]]),
                                                 cache)
    jt, jv = ref["verify"]
    assert int(cache.length[0]) == len(ids) + 5
    assert rel(vfeats.float().numpy(), jv) <= HIDDEN_REL
    got = decoder.head_logits(params, vfeats[0]).numpy()
    want = decoder.head_logits(params, torch.from_numpy(jv[0].copy()).to(torch.bfloat16)).numpy()
    diff = float(np.abs(got - want).max())
    for i in range(5):
        top2 = np.sort(want[i])[-2:]
        if top2[1] - top2[0] > diff:
            assert targets[0, i].item() == jt[i]


@pytest.mark.parametrize("prompt,kv", COMBOS)
def test_lookahead_stream_matches_jax(ref, params, prompt, kv):
    llm = Llm(CFG, params, rt_of(kv, speculative="lookahead", draft_len=4), device="cpu")
    toks = list(llm.stream(token_ids=PROMPTS[prompt], max_new_tokens=NEW))
    check_stream(ref, params, "lookahead", prompt, kv, toks, llm.spec_stats, None)
    assert llm.drafter is None and llm.spec_stats["drafted"] >= 0
    if prompt == "repeat":   # the n-grams of the pattern and of the output hit
        assert llm.spec_stats["accepted"] > 0


@pytest.mark.parametrize("prompt,kv", COMBOS)
def test_eagle_tree_stream_matches_jax(ref, params, prompt, kv):
    js = ref["streams"]["eagle-tree", prompt, kv]
    llm = Llm(CFG, params, rt_of(kv, speculative="eagle-tree", draft_len=3), device="cpu")
    llm.drafter = spec.TreeEagleDraft(eagle.eagle_params_from_numpy(js["drafter"]),
                                      draft_len=3, capacity=RT_KW["max_seq_len"],
                                      fanout=FANOUT)
    drafts = recorded(llm.drafter, "propose_tree")
    toks = list(llm.stream(token_ids=PROMPTS[prompt], max_new_tokens=NEW))
    check_stream(ref, params, "eagle-tree", prompt, kv, toks, llm.spec_stats, drafts)
    assert llm.spec_stats["drafted"] > 0 and "tokens_per_round" in llm.spec_stats
    assert drafts and drafts[0] == js["drafts"][0]


# --------------------------------------------------------------------------
# acceptance, lengths and the runtime's rules (the port alone)
# --------------------------------------------------------------------------

class OracleTree(spec.TreeEagleDraft):
    """A tree drafter whose chain `good` is the plain greedy stream's next
    tokens (the target itself, run ahead on a copy of the cache) and whose
    other chains are junk: the verify must accept that chain whole."""

    def __init__(self, llm, depth=3, fanout=3, good=1):
        super().__init__(None, draft_len=depth, fanout=fanout)
        self.llm, self.good = llm, good

    def start(self, params, config, prompt_ids, feats):
        self.params, self.config = params, config

    def propose_tree(self, last_token, last_feat):
        c = self.llm.cache
        cache = dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                                    k_scale=None if c.k_scale is None else c.k_scale.clone(),
                                    v_scale=None if c.v_scale is None else c.v_scale.clone())
        tok, chain = torch.as_tensor(last_token).reshape(1, 1), []
        for _ in range(self.draft_len):
            targets, _, cache = spec.verify_forward(self.params, self.config, tok, cache)
            chain.append(targets[0, 0].long())
            tok = targets[:, :1].long()
        good = torch.stack(chain)
        junk = (good + 1) % self.config.vocab_size
        return torch.stack([good if c == self.good else junk for c in range(self.fanout)])

    def commit(self, *a, **kw):
        pass

    def rollback(self, n):
        pass


class OracleChain:
    """`tests/test_eagle.py`'s oracle: the target's own next tokens."""

    draft_len = 3

    def __init__(self, llm):
        self.llm = llm

    def start(self, params, config, prompt_ids, feats):
        self.params, self.config = params, config

    def propose(self, last_token, last_feat):
        c = self.llm.cache
        cache = dataclasses.replace(c, k=c.k.clone(), v=c.v.clone())
        tok, out = torch.as_tensor(last_token).reshape(1, 1), []
        for _ in range(self.draft_len):
            targets, _, cache = spec.verify_forward(self.params, self.config, tok, cache)
            out.append(int(targets[0, 0]))
            tok = targets[:, :1].long()
        return out

    def commit(self, *a, **kw):
        pass

    def rollback(self, n):
        pass


@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_oracle_drafter_is_accepted_whole(params, kind):
    """Drafts that are the target's own greedy tokens are all accepted, and
    the stream is still the plain greedy stream (the bookkeeping of
    acceptance, compaction and rollback, end to end)."""
    ids = PROMPTS["random"]
    rt = rt_of("bf16")
    plain = list(Llm(CFG, params, rt, device="cpu").stream(token_ids=ids, max_new_tokens=13))
    llm = Llm(CFG, params, rt, device="cpu")
    if kind == "tree":
        gen = spec.tree_draft_generate(llm, ids, 13, drafter=OracleTree(llm))
    else:
        gen = spec.draft_generate(llm, ids, 13, drafter=OracleChain(llm))
    blocks = list(gen)
    got = [t for b in blocks for t in b]
    assert got == plain
    assert llm.spec_stats["accept_rate"] == 1.0
    assert [len(b) for b in blocks] == [1, 4, 4, 4]
    assert llm.context_len == len(ids) + 13 - 1


def test_lookahead_context_len_bounds(params):
    """`tests/test_speculative.py`'s rule: the newest emitted token is not
    yet in the cache."""
    prompt = [1, 2, 3, 1, 2, 3, 1, 2]
    llm = Llm(CFG, params, rt_of("bf16", speculative="lookahead", draft_len=4), device="cpu")
    out = list(llm.stream(token_ids=prompt, max_new_tokens=10))
    total = len(prompt) + len(out)
    assert len(out) == 10 and total - 1 <= llm.context_len <= total


@pytest.mark.parametrize("mode", ["lookahead", "eagle", "eagle-tree", "mtp", "dflash"])
def test_non_greedy_sampler_decodes_plainly(params, mode):
    """With any sampler but greedy, `speculative` is ignored: the tokens are
    those of the same runtime without it (the same generator seed), and no
    drafter is made."""
    kw = dict(sampler="temperature", temperature=0.8, seed=3)
    ids = PROMPTS["random"]
    rt = dataclasses.replace(rt_of("bf16"), **kw)
    want = list(Llm(CFG, params, rt, device="cpu").stream(token_ids=ids, max_new_tokens=8))
    llm = Llm(CFG, params, dataclasses.replace(rt, speculative=mode, draft_len=3),
              device="cpu")
    assert list(llm.stream(token_ids=ids, max_new_tokens=8)) == want
    assert llm.drafter is None and llm.spec_stats == {}
    assert llm.context_len == len(ids) + 8


def test_unknown_speculative_mode_decodes_plainly(params):
    """A mode the JAX `Llm.stream` does not dispatch decodes plainly there,
    and here."""
    ids = PROMPTS["random"]
    want = list(Llm(CFG, params, rt_of("bf16"), device="cpu").stream(
        token_ids=ids, max_new_tokens=6))
    llm = Llm(CFG, params, rt_of("bf16", speculative="medusa"), device="cpu")
    assert list(llm.stream(token_ids=ids, max_new_tokens=6)) == want
    assert llm.drafter is None and llm.spec_stats == {}
