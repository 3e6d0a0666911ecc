"""The draft models of speculative decoding in the port against the JAX
package, on the CPU: the EAGLE draft layer (`eagle_forward`,
`eagle_next_token`), the MTP heads (`mtp_propose`), DFlash (`fc_forward`,
`dflash_block_logits`, the sliding context window), the weights carried
across by `eagle_params_from_numpy` / `mtp_from_numpy` /
`dflash_params_from_numpy`, and the `eagle`, `mtp` and `dflash` streams of
`Llm.stream`.

Weights, runtime, prompts and the stream rule are those of
`tests/test_torch_speculative.py` (its docstring states them); the draft
weights are the JAX `Llm`'s own random draft nets (`_make_drafter`), carried
across and injected as `llm.drafter`. Bounds: the EAGLE layer's hidden
states within rel-L2 2e-2 (`tests/test_attention.py:59`), its one-layer
bf16 cache rows too; logits within 5e-2 (`tests/test_decode_model.py:97`),
tokens equal wherever the JAX top-2 margin exceeds the largest logit
difference; `fc_forward`, an f32 product of the same values, within 1e-5;
the DFlash window's row count and rope offset bit-exact.

The JAX side is computed once per module.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import dflash as jdflash
from mnn_tpu.models import eagle as jeagle
from mnn_tpu.runtime import speculative as jspec
from mnn_tpu.runtime.llm import Llm as JLlm
from mnn_tpu_torch.models import decoder, dflash, eagle
from mnn_tpu_torch.runtime import speculative as spec
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import jax_params, numpy_fields, rel
from tests.test_torch_speculative import (CFG, COMBOS, HIDDEN_REL, J_CFG, LOGIT_REL, NEW,
                                          PROMPTS, RT_KW, check_stream, jax_trace, jrt_of,
                                          recorded, rt_of)

MODES = {"eagle": 3, "mtp": 3, "dflash": 4}    # mode -> draft_len (DFlash: its block)
FC_REL = 1e-5
START_T = 27        # EAGLE start: 27 pairs, padded to a 32 bucket
NET = ("random", "int8")    # the stream whose draft nets the unit tests reuse


def jnp_bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def torch_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(torch.bfloat16)


def jax_stream(jp, mode, kv, ids):
    llm = JLlm(J_CFG, jp, jrt_of(kv, speculative=mode, draft_len=MODES[mode]))
    llm.drafter = llm._make_drafter()
    drafts = recorded(llm.drafter, "propose")
    toks = list(llm.stream(token_ids=ids, max_new_tokens=NEW))
    d = llm.drafter
    net = d.ep if mode == "eagle" else d.heads if mode == "mtp" else d.dp
    return dict(toks=toks, stats=dict(llm.spec_stats), drafts=drafts, net=net,
                drafter=numpy_fields(net),
                cache_len=int(d.cache.length[0]) if mode == "eagle" else None)


@pytest.fixture(scope="module")
def ref():
    jp = jax_params(J_CFG)
    out = dict(arrays=numpy_fields(jp), trace={}, streams={})
    for p, kv in COMBOS:
        out["trace"][p, kv] = jax_trace(jp, J_CFG, jrt_of(kv), PROMPTS[p], NEW)
        for mode in MODES:
            out["streams"][mode, p, kv] = jax_stream(jp, mode, kv, PROMPTS[p])
    rng = np.random.default_rng(21)
    h = J_CFG.hidden_size
    feats = rng.normal(size=(1, START_T + 2, h)).astype(np.float32)
    toks = rng.integers(0, J_CFG.vocab_size, START_T + 2).tolist()
    out["inputs"] = dict(feats=feats, toks=toks)

    # EAGLE: start over START_T pairs (bucket 32), then two single steps
    nets = {mode: out["streams"][(mode,) + NET]["net"] for mode in MODES}
    for s in out["streams"].values():
        del s["net"]
    ep = nets["eagle"]
    cache = jeagle.create_draft_cache(J_CFG, 64)
    pad_t = jnp.zeros((1, 32), jnp.int32).at[0, :START_T].set(jnp.asarray(toks[:START_T]))
    pad_f = jnp.zeros((1, 32, h), jnp.bfloat16).at[:, :START_T].set(
        jnp_bf16(feats[:, :START_T]))
    hid, cache = jeagle.eagle_forward(ep, jp, J_CFG, pad_t, pad_f, cache)
    cache = jspec.kvcache.rollback(cache, 32 - START_T)
    steps = []
    for i in (START_T, START_T + 1):
        tok, h1, cache = jeagle.eagle_next_token(
            ep, jp, J_CFG, jnp.asarray([[toks[i]]], jnp.int32),
            jnp_bf16(feats[:, i:i + 1]), cache)
        steps.append((int(tok[0]), np.asarray(h1.astype(jnp.float32))))
    out["eagle"] = dict(start=np.asarray(hid.astype(jnp.float32))[:, :START_T],
                        steps=steps, cache=numpy_fields(cache))

    # MTP: the tokens, and each head's logits through the JAX head
    heads = nets["mtp"]
    f = jnp_bf16(feats[:, -1])
    mtp_logits = []
    for i in range(heads.num_heads):
        hi = f + jax.nn.silu(jnp.dot(f, heads.w_res[i], preferred_element_type=jnp.float32)
                             ).astype(jnp.bfloat16)
        mtp_logits.append(np.asarray(jdec.head_logits(jp, hi), np.float32))
    out["mtp"] = dict(toks=np.asarray(jeagle.mtp_propose(heads, jp, f)).tolist(),
                      logits=mtp_logits)

    # DFlash: fc, the block logits over a half-full window, the window slide
    dp = nets["dflash"]
    rows = jdflash.fc_forward(dp, jnp_bf16(feats))
    ctx = jnp.zeros((1, 40, h), jnp.float32).at[:, :START_T + 2].set(rows)
    out["dflash"] = dict(
        fc=np.asarray(rows),
        logits=np.asarray(jdflash.dflash_block_logits(
            dp, jp, J_CFG, ctx, jnp.asarray(START_T + 2, jnp.int32),
            jnp.asarray(5, jnp.int32))),
        window=_dflash_window(jspec.DFlashDraft, dp, jp, jnp.ones, jdflash.fc_forward))
    return out


def _dflash_window(draft_cls, dp, params, ones, fc):
    """`tests/test_dflash.py`'s sequence: 24 prompt rows into a window of 16,
    a commit of 3 rows (it slides by 3), one rolled back. The (n, start_pos)
    after each step."""
    d = draft_cls(dp, capacity=16)
    feats = ones((1, 24, J_CFG.hidden_size))
    d.start(params, J_CFG if draft_cls is jspec.DFlashDraft else CFG, list(range(24)), feats)
    seen = [(d.n, d.start_pos)]
    d.commit(3, feats[:, -1], [1, 2, 3], fc(dp, feats[:, :8]), 2)
    seen.append((d.n, d.start_pos))
    d.rollback(1)
    seen.append((d.n, d.start_pos))
    return seen


@pytest.fixture(scope="module")
def params(ref):
    return decoder.params_from_numpy(ref["arrays"], CFG, "cpu")


def port_drafter(mode, fields):
    if mode == "eagle":
        return spec.EagleDraft(eagle.eagle_params_from_numpy(fields), draft_len=MODES[mode],
                               capacity=RT_KW["max_seq_len"])
    if mode == "mtp":
        return spec.MtpDraft(eagle.mtp_from_numpy(fields))
    return spec.DFlashDraft(dflash.dflash_params_from_numpy(fields),
                            capacity=RT_KW["max_seq_len"])


# --------------------------------------------------------------------------
# the draft weights and the draft nets
# --------------------------------------------------------------------------

def test_draft_params_from_numpy_carry_every_field(ref):
    for mode in MODES:
        fields = ref["streams"][(mode,) + NET]["drafter"]
        d = port_drafter(mode, fields)
        if mode == "eagle":
            ep = d.ep
            assert ep.wqkv.bits == fields["wqkv.bits"] and ep.wdown.block_size == \
                fields["wdown.block_size"]
            np.testing.assert_array_equal(ep.wgu.packed.numpy(), fields["wgu.packed"])
            np.testing.assert_array_equal(ep.fc.view(torch.int16).numpy(),
                                          fields["fc"].view(np.int16))
        elif mode == "mtp":
            assert d.heads.num_heads == MODES["mtp"] == d.draft_len
            np.testing.assert_array_equal(d.heads.w_res.view(torch.int16).numpy(),
                                          fields["w_res"].view(np.int16))
        else:
            dp = d.dp
            assert (dp.num_heads, dp.num_kv_heads, dp.head_dim, dp.block_size,
                    dp.mask_token_id) == tuple(int(fields[k]) for k in (
                        "num_heads", "num_kv_heads", "head_dim", "block_size",
                        "mask_token_id"))
            np.testing.assert_array_equal(dp.fc.numpy(), fields["fc"])
            np.testing.assert_array_equal(dp.wqkv.view(torch.int16).numpy(),
                                          fields["wqkv"].view(np.int16))


def test_eagle_forward_matches_jax(ref, params):
    """The draft layer over START_T pairs padded to 32 (the flash prefill
    kernel's plain version, q_offset 0), the pad rolled back, then two
    single steps (the flash decode kernel's plain version over the one-layer
    bf16 cache): hidden states, the cache rows and the greedy tokens."""
    r, inp = ref["eagle"], ref["inputs"]
    ep = eagle.eagle_params_from_numpy(ref["streams"][("eagle",) + NET]["drafter"])
    feats, toks = torch_bf16(inp["feats"]), inp["toks"]
    cache = eagle.create_draft_cache(CFG, 64)
    assert cache.k.shape == (1, 1, CFG.num_kv_heads, 64, CFG.head_dim) and cache.bits == 16
    pad_t = torch.zeros((1, 32), dtype=torch.int64)
    pad_t[0, :START_T] = torch.tensor(toks[:START_T])
    pad_f = torch.zeros((1, 32, CFG.hidden_size), dtype=torch.bfloat16)
    pad_f[:, :START_T] = feats[:, :START_T]
    hid, cache = eagle.eagle_forward(ep, params, CFG, pad_t, pad_f, cache)
    cache = spec.kvcache.rollback(cache, 32 - START_T)
    assert int(cache.length[0]) == START_T
    assert rel(hid[:, :START_T].float().numpy(), r["start"]) <= HIDDEN_REL
    for i, (jtok, jh) in zip((START_T, START_T + 1), r["steps"]):
        tok, h, cache = eagle.eagle_next_token(ep, params, CFG, torch.tensor([[toks[i]]]),
                                               feats[:, i:i + 1], cache)
        assert rel(h.float().numpy(), jh) <= HIDDEN_REL
        got = decoder.head_logits(params, h[:, -1]).numpy()
        want = decoder.head_logits(params, torch_bf16(jh[:, -1])).numpy()
        top2 = np.sort(want[0])[-2:]
        if top2[1] - top2[0] > float(np.abs(got - want).max()):
            assert int(tok[0]) == jtok
    jc = ref["eagle"]["cache"]
    assert int(cache.length[0]) == int(jc["length"][0]) == START_T + 2
    n = START_T + 2
    for name in ("k", "v"):
        assert rel(getattr(cache, name)[..., :n, :].float().numpy(),
                   np.asarray(jc[name], np.float32)[..., :n, :]) <= HIDDEN_REL


def test_mtp_propose_matches_jax(ref, params):
    r = ref["mtp"]
    heads = eagle.mtp_from_numpy(ref["streams"][("mtp",) + NET]["drafter"])
    f = torch_bf16(ref["inputs"]["feats"][:, -1])
    toks = eagle.mtp_propose(heads, params, f)
    assert toks.shape == (1, heads.num_heads) and toks.dtype == torch.int32
    checked = 0
    for i in range(heads.num_heads):
        res = torch.nn.functional.silu(f.float() @ heads.w_res[i].float()).to(torch.bfloat16)
        got = decoder.head_logits(params, f + res).numpy()
        want = r["logits"][i]
        assert rel(got, want) <= LOGIT_REL
        top2 = np.sort(want[0])[-2:]
        if top2[1] - top2[0] > float(np.abs(got - want).max()):
            checked += 1
            assert int(toks[0, i]) == r["toks"][0][i], f"head {i}"
    assert checked >= 2


def test_fc_forward_matches_jax(ref):
    dp = dflash.dflash_params_from_numpy(ref["streams"][("dflash",) + NET]["drafter"])
    rows = dflash.fc_forward(dp, torch_bf16(ref["inputs"]["feats"]))
    assert rows.dtype == torch.float32
    assert rel(rows.numpy(), ref["dflash"]["fc"]) <= FC_REL
    bad = torch.tensor([[[float("nan")] * CFG.hidden_size]])
    assert torch.isfinite(dflash.fc_forward(dp, bad)).all()


def test_dflash_block_logits_match_jax(ref, params):
    """One non-causal draft forward over a window of 40 rows, 29 valid, rope
    from position 5: the block's logits and greedy tokens."""
    dp = dflash.dflash_params_from_numpy(ref["streams"][("dflash",) + NET]["drafter"])
    h = CFG.hidden_size
    ctx = torch.zeros((1, 40, h))
    ctx[:, :START_T + 2] = torch.from_numpy(ref["dflash"]["fc"].copy())
    got = dflash.dflash_block_logits(dp, params, CFG, ctx, START_T + 2, 5)
    want = ref["dflash"]["logits"]
    assert got.shape == want.shape == (1, dp.block_size, CFG.vocab_size)
    assert rel(got.numpy(), want) <= LOGIT_REL
    diff = float(np.abs(got.numpy() - want).max())
    toks = spec.lowest_argmax(got[0]).tolist()
    checked = 0
    for i in range(dp.block_size):
        top2 = np.sort(want[0, i])[-2:]
        if top2[1] - top2[0] > diff:
            checked += 1
            assert toks[i] == int(np.argmax(want[0, i]))
    assert checked >= 2


def test_dflash_window_slides_as_jax(ref, params):
    dp = dflash.dflash_params_from_numpy(ref["streams"][("dflash",) + NET]["drafter"])
    seen = _dflash_window(spec.DFlashDraft, dp, params, torch.ones, dflash.fc_forward)
    assert seen == ref["dflash"]["window"] == [(16, 8), (16, 11), (15, 11)]


# --------------------------------------------------------------------------
# the streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,kv", COMBOS)
@pytest.mark.parametrize("mode", MODES)
def test_draft_stream_matches_jax(ref, params, mode, prompt, kv):
    js = ref["streams"][mode, prompt, kv]
    llm = Llm(CFG, params, rt_of(kv, speculative=mode, draft_len=MODES[mode]), device="cpu")
    llm.drafter = port_drafter(mode, js["drafter"])
    drafts = recorded(llm.drafter, "propose")
    toks = list(llm.stream(token_ids=PROMPTS[prompt], max_new_tokens=NEW))
    check_stream(ref, params, mode, prompt, kv, toks, llm.spec_stats, drafts)
    assert llm.spec_stats["drafted"] > 0
    assert drafts and all(len(d) == MODES[mode] for d in drafts)
    if mode == "eagle":
        # pairs (s_1 .. s_q): every token but the last emitted one is in
        # the draft cache (`tests/test_eagle.py:87-97`)
        total = len(PROMPTS[prompt]) + len(toks)
        assert int(llm.drafter.cache.length[0]) == total - 2 == js["cache_len"]


def test_made_drafters_serve_every_mode(params):
    """Without an injected drafter, `Llm` makes each mode's random draft net
    (seeded with rt.seed + 1): the stream is still the plain greedy one."""
    ids = PROMPTS["random"]
    want = list(Llm(CFG, params, rt_of("bf16"), device="cpu").stream(
        token_ids=ids, max_new_tokens=10))
    for mode, kind in (("eagle", spec.EagleDraft), ("eagle-tree", spec.TreeEagleDraft),
                       ("mtp", spec.MtpDraft), ("dflash", spec.DFlashDraft)):
        llm = Llm(CFG, params, rt_of("bf16", speculative=mode, draft_len=3), device="cpu")
        assert list(llm.stream(token_ids=ids, max_new_tokens=10)) == want, mode
        assert type(llm.drafter) is kind and llm.drafter.draft_len == 3
        assert llm.perf.gen_len == 10 and llm.perf.prefill_s > 0
