"""The port's whole-model decode step against the JAX package, on the CPU.

The JAX side is computed once, in a module-scoped fixture (XLA:CPU fails
after a few hundred compilations in one process): for each case it builds
random weights, prefills a cache through the pure-XLA reference, and then,
per decode step from the same state, calls `fused_decode_model` in interpret
mode with the fused head (whose bits follow the layers': the JAX kernel
keeps a small-vocabulary head only when it can reuse the MLP's slots).
Weights and cache cross to the port as numpy
(`params_from_numpy`, `cache_from_numpy`), and the port's plain version runs
the same step from the same state. Two independently evolved caches are never
compared: another f32 summation order can flip a bf16 rounding of qkv and
with it a quantization level.

Bounds (`decode_model.PARITY_BOUNDS`): logits rel-L2 5e-2 (the JAX
megakernel's own bound, `tests/test_decode_model.py:97`), x_out 2e-2, layer 0's
rows within one level and its scales within one bf16 ulp (8e-3), every layer's
dequantized rows rel-L2 3e-2, tokens equal wherever the JAX top-2 margin
exceeds the largest logit difference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels import decode_model as jdm
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import layers as jlayers
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.kernels import decode_model
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.llm import Llm

MK = dict(name="mk-test", vocab_size=512, hidden_size=256, intermediate_size=512,
          num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
          rope_theta=10000.0, attention_bias=True, tie_word_embeddings=True)
Q05 = dict(dataclasses.asdict(J_PRESETS["qwen2-0.5b"]), num_layers=2, vocab_size=1024)
CAP = 128
STEPS = 2

# name -> (config fields, config changes, weight bits, kv bits, prefill, lengths)
CASES = {
    "int8_kv": (MK, {}, 4, 8, 9, None),
    "int4_kv": (MK, {}, 4, 4, 12, None),
    "bf16_kv": (MK, {}, 4, 16, 9, None),
    "w8": (MK, {}, 8, 8, 9, None),
    "qk_norm_no_bias": (MK, dict(qk_norm=True, attention_bias=False), 4, 8, 9, None),
    "window_sink": (MK, dict(sliding_window=6, attention_sink=2), 4, 8, 20, None),
    "batch2_unequal": (MK, {}, 4, 8, 9, (9, 5)),
    "qwen2_0.5b_2_layers": (Q05, {}, 4, 8, 9, None),
}


def numpy_fields(obj, prefix=""):
    """JAX dataclass pytree -> {dotted field name: numpy array or static int}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(numpy_fields(v, prefix + f.name + "."))
        elif isinstance(v, (int, bool)):
            out[prefix + f.name] = int(v)
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def jax_case(fields, changes, bits, kv_bits, prefill, lengths):
    cfg = JModelConfig(**{**fields, **changes})
    batch = len(lengths) if lengths else 1
    # real widths: random packed bytes (quantizing random floats takes longer)
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(0), quant_bits=bits,
                                scale=0.05, lm_head_bits=bits, fast=fields is Q05)
    rng = np.random.default_rng(7)
    u = lambda *s: jnp.asarray(rng.uniform(0.7, 1.3, size=s), jnp.float32)
    lay = dataclasses.replace(p.layers, input_norm=u(*p.layers.input_norm.shape),
                              post_norm=u(*p.layers.post_norm.shape))
    if cfg.attention_bias:
        lay = dataclasses.replace(lay, wqkv=dataclasses.replace(
            lay.wqkv, out_bias=jnp.asarray(
                rng.normal(0, 0.1, size=lay.wqkv.out_bias.shape), jnp.float32)))
    if cfg.qk_norm:
        lay = dataclasses.replace(lay, q_norm=u(*lay.q_norm.shape),
                                  k_norm=u(*lay.k_norm.shape))
    p = dataclasses.replace(p, layers=lay, final_norm=u(*p.final_norm.shape))
    cache = jkv.create(cfg.num_layers, batch, cfg.num_kv_heads, CAP, cfg.head_dim,
                       quantized=kv_bits < 16, kv_bits=kv_bits)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, prefill)), jnp.int32)
    _, cache = jdec.forward(p, cfg, toks, cache, interpret=False)
    if lengths:
        cache = dataclasses.replace(cache, length=jnp.asarray(lengths, jnp.int32))
    assert jdm.supports(cfg, p, cache, batch) and jdm.supports_head(cfg, p)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch,)), jnp.int32)
    steps = []
    for _ in range(STEPS):
        x = p.embedding[tok]
        cos, sin = jlayers.rope_cos_sin(cache.length[:, None], cfg.head_dim,
                                        cfg.rope_theta, scaling=cfg.rope_scaling)
        cos_f = jnp.concatenate([cos[:, 0], cos[:, 0]], axis=-1)
        sin_f = jnp.concatenate([sin[:, 0], sin[:, 0]], axis=-1)
        outs = jdm.fused_decode_model(
            x, p.layers, cache.k, cache.v, cache.k_scale, cache.v_scale,
            cache.length, cos_f, sin_f, config=cfg, interpret=True,
            head=p.lm_head, final_norm=p.final_norm)
        assert len(outs) == 7
        steps.append(dict(
            tok=np.asarray(tok), x=np.asarray(x.astype(jnp.float32)),
            cos=np.asarray(cos_f), sin=np.asarray(sin_f),
            cache=numpy_fields(cache),
            outs=[None if o is None else np.asarray(o) for o in outs]))
        cache = jdm.scatter_rows(cache, *outs[1:5], cache.length)
        cache = dataclasses.replace(
            cache, length=jnp.minimum(cache.length + 1, cache.capacity))
        tok = outs[6]
    return dict(arrays=numpy_fields(p), steps=steps, last_cache=numpy_fields(cache))


@pytest.fixture(scope="module")
def jax_ref():
    return {name: jax_case(*case) for name, case in CASES.items()}


def port_config(name) -> ModelConfig:
    fields, changes = CASES[name][:2]
    return ModelConfig(**{**fields, **changes})


def tt(a) -> torch.Tensor:
    """numpy (read-only, as it comes from JAX) -> torch, through a copy."""
    return torch.from_numpy(np.array(a))


def as_torch(outs):
    return tuple(None if o is None else tt(o) for o in outs)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_per_step(jax_ref, name):
    """`fused_decode_model_plain` against `fused_decode_model(interpret=True)`
    on the same x, phases, weights and cache, for every step."""
    cfg = port_config(name)
    kv_bits = CASES[name][3]
    ref = jax_ref[name]
    params = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    assert decode_model.supports_head(cfg, params)
    for step in ref["steps"]:
        cache = kvcache.cache_from_numpy(step["cache"], kv_bits)
        assert decode_model.supports(cfg, params, cache, cache.k.shape[1])
        got = decode_model.fused_decode_model(
            tt(step["x"]), params.layers, cache.k, cache.v,
            cache.k_scale, cache.v_scale, cache.length,
            tt(step["cos"]), tt(step["sin"]),
            config=cfg, head=params.lm_head, final_norm=params.final_norm)
        want = as_torch(step["outs"])
        assert len(got) == 7 and got[5].dtype == torch.float32
        assert got[1].shape == want[1].shape and got[0].shape == want[0].shape
        assert all(torch.isfinite(t).all() for t in got if t is not None)
        m = decode_model.parity_metrics(got, want, kv_bits)
        assert not decode_model.parity_failures(m), m
        assert int(got[6][0]) == int(decode_model.lowest_argmax(got[5])[0])


@pytest.mark.parametrize("name", ["int8_kv", "int4_kv", "bf16_kv", "batch2_unequal"])
def test_forward_megakernel_matches_jax(jax_ref, name):
    """`forward(megakernel=True, return_token=True)`: embedding, rope phases,
    the kernel's plain version, the cache write and the new lengths, against
    the JAX step and the cache JAX leaves behind."""
    cfg = port_config(name)
    kv_bits = CASES[name][3]
    ref = jax_ref[name]
    params = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    step = ref["steps"][-1]
    cache = kvcache.cache_from_numpy(step["cache"], kv_bits)
    tok = tt(step["tok"]).long()[:, None]
    (logits, token), new = decoder.forward(params, cfg, tok, cache, megakernel=True,
                                           return_token=True)
    want_logits = tt(step["outs"][5])
    rel = float((logits - want_logits).norm() / want_logits.norm())
    assert rel <= 5e-2, rel
    after = kvcache.cache_from_numpy(ref["last_cache"], kv_bits)
    assert torch.equal(new.length, after.length)
    n = int(after.length.max())
    for a, b, sa, sb in ((new.k, after.k, new.k_scale, after.k_scale),
                         (new.v, after.v, new.v_scale, after.v_scale)):
        da = kvcache.dequant_kv(a, sa, kv_bits, torch.float32)[:, :, :, :n]
        db = kvcache.dequant_kv(b, sb, kv_bits, torch.float32)[:, :, :, :n]
        assert float((da - db).norm() / db.norm()) <= 3e-2
    # the default takes the same path; False takes the per-layer one
    cache = kvcache.cache_from_numpy(step["cache"], kv_bits)
    auto, _ = decoder.forward(params, cfg, tok, cache)
    assert torch.equal(auto, logits)
    cache = kvcache.cache_from_numpy(step["cache"], kv_bits)
    (per_layer, ptok), _ = decoder.forward(params, cfg, tok, cache, megakernel=False,
                                           return_token=True)
    assert float((per_layer - logits).norm() / logits.norm()) <= 5e-2
    assert torch.equal(ptok, decode_model.lowest_argmax(per_layer))


def test_cache_from_numpy_round_trip(jax_ref):
    for name in ("int8_kv", "int4_kv", "bf16_kv"):
        arrays = jax_ref[name]["steps"][0]["cache"]
        kv_bits = CASES[name][3]
        cache = kvcache.cache_from_numpy(arrays, kv_bits)
        assert cache.bits == kv_bits and cache.capacity == CAP
        assert cache.k.shape == arrays["k"].shape
        assert cache.length.dtype == torch.int32
        if kv_bits == 16:
            assert cache.k.dtype == torch.bfloat16 and cache.k_scale is None
            np.testing.assert_array_equal(cache.k.view(torch.int16).numpy(),
                                          arrays["k"].view(np.int16))
        else:
            assert cache.k.shape[-1] == 64 * kv_bits // 8
            np.testing.assert_array_equal(cache.v.numpy(), arrays["v"])
            np.testing.assert_array_equal(cache.k_scale.numpy(), arrays["k_scale"])


# --------------------------------------------------------------------------
# eligibility
# --------------------------------------------------------------------------

DENSE = ["qwen2-0.5b", "qwen2-1.5b", "qwen2-7b", "qwen3-0.6b", "llama3.2-1b",
         "llama3.2-3b", "mistral-7b", "tiny"]


def meta_params(abstract, cfg):
    """The port's Params with shape-only (`meta`) tensors, from the JAX
    package's abstract Params: eligibility reads shapes and metadata only."""
    dt = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}

    def t(a):
        return None if a is None else torch.empty(a.shape, dtype=dt[a.dtype.name],
                                                  device="meta")

    def ql(q):
        return QuantizedLinear(packed=t(q.packed), scale=t(q.scale), bias=t(q.bias),
                               out_bias=t(q.out_bias), bits=q.bits,
                               block_size=q.block_size, act_bits=q.act_bits)
    lay = abstract.layers
    layers = decoder.LayerParams(
        wqkv=ql(lay.wqkv), wo=ql(lay.wo), wgu=ql(lay.wgu), wdown=ql(lay.wdown),
        input_norm=t(lay.input_norm), post_norm=t(lay.post_norm),
        q_norm=t(lay.q_norm), k_norm=t(lay.k_norm))
    head = abstract.lm_head
    head = ql(head) if dataclasses.is_dataclass(head) else t(head)
    return decoder.Params(embedding=t(abstract.embedding),
                          final_norm=t(abstract.final_norm), lm_head=head,
                          layers=layers)


@pytest.mark.parametrize("preset", DENSE)
def test_supports_agrees_with_jax(preset, monkeypatch):
    """`supports` / `supports_head` against the JAX package's, on abstract
    weights (`jax.eval_shape`: nothing of 7B size is allocated), over weight
    bits, head bits, KV bits, act bits and batch sizes. The JAX gate's last
    clause, whether a chunk plan fits the TPU's VMEM, is no part of the
    contract and is answered yes here."""
    monkeypatch.setattr(jdm, "_plan", lambda *a, **k: object())
    jcfg, cfg = J_PRESETS[preset], PRESETS[preset]
    for bits, head_bits, act_bits in ((4, 4, 16), (8, 8, 16), (4, 0, 16), (4, 4, 8)):
        abstract = jax.eval_shape(lambda: jdec.init_random_params(
            jcfg, jax.random.PRNGKey(0), quant_bits=bits, fast=True,
            act_bits=act_bits, lm_head_bits=head_bits))
        params = meta_params(abstract, cfg)
        assert decode_model.supports_head(cfg, params) == jdm.supports_head(jcfg, abstract)
        for kv_bits in (16, 8, 4, 3):
            for batch in (1, 8, 9):
                view = type("CacheView", (), dict(capacity=1024, bits=kv_bits,
                                                  codebook=False))()
                want = jdm.supports(jcfg, abstract, view, batch)
                got = decode_model.supports(cfg, params, view, batch)
                assert got == want, (preset, bits, head_bits, act_bits, kv_bits, batch)


@pytest.mark.parametrize("preset", ["qwen1.5-moe-a2.7b"])
def test_supports_refuses_what_the_port_does_not_run(preset):
    """A mixture of experts is refused by the whole-model kernel only, in
    both packages: `forward` serves it layer by layer
    (`tests/test_torch_moe.py`). Gemma's presets, which it now takes, are
    held in `tests/test_torch_gemma.py`."""
    cfg = PRESETS[preset]
    view = type("CacheView", (), dict(capacity=1024, bits=8))()
    params = type("P", (), dict(layers=None))()
    assert not decode_model.supports(cfg, params, view, 1)
    decoder._check_supported(cfg)


def test_forward_megakernel_true_raises_when_ineligible():
    """An explicit request never measures the other path: `tiny` has
    head_dim 32, and a prefill chunk is not a decode step."""
    cfg = PRESETS["tiny"]
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(0))
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim)
    tok = torch.zeros((1, 1), dtype=torch.int64)
    assert not decode_model.supports(cfg, params, cache, 1)
    with pytest.raises(ValueError, match="megakernel=True"):
        decoder.forward(params, cfg, tok, cache, megakernel=True)
    logits, cache = decoder.forward(params, cfg, tok, cache)     # falls back
    assert logits.shape == (1, cfg.vocab_size)
    mk = ModelConfig(**MK)
    params = decoder.init_random_params(mk, torch.Generator().manual_seed(0))
    cache = kvcache.create(mk.num_layers, 1, mk.num_kv_heads, 64, mk.head_dim)
    assert decode_model.supports(mk, params, cache, 1)
    assert not decode_model.supports(mk, params, cache, 9)
    with pytest.raises(ValueError, match="megakernel=True"):
        decoder.forward(params, mk, torch.zeros((1, 4), dtype=torch.int64), cache,
                        megakernel=True)
    with pytest.raises(ValueError, match="write_cache"):
        decode_model.fused_decode_model(
            torch.zeros((1, mk.hidden_size)), params.layers, cache.k, cache.v,
            cache.k_scale, cache.v_scale, cache.length, torch.ones((1, 64)),
            torch.zeros((1, 64)), config=mk, write_cache=True)


def test_lowest_argmax_breaks_ties_low():
    logits = torch.tensor([[1.0, 5.0, 5.0, 2.0], [7.0, 7.0, 7.0, 7.0],
                           [0.0, -1.0, 3.0, 3.0]])
    got = decode_model.lowest_argmax(logits)
    assert got.dtype == torch.int32 and got.tolist() == [1, 0, 2]


# --------------------------------------------------------------------------
# the runtime on the megakernel path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [8, 4])
def test_llm_stream_megakernel_matches_per_layer(kv_bits):
    """`Llm.stream`'s greedy tokens through the megakernel path (fed back
    from the kernel's own argmax) equal the per-layer path's, teacher-forced
    from the same prompt, up to the first step whose top-2 margin is within
    the largest logit difference."""
    cfg = ModelConfig(**{**MK, "tie_word_embeddings": False})
    rt = RuntimeConfig(max_seq_len=64, prefill_chunk=32, decode_block=3,
                       sampler="greedy", kv_bits=kv_bits, lm_head_bits=4,
                       max_new_tokens=7)
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(3),
                                        scale=0.05, lm_head_bits=4)
    llm = Llm(cfg, params, rt, device="cpu")
    info = llm.info()
    assert info["decode_megakernel"] and info["decode_fused_head"]
    assert info["kv_bits"] == kv_bits
    ids = list(range(5, 25))
    out = list(llm.stream(token_ids=ids))
    assert len(out) == 7 and llm.context_len == len(ids) + 7

    from mnn_tpu_torch.runtime import generate
    cache = llm._new_cache()
    logits, cache = generate.run_prefill(params, cfg, rt,
                                         torch.tensor([ids]), cache)
    assert int(logits.argmax()) == out[0]
    rows, diff = [logits], 0.0
    for tok in out[:-1]:
        t = torch.tensor([[tok]])
        clone = dataclasses.replace(
            cache, k=cache.k.clone(), v=cache.v.clone(),
            k_scale=None if cache.k_scale is None else cache.k_scale.clone(),
            v_scale=None if cache.v_scale is None else cache.v_scale.clone())
        mk, _ = decoder.forward(params, cfg, t, clone, megakernel=True)
        logits, cache = decoder.forward(params, cfg, t, cache, megakernel=False)
        diff = max(diff, float((mk - logits).abs().max()))
        rows.append(logits)
    for s, row in enumerate(rows):
        top2 = row[0].topk(2).values
        if float(top2[0] - top2[1]) <= diff:
            break
        assert int(row.argmax()) == out[s], f"step {s}"


def test_sampled_decode_takes_the_megakernel_logits():
    """A sampled step's logits are the kernel's own (the fused head), and the
    greedy fast path records the tokens it feeds back."""
    from mnn_tpu_torch.runtime import generate, sampler
    cfg = ModelConfig(**{**MK, "tie_word_embeddings": False})
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(4),
                                        scale=0.05, lm_head_bits=4)
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim)
    first = torch.randn((1, cfg.vocab_size), generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    toks, logits, cache, state = generate.decode_steps(
        params, cfg, cache, first, sampler.make_state(1), g, steps=3,
        sampler="topK", top_k=4)
    assert toks.shape == (1, 3) and int(cache.length[0]) == 3
    again = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim)
    for i in range(3):
        want, again = decoder.forward(params, cfg, toks[:, i:i + 1].long(), again,
                                      megakernel=True)
    assert torch.equal(logits, want)
    toks, _, _, state = generate.decode_steps(
        params, cfg, kvcache.reset(cache), first, sampler.make_state(1), g, steps=3)
    assert state.pos == 3 and toks[0, 0] == first.argmax()
