"""The gemma family (gemma2, gemma3) in the port against the JAX package, on
the CPU.

Weights come from the JAX package's `init_random_params` (the quantizing
path) with every norm vector made random from a numpy seed (the JAX init
sets them to ones, under which swapped sandwich norms would pass unseen),
and cross to the port through `params_from_numpy`. A 12-token prefill, then
3 decode steps fed the JAX package's greedy tokens, run through both: the
JAX side as `forward(interpret=True)` (its gemma prefill and its decode
over an int4 cache take the layer scan and `_attention_xla`; its decode
over an int8 or bf16 cache the whole-model kernel or, with
`megakernel=False`, the per-layer decode-step kernel, both in interpret
mode), the port with its kernels' plain versions. Bounds per step: rel-L2
2e-2 on the per-layer path and the prefill (`tests/test_gemma_fast.py:58`),
5e-2 on the whole-model path (`tests/test_decode_model.py:97`); tokens
equal wherever the JAX top-2 margin exceeds the largest logit difference.
Over an int4 cache the bound is 1e-1: bf16 K/V rows put many values on a
tie of the int4 grid, one f32 ulp upstream moves them a level (a seventh of
the row's absmax), and the JAX package's own two implementations (Pallas in
interpret mode and its XLA reference path) give prefill logits 4.5e-2 to
6.4e-2 apart on these configs; `tests/test_torch_gemma_kernels.py` holds the
eager attention itself to the JAX function on the same int4 cache.

Configs: tiny gemma2 and gemma3 (`tests/test_gemma_fast.py:22-37`: head_dim
64, window 8, 4 layers) and a 2-layer gemma2 at head_dim 256. Gemma never
reaches the flash kernels in the port, as in the JAX package: they are
patched to raise here. Also: `supports` of the gemma presets, what is still
refused, and two gemma slots in the `BatchEngine` against batch-1 runs.
The JAX side is computed once per module (XLA:CPU fails after a few hundred
compilations in one process).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.kernels import decode_model
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.batch_engine import BatchEngine, Status
from mnn_tpu_torch.runtime.llm import Llm

from tests.test_torch_decoder import numpy_fields, rel

G2 = dict(name="tiny-gemma2", vocab_size=256, hidden_size=128, intermediate_size=256,
          num_layers=4, num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10000.0,
          tie_word_embeddings=True, attention_bias=False, sliding_window=8,
          mlp_act="gelu_tanh", embed_scale=True, sandwich_norm=True, attn_softcap=50.0,
          final_softcap=30.0, query_scale=64.0 ** -0.5, swa_every_other=True)
G3 = dict(name="tiny-gemma3", vocab_size=256, hidden_size=128, intermediate_size=256,
          num_layers=4, num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10000.0,
          tie_word_embeddings=True, attention_bias=False, sliding_window=8,
          mlp_act="gelu_tanh", embed_scale=True, sandwich_norm=True, qk_norm=True,
          swa_pattern=2, rope_local_theta=1000.0)
G2W = dict(G2, name="tiny-gemma2-d256", hidden_size=256, intermediate_size=512,
           num_layers=2, head_dim=256, query_scale=256.0 ** -0.5)
CONFIGS = {"gemma2": (G2, 4), "gemma3": (G3, 0), "gemma2-d256": (G2W, 4)}  # (fields, head bits)
CAP, PROMPT, STEPS = 64, 12, 3
# (cache, path): the whole-model kernel, the per-layer decode step, the eager path
PATHS = [("int8", "model"), ("int8", "layer"), ("bf16", "model"), ("bf16", "layer"),
         ("int4", "eager")]
BOUND = {"model": 5e-2, "layer": 2e-2}     # decode steps; step 0 is the prefill
INT4 = 1e-1


def jax_params(jcfg, head_bits):
    p = jdec.init_random_params(jcfg, jax.random.PRNGKey(0), scale=0.05,
                                lm_head_bits=head_bits)
    rng = np.random.default_rng(11)
    u = lambda a: None if a is None else jnp.asarray(rng.uniform(0.6, 1.4, a.shape),
                                                     jnp.float32)
    lay = p.layers
    lay = dataclasses.replace(
        lay, input_norm=u(lay.input_norm), post_norm=u(lay.post_norm),
        pre_ffn_norm=u(lay.pre_ffn_norm), post_ffn_norm=u(lay.post_ffn_norm),
        q_norm=u(lay.q_norm), k_norm=u(lay.k_norm))
    return dataclasses.replace(p, layers=lay, final_norm=u(p.final_norm))


def cache_args(kind):
    return dict(quantized=kind != "bf16", kv_bits=4 if kind == "int4" else 8)


def jax_prefill(params, jcfg, ids, kind):
    cache = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, CAP, jcfg.head_dim,
                       **cache_args(kind))
    return jdec.forward(params, jcfg, jnp.asarray([ids], jnp.int32), cache,
                        interpret=True)


def jax_decode(params, jcfg, prefilled, path):
    logits, cache = prefilled
    rows, toks = [np.asarray(logits, np.float32)], []
    mk = False if path == "layer" else None
    for _ in range(STEPS):
        toks.append(int(np.argmax(rows[-1][0])))
        logits, cache = jdec.forward(params, jcfg, jnp.asarray([[toks[-1]]], jnp.int32),
                                     cache, interpret=True, megakernel=mk)
        rows.append(np.asarray(logits, np.float32))
    return rows, toks


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name, (fields, head_bits) in CONFIGS.items():
        jcfg = JModelConfig(**fields)
        params = jax_params(jcfg, head_bits)
        ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, PROMPT).tolist()
        # one prefill a cache kind (JAX arrays are immutable: both paths reuse it)
        pre = {kind: jax_prefill(params, jcfg, ids, kind) for kind in ("int8", "bf16", "int4")}
        traces = {(kind, path): jax_decode(params, jcfg, pre[kind], path)
                  for kind, path in PATHS}
        out[name] = dict(arrays=numpy_fields(params), ids=ids, traces=traces)
    return out


@pytest.fixture(scope="module")
def port(ref):
    return {name: decoder.params_from_numpy(ref[name]["arrays"],
                                            ModelConfig(**CONFIGS[name][0]), "cpu")
            for name in CONFIGS}


@pytest.fixture
def no_flash(monkeypatch):
    """Gemma takes neither flash kernel, in either package."""
    def refuse(*a, **k):
        raise AssertionError("a gemma config reached a flash attention kernel")
    monkeypatch.setattr(decoder, "flash_attention", refuse)
    monkeypatch.setattr(decoder, "decode_attention", refuse)


def port_trace(params, cfg, ids, kind, path, feed):
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                           **cache_args(kind))
    logits, cache = decoder.forward(params, cfg, torch.tensor([ids]), cache)
    rows = [logits.float().numpy()]
    if path != "eager":     # over an int4 cache gemma decodes on the eager path
        assert decode_model.supports(cfg, params, cache, 1), (kind, path)
    for tok in feed:
        logits, cache = decoder.forward(params, cfg, torch.tensor([[tok]]), cache,
                                        megakernel=False if path == "layer" else None)
        rows.append(logits.float().numpy())
    assert int(cache.length[0]) == PROMPT + STEPS
    return rows


@pytest.mark.parametrize("kind,path", PATHS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_gemma_matches_jax(ref, port, no_flash, name, kind, path):
    cfg = ModelConfig(**CONFIGS[name][0])
    want, toks = ref[name]["traces"][(kind, path)]
    got = port_trace(port[name], cfg, ref[name]["ids"], kind, path, toks)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (1, cfg.vocab_size) and np.isfinite(a).all()
        bound = INT4 if kind == "int4" else 2e-2 if s == 0 else BOUND[path]
        assert rel(a, b) <= bound, f"step {s}: rel-L2 {rel(a, b):.3g}"
        top2 = np.sort(b[0])[-2:]
        if top2[1] - top2[0] > diff:
            assert int(a.argmax()) == int(b.argmax()), f"step {s}"
    if cfg.final_softcap:
        assert max(float(np.abs(a).max()) for a in got) < cfg.final_softcap


def test_params_carry_the_sandwich_norms(ref, port):
    arrays, lay = ref["gemma2"]["arrays"], port["gemma2"].layers
    for f in ("pre_ffn_norm", "post_ffn_norm", "post_norm"):
        np.testing.assert_array_equal(getattr(lay, f).numpy(), arrays[f"layers.{f}"])
    assert not np.allclose(arrays["layers.pre_ffn_norm"], arrays["layers.post_ffn_norm"])


def meta_params(cfg, head_bits=4, bits=4, bs=128):
    """Shape-only weights of a preset: `supports` reads metadata alone."""
    def ql(k, n, lead=(cfg.num_layers,), b=bits):
        t = lambda *s: torch.empty(s, device="meta")
        return QuantizedLinear(packed=t(*lead, k * b // 8, n), scale=t(*lead, k // bs, n),
                               bias=t(*lead, k // bs, n), out_bias=None, bits=b,
                               block_size=bs, act_bits=16)
    h, nq = cfg.hidden_size, (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    vec = torch.empty((cfg.num_layers, h), device="meta")
    qk = torch.empty((cfg.num_layers, cfg.head_dim), device="meta") if cfg.qk_norm else None
    layers = decoder.LayerParams(
        wqkv=ql(h, nq), wo=ql(cfg.q_dim, h), wgu=ql(h, 2 * cfg.intermediate_size),
        wdown=ql(cfg.intermediate_size, h), input_norm=vec, post_norm=vec,
        q_norm=qk, k_norm=qk, pre_ffn_norm=vec, post_ffn_norm=vec)
    head = ql(h, cfg.vocab_size, lead=(), b=head_bits)
    return decoder.Params(embedding=None, final_norm=None, lm_head=head, layers=layers)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("preset", ["gemma2-2b", "gemma3-4b"])
def test_supports_takes_the_gemma_presets(preset, batch):
    """The whole-model kernel serves gemma over an int8 or bf16 cache (not
    int4, which gemma sends down the eager path); the head is fused for
    gemma2's 128-aligned vocabulary only."""
    cfg = PRESETS[preset]
    params = meta_params(cfg)
    for bits, want in ((8, True), (16, True), (4, False)):
        view = type("CacheView", (), dict(capacity=1024, bits=bits))()
        assert decode_model.supports(cfg, params, view, batch) == want, bits
    assert decode_model.supports_head(cfg, params) == (preset == "gemma2-2b")
    assert decoder.gemma_like(cfg)


@pytest.mark.parametrize("field", ["mrope_section", "kv_rotate"])
def test_mrope_and_kv_rotate_pass_the_check(field):
    """Multimodal rope and the Hadamard KV rotation are ported and pass
    `forward`'s check. The whole-model kernel takes multimodal rope as it
    takes the config without it (its phases come in as cos/sin; the JAX
    `supports` ignores `mrope_section`) and refuses the rotation, as in the
    JAX package."""
    cfg = dataclasses.replace(PRESETS["gemma3-4b"],
                              **{field: (16, 24, 24) if field == "mrope_section" else True})
    decoder._check_supported(cfg)
    view = type("CacheView", (), dict(capacity=1024, bits=8))()
    got = decode_model.supports(cfg, meta_params(cfg), view, 1)
    if field == "mrope_section":
        plain = PRESETS["gemma3-4b"]
        assert got == decode_model.supports(plain, meta_params(plain), view, 1)
    else:
        assert not got


def test_gemma_slots_match_batch_one(port):
    """Two gemma2 slots at different lengths decode together (each masking
    its own windows over its own length) and give the tokens of their
    batch-1 runs."""
    cfg = ModelConfig(**G2)
    rt = dict(max_seq_len=CAP, prefill_chunk=16, decode_block=4, sampler="greedy",
              kv_quant=True, kv_bits=8, quant_bits=4, quant_block=128, lm_head_bits=4,
              prefill_act_bits=8)
    prompts = [list(range(3, 23)), list(range(40, 45))]
    eng = BatchEngine(cfg, port["gemma2"], RuntimeConfig(max_batch=2, **rt))
    reqs = [eng.submit(p, 10) for p in prompts]
    eng.run_until_idle()
    for req, p in zip(reqs, prompts):
        llm = Llm(cfg, port["gemma2"], RuntimeConfig(max_batch=1, **rt), device="cpu")
        assert req.status == Status.DONE
        assert req.generated == list(llm.stream(token_ids=p, max_new_tokens=10))
