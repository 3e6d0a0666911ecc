"""Gemma's shapes and flags in the port's kernels' plain versions, against
the JAX kernels in interpret mode, on the CPU.

* The fused decode step (row 6, `decode_step.fused_decode_attention`, whose
  CUDA kernel now takes head_dim 256) at head_dim 256: gemma2's softcap and
  query scale on a sliding and a global layer, gemma3's QK-norm, int8 and
  bf16 caches, 1, 2 and 4 query heads a KV head. Bounds of
  `tests/test_torch_decode_step.py` (attention rel-L2 3e-2, scales within
  1e-6), but the quantized rows within one level, on at most 1% of their
  values: XLA computes the JAX kernel's `absmax / 127` as absmax times 1/127,
  an ulp off the quotient, which moves a value that sits on a rounding tie
  (256-wide rows hold more of them) by one level.
* The whole-model decode step (row 7, `decode_model.fused_decode_model`)
  with each of gemma's flags: GeGLU alone, the score softcap alone, and the
  tiny gemma2 (sandwich norms, GeGLU, softcap, alternating windows) and
  gemma3 (sandwich norms, N:1 windows, local rope phases, QK-norm) configs,
  gemma2 also at head_dim 256 over a bf16 cache. Every norm is random. Per
  step from the same state, held to `decode_model.PARITY_BOUNDS` as in
  `tests/test_torch_decode_model.py`.
* `decoder._attention_eager` (gemma's prefill and int4 decode) against the
  JAX package's `_attention_xla` on the same int4 cache: rel-L2 1e-5.

The JAX side is computed once for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels import decode_model as jdm
from mnn_tpu.kernels.decode_step import fused_decode_attention as j_decode
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import layers as jlayers
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.kernels import decode_model, decode_step
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.runtime import kvcache

from tests.test_torch_decode_model import as_torch, numpy_fields, tt
from tests.test_torch_decode_step import _inputs, rel, to_torch

# ---------------------------------------------------------------------------
# the decode step at head_dim 256
# ---------------------------------------------------------------------------

L, LAYER = 2, 1
# (name, B, Hkv, G, S, lengths, int8 cache, qk-norm, window, softcap)
STEP_CASES = [
    ("gemma2-sliding", 2, 2, 2, 128, (90, 17), True, False, 16, 50.0),
    ("gemma2-global", 2, 2, 2, 128, (127, 40), True, False, 0, 50.0),
    ("gemma2-bf16", 1, 2, 2, 128, (100,), False, False, 16, 50.0),
    ("gemma3-qk-norm", 2, 2, 2, 128, (70, 128), True, True, 32, 0.0),
    ("g1", 1, 4, 1, 64, (50,), True, False, 0, 0.0),
    ("g4-bf16", 2, 1, 4, 128, (33, 100), False, True, 0, 20.0),
]
D = 256
SM_SCALE = 256.0 ** -0.5


@pytest.fixture(scope="module")
def step_cases():
    rng = np.random.default_rng(21)
    out = {}
    for name, b, hkv, g, s, lengths, int8, qkn, window, softcap in STEP_CASES:
        c = _inputs(rng, b, hkv, g, D, s, int8)
        opt = lambda n: None if c[n] is None else jnp.asarray(c[n])
        res = j_decode(
            jnp.asarray(c["qkv"]), jnp.asarray(c["kc"]), jnp.asarray(c["vc"]),
            opt("ks"), opt("vs"), jnp.int32(LAYER), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(c["cos"]), jnp.asarray(c["sin"]),
            q_norm=opt("q_norm") if qkn else None, k_norm=opt("k_norm") if qkn else None,
            sm_scale=SM_SCALE, block_kv=64, window=window, softcap=softcap,
            interpret=True)
        c["want"] = [None if r is None else np.asarray(r) for r in res]
        out[name] = c
    return out


@pytest.mark.parametrize("name,b,hkv,g,s,lengths,int8,qkn,window,softcap", STEP_CASES)
def test_decode_step_d256_matches_jax(step_cases, name, b, hkv, g, s, lengths, int8, qkn,
                                      window, softcap):
    c = step_cases[name]
    opt = lambda n: None if c[n] is None else to_torch(c[n])
    att, k_row, v_row, k_sc, v_sc = decode_step.fused_decode_attention(
        to_torch(c["qkv"]), to_torch(c["kc"]), to_torch(c["vc"]), opt("ks"), opt("vs"),
        LAYER, torch.tensor(lengths, dtype=torch.int32), to_torch(c["cos"]),
        to_torch(c["sin"]), q_norm=opt("q_norm") if qkn else None,
        k_norm=opt("k_norm") if qkn else None, sm_scale=SM_SCALE, window=window,
        softcap=softcap)
    w_att, w_k, w_v, w_ks, w_vs = c["want"]
    assert att.shape == (b, hkv * g, D) == w_att.shape and torch.isfinite(att).all()
    assert rel(att, w_att) <= 3e-2
    for got, want in ((k_row, w_k), (v_row, w_v)):
        diff = np.abs(got.float().numpy() - want)
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-2
    if int8:
        np.testing.assert_allclose(k_sc.numpy(), w_ks, rtol=1e-6)
        np.testing.assert_allclose(v_sc.numpy(), w_vs, rtol=1e-6)


# ---------------------------------------------------------------------------
# the whole-model decode step with gemma's flags
# ---------------------------------------------------------------------------

MK = dict(name="mk-gemma", vocab_size=512, hidden_size=256, intermediate_size=512,
          num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10000.0,
          attention_bias=False, tie_word_embeddings=True)
G2 = dict(MK, mlp_act="gelu_tanh", embed_scale=True, sandwich_norm=True, attn_softcap=50.0,
          final_softcap=30.0, query_scale=64.0 ** -0.5, swa_every_other=True,
          sliding_window=6)
G3 = dict(MK, num_layers=3, mlp_act="gelu_tanh", embed_scale=True, sandwich_norm=True,
          qk_norm=True, swa_pattern=3, rope_local_theta=1000.0, rope_theta=1e6,
          sliding_window=6)
CAP, STEPS, PREFILL = 64, 2, 11
# name -> (config fields, kv bits)
MODEL_CASES = {
    "gelu": (dict(MK, mlp_act="gelu_tanh"), 8),
    "softcap": (dict(MK, attn_softcap=5.0), 8),
    "gemma2": (G2, 8),
    "gemma3": (G3, 8),
    "gemma2-d256-bf16": (dict(G2, head_dim=256, query_scale=256.0 ** -0.5), 16),
}


def jax_model_case(fields, kv_bits):
    cfg = JModelConfig(**fields)
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(0), scale=0.05, lm_head_bits=4)
    rng = np.random.default_rng(5)
    u = lambda a: None if a is None else jnp.asarray(rng.uniform(0.6, 1.4, a.shape),
                                                     jnp.float32)
    lay = p.layers
    lay = dataclasses.replace(
        lay, input_norm=u(lay.input_norm), post_norm=u(lay.post_norm),
        pre_ffn_norm=u(lay.pre_ffn_norm), post_ffn_norm=u(lay.post_ffn_norm),
        q_norm=u(lay.q_norm), k_norm=u(lay.k_norm))
    p = dataclasses.replace(p, layers=lay, final_norm=u(p.final_norm))
    cache = jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                       quantized=kv_bits < 16, kv_bits=kv_bits)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, PREFILL)), jnp.int32)
    _, cache = jdec.forward(p, cfg, toks, cache, interpret=False)
    assert jdm.supports(cfg, p, cache, 1) and jdm.supports_head(cfg, p)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (1,)), jnp.int32)

    def full(c):
        return jnp.concatenate([c[:, 0], c[:, 0]], axis=-1)
    steps = []
    for _ in range(STEPS):
        x = p.embedding[tok]
        pos = cache.length[:, None]
        cos, sin = jlayers.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        cos_l = sin_l = None
        if cfg.swa_pattern:
            cos_l, sin_l = (full(a) for a in jlayers.rope_cos_sin(
                pos, cfg.head_dim, cfg.rope_local_theta))
        outs = jdm.fused_decode_model(
            x, p.layers, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.length,
            full(cos), full(sin), config=cfg, interpret=True, head=p.lm_head,
            final_norm=p.final_norm, cos_l=cos_l, sin_l=sin_l)
        steps.append(dict(
            x=np.asarray(x.astype(jnp.float32)), cos=np.asarray(full(cos)),
            sin=np.asarray(full(sin)),
            cos_l=None if cos_l is None else np.asarray(cos_l),
            sin_l=None if sin_l is None else np.asarray(sin_l),
            cache=numpy_fields(cache), outs=[None if o is None else np.asarray(o)
                                             for o in outs]))
        cache = jdm.scatter_rows(cache, *outs[1:5], cache.length)
        cache = dataclasses.replace(cache, length=jnp.minimum(cache.length + 1,
                                                              cache.capacity))
        tok = outs[6]
    return dict(arrays=numpy_fields(p), steps=steps)


@pytest.fixture(scope="module")
def model_ref():
    return {name: jax_model_case(*case) for name, case in MODEL_CASES.items()}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_plain_with_gemma_flags_matches_jax(model_ref, name):
    fields, kv_bits = MODEL_CASES[name]
    cfg = ModelConfig(**fields)
    ref = model_ref[name]
    params = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    assert decode_model.supports_head(cfg, params)
    for step in ref["steps"]:
        cache = kvcache.cache_from_numpy(step["cache"], kv_bits)
        assert decode_model.supports(cfg, params, cache, 1)
        opt = lambda k: None if step[k] is None else tt(step[k])
        got = decode_model.fused_decode_model(
            tt(step["x"]), params.layers, cache.k, cache.v, cache.k_scale, cache.v_scale,
            cache.length, tt(step["cos"]), tt(step["sin"]), config=cfg,
            head=params.lm_head, final_norm=params.final_norm, cos_l=opt("cos_l"),
            sin_l=opt("sin_l"))
        assert all(torch.isfinite(t).all() for t in got if t is not None)
        m = decode_model.parity_metrics(got, as_torch(step["outs"]), kv_bits)
        assert not decode_model.parity_failures(m), m


def test_model_flags_and_schedule_header():
    """The flags reach the schedule's header (a table built for other flags
    is refused by the kernel), and sandwich norms add a grid-wide wait after
    the last layer and one fold item a 128-column tile of the residual."""
    g2, g3 = ModelConfig(**G2), ModelConfig(**G3)
    f2, f3 = decode_model.model_flags(g2), decode_model.model_flags(g3)
    assert f2 == (decode_model.F_SANDWICH | decode_model.F_GELU | decode_model.F_SOFTCAP
                  | decode_model.F_SWA_ALT)
    assert f3 == decode_model.F_SANDWICH | decode_model.F_GELU | decode_model.F_SWA_P
    args = (1, 2, 256, 4, 2, 64, 512, CAP, 0, 4, 128, 128, 0, 0, 132,
            decode_model.ring_slots(1, 64), 132)
    plain, _ = decode_model.schedule(*args)
    sand, _ = decode_model.schedule(*args, flags=f3, swa_p=3)
    assert plain[decode_model.H_FLAGS] == 0 and sand[decode_model.H_FLAGS] == f3
    assert sand[decode_model.H_SWA_P] == 3

    def kinds(table):
        grid = int(table[decode_model.H_GRID])
        recs = table[decode_model.records_at(grid):].reshape(-1, decode_model.REC)
        return recs[:, decode_model.R_KIND].tolist()
    assert kinds(plain).count(decode_model.FOLD) == 0
    assert kinds(sand).count(decode_model.FOLD) == 2          # hidden 256: two tiles
    assert (kinds(sand).count(decode_model.BAR)
            == kinds(plain).count(decode_model.BAR) + 132)    # one more wait, every block


# ---------------------------------------------------------------------------
# the eager attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,window,softcap", [(5, 4, 50.0), (1, 0, 0.0), (1, 6, 50.0)])
def test_attention_eager_matches_xla(t, window, softcap):
    cfg = ModelConfig(**dict(G2, attn_softcap=softcap))
    jcfg = JModelConfig(**dict(G2, attn_softcap=softcap))
    rng = np.random.default_rng(9)
    b, hkv, g, d, s = 2, 2, 2, 64, 32
    lengths = np.array([17, 9], np.int32)
    kv = rng.standard_normal((2, b, hkv, s, d)).astype(np.float32)
    (kq, ks), (vq, vs) = (jkv.quantize_kv4(jnp.asarray(a)) for a in kv)
    q = jnp.asarray(rng.standard_normal((b, hkv * g, t, d)), jnp.bfloat16)
    kv_len = jnp.asarray(lengths + t, jnp.int32)
    want = jdec._attention_xla(jcfg, q, kq, vq, ks, vs, kv_len, jnp.asarray(lengths),
                               window, 4)
    got = decoder._attention_eager(
        cfg, to_torch(q), to_torch(kq), to_torch(vq), to_torch(ks), to_torch(vs),
        to_torch(kv_len), torch.from_numpy(lengths), window, 4)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hkv * g, t, d)
    assert rel(got, np.asarray(want, np.float32)) <= 1e-5
