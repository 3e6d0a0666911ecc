"""KV variants in the port against the JAX package, on the CPU: the TQ3 and
TQ4 codebook caches, the Hadamard KV rotation, `compact_tail`, and a tiny
dense, gemma and mixture-of-experts model under each.

The same numpy inputs go through the JAX function and the port's. Bounds:

* unpacking and dequantizing a codebook cache, the Hadamard matrix and
  `compact_tail`: bit-exact;
* the codebook quantizers: the scale is the row's RMS, whose mean of
  squares the JAX package sums in f32 in XLA's order and the port in f64,
  with the root in f64 too (rounded once, so that the card and the CPU
  agree). The scales then lie
  within `SCALE_ULPS` f32 ulps of each other (20,000 rows at each of
  head_dim 32, 64 and 128 showed at most 2), and a code moves only where x / rms sits within that
  much of a boundary between two levels: at most a share `CODE_SHARE` of
  the codes, each by one level (none moved in the rows here);
* `rotate_heads`: within 1e-6 (both are f32 products, summed in other
  orders);
* a model's logits, a prefill and `STEPS` greedy decode steps: rel-L2 5e-2
  a step (`tests/test_decode_model.py:97`), the tokens equal wherever the
  JAX top-2 margin exceeds the largest logit difference (at least one step
  for the dense and the mixture-of-experts model; the tiny gemma's
  softcapped logits can leave no margin above the difference, as in
  `tests/test_torch_gemma.py`). The tiny gemma over a grid of at most 4
  bits (TQ3, TQ4, int4 under rotation) is held to `tests/test_torch_gemma.py`'s
  int4 bound, 1e-1: one bf16 ulp upstream moves a K/V value a whole level
  of so coarse a grid, and the JAX package's own two paths (its plain XLA
  reference and its Pallas kernels in interpret mode) sit 4.8e-2 to 5.7e-2
  apart at TQ3, 3.4e-2 to 4.6e-2 at TQ4 and 5.6e-2 to 6.6e-2 at rotated
  int4 on this model and prompt; the port sits 5.0e-2, 4.6e-2 and 6.1e-2
  from the reference path at the prefill.

The JAX side runs as the JAX package's own tests of these variants run it
(`tests/test_kv3.py`, `test_kv_tq4.py`, `test_kv_rotate.py`): `forward`
without `interpret`, which on the CPU takes its plain XLA reference. It is
computed once per module (XLA:CPU fails after a few hundred compilations in
one process).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_gemma as tgemma
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import layers as jlayers
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.runtime.llm import Llm as JLlm
from mnn_tpu_torch.kernels import decode_model
from mnn_tpu_torch.models import decoder, layers
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import jax_params, numpy_fields, rel
from tests.test_torch_moe import FIELDS as MOE_FIELDS

SCALE_ULPS = 4
CODE_SHARE = 1e-3
REL = 5e-2
COARSE = ("tq3", "tq4", "rot-int4")   # grids of at most 4 bits: gemma's INT4 bound
CAP, PROMPT, STEPS = 48, 20, 3

MODELS = {   # name -> (ModelConfig fields, the JAX weights)
    "dense": (dataclasses.asdict(PRESETS["tiny"]), lambda c: jax_params(c)),
    "gemma2": (tgemma.G2, lambda c: tgemma.jax_params(c, 4)),
    "moe": (MOE_FIELDS, lambda c: jax_params(c)),
}
VARIANTS = {  # name -> (cache kwargs, kv_rotate)
    "tq3": (dict(quantized=True, kv_bits=3), False),
    "tq4": (dict(quantized=True, kv_bits=4, kv_codebook=True), False),
    "rot-bf16": (dict(quantized=False), True),
    "rot-int8": (dict(quantized=True, kv_bits=8), True),
    "rot-int4": (dict(quantized=True, kv_bits=4), True),
}
# the two runtime flags the parent tree's `Llm` dropped
FAULTS = {"kv_rotate": dict(kv_rotate=True, kv_bits=4),
          "kv_codebook": dict(kv_bits=4, kv_codebook=True)}


def jnp_of(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(np.uint16)).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def np_of(a) -> np.ndarray:
    """JAX array -> numpy, bf16 as its uint16 bits (comparable bit for bit)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def torch_np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


# --------------------------------------------------------------------------
# the codebook quantizers
# --------------------------------------------------------------------------

def kv_rows(d: int, seed: int = 0) -> torch.Tensor:
    """bf16 rows [3, 2, 41, d] of mixed scales, one of them all zeros (the
    K/V rows a cache quantizes are bf16)."""
    rng = np.random.default_rng(seed + d)
    x = rng.normal(size=(3, 2, 41, d)) * rng.uniform(0.05, 8.0, size=(3, 2, 41, 1))
    x[0, 0, 0] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


QUANTIZERS = {"tq3": (jkv.quantize_kv3, "quantize_kv3", jkv.unpack_kv3),
              "tq4": (jkv.quantize_kv4cb, "quantize_kv4cb", jkv.unpack_kv4cb)}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("kind", list(QUANTIZERS))
def test_codebook_quantizer_matches_jax(kind, d):
    jq, tq, junpack = QUANTIZERS[kind]
    x = kv_rows(d)
    pj, sj = jq(jnp_of(x))
    pt, st = getattr(kvcache, tq)(x)
    assert pt.dtype == torch.int8 and tuple(pt.shape) == tuple(pj.shape)
    assert pt.shape[-1] == (d * 3 // 8 if kind == "tq3" else d // 2)
    sj, st = np.asarray(sj), st.numpy()
    assert st[0, 0, 0] == 1.0 == sj[0, 0, 0]          # a zero row: scale 1
    ulps = np.abs(st.view(np.int32).astype(np.int64) - sj.view(np.int32))
    assert ulps.max() <= SCALE_ULPS, ulps.max()
    # the codes: the JAX unpack of both packings gives each value's level
    lv = np.asarray(jkv.TQ3_LEVELS if kind == "tq3" else jkv.TQ4_LEVELS)
    cj = np.searchsorted(lv, np.asarray(junpack(pj)))
    ct = np.searchsorted(lv, np.asarray(junpack(jnp.asarray(pt.numpy()))))
    moved = cj != ct
    assert moved.mean() <= CODE_SHARE and (np.abs(cj - ct)[moved] == 1).all()


@pytest.mark.parametrize("kind", list(QUANTIZERS))
def test_codebook_unpack_and_dequant_match_jax_bit_for_bit(kind):
    """Every byte value, and the JAX package's own packing of real rows,
    unpack and dequantize to the JAX package's bits."""
    jq, _, junpack = QUANTIZERS[kind]
    tunpack = kvcache.unpack_kv3 if kind == "tq3" else kvcache.unpack_kv4cb
    bits, codebook = (3, False) if kind == "tq3" else (4, True)
    every = np.resize(np.arange(-128, 128, dtype=np.int8), (2, 8, 24 if bits == 3 else 32))
    np.testing.assert_array_equal(tunpack(torch.from_numpy(every.copy())).numpy(),
                                  np.asarray(junpack(jnp.asarray(every))))
    packed, scale = jq(jnp_of(kv_rows(64, seed=5)))
    pt, sc = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale))
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        want = np_of(jkv.dequant_kv(packed, scale, bits, dtype=jdt, codebook=codebook))
        got = kvcache.dequant_kv(pt, sc, bits, dtype=tdt, codebook=codebook)
        np.testing.assert_array_equal(torch_np(got), want)


def test_codebook_cache_layouts():
    c3 = kvcache.create(2, 1, 2, 16, 64, kv_bits=3, device="cpu")
    c4 = kvcache.create(2, 1, 2, 16, 64, kv_bits=4, kv_codebook=True, device="cpu")
    u4 = kvcache.create(2, 1, 2, 16, 64, kv_bits=4, device="cpu")
    assert (c3.bits, c3.codebook, c3.k.shape[-1]) == (3, False, 24)
    assert (c4.bits, c4.codebook, c4.k.shape[-1]) == (4, True, 32)
    assert not u4.codebook and c3.k.nbytes < u4.k.nbytes
    # the flag means nothing without a 4-bit quantized cache, as in JAX
    assert not kvcache.create(1, 1, 1, 8, 64, kv_bits=8, kv_codebook=True).codebook
    assert not kvcache.create(1, 1, 1, 8, 64, quantized=False, kv_bits=4,
                              kv_codebook=True).codebook
    with pytest.raises(ValueError, match="head_dim % 8"):
        kvcache.create(1, 1, 1, 8, 36, kv_bits=3)
    assert kvcache.slot_view(c4, 0).codebook


# --------------------------------------------------------------------------
# the Hadamard rotation
# --------------------------------------------------------------------------

def test_hadamard_matches_jax_and_is_orthonormal():
    for d in (1, 2, 8, 32, 64, 128, 256):
        h = layers.hadamard(d)
        assert h.dtype == np.float32
        np.testing.assert_array_equal(h, np.asarray(jlayers.hadamard(d)).astype(np.float32))
        np.testing.assert_allclose(h @ h.T, np.eye(d), atol=1e-5)
    for bad in (48, 0, 96):
        with pytest.raises(ValueError):
            layers.hadamard(bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotate_heads_matches_jax(dtype):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 64)).astype(np.float32)).to(dtype)
    for inverse in (False, True):
        got = layers.rotate_heads(x, inverse=inverse)
        want = np.asarray(jlayers.rotate_heads(jnp_of(x), inverse=inverse))
        assert got.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        else:   # the f32 products round to the same bf16 values
            np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                       atol=1e-6, rtol=0)
    xf = x.float()
    back = layers.rotate_heads(layers.rotate_heads(xf), inverse=True)
    np.testing.assert_allclose(back.numpy(), xf.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# compact_tail
# --------------------------------------------------------------------------

TAILS = [  # (start, sel, m): overlapping moves, junk past m (one out of range)
    (5, [0, 2, 3, 1, 7, 9, 40, -3], 5),
    (12, [1, 0, 3, 2, -20, 5, 30, 2], 3),    # W rows at 8 (clamped), rows past S
    (0, [0, 1, 2, 3], 4),
]


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("case", range(len(TAILS)))
def test_compact_tail_matches_jax_bit_for_bit(quantized, case):
    start, sel, m = TAILS[case]
    rng = np.random.default_rng(case)
    shape = (2, 2, 2, 16, 8)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks, vs = (rng.uniform(0.1, 2, shape[:-1]).astype(np.float32) for _ in range(2))
    else:
        k, v = (np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)) for _ in range(2))
        ks = vs = None
    length = np.array([13, 9], np.int32)
    jc = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                     k_scale=None if ks is None else jnp.asarray(ks),
                     v_scale=None if vs is None else jnp.asarray(vs),
                     length=jnp.asarray(length), bits=8 if quantized else 16)
    want = jkv.compact_tail(jc, start, jnp.asarray(sel, jnp.int32), m)
    tc = kvcache.cache_from_numpy(dict(k=k, v=v, k_scale=ks, v_scale=vs, length=length),
                                  8 if quantized else 16)
    got = kvcache.compact_tail(tc, torch.tensor(start), torch.tensor(sel), m)
    for name in ("k", "v", "k_scale", "v_scale", "length"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
            continue
        np.testing.assert_array_equal(torch_np(getattr(got, name)), np_of(w), err_msg=name)
    assert got.k.data_ptr() == tc.k.data_ptr()      # in place
    assert int(got.length[1]) == 9                  # only row 0 moves


# --------------------------------------------------------------------------
# the models under each variant
# --------------------------------------------------------------------------

def jax_trace(params, jcfg, ids, variant):
    cache_kw, rotate = VARIANTS[variant]
    jcfg = dataclasses.replace(jcfg, kv_rotate=rotate)
    cache = jkv.create(jcfg.num_layers, 1, jcfg.num_kv_heads, CAP, jcfg.head_dim,
                       **cache_kw)
    logits, cache = jdec.forward(params, jcfg, jnp.asarray([ids], jnp.int32), cache)
    rows, toks = [np.asarray(logits, np.float32)], []
    for _ in range(STEPS):
        toks.append(int(np.argmax(rows[-1][0])))
        logits, cache = jdec.forward(params, jcfg, jnp.asarray([[toks[-1]]], jnp.int32),
                                     cache)
        rows.append(np.asarray(logits, np.float32))
    return rows, toks


def jax_rt(**kw):
    return JRuntimeConfig(max_seq_len=CAP, prefill_chunk=32, decode_block=STEPS,
                          sampler="greedy", max_new_tokens=STEPS, **kw)


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name, (fields, make) in MODELS.items():
        jcfg = JModelConfig(**fields)
        params = make(jcfg)
        ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, PROMPT).tolist()
        out[name] = dict(arrays=numpy_fields(params), ids=ids, traces={
            v: jax_trace(params, jcfg, ids, v) for v in VARIANTS})
        if name == "dense":
            out["llm"] = {f: list(JLlm(jcfg, params, rt=jax_rt(**kw)).stream(token_ids=ids))
                          for f, kw in FAULTS.items()}
    return out


def port_model(ref, name):
    cfg = ModelConfig(**MODELS[name][0])
    return cfg, decoder.params_from_numpy(ref[name]["arrays"], cfg, "cpu")


def port_trace(params, cfg, ids, variant, feed):
    cache_kw, rotate = VARIANTS[variant]
    cfg = dataclasses.replace(cfg, kv_rotate=rotate)
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                           device="cpu", **cache_kw)
    logits, cache = decoder.forward(params, cfg, torch.tensor([ids]), cache)
    rows = [logits.float().numpy()]
    for tok in feed:
        logits, cache = decoder.forward(params, cfg, torch.tensor([[tok]]), cache)
        rows.append(logits.float().numpy())
    return rows, cache


def checked_steps(got, want) -> int:
    """Steps whose JAX top-2 margin exceeds the largest logit difference,
    up to the first that does not: the tokens must be equal there."""
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    n = 0
    for b in want:
        top2 = np.sort(b[0])[-2:]
        if top2[1] - top2[0] <= diff:
            break
        n += 1
    return n


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("model", list(MODELS))
def test_model_under_variant_matches_jax(ref, model, variant):
    cfg, params = port_model(ref, model)
    want, toks = ref[model]["traces"][variant]
    got, cache = port_trace(params, cfg, ref[model]["ids"], variant, toks)
    assert int(cache.length[0]) == PROMPT + STEPS
    assert cache.codebook == (variant == "tq4")
    bound = tgemma.INT4 if model == "gemma2" and variant in COARSE else REL
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert rel(a, b) <= bound, f"{model} {variant} step {s}: rel-L2 {rel(a, b):.3g}"
    n = checked_steps(got, want)
    assert n >= 1 or model == "gemma2", f"{model} {variant}: no step with a clear margin"
    for s in range(n):
        assert int(got[s].argmax()) == int(want[s].argmax()), f"{model} {variant} step {s}"


@pytest.mark.parametrize("fault", list(FAULTS))
def test_llm_runtime_flag_reaches_the_model(ref, fault):
    """`RuntimeConfig(kv_rotate=True)` and `RuntimeConfig(kv_bits=4,
    kv_codebook=True)` give the JAX `Llm`'s tokens: the port's `Llm` rotates
    K, Q and V and builds a TQ4 cache, as the JAX `Llm` does."""
    cfg, params = port_model(ref, "dense")
    rt = RuntimeConfig(max_seq_len=CAP, prefill_chunk=32, decode_block=STEPS,
                       sampler="greedy", max_new_tokens=STEPS, **FAULTS[fault])
    llm = Llm(cfg, params, rt, device="cpu")
    info = llm.info()
    if fault == "kv_rotate":
        assert llm.config.kv_rotate and info["kv_rotate"] and not info["kv_codebook"]
        variant = "rot-int4"
    else:
        assert llm.cache.codebook and info["kv_codebook"] and llm.cache.bits == 4
        variant = "tq4"
    out = list(llm.stream(token_ids=ref["dense"]["ids"]))
    want_toks = ref["llm"][fault]
    assert len(out) == len(want_toks) == STEPS
    want, toks = ref["dense"]["traces"][variant]
    got, _ = port_trace(params, cfg, ref["dense"]["ids"], variant, toks)
    n = checked_steps(got, want)
    assert n >= 1
    assert out[:n] == want_toks[:n] == toks[:n]


def test_variants_refuse_the_self_quantizing_decode_kernels(ref, monkeypatch):
    """Under a codebook cache or rotated rows neither the whole-model kernel
    nor the decode-step kernel serves a decode step, as in the JAX package
    (`supports`, `fused`, gemma's eager condition); int8 without rotation
    still takes them."""
    cfg, params = port_model(ref, "gemma2")
    mk = lambda **kw: kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP,
                                     cfg.head_dim, device="cpu", **kw)
    assert decode_model.supports(cfg, params, mk(kv_bits=8), 1)
    assert decode_model.supports(cfg, params, mk(kv_bits=4), 1)
    assert not decode_model.supports(cfg, params, mk(kv_bits=4, kv_codebook=True), 1)
    assert not decode_model.supports(cfg, params, mk(kv_bits=3), 1)
    assert not decode_model.supports(dataclasses.replace(cfg, kv_rotate=True), params,
                                     mk(kv_bits=8), 1)

    def refuse(*a, **k):
        raise AssertionError("a self-quantizing decode kernel ran")

    for model in ("dense", "gemma2", "moe"):
        cfg, params = port_model(ref, model)
        for variant in VARIANTS:
            cache_kw, rotate = VARIANTS[variant]
            c = dataclasses.replace(cfg, kv_rotate=rotate)
            cache = kvcache.create(c.num_layers, 1, c.num_kv_heads, CAP, c.head_dim,
                                   device="cpu", **cache_kw)
            _, cache = decoder.forward(params, c, torch.tensor([[1, 2, 3]]), cache)
            with monkeypatch.context() as mp:
                mp.setattr(decoder, "fused_decode_attention", refuse)
                mp.setattr(decoder, "_decode_megakernel", refuse)
                logits, cache = decoder.forward(params, c, torch.tensor([[4]]), cache)
            assert np.isfinite(logits.float().numpy()).all()
            assert int(cache.length[0]) == 4


def test_cli_serves_a_tq3_cache(capsys, monkeypatch):
    """`cli run --kv-bits 3` on the CPU: the flag reaches the `Llm`'s cache."""
    from mnn_tpu_torch import cli
    from mnn_tpu_torch.runtime import llm as llm_mod

    seen = []
    real = llm_mod.Llm.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        seen.append((self.cache.bits, self.cache.codebook, self.cache.k.shape[-1]))
    monkeypatch.setattr(llm_mod.Llm, "__init__", spy)
    cli.main(["run", "--synthetic", "tiny", "--device", "cpu", "--max-seq-len", "64",
              "--max-new-tokens", "3", "--sampler", "greedy", "--raw", "--kv-bits", "3",
              "hi"])
    assert "decode 3 tok" in capsys.readouterr().err
    assert seen == [(3, False, PRESETS["tiny"].head_dim * 3 // 8)]
