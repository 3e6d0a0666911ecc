"""Quant blocks of 136 to 256 K-values: the port against the JAX package on
the CPU.

The JAX kernels take any quant block that divides K; on the card the port's
three tensor-core dequant kernels and the grouped expert kernel take blocks
above 128 in a build of their own that stages the whole block and unpacks
it in two chunks of K-rows (`csrc/dequant_matmul.cuh`, `csrc/deq_dot.cuh`),
and the GEMV and the whole-model kernel take them in their one build. Here,
on the CPU, the port's wrappers run their plain versions, which those
kernels are held to on the card (`tests/test_torch_cuda.py -k block`); the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's own
kernel tests do, and its `forward` on the per-layer Pallas path. The same
numpy inputs, made from a seed, feed both.

Cases: the dequant matmul at blocks 256 and 176 over two and three blocks
of K, M = 1 and M = 40 with bf16 rows, M = 40 with int8 rows, the
dequantize-tile algebra; W4, W8 and W3; stacked weights with `out_bias`;
f32 output (rel-L2 1e-2, the bound of the block-128 cases,
`tests/test_torch_rows_gemm.py`). The grouped expert MLP at blocks 256 / 176
(h 256, mi 704) on the partial algebra and with a dequantized down product
(2e-2, `tests/test_torch_moe_prefill.py`). A two-layer qwen2-family model
(hidden 256, intermediate 512) at quant_block 256 with an int4 head: a
40-token prefill and 4 greedy decode steps, logits within rel-L2 5e-2 a
step and tokens equal wherever the JAX top-2 margin exceeds the largest
logit difference (`tests/test_torch_decoder.py`). A block of 264, above the
card's limit, raises in the kernels' own check, named; no card is needed
to reach it. Every JAX result is computed once for the module.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels import moe_prefill as jmoe_prefill
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JConfig
from mnn_tpu.models.config import RuntimeConfig as JRuntime
from mnn_tpu.quant.quantize import QuantizedLinear as JQL
from mnn_tpu.runtime import generate as jgen
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.kernels import dequant_matmul, moe_prefill
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import generate
from mnn_tpu_torch.runtime.llm import Llm

jdq = importlib.import_module("mnn_tpu.kernels.dequant_matmul")

L = 2   # layers of a stacked weight; layer 1 is read
# (name, bits, act bits, M, K, N, block, stacked with out_bias, f32 out, dequantize-tile)
GEMM = [
    ("m1-w4-bs256-2blocks", 4, 16, 1, 512, 200, 256, False, False, False),
    ("m1-w8-bs176-3blocks-stacked-f32", 8, 16, 1, 528, 132, 176, True, True, False),
    ("m40-w4-bs256-3blocks-stacked", 4, 16, 40, 768, 200, 256, True, False, False),
    ("m40-w3-bs176-2blocks-f32", 3, 16, 40, 352, 200, 176, False, True, False),
    ("m40-a8-w4-bs176-3blocks-stacked-f32", 4, 8, 40, 528, 200, 176, True, True, False),
    ("m40-a8-w8-bs256-2blocks", 8, 8, 40, 512, 132, 256, False, False, False),
    ("m40-a8-w3-bs256-3blocks", 3, 8, 40, 768, 200, 256, False, False, False),
    ("m40-deq-w4-bs256-2blocks-stacked", 4, 16, 40, 512, 200, 256, True, False, True),
    ("m40-deq-w8-bs176-3blocks-f32", 8, 16, 40, 528, 132, 176, False, True, True),
]
# (name, bits, E, C, H, mi, block of gate/up, block of down): C below both
# blocks (partial products), and C = 200 (gate/up partial, down dequantized)
MOE = [("c24", 4, 2, 24, 256, 704, 256, 176), ("c200-w8", 8, 2, 200, 256, 704, 256, 176)]
CFG = dict(name="b256-test", vocab_size=256, hidden_size=256, intermediate_size=512,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64, attention_bias=True,
           tie_word_embeddings=False)
RT = dict(max_seq_len=128, prefill_chunk=64, decode_block=2, sampler="greedy", kv_quant=True,
          kv_bits=8, quant_bits=4, quant_block=256, lm_head_bits=4, prefill_act_bits=8)
PROMPT, STEPS = 40, 4


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> torch tensor; bf16 crosses through its bits."""
    a = np.array(np.asarray(a))                    # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def rel(got, want) -> float:
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def weights(rng, lead, k, n, bits, bs):
    """numpy packed [*lead, K*bits/8, N] int8 and bf16 (as JAX arrays) scale
    and bias [*lead, K/bs, N]: centred weights of about 0.1."""
    packed = rng.integers(-128, 128, size=(*lead, k * bits // 8, n), dtype=np.int8)
    qmax = (1 << bits) - 1
    scale = jnp.asarray(rng.uniform(0.5, 1.5, size=(*lead, k // bs, n)) * 0.1 / qmax,
                        jnp.bfloat16)
    bias = jnp.asarray(-(qmax / 2) * np.asarray(scale, np.float32)
                       + rng.normal(0, 2e-3, size=scale.shape), jnp.bfloat16)
    return packed, scale, bias


def numpy_fields(obj, prefix=""):
    """JAX Params -> {dotted field name: numpy array or static int}."""
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


def jax_trace(params, cfg, rt, ids):
    """The prefill and STEPS greedy steps on the JAX per-layer Pallas path in
    interpret mode: (logit rows, tokens fed)."""
    fwd = jax.jit(lambda p, tok, cache, all_logits=False: jdec.forward(
        p, cfg, tok, cache, interpret=True, megakernel=False, all_logits=all_logits),
        static_argnames=("all_logits",))
    cache = jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, rt.max_seq_len, cfg.head_dim,
                       quantized=True, kv_bits=rt.kv_bits)
    bucket = jgen.prefill_buckets(len(ids), rt.prefill_chunk)[0]
    chunk = jgen.pad_tokens(jnp.asarray([ids], jnp.int32), bucket)
    logits, cache = fwd(jgen.prefill_params_view(params, rt), chunk, cache, all_logits=True)
    cache = dataclasses.replace(cache, length=cache.length - (bucket - len(ids)))
    rows, toks = [np.asarray(logits[:, len(ids) - 1], np.float32)], []
    for _ in range(STEPS):
        toks.append(int(np.argmax(rows[-1][0])))
        logits, cache = fwd(params, jnp.asarray([[toks[-1]]], jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return rows, toks


@pytest.fixture(scope="module")
def ref():
    """Inputs, and every JAX result of this module computed once."""
    rng = np.random.default_rng(24)
    out = {}
    for name, bits, act, m, k, n, bs, stacked, f32, deq in GEMM:
        lead = (L,) if stacked else ()
        w = weights(rng, lead, k, n, bits, bs)
        ob = rng.normal(0, 0.1, size=(*lead, n)).astype(np.float32) if stacked else None
        x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
        ql = JQL(packed=jnp.asarray(w[0]), scale=w[1], bias=w[2],
                 out_bias=None if ob is None else jnp.asarray(ob), bits=bits, block_size=bs,
                 act_bits=act)
        lidx = jnp.int32(1) if stacked else None
        out_dtype = jnp.float32 if f32 else jnp.bfloat16
        if deq:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jdq, "DEQ_MIN_M", 1)
                # outside `jit`, whose cache would keep a trace made before the switch
                want = jdq._dequant_matmul_pallas(x, ql, lidx, out_dtype=out_dtype, block_m=None,
                                                  block_n=None, block_k=None, interpret=True)
        else:
            want = jdq.dequant_matmul(x, ql, layer_index=lidx, out_dtype=out_dtype,
                                      interpret=True)
        out[name] = dict(w=w, out_bias=ob, x=np.asarray(x), want=np.asarray(want, np.float32))
    for name, bits, e, cap, h, mi, bs_h, bs_mi in MOE:
        gu = weights(rng, (e,), h, 2 * mi, bits, bs_h)
        dn = weights(rng, (e,), mi, h, bits, bs_mi)
        xe = jnp.asarray(rng.standard_normal((e, cap, h)) * 0.5, jnp.bfloat16)
        w_e = rng.uniform(0.1, 0.9, size=(e, cap)).astype(np.float32)
        xe = xe.at[:, cap - 3:].set(0)               # empty slots: zero rows, weight 0
        w_e[:, cap - 3:] = 0
        jql = lambda d, bs: JQL(packed=jnp.asarray(d[0]), scale=d[1], bias=d[2], out_bias=None,
                                bits=bits, block_size=bs)
        y = jmoe_prefill.moe_prefill_mlp(xe, jnp.asarray(w_e), jql(gu, bs_h), jql(dn, bs_mi),
                                         interpret=True)
        out[name] = dict(gu=gu, dn=dn, xe=np.asarray(xe), w_e=w_e, want=np.asarray(y, np.float32))
    jcfg, jrt = JConfig(**CFG), JRuntime(**RT)
    params = jdec.init_random_params(jcfg, jax.random.PRNGKey(24), quant_block=256,
                                     lm_head_bits=4, scale=0.05, fast=True)
    ids = rng.integers(0, CFG["vocab_size"], PROMPT).tolist()
    rows, toks = jax_trace(params, jcfg, jrt, ids)
    out["model"] = dict(arrays=numpy_fields(params), ids=ids, rows=rows, toks=toks)
    return out


def port_ql(w, bits, bs, act_bits=16, out_bias=None) -> QuantizedLinear:
    return QuantizedLinear(packed=to_torch(w[0]), scale=to_torch(w[1]), bias=to_torch(w[2]),
                           out_bias=None if out_bias is None else to_torch(out_bias),
                           bits=bits, block_size=bs, act_bits=act_bits)


@pytest.mark.parametrize("name,bits,act,m,k,n,bs,stacked,f32,deq", GEMM)
def test_block256_dequant_matmul_matches_jax(ref, monkeypatch, name, bits, act, m, k, n, bs,
                                             stacked, f32, deq):
    d = ref[name]
    ql = port_ql(d["w"], bits, bs, act, d["out_bias"])
    if deq:
        monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", 1)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    got = dequant_matmul.dequant_matmul(to_torch(d["x"]), ql,
                                        layer_index=1 if stacked else None, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n) == d["want"].shape
    assert torch.isfinite(got).all()
    assert rel(got, d["want"]) <= 1e-2


@pytest.mark.parametrize("name,bits,e,cap,h,mi,bs_h,bs_mi", MOE)
def test_block256_moe_prefill_matches_jax(ref, name, bits, e, cap, h, mi, bs_h, bs_mi):
    d = ref[name]
    gu, dn = port_ql(d["gu"], bits, bs_h), port_ql(d["dn"], bits, bs_mi)
    assert moe_prefill.supports(gu, dn, h, cap)
    got = moe_prefill.moe_prefill_mlp(to_torch(d["xe"]), to_torch(d["w_e"]), gu, dn)
    assert got.shape == (e, cap, h) == d["want"].shape and torch.isfinite(got).all()
    assert rel(got, d["want"]) <= 2e-2
    assert (got[:, cap - 3:] == 0).all()


def test_block256_model_matches_jax(ref):
    """The port's prefill and decode at quant_block 256 (every projection
    and the int4 head), from the JAX package's weights."""
    d = ref["model"]
    cfg, rt = ModelConfig(**CFG), RuntimeConfig(**RT)
    params = decoder.params_from_numpy(d["arrays"], cfg, "cpu")
    lay = params.layers
    assert {q.block_size for q in (lay.wqkv, lay.wo, lay.wgu, lay.wdown, params.lm_head)} == {256}
    llm = Llm(cfg, params, rt, device="cpu")
    logits, cache = generate.run_prefill(params, cfg, rt, torch.tensor([d["ids"]]),
                                         llm._new_cache())
    got = [logits.float().numpy()]
    for tok in d["toks"]:
        logits, cache = decoder.forward(params, cfg, torch.tensor([[tok]]), cache)
        got.append(logits.float().numpy())
    want = d["rows"]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    checked = 0
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (1, cfg.vocab_size) and np.isfinite(a).all()
        assert rel(a, b) <= 5e-2, f"step {s}: rel-L2 {rel(a, b):.3g}"
        top2 = np.sort(b[0])[-2:]
        if top2[1] - top2[0] > diff:
            checked += 1
            assert int(a.argmax()) == int(b.argmax()), f"step {s}"
    assert checked >= 1


def test_block_above_256_raises_before_a_launch():
    """The kernels' own check, which a CUDA tensor meets before any launch,
    refuses a block of 264 and names the limit; the grouped expert kernel
    declines it. The plain version, which a CPU tensor takes, computes it."""
    rng = np.random.default_rng(264)
    w = weights(rng, (), 528, 200, 4, 264)
    ql = port_ql(w, 4, 264)
    with pytest.raises(ValueError, match="at most 256 K-values"):
        dequant_matmul._check_weights(ql, 528)
    dequant_matmul._check_weights(port_ql(weights(rng, (), 512, 200, 4, 256), 4, 256), 512)
    gu, dn = port_ql(weights(rng, (2,), 528, 256, 4, 264), 4, 264), port_ql(
        weights(rng, (2,), 128, 528, 4, 128), 4, 128)
    assert not moe_prefill.supports(gu, dn, 528, 8)
    x = torch.from_numpy(rng.standard_normal((3, 528)).astype(np.float32)).to(torch.bfloat16)
    assert torch.isfinite(dequant_matmul.dequant_matmul(x, ql)).all()
