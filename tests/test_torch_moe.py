"""The port's mixture-of-experts slice against the JAX package, on the CPU.

The same numpy inputs go through a JAX function and its counterpart in the
port: the fused expert decode kernel, the grouped expert prefill kernel, the
dequantize-tile matmul, the routing and capacity dispatch around them, and
the slice as a whole (chunked prefill, then greedy decode steps). The JAX
side runs its Pallas kernels in interpret mode, once per module; the port
runs its kernels' plain versions. Weights are the JAX package's and cross
through `params_from_numpy` (the [L, E, ...] expert stacks as they are).

Bounds: rel-L2 2e-2 for the two expert kernels and the dispatch (the JAX
tests' own, `tests/test_moe_decode.py`), 1e-2 for the dequantize-tile
matmul, 3e-2 per step for the slice's logits; routing ids equal and weights
within 1e-6.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels import moe_decode as jmoe_decode
from mnn_tpu.kernels import moe_prefill as jmoe_prefill
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.quant.quantize import quantize as jquantize
from mnn_tpu_torch.kernels import dequant_matmul, moe_decode, moe_prefill
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.decoder import _tensor
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import (RT, STEPS, jax_greedy_trace, jax_params,
                                      numpy_fields, port_trace, rel)

# the two configs of tests/test_moe_decode.py
FIELDS = dict(
    name="tiny-moe-d64", vocab_size=256, hidden_size=128,
    intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=64, tie_word_embeddings=True, attention_bias=True,
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
    shared_expert_intermediate_size=128, norm_topk_prob=False)
NOSHARED = dict(FIELDS, name="tiny-moe-ns", shared_expert_intermediate_size=0,
                norm_topk_prob=True)
CONFIGS = {"shared": FIELDS, "noshared": NOSHARED}
# a router that overflows an expert: E = 8, k = 2
SKEWED = dict(FIELDS, name="tiny-moe-skew", num_experts=8,
              shared_expert_intermediate_size=0)
# the module: the package re-exports the function under the same name
jdq = importlib.import_module("mnn_tpu.kernels.dequant_matmul")
PROMPT_LEN = 45     # tests.test_torch_decoder's: chunk 32, then 13 of a 32-bucket


def ql_from(arrays, prefix, index=None) -> QuantizedLinear:
    """A port QuantizedLinear over the JAX arrays under `prefix`."""
    def get(name):
        a = arrays.get(f"{prefix}.{name}")
        return None if a is None else _tensor(a if index is None else a[index])
    return QuantizedLinear(
        packed=get("packed"), scale=get("scale"), bias=get("bias"),
        out_bias=get("out_bias"), bits=arrays[prefix + ".bits"],
        block_size=arrays[prefix + ".block_size"])


# --------------------------------------------------------------------------
# (a) the fused expert decode kernel
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_ref():
    """JAX `moe_decode_mlp(interpret=True)` for both configs, n in {1, 3},
    every layer, on routing made with numpy."""
    out = {}
    for key, fields in CONFIGS.items():
        cfg = JModelConfig(**fields)
        p = jdec.init_random_params(cfg, jax.random.PRNGKey(0), scale=0.05)
        rng = np.random.default_rng(5)
        cases = []
        for n in (1, 3):
            for li in range(cfg.num_layers):
                x = (rng.standard_normal((n, cfg.hidden_size)) * 0.1).astype(np.float32)
                sel = np.stack([rng.permutation(cfg.num_experts)[:cfg.num_experts_per_tok]
                                for _ in range(n)]).astype(np.int32)
                wsel = rng.uniform(0.1, 0.9, size=sel.shape).astype(np.float32)
                gate = (rng.uniform(0.2, 0.8, size=n).astype(np.float32)
                        if cfg.shared_expert_intermediate_size and li else None)
                y = jmoe_decode.moe_decode_mlp(
                    jnp.asarray(x), p.layers, jnp.asarray(sel), jnp.asarray(wsel),
                    jnp.int32(li), None if gate is None else jnp.asarray(gate),
                    config=cfg, interpret=True)
                cases.append(dict(n=n, li=li, x=x, sel=sel, wsel=wsel, gate=gate,
                                  y=np.asarray(y, np.float32)))
        out[key] = dict(arrays=numpy_fields(p), cases=cases, supports={
            n: bool(jmoe_decode.supports(cfg, p.layers, n)) for n in (1, 8, 9)})
    return out


@pytest.mark.parametrize("key", list(CONFIGS))
def test_moe_decode_plain_matches_jax(decode_ref, key):
    ref = decode_ref[key]
    cfg = ModelConfig(**CONFIGS[key])
    lay = decoder.params_from_numpy(ref["arrays"], cfg, "cpu").layers
    for n, want in ref["supports"].items():
        assert moe_decode.supports(cfg, lay, n) == want, n
    assert ref["supports"] == {1: True, 8: True, 9: False}
    assert len(ref["cases"]) == 4
    for case in ref["cases"]:
        gate = None if case["gate"] is None else torch.from_numpy(case["gate"])
        args = (torch.from_numpy(case["x"]), lay, torch.from_numpy(case["sel"]),
                torch.from_numpy(case["wsel"]), case["li"], gate)
        got = moe_decode.moe_decode_mlp_plain(*args, config=cfg)
        assert got.shape == case["y"].shape and got.dtype == torch.float32
        r = rel(got.numpy(), case["y"])
        assert r <= 2e-2, (key, case["n"], case["li"], r)
        # on CPU tensors the wrapper runs the plain version
        np.testing.assert_array_equal(
            moe_decode.moe_decode_mlp(*args, config=cfg).numpy(), got.numpy())


def test_moe_decode_supports_refuses_what_the_kernel_cannot_take(decode_ref):
    cfg = ModelConfig(**FIELDS)
    lay = decoder.params_from_numpy(decode_ref["shared"]["arrays"], cfg, "cpu").layers
    a8 = dataclasses.replace(lay, wgu_e=dataclasses.replace(lay.wgu_e, act_bits=8))
    assert not moe_decode.supports(cfg, a8, 1)
    assert not moe_decode.supports(dataclasses.replace(cfg, num_experts=0), lay, 1)
    with pytest.raises(ValueError, match="supports"):
        moe_decode.moe_decode_mlp(torch.zeros((9, 128)), lay, torch.zeros((9, 2)),
                                  torch.zeros((9, 2)), 0, None, config=cfg)


# --------------------------------------------------------------------------
# (b) the grouped expert prefill kernel, both algebras
# --------------------------------------------------------------------------

PREFILL_CAPS = {"partial": 24, "dequant": 136}   # below / above the quant blocks


@pytest.fixture(scope="module")
def prefill_ref():
    cfg = JModelConfig(**FIELDS)
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(1), scale=0.05)
    lp = jax.tree_util.tree_map(lambda a: a[1], p.layers)
    rng = np.random.default_rng(6)
    out = dict(arrays=numpy_fields(p))
    for key, cap in PREFILL_CAPS.items():
        xe = (rng.standard_normal((cfg.num_experts, cap, cfg.hidden_size)) * 0.1
              ).astype(np.float32)
        w_e = rng.uniform(0.1, 0.9, size=(cfg.num_experts, cap)).astype(np.float32)
        xe[:, -5:] = 0          # empty slots: zero rows, weight 0
        w_e[:, -5:] = 0
        y = jmoe_prefill.moe_prefill_mlp(
            jnp.asarray(xe, jnp.bfloat16), jnp.asarray(w_e), lp.wgu_e, lp.wdown_e,
            interpret=True)
        out[key] = dict(xe=xe, w_e=w_e, y=np.asarray(y, np.float32))
    return out


@pytest.mark.parametrize("key", list(PREFILL_CAPS))
def test_moe_prefill_plain_matches_jax(prefill_ref, key):
    arrays, case = prefill_ref["arrays"], prefill_ref[key]
    gu, dn = ql_from(arrays, "layers.wgu_e", 1), ql_from(arrays, "layers.wdown_e", 1)
    cap = PREFILL_CAPS[key]
    assert (cap < gu.block_size) == (key == "partial")
    assert (cap < dn.block_size) == (key == "partial")
    assert moe_prefill.supports(gu, dn, 128, cap)
    xe = torch.from_numpy(case["xe"]).to(torch.bfloat16)
    w_e = torch.from_numpy(case["w_e"])
    got = moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn)
    assert got.shape == case["y"].shape and got.dtype == torch.float32
    assert rel(got.numpy(), case["y"]) <= 2e-2
    assert (got[:, -5:] == 0).all() and (case["y"][:, -5:] == 0).all()
    np.testing.assert_array_equal(
        moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn).numpy(), got.numpy())
    assert not moe_prefill.supports(dataclasses.replace(gu, act_bits=8), dn, 128, cap)
    assert not moe_prefill.supports(gu, None, 128, cap)


# --------------------------------------------------------------------------
# (c) routing and capacity dispatch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def routing_ref():
    """The JAX routing of `_moe_mlp_fused` for a few rows, and `_moe_mlp`
    (grouped dispatch, Pallas in interpret mode) on 32 rows whose router
    sends most of them to expert 0, past its capacity of 16."""
    out = {}
    rng = np.random.default_rng(8)
    for key in CONFIGS:
        cfg = JModelConfig(**CONFIGS[key])
        p = jdec.init_random_params(cfg, jax.random.PRNGKey(2), scale=0.05)
        x = (rng.standard_normal((5, cfg.hidden_size))).astype(np.float32)
        logits = jnp.dot(jnp.asarray(x), p.layers.router[1],
                         preferred_element_type=jnp.float32)
        vals, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                  cfg.num_experts_per_tok)
        if cfg.norm_topk_prob:
            vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
        out[key] = dict(x=x, router=np.array(p.layers.router[1]),
                        vals=np.asarray(vals), idx=np.asarray(idx))
    cfg = JModelConfig(**SKEWED)
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(3), scale=0.05)
    router = rng.standard_normal(p.layers.router.shape).astype(np.float32) * 0.05
    router[:, :, 0] += 0.2          # x has a positive mean: expert 0 wins
    p = dataclasses.replace(p, layers=dataclasses.replace(
        p.layers, router=jnp.asarray(router)))
    h2 = (rng.standard_normal((1, 32, cfg.hidden_size)) * 0.1 + 0.1).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[1], p.layers)
    y = jdec._moe_mlp(cfg, jnp.asarray(h2, jnp.bfloat16), lp, None, True)
    out["skewed"] = dict(arrays=numpy_fields(p), h2=h2, y=np.asarray(y, np.float32))
    return out


@pytest.mark.parametrize("key", list(CONFIGS))
def test_route_matches_jax(routing_ref, key):
    ref = routing_ref[key]
    cfg = ModelConfig(**CONFIGS[key])
    vals, idx = decoder._route(cfg, torch.from_numpy(ref["x"]),
                               torch.from_numpy(ref["router"]))
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    np.testing.assert_allclose(vals.numpy(), ref["vals"], atol=1e-6, rtol=0)


def test_route_orders_ties_by_expert_index():
    cfg = ModelConfig(**FIELDS)
    vals, idx = decoder._route(cfg, torch.zeros((3, 128)), torch.zeros((128, 4)))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1]] * 3)
    np.testing.assert_allclose(vals.numpy(), 0.25)


def test_grouped_dispatch_drops_the_same_tokens_as_jax(routing_ref):
    ref = routing_ref["skewed"]
    cfg = ModelConfig(**SKEWED)
    lay = decoder.params_from_numpy(ref["arrays"], cfg, "cpu").layers
    h2 = torch.from_numpy(ref["h2"]).to(torch.bfloat16)
    _, idx = decoder._route(cfg, h2[0], lay.router[1])
    assert int((idx == 0).sum()) > 16          # expert 0 is over its capacity
    got = decoder._moe_mlp(cfg, h2, lay, 1).numpy()
    want = ref["y"]
    assert got.shape == want.shape
    assert rel(got, want) <= 2e-2
    # token by token: a token dropped on one side only would be far off
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 5e-2 * scale


def test_grouped_dispatch_without_the_grouped_kernel(routing_ref, monkeypatch):
    """Expert stacks that the grouped kernel refuses run one expert's
    capacity batch at a time through the matmul kernel: the same dispatch,
    the same drops."""
    ref = routing_ref["skewed"]
    cfg = ModelConfig(**SKEWED)
    lay = decoder.params_from_numpy(ref["arrays"], cfg, "cpu").layers
    h2 = torch.from_numpy(ref["h2"]).to(torch.bfloat16)
    grouped = decoder._moe_mlp(cfg, h2, lay, 1)
    monkeypatch.setattr(moe_prefill, "supports", lambda *a: False)
    looped = decoder._moe_mlp(cfg, h2, lay, 1)
    assert rel(looped.numpy(), grouped.numpy()) <= 2e-2
    assert rel(looped.numpy(), ref["y"]) <= 2e-2


# --------------------------------------------------------------------------
# (d) the dequantize-tile matmul
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deq_ref():
    """JAX `dequant_matmul` on its dequantize-tile kernel: `DEQ_MIN_M` set low
    on the imported module for one call at a shape no other test uses."""
    rng = np.random.default_rng(9)
    out = {}
    for bits in (4, 8):
        w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
        x = rng.standard_normal((24, 256)).astype(np.float32)
        ql = jquantize(jnp.asarray(w), bits=bits, block_size=128)
        ql = dataclasses.replace(ql, out_bias=jnp.asarray(
            rng.normal(0, 0.1, size=384), jnp.float32))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdq, "DEQ_MIN_M", 24)
            y = jdq.dequant_matmul(jnp.asarray(x, jnp.bfloat16), ql, interpret=True)
        out[bits] = dict(x=x, arrays=numpy_fields(ql, "w."),
                         y=np.asarray(y.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_matmul_deq_plain_matches_jax(deq_ref, bits, monkeypatch):
    ref = deq_ref[bits]
    ql = ql_from(ref["arrays"], "w")
    assert ql.bits == bits and ql.out_bias is not None
    x = torch.from_numpy(ref["x"]).to(torch.bfloat16)
    got = dequant_matmul.dequant_matmul_plain(x, ql, deq=True)
    assert got.dtype == torch.bfloat16
    assert rel(got.float().numpy(), ref["y"]) <= 1e-2
    # the route: off by default, taken from DEQ_MIN_M rows on
    assert dequant_matmul.DEQ_MIN_M == 1 << 30
    other = dequant_matmul.dequant_matmul(x, ql)
    monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", 24)
    routed = dequant_matmul.dequant_matmul(x, ql)
    np.testing.assert_array_equal(routed.float().numpy(), got.float().numpy())
    assert not torch.equal(other, routed)      # the two algebras round differently
    assert rel(other.float().numpy(), ref["y"]) <= 1e-2


# --------------------------------------------------------------------------
# (e) the slice: chunked prefill, then greedy decode steps
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_slice_ref():
    """Weights of the JAX package, a 45-token prompt through its chunked
    prefill (grouped dispatch and the grouped kernel) and greedy decode steps
    (the fused kernel), every Pallas kernel in interpret mode."""
    out = {}
    for key, fields in CONFIGS.items():
        cfg = JModelConfig(**fields)
        params = jax_params(cfg)
        ids = np.random.default_rng(3).integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
        rows, toks = jax_greedy_trace(params, cfg, ids)
        out[key] = dict(arrays=numpy_fields(params), ids=ids, rows=rows, toks=toks)
    return out


@pytest.mark.parametrize("key", list(CONFIGS))
def test_moe_slice_matches_jax(moe_slice_ref, key):
    ref = moe_slice_ref[key]
    cfg = ModelConfig(**CONFIGS[key])
    params = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    lay = params.layers
    assert lay.wgu is None and lay.wdown is None
    assert lay.wgu_e.packed.shape[:2] == (cfg.num_layers, cfg.num_experts)
    assert (lay.wgu_shared is not None) == (key == "shared")
    np.testing.assert_array_equal(lay.wdown_e.packed.numpy(),
                                  ref["arrays"]["layers.wdown_e.packed"])
    want, toks = ref["rows"], ref["toks"]
    got, cache = port_trace(params, cfg, ref["ids"], toks)
    assert int(cache.length[0]) == PROMPT_LEN + STEPS
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (1, cfg.vocab_size) and np.isfinite(a).all()
        assert rel(a, b) <= 3e-2, f"{key} step {s}: rel-L2 {rel(a, b):.3g}"
    # the runtime's own greedy loop, up to the first low-margin step
    llm = Llm(cfg, params, RT, device="cpu")
    info = llm.info()
    assert info["decode_moe_fused"] is True and info["decode_megakernel"] is False
    out = list(llm.stream(token_ids=ref["ids"]))
    assert len(out) == STEPS
    for s in range(STEPS):
        top2 = np.sort(want[s][0])[-2:]
        if top2[1] - top2[0] <= diff:
            break
        assert out[s] == toks[s], f"{key} step {s}"


def test_moe_decode_fallback_matches_fused_path(moe_slice_ref):
    """What serves a decode step when the fused kernel refuses: one pair at a
    time through the matmul kernel, reading expert l * E + e in place."""
    cfg = ModelConfig(**FIELDS)
    lay = decoder.params_from_numpy(moe_slice_ref["shared"]["arrays"], cfg, "cpu").layers
    h2 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 1, cfg.hidden_size)).astype(np.float32) * 0.1).to(torch.bfloat16)
    fused = decoder._moe_mlp_fused(cfg, h2, lay, 1)
    pairs = decoder._moe_mlp(cfg, h2, lay, 1)
    assert fused.shape == pairs.shape == (3, 1, cfg.hidden_size)
    assert rel(pairs.numpy(), fused.numpy()) <= 2e-2
    flat = lay.wgu_e.flat_experts()
    assert flat.packed.shape[0] == cfg.num_layers * cfg.num_experts
    assert flat.layer(1 * cfg.num_experts + 2).packed.data_ptr() == \
        lay.wgu_e.packed[1, 2].data_ptr()


def test_init_random_params_moe_fields():
    cfg = ModelConfig(**FIELDS)
    p = decoder.init_random_params(cfg, torch.Generator().manual_seed(0),
                                   act_bits=8, lm_head_bits=4, device="cpu")
    lay = p.layers
    assert lay.wgu is None and lay.wdown is None
    assert lay.router.shape == (2, 128, 4) and lay.router.dtype == torch.float32
    assert lay.wgu_e.packed.shape == (2, 4, 64, 128) and lay.wgu_e.act_bits == 16
    assert lay.wdown_e.packed.shape == (2, 4, 32, 128) and lay.wdown_e.block_size == 64
    assert lay.wgu_shared.packed.shape == (2, 64, 256) and lay.wgu_shared.act_bits == 8
    assert lay.shared_gate.shape == (2, 128) and not lay.shared_gate.any()
    # every layer and expert has bytes of its own
    assert not torch.equal(lay.wgu_e.packed[0, 0], lay.wgu_e.packed[1, 0])
    assert not torch.equal(lay.wgu_e.packed[0, 0], lay.wgu_e.packed[0, 1])
    q = decoder.init_random_params(cfg, torch.Generator().manual_seed(0),
                                   act_bits=8, lm_head_bits=4, device="cpu")
    assert torch.equal(q.layers.wdown_e.packed, lay.wdown_e.packed)
