"""The port's quant format against the JAX package, bit for bit, on the CPU.

The same numpy inputs go through `mnn_tpu.quant.quantize` and
`mnn_tpu_torch.quant.quantize` (and the int8 and int4 KV quantizers and the
decode-row cache writes of both `runtime/kvcache.py`). Packing, quantization and the bf16 bits of scales
and biases must be identical; the dequantize-then-matmul reference agrees
to f32 summation order. The JAX side is computed once per module.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.runtime import kvcache as tkv

# the modules: each package re-exports a function named `quantize` over
# the module's name
tq = importlib.import_module("mnn_tpu_torch.quant.quantize")
jq = importlib.import_module("mnn_tpu.quant.quantize")

BS = 128
QUANT_CASES = [(4, False), (4, True), (8, False), (8, True)]   # (bits, sym)
APPEND_BITS = [4, 8, 16]
APPEND_AT = [5, 11]       # per-sequence write offsets; 11 clamps to the last slot


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> torch tensor; bf16 crosses through its bits."""
    a = np.array(np.asarray(a))                    # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def bits_of(t) -> np.ndarray:
    """The raw bits of a torch or JAX array, for bit-exact comparison."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(
        q4=rng.integers(0, 16, size=(256, 40)).astype(np.int32),
        w=(rng.standard_normal((256, 72)) * 0.05).astype(np.float32),
        x=rng.standard_normal((40, 256)).astype(np.float32),
        kv=(rng.standard_normal((2, 2, 7, 32)) * 3).astype(np.float32),
    )


@pytest.fixture(scope="module")
def ref(data):
    """Every JAX result of this module, computed once."""
    out = {}
    packed = jq.pack_int4(jnp.asarray(data["q4"]), BS)
    out["pack4"] = np.asarray(packed)
    out["unpack4"] = np.asarray(jq.unpack_int4(packed, BS))
    x_bf = jnp.asarray(data["x"]).astype(jnp.bfloat16)
    out["x_bf"] = np.asarray(x_bf)
    for bits, sym in QUANT_CASES:
        ql = jq.quantize(jnp.asarray(data["w"]), bits=bits, block_size=BS, sym=sym)
        out[("q", bits, sym)] = dict(
            packed=np.asarray(ql.packed), scale=np.asarray(ql.scale),
            bias=np.asarray(ql.bias),
            unpack=np.asarray(jq.unpack_bits(ql.packed, bits, BS)),
            deq=np.asarray(jq.dequantize(ql)),
            mm=np.asarray(jq.matmul_dequant_ref(x_bf, ql, dtype=jnp.float32)))
    xq, xs = jq.quantize_activations_int8(x_bf)
    out["act8"] = (np.asarray(xq), np.asarray(xs))
    kq, ks = jkv.quantize_kv(jnp.asarray(data["kv"]))
    out["kv8"] = (np.asarray(kq), np.asarray(ks))
    out["dq8"] = np.asarray(jkv.dequant_kv(kq, ks, 8))
    k4, s4 = jkv.quantize_kv4(jnp.asarray(data["kv"]))
    out["kv4"] = (np.asarray(k4), np.asarray(s4))
    out["unpack4kv"] = np.asarray(jkv.unpack_kv4(k4))
    out["dq4"] = np.asarray(jkv.dequant_kv(k4, s4, 4))
    # decode-row writes into a stacked cache [L=2, B=2, Hkv=2, S=8, D=32]
    new = (jnp.asarray(data["kv"][:, :, :1]).astype(jnp.bfloat16),
           jnp.asarray(data["kv"][:, :, 1:2]).astype(jnp.bfloat16))
    for bits in APPEND_BITS:
        cache = jkv.create(2, 2, 2, 8, 32, quantized=bits < 16, kv_bits=bits)
        cache = jkv.append_stacked(cache, 1, jnp.asarray(data["kv"][:, :, 2:5]).astype(
            jnp.bfloat16), jnp.asarray(data["kv"][:, :, 3:6]).astype(jnp.bfloat16),
            jnp.int32(2))
        cache = jkv.append_decode_stacked(cache, 1, *new, jnp.asarray(APPEND_AT, jnp.int32))
        out[("append", bits)] = {k: None if getattr(cache, k) is None
                                 else np.asarray(getattr(cache, k))
                                 for k in ("k", "v", "k_scale", "v_scale")}
    return out


def test_pack_int4_bit_exact(data, ref):
    q = torch.from_numpy(data["q4"])
    packed = tq.pack_int4(q, BS)
    np.testing.assert_array_equal(bits_of(packed), ref["pack4"])
    np.testing.assert_array_equal(tq.unpack_int4(packed, BS).numpy(), ref["unpack4"])
    np.testing.assert_array_equal(tq.unpack_int4(packed, BS).numpy(), data["q4"])


@pytest.mark.parametrize("bits,sym", QUANT_CASES)
def test_quantize_bit_exact(data, ref, bits, sym):
    want = ref[("q", bits, sym)]
    ql = tq.quantize(data["w"], bits=bits, block_size=BS, sym=sym)
    np.testing.assert_array_equal(bits_of(ql.packed), want["packed"])
    np.testing.assert_array_equal(bits_of(ql.scale), bits_of(want["scale"]))
    np.testing.assert_array_equal(bits_of(ql.bias), bits_of(want["bias"]))
    np.testing.assert_array_equal(
        tq.unpack_bits(ql.packed, bits, BS).numpy(), want["unpack"])
    np.testing.assert_array_equal(tq.dequantize(ql).numpy(), want["deq"])


@pytest.mark.parametrize("bits,sym", QUANT_CASES)
def test_matmul_dequant_ref(data, ref, bits, sym):
    """Carried across from JAX's bytes: f32 sums in another order only."""
    want = ref[("q", bits, sym)]
    ql = tq.QuantizedLinear(packed=to_torch(want["packed"]), scale=to_torch(want["scale"]),
                            bias=to_torch(want["bias"]), out_bias=None, bits=bits,
                            block_size=BS)
    got = tq.matmul_dequant_ref(to_torch(ref["x_bf"]), ql, dtype=torch.float32)
    assert _rel(got.numpy(), want["mm"]) < 1e-5


def test_quantize_activations_int8_bit_exact(ref):
    xq, xs = tq.quantize_activations_int8(to_torch(ref["x_bf"]))
    np.testing.assert_array_equal(xq.numpy(), ref["act8"][0])
    np.testing.assert_array_equal(xs.numpy(), ref["act8"][1])


def test_quantize_kv_bit_exact(data, ref):
    kq, ks = tkv.quantize_kv(torch.from_numpy(data["kv"]))
    np.testing.assert_array_equal(kq.numpy(), ref["kv8"][0])
    np.testing.assert_array_equal(ks.numpy(), ref["kv8"][1])
    dq = tkv.dequant_kv(kq, ks, 8)
    np.testing.assert_array_equal(bits_of(dq), bits_of(ref["dq8"]))


def test_quantize_kv4_bit_exact(data, ref):
    k4, s4 = tkv.quantize_kv4(torch.from_numpy(data["kv"]))
    assert k4.dtype == torch.int8 and k4.shape[-1] == data["kv"].shape[-1] // 2
    np.testing.assert_array_equal(k4.numpy(), ref["kv4"][0])
    np.testing.assert_array_equal(s4.numpy(), ref["kv4"][1])
    np.testing.assert_array_equal(tkv.unpack_kv4(k4).numpy(), ref["unpack4kv"])
    np.testing.assert_array_equal(bits_of(tkv.dequant_kv(k4, s4, 4)), bits_of(ref["dq4"]))
    levels = tkv.unpack_kv4(k4)
    assert levels.min() >= -8 and levels.max() <= 7


@pytest.mark.parametrize("bits", APPEND_BITS)
def test_cache_appends_bit_exact(data, ref, bits):
    """`append_stacked` (prefill rows) and `append_decode_stacked` (one row
    per sequence at its own clamped offset) leave the same bytes and scales
    as the JAX package, for int4, int8 and bf16 storage."""
    kv = torch.from_numpy(data["kv"]).to(torch.bfloat16)
    cache = tkv.create(2, 2, 2, 8, 32, quantized=bits < 16, kv_bits=bits)
    assert cache.bits == bits and cache.k.shape[-1] == (16 if bits == 4 else 32)
    tkv.append_stacked(cache, 1, kv[:, :, 2:5], kv[:, :, 3:6],
                       torch.tensor(2, dtype=torch.int32))
    tkv.append_decode_stacked(cache, 1, kv[:, :, :1], kv[:, :, 1:2],
                              torch.tensor(APPEND_AT, dtype=torch.int32))
    want = ref[("append", bits)]
    np.testing.assert_array_equal(bits_of(cache.k), bits_of(want["k"]))
    np.testing.assert_array_equal(bits_of(cache.v), bits_of(want["v"]))
    if bits < 16:
        np.testing.assert_array_equal(cache.k_scale.numpy(), want["k_scale"])
        np.testing.assert_array_equal(cache.v_scale.numpy(), want["v_scale"])
    else:
        assert cache.k_scale is None and want["k_scale"] is None


def test_create_refuses_unported_kv_bits():
    """kv_bits 3 is the TQ3 codebook cache; other widths stay refused, by
    the cache and by the dequantizer."""
    for bits in (2, 5):
        with pytest.raises(ValueError, match=f"kv_bits={bits}"):
            tkv.create(1, 1, 1, 8, 32, kv_bits=bits)
    with pytest.raises(ValueError, match="kv bits 2"):
        tkv.dequant_kv(torch.zeros((1, 12), dtype=torch.int8), torch.ones(1), 2)
    assert tkv.create(1, 1, 1, 8, 32, kv_bits=3).k.shape[-1] == 12


@pytest.mark.parametrize("k,req,shards", [(896, 128, 1), (4864, 128, 1),
                                          (4864, 128, 4), (100, 128, 1)])
def test_choose_block_size(k, req, shards):
    assert tq.choose_block_size(k, req, shards) == jq.choose_block_size(k, req, shards)
