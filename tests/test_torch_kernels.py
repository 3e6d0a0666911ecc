"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as the JAX package's own
kernel tests do. The same numpy inputs feed both. Tolerances: rel-L2 1e-2
for the dequant matmuls (bf16 output rounding over f32 sums taken in
another order), 2e-2 for flash prefill (`tests/test_attention.py:59`) and
3e-2 for decode attention over int8 KV (`tests/test_attention.py:126`);
the quantized K/V rows of the fused decode step are equal and their scales
agree to 1e-6. The flash decode kernel's plain version is held to
`decode_attention(interpret=True)` over bf16, int8 and nibble-packed int4
caches, stacked and not, at rel-L2 3e-2. The JAX side is computed once per module: XLA:CPU fails
after a few hundred compilations in one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels.decode_step import fused_decode_attention as j_decode
from mnn_tpu.kernels.dequant_matmul import dequant_matmul as j_dqmm
from mnn_tpu.kernels.flash_attention import attention_xla_ref as j_attn_ref
from mnn_tpu.kernels.flash_attention import decode_attention as j_decode_attn
from mnn_tpu.kernels.flash_attention import flash_attention as j_flash
from mnn_tpu.quant.quantize import QuantizedLinear as JQL
from mnn_tpu_torch.kernels import decode_step, dequant_matmul, flash_attention
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache

K, N, BS, L = 256, 200, 128, 2
# (name, bits, act_bits, M, stacked with out_bias, out f32)
GEMM_CASES = [
    ("w4a16-gemv", 4, 16, 1, True, False),
    ("w4a16-gemm", 4, 16, 40, True, False),
    ("w4a8-gemv", 4, 8, 1, True, False),
    ("w4a8-gemm", 4, 8, 40, True, False),
    ("w8a16-gemm", 8, 16, 40, True, False),
    ("w4-head", 4, 16, 1, False, True),
]
# int8 rows at the edges of the a8 kernel's tiles: (name, bits, M, K, N,
# block size, stacked with out_bias, out f32)
A8_CASES = [
    ("w8a8", 8, 40, 256, 200, 128, True, False),
    ("w4a8-ragged-bs32", 4, 130, 256, 1028, 32, False, False),
    ("w4a8-bs64-f32-bias", 4, 33, 256, 200, 64, True, True),
    ("w4a8-bs16", 4, 17, 128, 132, 16, True, False),
    ("w8a8-bs8-f32", 8, 9, 64, 200, 8, False, True),
    ("w4a8-deep-k", 4, 20, 576, 200, 64, False, False),
]
# (name, H, Hkv, T, S, kv_len, q_offset, window, sink)
FLASH_CASES = [
    ("group1", 2, 2, 16, 64, 40, 24, 0, 0),
    ("group2-padded", 4, 2, 24, 64, 44, 20, 0, 0),
    ("group2-window-sink", 4, 2, 16, 64, 48, 32, 8, 2),
]
# (name, G, int8 cache, qk-norm, window, sink)
DECODE_CASES = [
    ("int8", 3, True, False, 0, 0),
    ("int8-qknorm-window", 3, True, True, 16, 2),
    ("bf16", 2, False, False, 0, 0),
]
# (name, G, kv bits, stacked with layer_index, window, sink, kv_len per sequence)
FLASH_DECODE_CASES = [
    ("kv-bf16", 2, 16, False, 0, 0, (20, 137)),
    ("int8-stacked", 3, 8, True, 0, 0, (256, 1)),
    ("int4-stacked", 3, 4, True, 0, 0, (20, 137)),
    ("int4-window-sink", 7, 4, True, 16, 2, (140, 256)),
    ("int8-window", 1, 8, False, 8, 0, (133, 9)),
]


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> torch tensor; bf16 crosses through its bits."""
    a = np.array(np.asarray(a))                    # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def rel(got, want) -> float:
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _gemm_inputs(rng, bits, act_bits, m, stacked, k=K, n=N, bs=BS):
    lead = (L,) if stacked else ()
    packed = rng.integers(-128, 128, size=(*lead, k * bits // 8, n), dtype=np.int8)
    scale = jnp.asarray(rng.uniform(1e-3, 3e-3, size=(*lead, k // bs, n)),
                        jnp.bfloat16)
    bias = jnp.asarray(-7.5 * np.asarray(scale, np.float32)
                       + rng.normal(0, 1e-3, size=scale.shape), jnp.bfloat16)
    ob = (rng.normal(0, 0.1, size=(*lead, n)).astype(np.float32)
          if stacked else None)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    return dict(packed=packed, scale=np.asarray(scale), bias=np.asarray(bias),
                out_bias=ob, x=np.asarray(x), bits=bits, act_bits=act_bits)


def _flash_inputs(rng, h, hkv, t, s):
    mk = lambda *shape: np.asarray(jnp.asarray(rng.standard_normal(shape),
                                               jnp.bfloat16))
    return dict(q=mk(1, h, t, 64), k=mk(1, hkv, s, 64), v=mk(1, hkv, s, 64))


def _decode_inputs(rng, g, int8):
    b, hkv, s, d = 2, 2, 64, 32
    kf = rng.standard_normal((L, b, hkv, s, d)).astype(np.float32)
    vf = rng.standard_normal((L, b, hkv, s, d)).astype(np.float32)
    if int8:
        ks = np.abs(kf).max(-1) / 127.0
        vs = np.abs(vf).max(-1) / 127.0
        kc = np.round(kf / ks[..., None]).astype(np.int8)
        vc = np.round(vf / vs[..., None]).astype(np.int8)
    else:
        kc = np.asarray(jnp.asarray(kf, jnp.bfloat16))
        vc = np.asarray(jnp.asarray(vf, jnp.bfloat16))
        ks = vs = None
    ang = rng.uniform(0, 6.3, size=(b, d // 2)).astype(np.float32)
    return dict(
        qkv=np.asarray(jnp.asarray(rng.standard_normal((b, hkv, g + 2, d)) * 2,
                                   jnp.bfloat16)),
        kc=kc, vc=vc, ks=ks, vs=vs,
        lengths=np.array([20, 37], np.int32),
        cos=np.concatenate([np.cos(ang), np.cos(ang)], -1),
        sin=np.concatenate([np.sin(ang), np.sin(ang)], -1),
        q_norm=rng.uniform(0.5, 1.5, size=d).astype(np.float32),
        k_norm=rng.uniform(0.5, 1.5, size=d).astype(np.float32))


def _flash_decode_inputs(rng, g, bits, stacked):
    b, hkv, s, d = 2, 2, 256, 64     # two KV tiles of 128 on the JAX side
    lead = (L,) if stacked else ()
    kf = torch.from_numpy(rng.standard_normal((*lead, b, hkv, s, d)).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((*lead, b, hkv, s, d)).astype(np.float32))
    if bits == 16:
        kc, vc = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        kc, vc = (np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16)) for t in (kc, vc))
        ks = vs = None
    else:
        (kc, ks), (vc, vs) = kvcache.quantize_for(bits, kf), kvcache.quantize_for(bits, vf)
        kc, vc, ks, vs = (t.numpy() for t in (kc, vc, ks, vs))
    q = np.asarray(jnp.asarray(rng.standard_normal((b, hkv * g, d)) * 2, jnp.bfloat16))
    return dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs)


@pytest.fixture(scope="module")
def cases():
    """Inputs, and every JAX result of this module computed once."""
    rng = np.random.default_rng(0)
    out = {}
    gemms = [(name, bits, act_bits, m, K, N, BS, stacked, head)
             for name, bits, act_bits, m, stacked, head in GEMM_CASES]
    gemms += [(name, bits, 8, m, k, n, bs, stacked, f32_out)
              for name, bits, m, k, n, bs, stacked, f32_out in A8_CASES]
    for name, bits, act_bits, m, k, n, bs, stacked, head in gemms:
        d = _gemm_inputs(rng, bits, act_bits, m, stacked, k, n, bs)
        ql = JQL(packed=jnp.asarray(d["packed"]), scale=jnp.asarray(d["scale"]),
                 bias=jnp.asarray(d["bias"]),
                 out_bias=None if d["out_bias"] is None else jnp.asarray(d["out_bias"]),
                 bits=bits, block_size=bs, act_bits=act_bits)
        d["want"] = np.asarray(j_dqmm(
            jnp.asarray(d["x"]), ql, layer_index=jnp.int32(1) if stacked else None,
            out_dtype=jnp.float32 if head else jnp.bfloat16, interpret=True))
        out[name] = d
    for name, h, hkv, t, s, kv_len, q_off, window, sink in FLASH_CASES:
        d = _flash_inputs(rng, h, hkv, t, s)
        q, k, v = (jnp.asarray(d[n]) for n in "qkv")
        kw = dict(kv_len=jnp.int32(kv_len), q_offset=jnp.int32(q_off),
                  window=window, sink=sink)
        d["want"] = np.asarray(j_flash(q, k, v, block_q=16, block_kv=32,
                                       interpret=True, **kw))
        d["want_ref"] = np.asarray(j_attn_ref(q, k, v, **kw))
        out[name] = d
    for name, g, int8, qkn, window, sink in DECODE_CASES:
        d = _decode_inputs(rng, g, int8)
        opt = lambda n: None if d[n] is None else jnp.asarray(d[n])
        res = j_decode(
            jnp.asarray(d["qkv"]), jnp.asarray(d["kc"]), jnp.asarray(d["vc"]),
            opt("ks"), opt("vs"), jnp.int32(1), jnp.asarray(d["lengths"]),
            jnp.asarray(d["cos"]), jnp.asarray(d["sin"]),
            q_norm=jnp.asarray(d["q_norm"]) if qkn else None,
            k_norm=jnp.asarray(d["k_norm"]) if qkn else None,
            block_kv=32, window=window, sink=sink, interpret=True)
        d["want"] = [None if r is None else np.asarray(r) for r in res]
        out[name] = d
    for name, g, bits, stacked, window, sink, lens in FLASH_DECODE_CASES:
        d = _flash_decode_inputs(rng, g, bits, stacked)
        opt = lambda n: None if d[n] is None else jnp.asarray(d[n])
        d["want"] = np.asarray(j_decode_attn(
            jnp.asarray(d["q"]), jnp.asarray(d["kc"]), jnp.asarray(d["vc"]),
            jnp.asarray(lens, jnp.int32), k_scale=opt("ks"), v_scale=opt("vs"),
            layer_index=jnp.int32(1) if stacked else None, block_kv=128,
            window=window, sink=sink, interpret=True))
        out[name] = d
    return out


@pytest.mark.parametrize("name,bits,act_bits,m,stacked,head", GEMM_CASES)
def test_dequant_matmul(cases, name, bits, act_bits, m, stacked, head):
    d = cases[name]
    ob = d["out_bias"]
    ql = QuantizedLinear(packed=to_torch(d["packed"]), scale=to_torch(d["scale"]),
                         bias=to_torch(d["bias"]),
                         out_bias=None if ob is None else to_torch(ob),
                         bits=bits, block_size=BS, act_bits=act_bits)
    got = dequant_matmul.dequant_matmul(
        to_torch(d["x"]), ql, layer_index=1 if stacked else None,
        out_dtype=torch.float32 if head else torch.bfloat16)
    assert got.dtype == (torch.float32 if head else torch.bfloat16)
    assert got.shape == d["want"].shape
    assert rel(got, d["want"]) <= 1e-2


@pytest.mark.parametrize("name,bits,m,k,n,bs,stacked,f32_out", A8_CASES)
def test_dequant_matmul_a8_edges(cases, name, bits, m, k, n, bs, stacked, f32_out):
    """W8A8, ragged M and N, block sizes 8 to 128, f32 output with out_bias,
    K of nine quant blocks: the a8 path against `_kernel_a8` in interpret mode."""
    d = cases[name]
    ob = d["out_bias"]
    ql = QuantizedLinear(packed=to_torch(d["packed"]), scale=to_torch(d["scale"]),
                         bias=to_torch(d["bias"]),
                         out_bias=None if ob is None else to_torch(ob),
                         bits=bits, block_size=bs, act_bits=8)
    out_dtype = torch.float32 if f32_out else torch.bfloat16
    got = dequant_matmul.dequant_matmul(to_torch(d["x"]), ql,
                                        layer_index=1 if stacked else None,
                                        out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n) == d["want"].shape
    assert rel(got, d["want"]) <= 1e-2


@pytest.mark.parametrize("name,h,hkv,t,s,kv_len,q_off,window,sink", FLASH_CASES)
def test_flash_attention(cases, name, h, hkv, t, s, kv_len, q_off, window, sink):
    d = cases[name]
    q, k, v = (to_torch(d[n]) for n in "qkv")
    kw = dict(kv_len=torch.tensor(kv_len, dtype=torch.int32),
              q_offset=torch.tensor(q_off, dtype=torch.int32),
              window=window, sink=sink)
    got = flash_attention.flash_attention(q, k, v, **kw)
    assert got.shape == (1, h, t, 64) and got.dtype == torch.bfloat16
    assert rel(got, d["want"]) <= 2e-2
    assert rel(flash_attention.attention_ref(q, k, v, **kw), d["want_ref"]) <= 1e-2


@pytest.mark.parametrize("name,g,int8,qkn,window,sink", DECODE_CASES)
def test_fused_decode_attention(cases, name, g, int8, qkn, window, sink):
    d = cases[name]
    opt = lambda n: None if d[n] is None else to_torch(d[n])
    att, k_row, v_row, k_sc, v_sc = decode_step.fused_decode_attention(
        to_torch(d["qkv"]), to_torch(d["kc"]), to_torch(d["vc"]), opt("ks"),
        opt("vs"), 1, to_torch(d["lengths"]), to_torch(d["cos"]),
        to_torch(d["sin"]), q_norm=opt("q_norm") if qkn else None,
        k_norm=opt("k_norm") if qkn else None, window=window, sink=sink)
    w_att, w_k, w_v, w_ks, w_vs = d["want"]
    assert att.shape == w_att.shape
    assert rel(att, w_att) <= 3e-2
    np.testing.assert_array_equal(f32(k_row), w_k)
    np.testing.assert_array_equal(f32(v_row), w_v)
    if int8:
        np.testing.assert_allclose(f32(k_sc), w_ks, rtol=1e-6)
        np.testing.assert_allclose(f32(v_sc), w_vs, rtol=1e-6)
    else:
        assert k_sc is None and w_ks is None


@pytest.mark.parametrize("name,g,bits,stacked,window,sink,lens", FLASH_DECODE_CASES)
def test_decode_attention(cases, name, g, bits, stacked, window, sink, lens):
    d = cases[name]
    opt = lambda n: None if d[n] is None else to_torch(d[n])
    got = flash_attention.decode_attention(
        to_torch(d["q"]), to_torch(d["kc"]), to_torch(d["vc"]),
        torch.tensor(lens, dtype=torch.int32), k_scale=opt("ks"), v_scale=opt("vs"),
        layer_index=1 if stacked else None, window=window, sink=sink)
    assert got.shape == d["want"].shape and got.dtype == torch.bfloat16
    assert rel(got, d["want"]) <= 3e-2


def test_decode_attention_edges():
    """An empty sequence gives zeros (the kernel's l == 0 -> 1), and a
    quantized cache without scales is refused."""
    q = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    k = torch.randn((1, 2, 16, 64), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    out = flash_attention.decode_attention(q, k, k, torch.tensor([0], dtype=torch.int32))
    assert out.shape == (1, 2, 64) and not out.any()
    one = flash_attention.decode_attention(q, k, k, 1)       # only position 0 visible
    np.testing.assert_array_equal(f32(one), f32(k[:, :, 0]))
    with pytest.raises(ValueError, match="k_scale"):
        flash_attention.decode_attention(q, k.to(torch.int8), k.to(torch.int8), 4)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The device of the tensors picks the path: a CPU tensor runs the plain
    version, a CUDA tensor the kernel (here, with no card, the attempt must
    raise rather than fall back)."""
    from mnn_tpu_torch.kernels import common

    assert common.use_kernel(torch.zeros(1)) is False
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError):
        common.use_kernel(meta)
    with pytest.raises(ValueError):
        common.use_kernel(torch.zeros(1), meta)
