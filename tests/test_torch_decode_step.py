"""The port's fused decode step against the JAX package, at the edges of the
split kernel's design.

On the card these calls take `decode_step_kernel` (`csrc/decode_step.cu`),
which replaces `mnn_tpu/kernels/decode_step.py::_kernel`: a cluster of
blocks per (batch row, KV head) splits the visible positions into ranges of
64-position tiles and merges the ranges' softmax states in a fixed order.
On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as the JAX package's own kernel tests do.
The same numpy inputs feed both: len_old 0 (only the new token), len_old at
the capacity, batch 2 with one empty and one full sequence, one query head
at head_dim 128 over a narrow cache (the mixture-of-experts shape), eight
query heads, a score softcap, a window whose sink straddles a tile, and a
bf16 cache. Tolerances as in `tests/test_torch_kernels.py`: rel-L2 3e-2 on
the attention rows (`tests/test_attention.py:126`), the quantized K/V rows
equal, the scales within 1e-6. The JAX side is computed once for the
module: XLA:CPU fails after a few hundred compilations in one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels.decode_step import fused_decode_attention as j_decode
from mnn_tpu_torch.kernels import decode_step

L, LAYER = 2, 1
# (name, B, Hkv, G, D, S, lengths, int8 cache, qk-norm, window, sink, softcap)
CASES = [
    ("len0", 2, 2, 7, 64, 128, (0, 0), True, False, 0, 0, 0.0),
    ("len-capacity", 2, 2, 7, 64, 128, (127, 128), True, True, 0, 0, 0.0),
    ("ragged-empty-full", 2, 2, 3, 64, 128, (0, 128), True, False, 0, 0, 0.0),
    ("moe-g1-d128", 1, 4, 1, 128, 64, (50,), True, False, 0, 0, 0.0),
    ("g8-d32", 2, 1, 8, 32, 128, (100, 33), True, True, 0, 0, 0.0),
    ("softcap", 2, 2, 4, 64, 128, (90, 17), True, False, 0, 0, 5.0),
    ("window-sink-straddles", 1, 2, 4, 64, 256, (200,), True, False, 100, 70, 0.0),
    ("bf16", 2, 2, 2, 64, 128, (60, 127), False, True, 0, 0, 0.0),
]


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> torch tensor; bf16 crosses through its bits."""
    a = np.array(np.asarray(a))                    # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def rel(got: torch.Tensor, want: np.ndarray) -> float:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _inputs(rng, b, hkv, g, d, s, int8):
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
        cos=np.concatenate([np.cos(ang), np.cos(ang)], -1),
        sin=np.concatenate([np.sin(ang), np.sin(ang)], -1),
        q_norm=rng.uniform(0.5, 1.5, size=d).astype(np.float32),
        k_norm=rng.uniform(0.5, 1.5, size=d).astype(np.float32))


@pytest.fixture(scope="module")
def cases():
    """Inputs, and every JAX result of this module computed once."""
    rng = np.random.default_rng(8)
    out = {}
    for name, b, hkv, g, d, s, lengths, int8, qkn, window, sink, softcap in CASES:
        c = _inputs(rng, b, hkv, g, d, s, int8)
        opt = lambda n: None if c[n] is None else jnp.asarray(c[n])
        res = j_decode(
            jnp.asarray(c["qkv"]), jnp.asarray(c["kc"]), jnp.asarray(c["vc"]),
            opt("ks"), opt("vs"), jnp.int32(LAYER), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(c["cos"]), jnp.asarray(c["sin"]),
            q_norm=opt("q_norm") if qkn else None, k_norm=opt("k_norm") if qkn else None,
            block_kv=64, window=window, sink=sink, softcap=softcap, interpret=True)
        c["want"] = [None if r is None else np.asarray(r) for r in res]
        out[name] = c
    return out


@pytest.mark.parametrize("name,b,hkv,g,d,s,lengths,int8,qkn,window,sink,softcap", CASES)
def test_decode_step_matches_jax(cases, name, b, hkv, g, d, s, lengths, int8, qkn, window,
                                 sink, softcap):
    c = cases[name]
    opt = lambda n: None if c[n] is None else to_torch(c[n])
    att, k_row, v_row, k_sc, v_sc = decode_step.fused_decode_attention(
        to_torch(c["qkv"]), to_torch(c["kc"]), to_torch(c["vc"]), opt("ks"), opt("vs"),
        LAYER, torch.tensor(lengths, dtype=torch.int32), to_torch(c["cos"]),
        to_torch(c["sin"]), q_norm=opt("q_norm") if qkn else None,
        k_norm=opt("k_norm") if qkn else None, window=window, sink=sink, softcap=softcap)
    w_att, w_k, w_v, w_ks, w_vs = c["want"]
    assert att.shape == (b, hkv * g, d) == w_att.shape and att.dtype == torch.bfloat16
    assert torch.isfinite(att).all()
    assert rel(att, w_att) <= 3e-2
    np.testing.assert_array_equal(k_row.float().numpy(), w_k)
    np.testing.assert_array_equal(v_row.float().numpy(), w_v)
    if int8:
        np.testing.assert_allclose(k_sc.numpy(), w_ks, rtol=1e-6)
        np.testing.assert_allclose(v_sc.numpy(), w_vs, rtol=1e-6)
    else:
        assert k_sc is None and w_ks is None
