"""The port's flash decode against the JAX package, at the edges of the split
kernel's design.

On the card these calls take `flash_decode_kernel` (`csrc/flash_decode.cu`),
which replaces `mnn_tpu/kernels/flash_attention.py::_decode_kernel`: P blocks
a KV head split the visible positions into ranges of 64-position tiles, and
the last block to arrive merges the ranges' softmax states in a fixed order.
On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode (`decode_attention(interpret=True)`, 128
positions a block), as the JAX package's own kernel tests do. The same numpy
inputs feed both. Each configuration is one ragged batch of ten sequences
over a stacked cache of capacity 256 (layer 1 read in place), each sequence
its own case: lengths 0 (zeros out), 1, either side of the card's
64-position tile (63, 64, 65) and of the JAX side's block (127, 128, 129),
255 and the capacity. Configurations:
qwen2-0.5b's heads (D = 64, G = 7) and qwen1.5-moe-a2.7b's (D = 128, G = 1)
at int8 and nibble-packed int4, a window with a sink inside it and one
past the window's start, and a batch of two. Tolerance: rel-L2 3e-2
(`tests/test_attention.py:126`). The JAX side is computed once for the
module: XLA:CPU fails after a few hundred compilations in one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels.flash_attention import decode_attention as j_decode_attn
from mnn_tpu_torch.kernels import flash_attention
from mnn_tpu_torch.runtime import kvcache

L, LAYER, S = 2, 1, 256
LENGTHS = (0, 1, 63, 64, 65, 127, 128, 129, 255, 256)
# (name, Hkv, G, D, kv bits, window, sink, kv_len per sequence)
CONFIGS = [
    ("d64-g7-int8", 2, 7, 64, 8, 0, 0, LENGTHS),
    ("d64-g7-int4", 2, 7, 64, 4, 0, 0, LENGTHS),
    ("d128-g1-int8", 4, 1, 128, 8, 0, 0, LENGTHS),
    ("d128-g1-int4", 4, 1, 128, 4, 0, 0, LENGTHS),
    ("d64-g7-int4-window-sink", 2, 7, 64, 4, 100, 4, LENGTHS),
    ("d128-g1-int8-sink-past-window", 4, 1, 128, 8, 64, 70, LENGTHS),
    ("d64-g7-int8-batch2", 2, 7, 64, 8, 0, 0, (37, 250)),
]
CASES = [(name, i) for name, *_, lens in CONFIGS for i in range(len(lens))]


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


@pytest.fixture(scope="module")
def configs():
    """Inputs, and the JAX result of every configuration computed once."""
    rng = np.random.default_rng(10)
    out = {}
    for name, hkv, g, d, bits, window, sink, lens in CONFIGS:
        b = len(lens)
        kf = torch.from_numpy(rng.standard_normal((L, b, hkv, S, d)).astype(np.float32))
        vf = torch.from_numpy(rng.standard_normal((L, b, hkv, S, d)).astype(np.float32))
        (kc, ks), (vc, vs) = kvcache.quantize_for(bits, kf), kvcache.quantize_for(bits, vf)
        c = dict(kc=kc.numpy(), vc=vc.numpy(), ks=ks.numpy(), vs=vs.numpy(),
                 q=np.asarray(jnp.asarray(rng.standard_normal((b, hkv * g, d)) * 2,
                                          jnp.bfloat16)))
        c["want"] = np.asarray(j_decode_attn(
            jnp.asarray(c["q"]), jnp.asarray(c["kc"]), jnp.asarray(c["vc"]),
            jnp.asarray(lens, jnp.int32), k_scale=jnp.asarray(c["ks"]),
            v_scale=jnp.asarray(c["vs"]), layer_index=jnp.int32(LAYER), block_kv=128,
            window=window, sink=sink, interpret=True))
        out[name] = c
    return out


@pytest.mark.parametrize("name,row", CASES)
def test_flash_decode_matches_jax(configs, name, row):
    _, hkv, g, d, bits, window, sink, lens = next(c for c in CONFIGS if c[0] == name)
    c = configs[name]
    got = flash_attention.decode_attention(
        to_torch(c["q"]), to_torch(c["kc"]), to_torch(c["vc"]),
        torch.tensor(lens, dtype=torch.int32), k_scale=to_torch(c["ks"]),
        v_scale=to_torch(c["vs"]), layer_index=LAYER, window=window, sink=sink)
    assert got.shape == (len(lens), hkv * g, d) == c["want"].shape
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    if lens[row] == 0:                  # an empty sequence: l == 0 -> 1, zeros
        assert not got[row].any() and not c["want"][row].astype(np.float32).any()
    else:
        assert rel(got[row], c["want"][row]) <= 3e-2
