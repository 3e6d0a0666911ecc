"""The port's bf16-row dequant matmul at M = 1 against the JAX package.

On the card these calls take `dqmm_gemv_kernel` (`csrc/dequant_matmul.cu`),
which replaces `mnn_tpu/kernels/dequant_matmul.py::_kernel` at M = 1 (every
decode GEMV and the lm head): (128-column tile, K range) items, one a block,
the K ranges whole quant blocks that meet in a fixed order. On the CPU the
port's wrapper runs its plain version; the JAX side runs the Pallas kernel in
interpret mode, as the JAX package's own kernel tests do. The same numpy
inputs feed both. The cases sit at the split's edges: K = 4864 (38 quant
blocks, which no even count of K ranges divides), N = 132, 200, 260 and 1028
(a partial column tile), quant blocks of 8, 16, 40, 64 and 128 K-values (a
partial unit of 16 packed rows at 8 and 40), W4 and W8, f32 output with
`out_bias`, and a stacked [L, ...] weight read at `layer_index`. Tolerance:
rel-L2 1e-2, the JAX tests' bound (bf16 output rounding over f32 sums taken
in another order). The JAX side is computed once for the module: XLA:CPU
fails after a few hundred compilations in one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels.dequant_matmul import dequant_matmul as j_dqmm
from mnn_tpu.quant.quantize import QuantizedLinear as JQL
from mnn_tpu_torch.kernels import dequant_matmul
from mnn_tpu_torch.quant.quantize import QuantizedLinear

L = 2   # layers of a stacked weight; layer 1 is read
# (name, bits, K, N, block size, stacked with out_bias, out f32)
CASES = [
    ("w4-k4864", 4, 4864, 200, 128, False, False),
    ("w4-k4864-stacked-f32", 4, 4864, 132, 128, True, True),
    ("w4-n1028-stacked", 4, 256, 1028, 128, True, False),
    ("w4-bs40-stacked-f32", 4, 320, 200, 40, True, True),
    ("w4-bs8-n132", 4, 128, 132, 8, False, False),
    ("w4-bs64-k2048-f32", 4, 2048, 260, 64, False, True),
    ("w8-k2048-stacked", 8, 2048, 260, 128, True, False),
    ("w8-bs16-f32", 8, 256, 1028, 16, False, True),
    ("w8-bs40-stacked", 8, 160, 200, 40, True, False),
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


@pytest.fixture(scope="module")
def cases():
    """Inputs, and every JAX result of this module computed once."""
    rng = np.random.default_rng(11)
    out = {}
    for name, bits, k, n, bs, stacked, f32_out in CASES:
        lead = (L,) if stacked else ()
        packed = rng.integers(-128, 128, size=(*lead, k * bits // 8, n), dtype=np.int8)
        scale = jnp.asarray(rng.uniform(1e-3, 3e-3, size=(*lead, k // bs, n)), jnp.bfloat16)
        bias = jnp.asarray(-(1 << (bits - 1)) * np.asarray(scale, np.float32)
                           + rng.normal(0, 1e-3, size=scale.shape), jnp.bfloat16)
        ob = rng.normal(0, 0.1, size=(*lead, n)).astype(np.float32) if stacked else None
        x = jnp.asarray(rng.standard_normal((1, k)), jnp.bfloat16)
        ql = JQL(packed=jnp.asarray(packed), scale=scale, bias=bias,
                 out_bias=None if ob is None else jnp.asarray(ob),
                 bits=bits, block_size=bs, act_bits=16)
        want = np.asarray(j_dqmm(x, ql, layer_index=jnp.int32(1) if stacked else None,
                                 out_dtype=jnp.float32 if f32_out else jnp.bfloat16,
                                 interpret=True))
        out[name] = dict(packed=packed, scale=np.asarray(scale), bias=np.asarray(bias),
                         out_bias=ob, x=np.asarray(x), want=want)
    return out


def _ql(d, bits, bs) -> QuantizedLinear:
    ob = d["out_bias"]
    return QuantizedLinear(packed=to_torch(d["packed"]), scale=to_torch(d["scale"]),
                           bias=to_torch(d["bias"]),
                           out_bias=None if ob is None else to_torch(ob),
                           bits=bits, block_size=bs, act_bits=16)


@pytest.mark.parametrize("name,bits,k,n,bs,stacked,f32_out", CASES)
def test_gemv_matches_jax(cases, name, bits, k, n, bs, stacked, f32_out):
    d = cases[name]
    out_dtype = torch.float32 if f32_out else torch.bfloat16
    got = dequant_matmul.dequant_matmul(to_torch(d["x"]), _ql(d, bits, bs),
                                        layer_index=1 if stacked else None,
                                        out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (1, n) == d["want"].shape
    assert torch.isfinite(got).all()
    assert rel(got, d["want"]) <= 1e-2


def test_gemv_keeps_leading_axes(cases):
    """One row with leading axes, as a decode step sends it ([B = 1, T = 1,
    K]), comes back with them."""
    d = cases["w4-k4864"]
    got = dequant_matmul.dequant_matmul(to_torch(d["x"]).reshape(1, 1, -1),
                                        _ql(d, 4, 128))
    assert got.shape == (1, 1, 200)
    assert rel(got.reshape(1, 200), d["want"]) <= 1e-2
