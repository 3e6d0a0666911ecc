"""The port's bf16-row dequant matmul at M > 1 against the JAX package.

On the card these calls take `dqmm_bf16_tile_kernel` (bf16 tensor cores),
which replaces `mnn_tpu/kernels/dequant_matmul.py::_kernel` at M > 1. On
the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as the JAX package's own kernel tests do.
The same numpy inputs feed both. The cases sit at the new kernel's edges:
M = 2, 16, 33, 64 and 130 (a partial row tile), quant blocks of 8 and 40
K-values (padded to the mma depth of 16) and 16, 64 and 128, W8, N = 200
and 1028 (ragged column tiles), f32 output with `out_bias`, and a stacked
[L, ...] weight read at `layer_index`. Tolerance: rel-L2 1e-2, the JAX
tests' bound (bf16 output rounding over f32 sums taken in another order).
The JAX side is computed once for the module: XLA:CPU fails after a few
hundred compilations in one process.
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
# (name, bits, M, K, N, block size, stacked with out_bias, out f32)
CASES = [
    ("m2-bs16-stacked", 4, 2, 256, 200, 16, True, False),
    ("m16-bs8-n1028", 4, 16, 128, 1028, 8, False, False),
    ("m33-bs40-f32-bias", 4, 33, 320, 200, 40, True, True),
    ("m64-w8-bs64-n1028", 8, 64, 256, 1028, 64, True, False),
    ("m130-bs128", 4, 130, 256, 200, 128, False, False),
    ("m130-w8-bs40-f32", 8, 130, 160, 200, 40, False, True),
    ("m33-w8-bs8-stacked", 8, 33, 64, 1028, 8, True, False),
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
    rng = np.random.default_rng(6)
    out = {}
    for name, bits, m, k, n, bs, stacked, f32_out in CASES:
        lead = (L,) if stacked else ()
        packed = rng.integers(-128, 128, size=(*lead, k * bits // 8, n), dtype=np.int8)
        scale = jnp.asarray(rng.uniform(1e-3, 3e-3, size=(*lead, k // bs, n)), jnp.bfloat16)
        bias = jnp.asarray(-(1 << (bits - 1)) * np.asarray(scale, np.float32)
                           + rng.normal(0, 1e-3, size=scale.shape), jnp.bfloat16)
        ob = rng.normal(0, 0.1, size=(*lead, n)).astype(np.float32) if stacked else None
        x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
        ql = JQL(packed=jnp.asarray(packed), scale=scale, bias=bias,
                 out_bias=None if ob is None else jnp.asarray(ob),
                 bits=bits, block_size=bs, act_bits=16)
        want = np.asarray(j_dqmm(x, ql, layer_index=jnp.int32(1) if stacked else None,
                                 out_dtype=jnp.float32 if f32_out else jnp.bfloat16,
                                 interpret=True))
        out[name] = dict(packed=packed, scale=np.asarray(scale), bias=np.asarray(bias),
                         out_bias=ob, x=np.asarray(x), want=want)
    return out


@pytest.mark.parametrize("name,bits,m,k,n,bs,stacked,f32_out", CASES)
def test_bf16_rows_gemm_matches_jax(cases, name, bits, m, k, n, bs, stacked, f32_out):
    d = cases[name]
    ob = d["out_bias"]
    ql = QuantizedLinear(packed=to_torch(d["packed"]), scale=to_torch(d["scale"]),
                         bias=to_torch(d["bias"]),
                         out_bias=None if ob is None else to_torch(ob),
                         bits=bits, block_size=bs, act_bits=16)
    out_dtype = torch.float32 if f32_out else torch.bfloat16
    got = dequant_matmul.dequant_matmul(to_torch(d["x"]), ql,
                                        layer_index=1 if stacked else None,
                                        out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n) == d["want"].shape
    assert torch.isfinite(got).all()
    assert rel(got, d["want"]) <= 1e-2


def test_bf16_rows_gemm_leading_axes_on_the_cpu():
    """Rows with leading axes are flattened and restored; CPU tensors take
    the plain version without asking the card which kernel to use (which
    would build the kernels, and raise where there is no nvcc)."""
    rng = np.random.default_rng(7)
    k, n, bs = 64, 12, 16
    ql = QuantizedLinear(
        packed=torch.from_numpy(rng.integers(-128, 128, size=(k // 2, n), dtype=np.int8)),
        scale=torch.full((k // bs, n), 2e-3).to(torch.bfloat16),
        bias=torch.full((k // bs, n), -1.6e-2).to(torch.bfloat16),
        out_bias=None, bits=4, block_size=bs, act_bits=16)
    x = torch.from_numpy(rng.standard_normal((2, 3, k)).astype(np.float32)).to(torch.bfloat16)
    got = dequant_matmul.dequant_matmul(x, ql)
    want = dequant_matmul.dequant_matmul_plain(x.reshape(6, k), ql)
    assert got.shape == (2, 3, n)
    torch.testing.assert_close(got.reshape(6, n), want, rtol=0, atol=0)
