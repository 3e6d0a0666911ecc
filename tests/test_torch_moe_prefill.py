"""The grouped expert prefill MLP and the dequantize-tile matmul against the
JAX package, on the CPU, at the edges of the kernels' tiles.

On the card both calls run the tile body of `csrc/deq_dot.cuh`:
`moe_prefill_{gu,down}_kernel` (replacing `mnn_tpu/kernels/moe_prefill.py::
_kernel`) in slabs of 80, 64, 32 or 16 rows and 128-column tiles, and
`dqmm_deq_kernel` (replacing `mnn_tpu/kernels/dequant_matmul.py::_kernel_deq`)
in the bf16 tile kernel's tiles. On the CPU the port's wrappers run their
plain versions; the JAX side runs its Pallas kernels in interpret mode, as
the JAX package's own kernel tests do. The same numpy inputs, made from a
seed, feed both.

Grouped MLP cases: capacities C = 1, 8, 17, 72, 80 and 81 on the partial-
product side (C below both quant blocks) and 128 and 144 on the dequantize
side, W4 and W8, quant blocks of 32, 64 and 128, a ragged last 128-column
tile of H (192, 320), mi = 64 x an odd number (192, 320), and empty slots
(zero rows, weight 0), which must come out exactly zero. Tolerance rel-L2
2e-2, the JAX tests' bound (`tests/test_moe_decode.py`). Dequantize-tile
cases: M off every row tile (7, 33, 90, 130) and N % 4 != 0, f32 and bf16
output, with and without `out_bias`; rel-L2 1e-2. Every JAX result is
computed once for the module: XLA:CPU fails after a few hundred
compilations in one process.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels import moe_prefill as jmoe_prefill
from mnn_tpu.quant.quantize import QuantizedLinear as JQL
from mnn_tpu_torch.kernels import dequant_matmul, moe_prefill
from mnn_tpu_torch.quant.quantize import QuantizedLinear

# the module: the package re-exports the function under the same name
jdq = importlib.import_module("mnn_tpu.kernels.dequant_matmul")

# (name, bits, E, C, H, mi, block of gate/up, block of down)
MOE_CASES = [
    ("c1", 4, 2, 1, 256, 128, 128, 128),
    ("c8-mi192", 4, 3, 8, 256, 192, 128, 64),
    ("c17-w8-h192-mi192", 8, 2, 17, 192, 192, 64, 64),
    ("c72", 4, 2, 72, 256, 128, 128, 128),
    ("c80-w8", 8, 2, 80, 384, 128, 128, 128),
    ("c81", 4, 2, 81, 256, 256, 128, 128),
    ("c128-deq-h320-bs32", 4, 2, 128, 320, 192, 32, 64),
    ("c144-deq-w8", 8, 2, 144, 256, 128, 128, 128),
    ("c144-deq-h192-mi320", 4, 2, 144, 192, 320, 64, 32),
]
# (name, bits, M, K, N, block, out_bias, out f32)
DEQ_CASES = [
    ("m7-n130-bias", 4, 7, 256, 130, 128, True, False),
    ("m33-w8-n202-f32", 8, 33, 384, 202, 64, False, True),
    ("m90-n1030-bs32-bias-f32", 4, 90, 256, 1030, 32, True, True),
    ("m130-w8-n66-bs16", 8, 130, 128, 66, 16, False, False),
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


def port_ql(d, bits, bs, out_bias=None) -> QuantizedLinear:
    return QuantizedLinear(packed=to_torch(d[0]), scale=to_torch(d[1]), bias=to_torch(d[2]),
                           out_bias=None if out_bias is None else to_torch(out_bias),
                           bits=bits, block_size=bs, act_bits=16)


@pytest.fixture(scope="module")
def ref():
    """Inputs, and every JAX result of this module computed once."""
    rng = np.random.default_rng(19)
    out = {}
    for name, bits, e, cap, h, mi, bs_h, bs_mi in MOE_CASES:
        gu = weights(rng, (e,), h, 2 * mi, bits, bs_h)
        dn = weights(rng, (e,), mi, h, bits, bs_mi)
        xe = jnp.asarray(rng.standard_normal((e, cap, h)) * 0.5, jnp.bfloat16)
        w_e = rng.uniform(0.1, 0.9, size=(e, cap)).astype(np.float32)
        empty = min(3, cap // 4)
        xe = xe.at[:, cap - empty:].set(0)          # empty slots: zero rows, weight 0
        w_e[:, cap - empty:] = 0
        jql = lambda d, bs: JQL(packed=jnp.asarray(d[0]), scale=d[1], bias=d[2],
                                out_bias=None, bits=bits, block_size=bs)
        y = jmoe_prefill.moe_prefill_mlp(xe, jnp.asarray(w_e), jql(gu, bs_h), jql(dn, bs_mi),
                                         interpret=True)
        out[name] = dict(gu=gu, dn=dn, xe=np.asarray(xe), w_e=w_e, empty=empty,
                         want=np.asarray(y, np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdq, "DEQ_MIN_M", 1)
        for name, bits, m, k, n, bs, with_bias, f32_out in DEQ_CASES:
            w = weights(rng, (), k, n, bits, bs)
            ob = rng.normal(0, 0.1, size=n).astype(np.float32) if with_bias else None
            x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
            ql = JQL(packed=jnp.asarray(w[0]), scale=w[1], bias=w[2],
                     out_bias=None if ob is None else jnp.asarray(ob),
                     bits=bits, block_size=bs, act_bits=16)
            # the kernel's wrapper outside `jit`, which would keep a trace
            # made before the switch was set
            y = jdq._dequant_matmul_pallas(
                x, ql, None, out_dtype=jnp.float32 if f32_out else jnp.bfloat16,
                block_m=None, block_n=None, block_k=None, interpret=True)
            out[name] = dict(w=w, out_bias=ob, x=np.asarray(x),
                             want=np.asarray(y.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("name,bits,e,cap,h,mi,bs_h,bs_mi", MOE_CASES)
def test_moe_prefill_matches_jax(ref, name, bits, e, cap, h, mi, bs_h, bs_mi):
    d = ref[name]
    gu, dn = port_ql(d["gu"], bits, bs_h), port_ql(d["dn"], bits, bs_mi)
    assert moe_prefill.supports(gu, dn, h, cap)
    xe, w_e = to_torch(d["xe"]), to_torch(d["w_e"])
    got = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
    assert got.shape == (e, cap, h) == d["want"].shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert rel(got, d["want"]) <= 2e-2
    empty = d["empty"]
    assert (got[:, cap - empty:] == 0).all() and (d["want"][:, cap - empty:] == 0).all()


@pytest.mark.parametrize("name,bits,m,k,n,bs,with_bias,f32_out", DEQ_CASES)
def test_dequant_matmul_deq_matches_jax(ref, name, bits, m, k, n, bs, with_bias, f32_out,
                                        monkeypatch):
    d = ref[name]
    ql = port_ql(d["w"], bits, bs, d["out_bias"])
    monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", m)
    out_dtype = torch.float32 if f32_out else torch.bfloat16
    got = dequant_matmul.dequant_matmul(to_torch(d["x"]), ql, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n) == d["want"].shape
    assert torch.isfinite(got).all()
    assert rel(got, d["want"]) <= 1e-2
