"""W2 and W3 weights in the port against the JAX package, on the CPU.

The packing (`pack_int2`, `pack_int3`, `unpack_bits`) and `quantize` at 2 and
3 bits, sym and asym, quant blocks of 8, 32, 64 and 128: the packed bytes
and the bits of every bf16 scale and bias must be the JAX package's. The
plain versions of the four matmul kernels that meet W2/W3 (the M = 1 GEMV
and the bf16-row tile kernel share `dequant_matmul_plain`'s bf16 algebra;
the a8 kernel its int8 one; the dequantize-tile kernel `deq_dot_plain`)
against the JAX kernels in interpret mode, on the JAX package's own packed
weights: rel-L2 5e-3, the bound of `tests/test_w23.py:65`.

The JAX side runs once for the module, in one fresh subprocess that writes
an `.npz`: XLA:CPU's codegen has segfaulted when it first traced the W2/W3
unpack late in a long test session (`tests/test_w23.py:77-100`), so it is
never traced in the test process. The port side needs no subprocess.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mnn_tpu_torch.kernels import dequant_matmul
from mnn_tpu_torch.quant.quantize import QuantizedLinear

# the modules: each package re-exports a function named `quantize` over
# the module's name
tq = importlib.import_module("mnn_tpu_torch.quant.quantize")
jq = importlib.import_module("mnn_tpu.quant.quantize")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUANT = [(bits, bs, sym) for bits in (2, 3) for bs in (8, 32, 64, 128)
         for sym in (False, True)]
PACK = [(bits, bs) for bits in (2, 3) for bs in (8, 32, 128)]
K, N = 512, 384
# (bits, M): bf16 rows (the GEMV at M = 1, the tile kernel above)
BF16 = [(bits, m) for bits in (2, 3) for m in (1, 8, 300)]
# (bits, M): int8 rows
A8 = [(bits, m) for bits in (2, 3) for m in (8, 300)]
# (bits, M, block): the dequantize-tile algebra, blocks of 16 to 128
DEQ = [(2, 33, 128), (3, 90, 128), (2, 130, 16), (3, 7, 32)]
BOUND = 5e-3


def _jax_side(path):
    """Every JAX result of this module, into the .npz at `path`. Runs in a
    subprocess of its own (see the module docstring)."""
    import dataclasses

    import jax.numpy as jnp

    jdq = importlib.import_module("mnn_tpu.kernels.dequant_matmul")
    u16 = lambda a: np.asarray(a).view(np.uint16)
    out = {}
    weights = {}

    def matmul_weights(bits, bs):
        """The JAX package's quantization of one seeded weight matrix, kept
        for the port as bytes."""
        if (bits, bs) not in weights:
            w = np.random.default_rng(100 * bits + bs).standard_normal((K, N))
            ql = weights[bits, bs] = jq.quantize(w.astype(np.float32) * 0.05, bits=bits,
                                                 block_size=bs)
            out[f"w{bits}_{bs}_packed"] = np.asarray(ql.packed)
            out[f"w{bits}_{bs}_scale"] = u16(ql.scale)
            out[f"w{bits}_{bs}_bias"] = u16(ql.bias)
        return weights[bits, bs]

    for bits, bs, sym in QUANT:
        w = np.random.default_rng(bits * 1000 + bs * 2 + sym).standard_normal(
            (256, 48)).astype(np.float32) * 0.05
        ql = jq.quantize(w, bits=bits, block_size=bs, sym=sym)
        key = f"q{bits}_{bs}_{int(sym)}"
        out[key + "_w"] = w
        out[key + "_packed"] = np.asarray(ql.packed)
        out[key + "_scale"] = u16(ql.scale)
        out[key + "_bias"] = u16(ql.bias)
        out[key + "_deq"] = np.asarray(jq.dequantize(ql))
    for bits, bs in PACK:
        q = np.random.default_rng(bits + bs).integers(0, 1 << bits, (256, 40)).astype(np.int32)
        p = (jq.pack_int2 if bits == 2 else jq.pack_int3)(jnp.asarray(q), bs)
        out[f"p{bits}_{bs}_q"] = q
        out[f"p{bits}_{bs}_packed"] = np.asarray(p)
        out[f"p{bits}_{bs}_unpacked"] = np.asarray(jq.unpack_bits(p, bits, bs))
    rng = np.random.default_rng(5)
    for bits, m in BF16 + [(b, m) for b, m in A8]:
        x = jnp.asarray(rng.standard_normal((m, K)), jnp.bfloat16)
        out[f"x{bits}_{m}"] = np.asarray(x.astype(jnp.float32))
    for bits, m in BF16:
        ql = matmul_weights(bits, 128)
        x = jnp.asarray(out[f"x{bits}_{m}"], jnp.bfloat16)
        y = jdq.dequant_matmul(x, ql, out_dtype=jnp.float32, interpret=True)
        out[f"bf16_{bits}_{m}"] = np.asarray(y)
    for bits, m in A8:
        ql = dataclasses.replace(matmul_weights(bits, 128), act_bits=8)
        x = jnp.asarray(out[f"x{bits}_{m}"], jnp.bfloat16)
        y = jdq.dequant_matmul(x, ql, out_dtype=jnp.float32, interpret=True)
        out[f"a8_{bits}_{m}"] = np.asarray(y)
    jdq.DEQ_MIN_M = 1
    for bits, m, bs in DEQ:
        ql = matmul_weights(bits, bs)
        x = jnp.asarray(rng.standard_normal((m, K)), jnp.bfloat16)
        out[f"dx{bits}_{m}_{bs}"] = np.asarray(x.astype(jnp.float32))
        # the kernel's wrapper outside `jit`, whose cache would keep a
        # trace made before DEQ_MIN_M was set
        y = jdq._dequant_matmul_pallas(x, ql, None, out_dtype=jnp.float32, block_m=None,
                                       block_n=None, block_k=None, interpret=True)
        out[f"deq_{bits}_{m}_{bs}"] = np.asarray(y)
    np.savez(path, **out)


def run_jax_side(fn_module: str, path: str, timeout: int = 600):
    """`fn_module._jax_side(path)` in a fresh Python on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false")
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            f"import {fn_module} as m; m._jax_side({path!r})\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w23") / "jax.npz")
    run_jax_side("tests.test_torch_w23", path)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def port_ql(ref, bits, bs, act_bits=16) -> QuantizedLinear:
    """The JAX package's packed weights (bytes from the .npz) as the port's
    QuantizedLinear."""
    key = f"w{bits}_{bs}_"
    bf = lambda a: torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return QuantizedLinear(packed=torch.from_numpy(ref[key + "packed"].copy()),
                           scale=bf(ref[key + "scale"]), bias=bf(ref[key + "bias"]),
                           out_bias=None, bits=bits, block_size=bs, act_bits=act_bits)


def rel(got: torch.Tensor, want: np.ndarray) -> float:
    got = got.double().numpy()
    want = want.astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("bits,bs,sym", QUANT)
def test_quantize_matches_jax_bit_for_bit(ref, bits, bs, sym):
    key = f"q{bits}_{bs}_{int(sym)}"
    ql = tq.quantize(torch.from_numpy(ref[key + "_w"]), bits=bits, block_size=bs, sym=sym)
    assert ql.packed.dtype == torch.int8 and ql.packed.shape == (256 * bits // 8, 48)
    np.testing.assert_array_equal(ql.packed.numpy(), ref[key + "_packed"])
    np.testing.assert_array_equal(ql.scale.view(torch.int16).numpy().view(np.uint16),
                                  ref[key + "_scale"])
    np.testing.assert_array_equal(ql.bias.view(torch.int16).numpy().view(np.uint16),
                                  ref[key + "_bias"])
    np.testing.assert_array_equal(tq.dequantize(ql).numpy(), ref[key + "_deq"])


@pytest.mark.parametrize("bits,bs", PACK)
def test_pack_and_unpack_match_jax(ref, bits, bs):
    key = f"p{bits}_{bs}"
    q = torch.from_numpy(ref[key + "_q"])
    packed = (tq.pack_int2 if bits == 2 else tq.pack_int3)(q, bs)
    np.testing.assert_array_equal(packed.numpy(), ref[key + "_packed"])
    back = tq.unpack_bits(packed, bits, bs)
    np.testing.assert_array_equal(back.numpy(), ref[key + "_unpacked"])
    np.testing.assert_array_equal(back.numpy(), ref[key + "_q"])


@pytest.mark.parametrize("bits,bs", [(2, 4), (2, 12), (3, 8), (3, 24), (3, 40)])
def test_round_trip_at_small_blocks(bits, bs):
    """Blocks down to the packing's alignment (W2: 4 K values, W3: 8)."""
    q = torch.randint(0, 1 << bits, (bs * 5, 12), generator=torch.Generator().manual_seed(bs))
    packed = (tq.pack_int2 if bits == 2 else tq.pack_int3)(q, bs)
    assert packed.shape == (bs * 5 * bits // 8, 12)
    assert torch.equal(tq.unpack_bits(packed, bits, bs), q.to(torch.int32))


@pytest.mark.parametrize("bits,bs", [(2, 6), (3, 12), (3, 4), (5, 8)])
def test_refuses_what_jax_refuses(bits, bs):
    """The alignments of `quantize` ({2: 4, 3: 8, 4: 2, 8: 1}) and its bits."""
    w = np.zeros((bs * 4, 8), np.float32)
    with pytest.raises(ValueError):
        jq.quantize(w, bits=bits, block_size=bs)
    with pytest.raises(ValueError):
        tq.quantize(torch.from_numpy(w), bits=bits, block_size=bs)


@pytest.mark.parametrize("bits,m", BF16)
def test_bf16_rows_match_jax(ref, bits, m):
    """`dequant_matmul` on the CPU (the plain version of the M = 1 GEMV and of
    the bf16-row tile kernel) against JAX `dequant_matmul(interpret=True)`."""
    ql = port_ql(ref, bits, 128)
    got = dequant_matmul.dequant_matmul(torch.from_numpy(ref[f"x{bits}_{m}"]), ql,
                                        out_dtype=torch.float32)
    assert got.shape == (m, N) and torch.isfinite(got).all()
    assert rel(got, ref[f"bf16_{bits}_{m}"]) <= BOUND


@pytest.mark.parametrize("bits,m", A8)
def test_int8_rows_match_jax(ref, bits, m):
    """The a8 plain version (rows re-centred on 2^(bits-1): -2..1 at W2, -4..3
    at W3) against the JAX `_kernel_a8` with `act_bits=8`."""
    ql = port_ql(ref, bits, 128, act_bits=8)
    got = dequant_matmul.dequant_matmul(torch.from_numpy(ref[f"x{bits}_{m}"]), ql,
                                        out_dtype=torch.float32)
    assert got.shape == (m, N) and torch.isfinite(got).all()
    assert rel(got, ref[f"a8_{bits}_{m}"]) <= BOUND


@pytest.mark.parametrize("bits,m,bs", DEQ)
def test_dequantize_tile_matches_jax(ref, bits, m, bs, monkeypatch):
    """The dequantize-tile algebra joins W3's planes before it rounds
    bf16(q * s + m), as the JAX `_kernel_deq` does."""
    ql = port_ql(ref, bits, bs)
    monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", m)
    got = dequant_matmul.dequant_matmul(torch.from_numpy(ref[f"dx{bits}_{m}_{bs}"]), ql,
                                        out_dtype=torch.float32)
    assert got.shape == (m, N) and torch.isfinite(got).all()
    assert rel(got, ref[f"deq_{bits}_{m}_{bs}"]) <= BOUND


def test_kernel_checks_take_sub4_bits():
    """The wrappers' weight check takes W2 and W3 (the kernels' C entries
    take them too; `tests/test_torch_cuda.py` launches them)."""
    for bits in (2, 3):
        ql = tq.quantize(torch.randn(256, 64), bits=bits, block_size=128)
        dequant_matmul._check_weights(ql, 256)
    bad = QuantizedLinear(packed=torch.zeros((160, 64), dtype=torch.int8),
                          scale=torch.zeros((2, 64), dtype=torch.bfloat16),
                          bias=torch.zeros((2, 64), dtype=torch.bfloat16), out_bias=None,
                          bits=5, block_size=128)
    with pytest.raises(ValueError, match="W5"):
        dequant_matmul._check_weights(bad, 256)
