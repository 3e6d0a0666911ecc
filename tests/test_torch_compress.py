"""The port's QAT and pruning tools (`train/compress.py`) against the JAX
package's, on the CPU.

Fake quantization must give the JAX function's values bit for bit (both
land on the inference grid with tensor divisors and the same bf16 covering
rounding), and the port's own `dequantize(quantize(w))`; straight-through
gradients must equal JAX's (their f32 arithmetic is the same); pruning
masks and the GMP schedule must be equal. Same numpy inputs for both; the
JAX side is computed once, in one module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.train import compress as jc
from mnn_tpu_torch.quant.quantize import dequantize, quantize
from mnn_tpu_torch.train import compress as tc

# (bits, sym) of the fake-quant cases; block 32 over K = 64
FQ = [(4, False), (4, True), (8, False), (8, True), (2, False)]
PRUNE = {"unstructured": jc.PruneSpec(sparsity=0.75),
         "structured": jc.PruneSpec(sparsity=0.5, structured=True),
         "blocked": jc.PruneSpec(sparsity=0.5, block=4)}


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 32)) * 0.3).astype(np.float32)
    target = (rng.standard_normal((64, 32)) * 0.3).astype(np.float32)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    out = dict(w=w, target=target, x=x, fq={}, fq_grad={})
    for bits, sym in FQ:
        jw = jnp.asarray(w)
        out["fq"][bits, sym] = np.asarray(jc.fake_quant_weight(jw, bits, 32, sym))
        # jitted: gradients are compared within a tolerance (the values,
        # compared bit for bit, come from the eager call above)
        out["fq_grad"][bits, sym] = np.asarray(jax.jit(jax.grad(lambda v: jnp.mean(
            (jc.fake_quant_weight(v, bits, 32, sym) - jnp.asarray(target)) ** 2)))(jw))
    out["act"] = np.asarray(jc.fake_quant_activation(jnp.asarray(x), 8))
    out["act_grad"] = np.asarray(jax.grad(lambda v: jnp.sum(
        jc.fake_quant_activation(v, 8) * jnp.asarray(x)))(jnp.asarray(x)))
    out["qat"] = np.asarray(jc.qat_linear(jnp.asarray(x), jnp.asarray(w), bits=4,
                                          block_size=32, act_bits=8))
    out["masks"] = {k: np.asarray(jc.prune_mask(jnp.asarray(w), spec))
                    for k, spec in PRUNE.items()}
    mask = jnp.asarray(out["masks"]["unstructured"])
    out["mask_grad"] = np.asarray(jax.grad(
        lambda v: jnp.sum(jc.apply_mask(v, mask) ** 2))(jnp.asarray(w)))
    return out


@pytest.mark.parametrize("bits,sym", FQ)
def test_fake_quant_weight_is_the_jax_grid(ref, bits, sym):
    w = torch.from_numpy(ref["w"])
    got = tc.fake_quant_weight(w, bits, 32, sym)
    np.testing.assert_array_equal(got.numpy(), ref["fq"][bits, sym])
    # the deployed weights, bit for bit
    deployed = dequantize(quantize(w, bits=bits, block_size=32, sym=sym))
    np.testing.assert_array_equal(got.numpy(), deployed.numpy())


@pytest.mark.parametrize("bits,sym", FQ)
def test_fake_quant_gradient_matches_jax(ref, bits, sym):
    w = torch.from_numpy(ref["w"]).requires_grad_(True)
    loss = ((tc.fake_quant_weight(w, bits, 32, sym) - torch.from_numpy(ref["target"])) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(w.grad.numpy(), ref["fq_grad"][bits, sym], rtol=1e-5,
                               atol=1e-9)
    assert float(w.grad.norm()) > 0


def test_ste_round_passes_the_gradient_through():
    x = torch.linspace(-2, 2, 9, requires_grad=True)
    c = torch.arange(9.0)
    (tc.ste_round(x) * c).sum().backward()
    assert torch.equal(x.grad, c)
    assert torch.equal(tc.ste_round(x.detach()), torch.round(x.detach()))


def test_fake_quant_activation_and_qat_linear_match_jax(ref):
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    got = tc.fake_quant_activation(x, 8)
    np.testing.assert_array_equal(got.detach().numpy(), ref["act"])
    (got * torch.from_numpy(ref["x"])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref["act_grad"], rtol=1e-5, atol=1e-5)
    y = tc.qat_linear(torch.from_numpy(ref["x"]), torch.from_numpy(ref["w"]), bits=4,
                      block_size=32, act_bits=8)
    np.testing.assert_allclose(y.numpy(), ref["qat"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", list(PRUNE))
def test_prune_masks_match_jax(ref, kind):
    spec = PRUNE[kind]
    got = tc.prune_mask(torch.from_numpy(ref["w"]), tc.PruneSpec(
        sparsity=spec.sparsity, structured=spec.structured, block=spec.block))
    np.testing.assert_array_equal(got.numpy(), ref["masks"][kind])
    assert tc.sparsity_of(got) == pytest.approx(jc.sparsity_of(jnp.asarray(ref["masks"][kind])))


def test_masked_gradient_matches_jax(ref):
    mask = torch.from_numpy(ref["masks"]["unstructured"])
    w = torch.from_numpy(ref["w"]).requires_grad_(True)
    (tc.apply_mask(w, mask) ** 2).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), ref["mask_grad"])
    assert (w.grad[mask == 0] == 0).all() and (w.grad[mask > 0] != 0).any()


def test_gmp_schedule_matches_jax():
    for step in range(0, 121, 3):
        for power in (1.0, 3.0):
            kw = dict(target=0.8, begin=10, end=100, power=power)
            assert tc.gmp_sparsity(step, **kw) == jc.gmp_sparsity(step, **kw)
