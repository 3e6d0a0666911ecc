"""The port's training slice against the JAX package, on the CPU.

The `tiny` preset with W4 block-64 weights and an int4 head, from the JAX
package's `init_random_params(fast=True)` (random codes; norms and the qkv
bias made random), crosses to the port through `params_from_numpy`; adapters of rank
4 on all four projections are made with numpy and handed to both: a ~
N(0, 1/r), b zero or ~ N(0, 0.01^2), so that the adapters' delta is of the
frozen projection's size, as early in a fine-tuning. (With b ~ N(0,
0.05^2) the delta is six times the projection's and the attention scores
have a spread of about 5: there the JAX package's own two paths, its
trainer's XLA reference and its kernels in interpret mode, differ by 2 %
in the logits, and the two packages' adapter gradients by 4 to 7 %.) The JAX
side runs its trainer's path (`interpret=False`: the XLA reference of every
projection, differentiated by autodiff, and XLA attention); the port runs
the plain versions of its kernels inside `DequantMatmulFn` and the eager
attention. Bounds: logits rel-L2 2e-2 (the JAX reference rounds each
dequantized weight to bf16, the port's kernels never do: 0.8 to 1.1 %
apart here, as the JAX package's reference and its own kernels are); the
loss rel 1e-2 and each
adapter gradient rel-L2 5e-2 (the JAX package computes dx by autodiff
through its reference, the port by the JAX VJP, which rounds g to bf16
first); three optimizer steps, adapters rel-L2 5e-2; the VJP's dx against
`jax.vjp` of the JAX `dequant_matmul` in interpret mode (its custom VJP)
rel-L2 1e-2. `merge_lora` must give the JAX bytes except where the f32
product a @ b, summed in another order, puts a weight on the other side of
a rounding tie: at most 1 % of the codes and scale entries may differ
(none does with these inputs). The JAX
side of each comparison is computed once, in one module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels.dequant_matmul import dequant_matmul as jdequant_matmul
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.train import datasets as jdatasets
from mnn_tpu.train import lm_loss as jlm_loss
from mnn_tpu.train import make_lora_train_step as jmake_step
from mnn_tpu.train import make_optimizer as jmake_opt
from mnn_tpu.train import merge_lora as jmerge
from mnn_tpu_torch.kernels import dequant_matmul as dqmm
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.train import (datasets, init_lora, lm_loss, make_lora_train_step,
                                 make_optimizer, merge_lora)
from tests.test_torch_decoder import numpy_fields, rel

CFG = "tiny"
RANK = 4
B, T = 2, 16
# (optimizer, schedule): every optimizer and every schedule once
OPTS = [("sgd", None), ("adam", "cosine"), ("adamw", "exponential")]
# three steps of the whole train step stay where a step changes the loss
# by about 1 %: there the two packages' trajectories part no faster than
# their gradients do (each a few % apart, as the JAX package's own
# gradients move under a 0.1 % change of its inputs: bf16 rounding flips in
# this random model). `test_optimizer_updates_match_optax` holds the
# optimizers themselves to optax within 1e-5 (f32 rounding of Adam's
# moments) on the same gradients.
LR = 1e-3


def jax_params(cfg):
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(0), quant_block=64,
                                lm_head_bits=4, scale=0.05, fast=True)
    rng = np.random.default_rng(7)
    u = lambda *s: jnp.asarray(rng.uniform(0.7, 1.3, size=s), jnp.float32)
    lay = p.layers
    lay = dataclasses.replace(
        lay, wqkv=dataclasses.replace(lay.wqkv, out_bias=jnp.asarray(
            rng.normal(0, 0.1, size=lay.wqkv.out_bias.shape), jnp.float32)),
        input_norm=u(*lay.input_norm.shape), post_norm=u(*lay.post_norm.shape))
    return dataclasses.replace(p, layers=lay, final_norm=u(*p.final_norm.shape))


def numpy_lora(cfg, seed, b_scale):
    """Adapter arrays (rank 4, all four targets): a ~ N(0, 1/r), b ~
    N(0, b_scale^2) (b_scale 0: the standard zero init)."""
    rng = np.random.default_rng(seed)
    qkv_n = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dims = {"qkv": (cfg.hidden_size, qkv_n), "o": (cfg.q_dim, cfg.hidden_size),
            "gu": (cfg.hidden_size, 2 * cfg.intermediate_size),
            "down": (cfg.intermediate_size, cfg.hidden_size)}
    out = {}
    for name, (k, n) in dims.items():
        out["a_" + name] = (rng.standard_normal((cfg.num_layers, k, RANK))
                            / RANK ** 0.5).astype(np.float32)
        out["b_" + name] = (rng.standard_normal((cfg.num_layers, RANK, n))
                            * b_scale).astype(np.float32)
    return out


def jlora(arrays):
    return jdec.LoraParams(scaling=16.0 / RANK,
                           **{k: jnp.asarray(v) for k, v in arrays.items()})


def tlora(arrays):
    return decoder.LoraParams(scaling=16.0 / RANK,
                              **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def lora_arrays(lora) -> dict:
    return {f.name: np.asarray(getattr(lora, f.name), np.float32)
            for f in dataclasses.fields(lora) if f.name != "scaling"}


@pytest.fixture(scope="module")
def ref():
    cfg = J_PRESETS[CFG]
    params = jax_params(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    zero, live = numpy_lora(cfg, 1, 0.0), numpy_lora(cfg, 1, 0.01)
    out = dict(arrays=numpy_fields(params), tokens=tokens, zero=zero, live=live)

    def jfwd(lora):
        cache = jkv.create(cfg.num_layers, B, cfg.num_kv_heads, T, cfg.head_dim,
                           quantized=False)
        logits, _ = jdec.forward(params, cfg, jnp.asarray(tokens), cache,
                                 all_logits=True, lora=lora)
        return np.asarray(logits, np.float32)

    out["fwd_zero"], out["fwd_live"] = jfwd(jlora(zero)), jfwd(jlora(live))
    loss, grads = jax.value_and_grad(
        lambda lo: jlm_loss(params, lo, cfg, jnp.asarray(tokens)))(jlora(live))
    out["loss"], out["grads"] = float(loss), lora_arrays(grads)
    out["steps"] = {}
    for name, sched in OPTS:
        opt = jmake_opt(name, lr=LR, weight_decay=0.1, schedule=sched, total_steps=3,
                        warmup_steps=1)
        step = jmake_step(cfg, opt)
        lora = jlora(live)
        state = opt.init(lora)
        losses = []
        for _ in range(3):
            lora, state, loss = step(params, lora, state, jnp.asarray(tokens))
            losses.append(float(loss))
        out["steps"][name, sched] = (lora_arrays(lora), losses)
    merged = jmerge(params, jlora(live))
    out["merged"] = numpy_fields(merged.layers, "layers.")
    # the projection's VJP in interpret mode: qkv of layer 1 at M = B * T,
    # and the f32 int4 head
    rng = np.random.default_rng(5)
    out["vjp"] = []
    for ql, lidx, odt in ((params.layers.wqkv, 1, jnp.bfloat16),
                          (params.lm_head, None, jnp.float32)):
        k = ql.packed.shape[-2] * 8 // ql.bits
        x = rng.standard_normal((B * T, k)).astype(np.float32)
        g = rng.standard_normal((B * T, ql.packed.shape[-1])).astype(np.float32)
        y, vjp = jax.vjp(lambda xx: jdequant_matmul(
            xx, ql, layer_index=lidx, out_dtype=odt, interpret=True),
            jnp.asarray(x, jnp.bfloat16))
        (dx,) = vjp(jnp.asarray(g, odt))
        out["vjp"].append((x, g, lidx, np.asarray(y, np.float32),
                           np.asarray(dx, np.float32)))
    data = np.random.default_rng(9).standard_normal((10, 3)).astype(np.float32)
    labels = np.arange(10, dtype=np.int32)
    out["loader"] = (data, labels, [tuple(np.asarray(a) for a in batch) for batch in
                                    jdatasets.DataLoader(data, labels, 3, seed=4,
                                                         drop_last=False)])
    return out


@pytest.fixture(scope="module")
def port(ref):
    cfg = PRESETS[CFG]
    return cfg, decoder.params_from_numpy(ref["arrays"], cfg, "cpu")


def port_fwd(cfg, params, tokens, lora):
    cache = kvcache.create(cfg.num_layers, B, cfg.num_kv_heads, T, cfg.head_dim,
                           quantized=False, device="cpu")
    with torch.no_grad():
        logits, _ = decoder.forward(params, cfg, torch.from_numpy(tokens).long(), cache,
                                    all_logits=True, lora=lora)
    return logits.numpy()


@pytest.mark.parametrize("which", ["zero", "live"])
def test_forward_with_lora_matches_jax(ref, port, which):
    cfg, params = port
    got = port_fwd(cfg, params, ref["tokens"], tlora(ref[which]))
    assert rel(got, ref["fwd_" + which]) < 2e-2
    if which == "live":
        assert rel(ref["fwd_live"], ref["fwd_zero"]) > 0.1      # the adapters matter


def test_lm_loss_and_adapter_grads_match_jax(ref, port):
    cfg, params = port
    lora = tlora(ref["live"])
    for t in lora.tensors():
        t.requires_grad_(True)
    loss = lm_loss(params, lora, cfg, torch.from_numpy(ref["tokens"]).long())
    loss.backward()
    assert abs(float(loss.detach()) - ref["loss"]) <= 1e-2 * abs(ref["loss"])
    for f in dataclasses.fields(lora):
        if f.name.startswith(("a_", "b_")):
            grad = getattr(lora, f.name).grad
            assert rel(grad.numpy(), ref["grads"][f.name]) < 5e-2, f.name
    # the packed weights took no gradient, and nothing else asked for one
    assert not any(t.requires_grad for t in (params.layers.wqkv.packed,
                                             params.embedding))


@pytest.mark.parametrize("name,sched", OPTS)
def test_three_lora_steps_match_optax(ref, port, name, sched):
    cfg, params = port
    opt = make_optimizer(name, lr=LR, weight_decay=0.1, schedule=sched, total_steps=3,
                         warmup_steps=1)
    step = make_lora_train_step(cfg, opt)
    lora = tlora(ref["live"])
    state = opt.init(lora)
    losses = []
    for _ in range(3):
        lora, state, loss = step(params, lora, state, torch.from_numpy(ref["tokens"]).long())
        losses.append(float(loss))
    want, want_losses = ref["steps"][name, sched]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    for f, arr in want.items():
        got = getattr(lora, f).detach().numpy()
        assert rel(got, arr) < 5e-2, f
        if name == "sgd":
            # the steps moved the adapter as optax moved it (Adam's steps
            # are near the gradient's sign, which noise flips where it is
            # small, so this holds for SGD's steps only)
            assert rel(got - ref["live"][f], arr - ref["live"][f]) < 5e-2, f


@pytest.mark.parametrize("name,sched", OPTS + [("adamw", None)])
def test_optimizer_updates_match_optax(name, sched):
    """Four updates from the same gradients: the torch optimizer, the
    schedule's count (a warmup from 0 makes the first update zero) and the
    decoupled weight decay as optax applies them."""
    import optax

    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((8, 4)).astype(np.float32),
          "v": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    kw = dict(lr=0.1, weight_decay=0.1, schedule=sched, total_steps=4, warmup_steps=1)
    jopt = jmake_opt(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    opt = make_optimizer(name, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ostate = opt.init(tp)
    for g in grads:
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        ostate.step()
    assert ostate.count == 4
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5)


def test_schedules_follow_optax():
    import optax

    from mnn_tpu_torch.train.trainer import exponential_decay, warmup_cosine_decay

    for ours, theirs in ((warmup_cosine_decay(0.0, 0.1, 3, 10),
                          optax.warmup_cosine_decay_schedule(0.0, 0.1, 3, 10)),
                         (warmup_cosine_decay(0.0, 0.1, 0, 10),
                          optax.warmup_cosine_decay_schedule(0.0, 0.1, 0, 10)),
                         (exponential_decay(0.1, 2, 0.9), optax.exponential_decay(0.1, 2, 0.9))):
        np.testing.assert_allclose([ours(k) for k in range(13)],
                                   [float(theirs(k)) for k in range(13)], rtol=1e-6)


def test_merge_lora_matches_jax_bytes(ref, port):
    cfg, params = port
    merged = merge_lora(params, tlora(ref["live"]))
    for name in ("wqkv", "wo", "wgu", "wdown"):
        ql, key = getattr(merged.layers, name), f"layers.{name}"
        assert (ql.bits, ql.block_size) == (ref["merged"][key + ".bits"],
                                             ref["merged"][key + ".block_size"])
        for part in ("scale", "bias"):
            got = getattr(ql, part).float().numpy()
            want = np.asarray(ref["merged"][f"{key}.{part}"], np.float32)
            assert np.mean(got != want) <= 0.01, (name, part)
        codes = lambda q: dqmm.unpack_bits(q.packed.reshape(-1, q.packed.shape[-1]),
                                           q.bits, q.block_size).numpy()
        want_q = QuantizedLinear(packed=torch.from_numpy(
            ref["merged"][key + ".packed"].copy()), scale=ql.scale, bias=ql.bias,
            out_bias=None, bits=ql.bits, block_size=ql.block_size)
        assert np.mean(codes(ql) != codes(want_q)) <= 0.01, name
        if key + ".out_bias" in ref["merged"]:
            np.testing.assert_array_equal(ql.out_bias.numpy(),
                                          ref["merged"][key + ".out_bias"])


@pytest.mark.parametrize("base_bits,merge_bits", [(8, None), (4, 8)])
def test_merged_model_serves_like_the_adapters(ref, base_bits, merge_bits):
    """tests/test_train.py:75's bound, on the port: W8 weights merged at
    their own bits (the JAX test's setting), and W4 weights merged at 8
    bits (`merge_lora(bits=8)`); the merged layers take the bits asked."""
    cfg = PRESETS[CFG]
    params = decoder.init_random_params(cfg, torch.Generator().manual_seed(0),
                                        quant_bits=base_bits, quant_block=64, scale=0.05,
                                        lm_head_bits=8, device="cpu")
    lora = tlora(ref["live"])
    want = port_fwd(cfg, params, ref["tokens"], lora)
    merged = merge_lora(params, lora, bits=merge_bits)
    assert {getattr(merged.layers, n).bits for n in ("wqkv", "wo", "wgu", "wdown")} == {8}
    assert merged.layers.wqkv.packed.shape[1] == cfg.hidden_size      # K rows at W8
    got = port_fwd(cfg, merged, ref["tokens"], None)
    assert rel(got, want) < 5e-2


@pytest.mark.parametrize("case", [0, 1])
def test_dequant_matmul_vjp_matches_jax(ref, port, case):
    cfg, params = port
    x, g, lidx, want_y, want_dx = ref["vjp"][case]
    ql = params.layers.wqkv if case == 0 else params.lm_head
    odt = torch.bfloat16 if case == 0 else torch.float32
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = dqmm.dequant_matmul(xt, ql, layer_index=lidx, out_dtype=odt)
    assert y.grad_fn is not None and y.dtype == odt
    y.backward(torch.from_numpy(g).to(odt))
    assert xt.grad.dtype == torch.bfloat16
    assert rel(y.detach().float().numpy(), want_y) < 1e-2
    assert rel(xt.grad.float().numpy(), want_dx) < 1e-2
    # without autograd the call records nothing
    with torch.no_grad():
        assert dqmm.dequant_matmul(xt, ql, layer_index=lidx, out_dtype=odt).grad_fn is None


def test_init_lora_starts_at_zero_delta():
    cfg = PRESETS[CFG]
    lora = init_lora(cfg, torch.Generator().manual_seed(0), rank=RANK,
                     targets=("qkv", "gu"), device="cpu")
    assert lora.a_o is None and lora.b_down is None and lora.scaling == 16.0 / RANK
    assert lora.a_qkv.shape == (cfg.num_layers, cfg.hidden_size, RANK)
    assert not lora.b_gu.any() and len(lora.tensors()) == 4
    again = init_lora(cfg, torch.Generator().manual_seed(0), rank=RANK,
                      targets=("qkv", "gu"), device="cpu")
    assert torch.equal(lora.a_gu, again.a_gu)


def test_data_loader_matches_jax(ref):
    data, labels, want = ref["loader"]
    got = list(datasets.DataLoader(data, labels, 3, seed=4, drop_last=False, device="cpu"))
    assert len(got) == len(want) == 4
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd.numpy(), wd)
        np.testing.assert_array_equal(gl.numpy(), wl)


def test_mnist_idx_parser(tmp_path):
    import gzip
    import struct

    imgs = np.random.default_rng(0).integers(0, 256, (3, 4, 5), dtype=np.uint8)
    with gzip.open(tmp_path / "i.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 4, 5) + imgs.tobytes())
    with open(tmp_path / "l", "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + bytes([7, 1, 2]))
    np.testing.assert_array_equal(datasets.load_mnist_images(str(tmp_path / "i.gz")), imgs)
    np.testing.assert_array_equal(datasets.load_mnist_labels(str(tmp_path / "l")), [7, 1, 2])
    np.testing.assert_array_equal(jdatasets.load_mnist_images(str(tmp_path / "i.gz")), imgs)
    with pytest.raises(ValueError, match="magic"):
        datasets.load_mnist_labels(str(tmp_path / "i.gz"))
