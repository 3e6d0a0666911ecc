"""W2 and W3 models in the port against the JAX package, on the CPU.

* The whole-model decode kernel's plain version at W3 and W2 on the 3-layer
  `mk-test` shape of `tests/test_decode_model.py`, from the state the JAX
  megakernel (interpret mode) steps from: its results held to
  `decode_model.PARITY_BOUNDS` and the logits of both (the final norm and
  the tied head on x_out, after the kernel, as the JAX package serves a
  sub-4-bit head) within 5e-2 (`tests/test_decode_model.py:97`).
* A tiny qwen2 (2 layers, head_dim 64, untied) at W3 and W2 with a W3 / W2
  head: prefill, then decode steps fed the JAX tokens, against JAX
  `forward(interpret=True, megakernel=False)` within rel-L2 5e-2. The port's
  decode steps take the whole-model plain version with the head on the GEMV
  path, as they do on the card.
* `convert_hf(bits=3|2, block_size=32)` writes the JAX converter's bytes.
* `perplexity` at 4, 3 and 2 bits of the HF model of
  `tests/test_w23.py::TestPpl`, converted by the JAX converter, within 1e-3
  (relative) of the JAX one.
* `cli convert --bits 3` writes the same bytes; `supports` and
  `supports_head` agree with the JAX package's on abstract W2/W3 weights.

The JAX side runs once for the module in one fresh subprocess that writes
an `.npz` (and the converted directories): XLA:CPU's codegen has segfaulted
when it first traced the W2/W3 unpack late in a long test session
(`tests/test_w23.py:77-100`).
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from mnn_tpu_torch.convert.checkpoint import load_checkpoint
from mnn_tpu_torch.convert.hf import convert_hf
from mnn_tpu_torch.kernels import decode_model
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.layers import rms_norm
from mnn_tpu_torch.runtime import evaluate, kvcache
from tests.test_torch_w23 import run_jax_side

transformers = pytest.importorskip("transformers")

MK = dict(name="mk-test", vocab_size=512, hidden_size=256, intermediate_size=512,
          num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
          rope_theta=10000.0, attention_bias=True, tie_word_embeddings=True)
TQ = dict(MK, name="w23-qwen2", num_layers=2, tie_word_embeddings=False)
CAP, PREFILL, STEPS = 64, 9, 1
PPL_BITS = (4, 3, 2)
PPL_TOKENS = 192
BF16 = "@bf16"      # the .npz key suffix of a bf16 array kept as its bits
HF = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
          tie_word_embeddings=False)


def _jax_side(path):
    """Every JAX result of this module into the .npz at `path`; the HF model
    and the JAX converter's directories beside it."""
    import jax
    import jax.numpy as jnp

    from mnn_tpu.convert.checkpoint import load_checkpoint as jload
    from mnn_tpu.convert.hf import convert_hf as jconvert
    from mnn_tpu.kernels import decode_model as jdm
    from mnn_tpu.models import decoder as jdec
    from mnn_tpu.models import layers as jlayers
    from mnn_tpu.models.config import ModelConfig as JModelConfig
    from mnn_tpu.runtime import evaluate as jevaluate
    from mnn_tpu.runtime import kvcache as jkv
    from tests.test_torch_decode_model import numpy_fields

    out = {}
    root = os.path.dirname(path)

    def keep(prefix, tree):
        """A JAX pytree's fields under `prefix`; bf16 as its uint16 bits."""
        for k, v in numpy_fields(tree).items():
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                out[prefix + k + BF16] = v.view(np.uint16)
            else:
                out[prefix + k] = v
    for bits in (3, 2):
        # the whole-model kernel, one step from a prefilled int8 cache
        cfg = JModelConfig(**MK)
        # packed bytes drawn at random (the packing is held by
        # tests/test_torch_w23.py; quantizing floats here takes longer)
        p = jdec.init_random_params(cfg, jax.random.PRNGKey(bits), quant_bits=bits,
                                    scale=0.05, fast=True)
        rng = np.random.default_rng(bits)
        u = lambda *s: jnp.asarray(rng.uniform(0.7, 1.3, size=s), jnp.float32)
        lay = dataclasses.replace(
            p.layers, input_norm=u(*p.layers.input_norm.shape),
            post_norm=u(*p.layers.post_norm.shape),
            wqkv=dataclasses.replace(p.layers.wqkv, out_bias=jnp.asarray(
                rng.normal(0, 0.1, size=p.layers.wqkv.out_bias.shape), jnp.float32)))
        p = dataclasses.replace(p, layers=lay, final_norm=u(*p.final_norm.shape))
        cache = jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                           quantized=True, kv_bits=8)
        toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, PREFILL)), jnp.int32)
        _, cache = jdec.forward(p, cfg, toks, cache, interpret=False)
        assert jdm.supports(cfg, p, cache, 1)
        tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (1,)), jnp.int32)
        cos, sin = jlayers.rope_cos_sin(cache.length[:, None], cfg.head_dim, cfg.rope_theta)
        cos_f = jnp.concatenate([cos[:, 0], cos[:, 0]], axis=-1)
        sin_f = jnp.concatenate([sin[:, 0], sin[:, 0]], axis=-1)
        x = p.embedding[tok]
        outs = jdm.fused_decode_model(x, p.layers, cache.k, cache.v, cache.k_scale,
                                      cache.v_scale, cache.length, cos_f, sin_f,
                                      config=cfg, interpret=True)
        key = f"mk{bits}_"
        keep(key + "p.", p)
        keep(key + "c.", cache)
        out[key + "x"] = np.asarray(x.astype(jnp.float32))
        out[key + "cos"], out[key + "sin"] = np.asarray(cos_f), np.asarray(sin_f)
        for i, o in enumerate(outs):
            out[key + f"out{i}"] = np.asarray(o)

        # the tiny slice, a sub-4-bit head
        cfg = JModelConfig(**TQ)
        p = jdec.init_random_params(cfg, jax.random.PRNGKey(10 + bits), quant_bits=bits,
                                    lm_head_bits=bits, scale=0.05, fast=True)
        cache = jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                           quantized=True, kv_bits=8)
        toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, PREFILL)), jnp.int32)
        key = f"tq{bits}_"
        keep(key + "p.", p)
        out[key + "tokens"] = np.asarray(toks)
        logits, cache = jdec.forward(p, cfg, toks, cache, interpret=True, megakernel=False)
        rows, fed = [np.asarray(logits, np.float32)], []
        for _ in range(STEPS):
            t = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
            fed.append(int(t[0, 0]))
            logits, cache = jdec.forward(p, cfg, t, cache, interpret=True, megakernel=False)
            rows.append(np.asarray(logits, np.float32))
        out[key + "logits"] = np.stack(rows)
        out[key + "fed"] = np.asarray(fed)

    # the HF model of tests/test_w23.py::TestPpl (written by the fixture),
    # converted at 4, 3 and 2 bits; perplexity as TestPpl takes it
    src = os.path.join(root, "hf")
    ids = np.random.default_rng(3).integers(0, HF["vocab_size"], PPL_TOKENS)
    out["ppl_ids"] = ids
    for bits in PPL_BITS:
        conv = os.path.join(root, f"jax{bits}")
        jconvert(src, conv, bits=bits, block_size=32, lm_head_bits=8)
        config, params, _ = jload(conv)
        out[f"ppl{bits}"] = np.asarray(jevaluate.perplexity(params, config, ids.tolist(),
                                                            chunk=64))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("w23model")
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**HF)).eval()
    model.save_pretrained(str(root / "hf"), safe_serialization=True)
    path = str(root / "jax.npz")
    run_jax_side("tests.test_torch_w23_model", path, timeout=900)
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    out["root"] = os.path.dirname(path)
    return out


def fields(ref, prefix) -> dict:
    """The arrays kept under `prefix`, bf16 ones as torch bf16 tensors."""
    out = {}
    for k, v in ref.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k.endswith(BF16):
            out[k[:-len(BF16)]] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = int(v) if v.ndim == 0 and v.dtype.kind == "i" else v
    return out


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def tied_logits(params, cfg, x_out) -> torch.Tensor:
    """The final norm and the tied bf16 head on a step's x_out."""
    xn = rms_norm(x_out.to(torch.bfloat16), params.final_norm, cfg.rms_norm_eps)
    return decoder.head_logits(params, xn).float()


@pytest.mark.parametrize("bits", [3, 2])
def test_whole_model_plain_matches_jax(ref, bits):
    cfg = ModelConfig(**MK)
    key = f"mk{bits}_"
    params = decoder.params_from_numpy(fields(ref, key + "p."), cfg, "cpu")
    assert params.layers.wqkv.bits == bits and params.lm_head is None
    cache = kvcache.cache_from_numpy(fields(ref, key + "c."), 8)
    assert decode_model.supports(cfg, params, cache, 1)
    got = decode_model.fused_decode_model(
        tt(ref[key + "x"]), params.layers, cache.k, cache.v, cache.k_scale, cache.v_scale,
        cache.length, tt(ref[key + "cos"]), tt(ref[key + "sin"]), config=cfg)
    want = tuple(tt(ref[key + f"out{i}"]) for i in range(5))
    assert len(got) == 5 and all(torch.isfinite(t).all() for t in got)
    assert got[1].shape == want[1].shape and got[0].shape == want[0].shape
    m = decode_model.parity_metrics(got, want, 8)
    assert not decode_model.parity_failures(m), m
    lg, lw = tied_logits(params, cfg, got[0]), tied_logits(params, cfg, want[0])
    assert rel(lg, lw) <= decode_model.PARITY_BOUNDS["logits_rel"]


@pytest.mark.parametrize("bits", [3, 2])
def test_tiny_slice_matches_jax(ref, bits):
    cfg = ModelConfig(**TQ)
    key = f"tq{bits}_"
    params = decoder.params_from_numpy(fields(ref, key + "p."), cfg, "cpu")
    assert params.lm_head.bits == bits and params.layers.wdown.bits == bits
    assert not decode_model.supports_head(cfg, params)
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                           kv_bits=8)
    assert decode_model.supports(cfg, params, cache, 1)
    want = ref[key + "logits"]
    logits, cache = decoder.forward(params, cfg, tt(ref[key + "tokens"]).long(), cache)
    rows = [logits]
    for tok in ref[key + "fed"]:
        logits, cache = decoder.forward(params, cfg, torch.tensor([[int(tok)]]), cache)
        rows.append(logits)
    for s, (a, b) in enumerate(zip(rows, want)):
        assert torch.isfinite(a).all()
        assert rel(a, tt(b)) <= 5e-2, (s, rel(a, tt(b)))


@pytest.mark.parametrize("bits", [3, 2])
def test_convert_hf_matches_jax(ref, bits, tmp_path):
    from tests.test_torch_convert import assert_same_checkpoint

    out = str(tmp_path / "port")
    convert_hf(os.path.join(ref["root"], "hf"), out, bits=bits, block_size=32,
               lm_head_bits=8, device="cpu")
    assert_same_checkpoint(out, os.path.join(ref["root"], f"jax{bits}"))


@pytest.mark.parametrize("bits", PPL_BITS)
def test_perplexity_matches_jax(ref, bits):
    config, params, _ = load_checkpoint(os.path.join(ref["root"], f"jax{bits}"), device="cpu")
    assert params.layers.wqkv.bits == bits
    ppl = evaluate.perplexity(params, config, ref["ppl_ids"].tolist(), chunk=64)
    want = float(ref[f"ppl{bits}"])
    assert math.isfinite(ppl) and abs(ppl - want) / want <= 1e-3, (ppl, want)


def test_cli_convert_bits_3_writes_the_jax_bytes(ref, tmp_path):
    """`cli convert --bits 3` passes its bits through to `convert_hf`."""
    from mnn_tpu_torch import cli
    from tests.test_torch_convert import assert_same_checkpoint

    out = str(tmp_path / "cli3")
    cli.main(["convert", "--hf", os.path.join(ref["root"], "hf"), "--out", out, "--bits", "3",
              "--block", "32", "--lm-head-bits", "8", "--device", "cpu"])
    assert_same_checkpoint(out, os.path.join(ref["root"], "jax3"))


@pytest.mark.parametrize("preset", ["qwen2-0.5b", "qwen2-7b", "llama3.2-1b"])
def test_supports_agrees_with_jax_at_w23(preset, monkeypatch):
    """`supports` / `supports_head` against the JAX package's on abstract
    W2/W3 weights (`jax.eval_shape`: nothing is traced but the shapes), as
    `tests/test_torch_decode_model.py` holds them at W4/W8: the layers at 2
    and 3 bits are taken, a 2- or 3-bit head is never fused."""
    import jax

    from mnn_tpu.kernels import decode_model as jdm
    from mnn_tpu.models import decoder as jdec
    from mnn_tpu.models.config import PRESETS as J_PRESETS
    from mnn_tpu_torch.models.config import PRESETS
    from tests.test_torch_decode_model import meta_params

    monkeypatch.setattr(jdm, "_plan", lambda *a, **k: object())
    jcfg, cfg = J_PRESETS[preset], PRESETS[preset]
    for bits, head_bits, block in ((3, 3, 128), (2, 2, 128), (3, 4, 128), (2, 0, 32),
                                   (3, 8, 64)):
        abstract = jax.eval_shape(lambda: jdec.init_random_params(
            jcfg, jax.random.PRNGKey(0), quant_bits=bits, quant_block=block, fast=True,
            lm_head_bits=head_bits))
        params = meta_params(abstract, cfg)
        assert decode_model.supports_head(cfg, params) == jdm.supports_head(jcfg, abstract)
        for kv_bits in (16, 8, 4):
            for batch in (1, 4, 9):
                view = type("CacheView", (), dict(capacity=1024, bits=kv_bits,
                                                  codebook=False))()
                assert (decode_model.supports(cfg, params, view, batch)
                        == jdm.supports(jcfg, abstract, view, batch)), \
                    (preset, bits, head_bits, block, kv_bits, batch)
