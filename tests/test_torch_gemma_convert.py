"""Gemma checkpoints in the port's converter and loader, against the JAX
package's, on the CPU.

Tiny `Gemma2ForCausalLM` and `Gemma3ForCausalLM` directories are built with
`transformers` (as `tests/test_model_families.py` builds them: sandwich
norms, the `1 + w` RMSNorm, softcaps, gemma3's N:1 pattern, dual rope and
QK-norm). The port's `convert_hf(device="cpu")` must write the JAX
converter's bytes, metadata, config.json and runtime.json; the directory
must load back to the params the converter returned; and the loaded model's
logits (a prefill of 8 tokens, then 2 decode steps) must agree with the JAX
`forward` over the JAX loader's params within rel-L2 5e-2 (the whole-model
bound, `tests/test_decode_model.py:97`). The JAX conversions and forwards
run once, in module-scoped fixtures.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.convert.checkpoint import load_checkpoint as jload_checkpoint
from mnn_tpu.convert.hf import convert_hf as jconvert_hf
from mnn_tpu.models import decoder as jdec
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.convert.checkpoint import load_checkpoint
from mnn_tpu_torch.convert.hf import convert_hf
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_checkpoint import assert_params_equal
from tests.test_torch_convert import assert_same_checkpoint

transformers = pytest.importorskip("transformers")

BLOCK, BITS, HEAD_BITS = 32, 4, 4
IDS = [2, 8, 32, 64, 90, 11, 45, 7]      # 8 > the window of 4: the windows matter
FEED = [17, 5]                           # two decode steps
CAP = 32
COMMON = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              max_position_embeddings=128, query_pre_attn_scalar=16, sliding_window=4,
              tie_word_embeddings=True, pad_token_id=0, bos_token_id=1, eos_token_id=2)
FAMILIES = {
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        num_hidden_layers=2, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        rope_theta=10000.0)),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        num_hidden_layers=4, sliding_window_pattern=2, layer_types=None,
        rope_theta=1000000.0, rope_local_base_freq=10000.0)),
}


def build(name, out):
    cfg_cls, model_cls, extra = FAMILIES[name]
    cfg = getattr(transformers, cfg_cls)(**COMMON, **extra)
    cfg._attn_implementation = "eager"
    torch.manual_seed(len(name))
    model = getattr(transformers, model_cls)(cfg).eval()
    with torch.no_grad():       # norms away from HF's init (zeros: 1 + w is 1)
        for n, p in model.named_parameters():
            if "norm" in n:
                p.uniform_(-0.4, 0.4)
    model.save_pretrained(out, safe_serialization=True)
    return out


def jax_logits(out):
    cfg, params, _ = jload_checkpoint(out)
    cache = jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                       quantized=True)
    logits, cache = jdec.forward(params, cfg, jnp.asarray([IDS], jnp.int32), cache)
    rows = [np.asarray(logits, np.float32)]
    for tok in FEED:
        logits, cache = jdec.forward(params, cfg, jnp.asarray([[tok]], jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return rows


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("gemma")
    out = {}
    for name in FAMILIES:
        src = build(name, str(root / name))
        jout = str(root / ("jax-" + name))
        jconvert_hf(src, jout, bits=BITS, block_size=BLOCK, lm_head_bits=HEAD_BITS)
        out[name] = dict(src=src, jax_dir=jout, rows=jax_logits(jout))
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_convert_gemma_matches_jax(ref, name, tmp_path):
    out = str(tmp_path / "port")
    config, params = convert_hf(ref[name]["src"], out, bits=BITS, block_size=BLOCK,
                                lm_head_bits=HEAD_BITS, device="cpu")
    assert config.sandwich_norm and config.mlp_act == "gelu_tanh" and config.embed_scale
    assert config.swa_every_other == (name == "gemma2")
    assert config.swa_pattern == (2 if name == "gemma3" else 0)
    assert params.layers.pre_ffn_norm is not None and params.layers.post_ffn_norm is not None
    assert_same_checkpoint(out, ref[name]["jax_dir"])
    cfg2, params2, _ = load_checkpoint(out, device="cpu")
    assert cfg2 == config
    assert_params_equal(params2, params)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loaded_gemma_matches_jax_forward(ref, name, tmp_path):
    config, params, _ = load_checkpoint(ref[name]["jax_dir"], device="cpu")
    cache = kvcache.create(config.num_layers, 1, config.num_kv_heads, CAP, config.head_dim,
                           quantized=True)
    logits, cache = decoder.forward(params, config, torch.tensor([IDS]), cache)
    got = [logits.float().numpy()]
    for tok in FEED:
        logits, cache = decoder.forward(params, config, torch.tensor([[tok]]), cache)
        got.append(logits.float().numpy())
    for s, (a, b) in enumerate(zip(got, ref[name]["rows"])):
        r = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert np.isfinite(a).all() and r <= 5e-2, (s, r)


def test_from_pretrained_serves_gemma(ref):
    llm = Llm.from_pretrained(ref["gemma3"]["jax_dir"], device="cpu")
    assert llm.config.swa_pattern == 2 and llm.info()["kv_bits"] == 8
    toks = list(llm.stream(token_ids=IDS, max_new_tokens=3))
    assert len(toks) == 3 and all(0 <= t < llm.config.vocab_size for t in toks)
