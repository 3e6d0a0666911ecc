"""The port's checkpoint I/O against the `safetensors` package and the JAX
package, on the CPU.

* `convert/stfile.py`: the reader against `safetensors.safe_open` on every
  dtype, empty tensors and metadata; the writer's files read back by
  `safe_open` and laid out byte for byte as `safetensors` lays them out;
  several files of one directory read as one.
* `convert/checkpoint.py`: checkpoints of `tiny` and a tiny mixture of
  experts (W4 / W8, quantized and bf16 heads) written by the JAX
  `save_checkpoint` load in the port byte-equal to `params_from_numpy` of
  the same JAX params; the port's `save_checkpoint` reads back in the JAX
  `load_checkpoint` with equal leaves, config and runtime JSON.
* `Llm.from_pretrained(device="cpu")` gives the JAX `Llm.from_pretrained`'s
  greedy tokens, and prefill logits within rel-L2 5e-2
  (`tests/test_decode_model.py:97`).
* A gemma checkpoint (sandwich norms, QK-norm) written by the JAX
  `save_checkpoint` loads, byte-equal to `params_from_numpy`; every new
  module imports with `safetensors`, `transformers`, `tokenizers`,
  `ml_dtypes` and JAX blocked.

The JAX side is computed once, in one module-scoped fixture.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from mnn_tpu.convert import checkpoint as jckpt
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.runtime.llm import Llm as JLlm
from mnn_tpu_torch.convert import checkpoint, stfile
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import ROOT, numpy_fields, rel

MOE = dict(name="tiny-moe", vocab_size=256, hidden_size=128, intermediate_size=256,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
           tie_word_embeddings=True, attention_bias=True, num_experts=4,
           num_experts_per_tok=2, moe_intermediate_size=64,
           shared_expert_intermediate_size=128, norm_topk_prob=False)
# (config key, weight bits, lm_head_bits, act_bits)
CASES = [("tiny", 4, 4, 16), ("tiny", 8, 0, 8), ("tiny", 4, 8, 16),
         ("moe", 4, 4, 16), ("moe", 8, 0, 16)]
IDS = [3, 17, 99, 42, 7, 64, 28, 5, 200, 11, 90]
NEW = 6
RT = dict(max_seq_len=64, prefill_chunk=16, decode_block=3, sampler="greedy",
          kv_quant=True, kv_bits=8, max_new_tokens=NEW)
DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.uint8,
          torch.int16, torch.uint16, torch.int32, torch.int64]


def case_id(case):
    return "-".join(map(str, case))


def jax_config(key):
    return J_PRESETS["tiny"] if key == "tiny" else JModelConfig(**MOE)


def port_config(key):
    return ModelConfig(**dataclasses.asdict(jax_config(key)))


def raw(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, to compare two tensors bit for bit."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def assert_params_equal(a, b):
    fa, fb = checkpoint.flatten(a), checkpoint.flatten(b)
    assert fa[1] == fb[1]
    assert sorted(fa[0]) == sorted(fb[0])
    for k, x in fa[0].items():
        y = fb[0][k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(raw(x), raw(y)), k


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Per case: the JAX params (as numpy fields) and the directory the JAX
    `save_checkpoint` wrote them to. For the first tiny and the first MoE
    case also the JAX `Llm.from_pretrained` greedy tokens and the prefill
    logits of the loaded params."""
    out = {}
    for case in CASES:
        key, bits, head_bits, act_bits = case
        cfg = jax_config(key)
        p = jdec.init_random_params(cfg, jax.random.PRNGKey(bits + head_bits),
                                    quant_bits=bits, act_bits=act_bits,
                                    lm_head_bits=head_bits, scale=0.05)
        d = str(tmp_path_factory.mktemp(case_id(case)))
        jckpt.save_checkpoint(d, cfg, p, JRuntimeConfig(quant_bits=bits, seed=5))
        ref = dict(arrays=numpy_fields(p), dir=d)
        if case in (CASES[0], CASES[3], CASES[4]):
            llm = JLlm.from_pretrained(d, rt=JRuntimeConfig(**RT))
            ref["tokens"] = list(llm.stream(token_ids=IDS, max_new_tokens=NEW))
            c2, p2, _ = jckpt.load_checkpoint(d)
            cache = jkv.create(c2.num_layers, 1, c2.num_kv_heads, 32, c2.head_dim,
                               quantized=False)
            logits, _ = jdec.forward(p2, c2, jnp.asarray([IDS], jnp.int32), cache,
                                     all_logits=True, interpret=True, megakernel=False)
            ref["logits"] = np.asarray(logits, np.float32)
        out[case] = ref
    return out


# --------------------------------------------------------------------------
# the safetensors reader and writer
# --------------------------------------------------------------------------

def sample_tensors():
    g = torch.Generator().manual_seed(0)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5) if i % 2 else (7,)
        if dt.is_floating_point:
            out[f"t_{i}"] = torch.randn(shape, generator=g).to(dt)
        else:
            out[f"t_{i}"] = torch.randint(0, 120, shape, generator=g).to(dt)
    out["empty"] = torch.zeros((0, 4), dtype=torch.float32)
    out["scalar"] = torch.tensor(2.5, dtype=torch.float32)
    return out


def test_reader_against_safetensors(tmp_path):
    tensors = sample_tensors()
    path = str(tmp_path / "x.safetensors")
    st_save_file(tensors, path, metadata={"quant": "{}", "format": "pt"})
    with stfile.StFile(path) as f, safe_open(path, framework="pt") as ref:
        assert f.metadata() == ref.metadata() == {"quant": "{}", "format": "pt"}
        assert sorted(f.names) == sorted(ref.keys())
        got = {k: f.tensor(k).clone() for k in f.names}
        for k in f.names:
            want = ref.get_tensor(k)
            assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
            assert torch.equal(raw(got[k]), raw(want)), k
    assert got["t_2"].dtype == torch.bfloat16      # lands as torch.bfloat16
    for k, t in tensors.items():                    # the copies outlive the map
        assert torch.equal(raw(got[k]), raw(t)), k


def test_writer_read_by_safetensors(tmp_path):
    tensors = sample_tensors()
    ours, theirs = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    stfile.save_file(tensors, ours, metadata={"casts": "{}"})
    st_save_file(tensors, theirs, metadata={"casts": "{}"})
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == {"casts": "{}"}
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            assert torch.equal(raw(f.get_tensor(k)), raw(t)), k
    # the same layout, byte for byte (one metadata key: its order is fixed)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_sharded_directory(tmp_path):
    tensors = sample_tensors()
    names = sorted(tensors)
    stfile.save_file({k: tensors[k] for k in names[:4]},
                     str(tmp_path / "model-00001-of-00002.safetensors"))
    stfile.save_file({k: tensors[k] for k in names[4:]},
                     str(tmp_path / "model-00002-of-00002.safetensors"))
    with stfile.StDir(str(tmp_path)) as d:
        assert sorted(d) == names and len(d) == len(names)
        for k in names:
            assert k in d and torch.equal(raw(d[k]), raw(tensors[k])), k
    with pytest.raises(FileNotFoundError):
        stfile.StDir(str(tmp_path / "none"))


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_load_jax_checkpoint(jax_ref, case):
    ref = jax_ref[case]
    cfg, params, rt = checkpoint.load_checkpoint(ref["dir"], device="cpu")
    assert cfg == port_config(case[0])
    assert rt.quant_bits == case[1] and rt.seed == 5
    want = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    assert_params_equal(params, want)
    assert params.layers.wqkv.act_bits == case[3]
    head = params.lm_head
    if case[2]:
        assert head.bits == case[2]
    else:
        assert head is None          # tied and kept in bf16: embedding.T


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_port_checkpoint_read_by_jax(jax_ref, case, tmp_path):
    ref = jax_ref[case]
    cfg, params, rt = checkpoint.load_checkpoint(ref["dir"], device="cpu")
    out = str(tmp_path / "port")
    checkpoint.save_checkpoint(out, cfg, params, rt)
    jcfg, jparams, jrt = jckpt.load_checkpoint(out)
    assert jcfg == jax_config(case[0]) and jrt == JRuntimeConfig(quant_bits=case[1], seed=5)
    got = numpy_fields(jparams)
    assert sorted(got) == sorted(ref["arrays"])
    for k, v in ref["arrays"].items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert np.array_equal(got[k].view(np.uint8), v.view(np.uint8)), k
    for name in ("config.json", "runtime.json"):
        with open(os.path.join(out, name)) as a, open(os.path.join(ref["dir"], name)) as b:
            assert json.load(a) == json.load(b), name


def test_native_bf16_checkpoint(jax_ref, tmp_path):
    """A file whose bf16 tensors are native BF16 (no `casts`) loads the same."""
    ref = jax_ref[CASES[0]]
    cfg, params, rt = checkpoint.load_checkpoint(ref["dir"], device="cpu")
    tensors, meta = checkpoint.flatten(params)
    assert any(t.dtype == torch.bfloat16 for t in tensors.values())
    out = tmp_path / "bf16"
    out.mkdir()
    stfile.save_file(tensors, str(out / "model.safetensors"),
                     metadata={"quant": json.dumps(meta)})
    for name in ("config.json", "runtime.json"):
        (out / name).write_text(open(os.path.join(ref["dir"], name)).read())
    _, params2, _ = checkpoint.load_checkpoint(str(out), device="cpu")
    assert_params_equal(params2, params)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4]], ids=case_id)
def test_from_pretrained_matches_jax(jax_ref, case):
    ref = jax_ref[case]
    llm = Llm.from_pretrained(ref["dir"], rt=RuntimeConfig(**RT), device="cpu")
    assert llm.device.type == "cpu" and llm.rt.seed == 0
    assert list(llm.stream(token_ids=IDS, max_new_tokens=NEW)) == ref["tokens"]
    cache = kvcache.create(llm.config.num_layers, 1, llm.config.num_kv_heads, 32,
                           llm.config.head_dim, quantized=False)
    logits, _ = decoder.forward(llm.params, llm.config, torch.tensor([IDS]), cache,
                                all_logits=True)
    assert rel(logits.float().numpy(), ref["logits"]) < 5e-2
    # without `rt` the saved runtime.json serves, whole
    assert Llm.from_pretrained(ref["dir"], device="cpu").rt == RuntimeConfig(
        quant_bits=case[1], seed=5)


def test_from_pretrained_needs_a_device_or_the_card(jax_ref):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Llm.from_pretrained(jax_ref[CASES[0]]["dir"])


def test_gemma_checkpoint_loads_and_mrope_loads(tmp_path):
    """A tiny gemma3 checkpoint (sandwich norms, QK-norm, the N:1 pattern)
    written by the JAX `save_checkpoint` loads, byte-equal to
    `params_from_numpy` of the same JAX params, with its config; the same
    tensors under a multimodal-rope config load with its sections."""
    cfg = dataclasses.replace(J_PRESETS["gemma3-4b"], name="tiny-gemma3", vocab_size=256,
                              hidden_size=128, intermediate_size=256, num_layers=2,
                              head_dim=64)
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(3), lm_head_bits=4, scale=0.05)
    out = tmp_path / "gemma"
    jckpt.save_checkpoint(str(out), cfg, p, JRuntimeConfig(quant_bits=4))
    got_cfg, got, _ = checkpoint.load_checkpoint(str(out), device="cpu")
    assert got_cfg == ModelConfig(**dataclasses.asdict(cfg))
    assert got.layers.pre_ffn_norm.shape == (2, 128) and got.layers.q_norm.shape == (2, 64)
    assert_params_equal(got, decoder.params_from_numpy(numpy_fields(p), got_cfg, "cpu"))
    mrope = tmp_path / "mrope"
    shutil.copytree(out, mrope)
    (mrope / "config.json").write_text(json.dumps(
        {"mnn_tpu": True, **dataclasses.asdict(cfg), "mrope_section": [16, 24, 24]}))
    m_cfg, m_params, _ = checkpoint.load_checkpoint(str(mrope), device="cpu")
    assert m_cfg.mrope_section == (16, 24, 24)
    assert m_cfg == dataclasses.replace(got_cfg, mrope_section=(16, 24, 24))
    assert_params_equal(m_params, got)


# --------------------------------------------------------------------------
# the new modules need none of the optional packages
# --------------------------------------------------------------------------

NEW_MODULES = ("mnn_tpu_torch.convert.stfile", "mnn_tpu_torch.convert.checkpoint",
               "mnn_tpu_torch.convert.awq", "mnn_tpu_torch.convert.hf",
               "mnn_tpu_torch.convert.gguf", "mnn_tpu_torch.runtime.evaluate",
               "mnn_tpu_torch.runtime.llm", "mnn_tpu_torch.cli",
               "mnn_tpu_torch.train", "mnn_tpu_torch.train.lora",
               "mnn_tpu_torch.train.trainer", "mnn_tpu_torch.train.datasets",
               "mnn_tpu_torch.train.compress", "mnn_tpu_torch.quant",
               "mnn_tpu_torch.quant.awq_search", "mnn_tpu_torch.quant.calibrate",
               "mnn_tpu_torch.quant.hqq", "mnn_tpu_torch.quant.omni_quant",
               "mnn_tpu_torch.quant.smooth")


def test_new_modules_import_without_optional_packages(jax_ref, tmp_path):
    """Import every new module, and load a checkpoint, with `safetensors`,
    `transformers`, `tokenizers`, `ml_dtypes`, JAX, optax and PIL blocked."""
    code = f"""
import sys
for m in ("safetensors", "transformers", "tokenizers", "ml_dtypes", "jax", "mnn_tpu",
          "optax", "PIL"):
    sys.modules[m] = None
import importlib
for m in {NEW_MODULES!r}:
    importlib.import_module(m)
from mnn_tpu_torch.runtime.llm import Llm
llm = Llm.from_pretrained({jax_ref[CASES[0]]["dir"]!r}, device="cpu")
print(type(llm.tokenizer).__name__, llm.config.name)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ByteTokenizer", "tiny"]
