"""The port's HF and AWQ/GPTQ converters against the JAX package's, on the
CPU, and the CLI's model commands.

Tiny HuggingFace models of six families are built with `transformers`:
Qwen2 (untied, qkv bias), Qwen2 tied, Llama, Qwen3 (qk-norm), Qwen2-MoE
(shared expert) and Phi-3 (fused qkv_proj / gate_up_proj). The port's
`convert_hf(device="cpu")` and the JAX `convert_hf` must write the same
tensors, byte for byte, with the same metadata, config.json and
runtime.json, over weight bits 4 / 8, `lm_head_bits` 0 / 4 / 8 and `sym`.
A checkpoint converted at W8 gives the transformers model's logits within
rel-L2 0.06 (`tests/test_convert.py:58`). AWQ and GPTQ inputs, packed as `tests/test_awq.py`
packs them, unpack to the JAX loader's weights and convert to the same
bytes. The JAX conversions run once, in one module-scoped fixture.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy

from mnn_tpu.convert import awq as jawq
from mnn_tpu.convert.hf import convert_hf as jconvert_hf
from mnn_tpu_torch import cli
from mnn_tpu_torch.convert import awq
from mnn_tpu_torch.convert.checkpoint import flatten, load_checkpoint
from mnn_tpu_torch.convert.hf import convert_hf
from mnn_tpu_torch.convert.stfile import StFile
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.runtime import kvcache
from tests.test_awq import _pack_awq_axis1, _pack_seq_axis0, _pack_seq_axis1
from tests.test_torch_checkpoint import assert_params_equal

transformers = pytest.importorskip("transformers")

BLOCK = 32
IDS = [5, 17, 99, 3, 42, 7, 64, 28]
COMMON = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=256, rope_theta=10000.0)
FAMILIES = {
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(tie_word_embeddings=False)),
    "qwen2_tied": ("Qwen2Config", "Qwen2ForCausalLM", dict(tie_word_embeddings=True)),
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(tie_word_embeddings=False)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(tie_word_embeddings=False,
                                                      head_dim=16)),
    "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM", dict(
        tie_word_embeddings=False, moe_intermediate_size=48,
        shared_expert_intermediate_size=96, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[])),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(
        tie_word_embeddings=False, sliding_window=None, pad_token_id=0,
        bos_token_id=1, eos_token_id=2)),
}
# (family, bits, lm_head_bits, sym); the converter's defaults are 4, 8, False
CASES = [(f, 4, 8, False) for f in FAMILIES] + [
    ("qwen2", 8, 0, False), ("qwen2", 4, 4, True), ("qwen2", 8, 8, True),
    ("qwen2_tied", 4, 0, False), ("qwen2_tied", 8, 4, False),
    ("qwen2_moe", 8, 0, True), ("awq", 4, 8, False), ("gptq", 4, 4, False)]


def case_id(case):
    return "-".join(map(str, case))


def build_family(name, out):
    cfg_cls, model_cls, extra = FAMILIES[name]
    cfg = getattr(transformers, cfg_cls)(**COMMON, **extra)
    torch.manual_seed(len(name))
    model = getattr(transformers, model_cls)(cfg).eval()
    model.save_pretrained(out, safe_serialization=True)
    return model


def awq_source(src, out, kind):
    """The qwen2 directory with layer 0's q_proj and down_proj replaced by
    AWQ (packed along N) or GPTQ v1 (packed along K) tensors, group 32."""
    rng = np.random.default_rng(9 if kind == "awq" else 10)
    tensors = st_load_numpy(os.path.join(src, "model.safetensors"))
    for name in ("model.layers.0.self_attn.q_proj", "model.layers.0.mlp.down_proj"):
        n, k = tensors.pop(name + ".weight").shape        # [out, in]
        q = rng.integers(0, 16, (k, n)).astype(np.uint8)
        z = rng.integers(1, 15, (k // BLOCK, n)).astype(np.uint8)
        s = rng.uniform(0.001, 0.01, (k // BLOCK, n)).astype(np.float16)
        if kind == "awq":
            tensors[name + ".qweight"] = _pack_awq_axis1(q)
            tensors[name + ".qzeros"] = _pack_awq_axis1(z)
        else:
            tensors[name + ".qweight"] = _pack_seq_axis0(q)
            tensors[name + ".qzeros"] = _pack_seq_axis1(z - 1)
        tensors[name + ".scales"] = s
    os.makedirs(out)
    st_save_numpy(tensors, os.path.join(out, "model.safetensors"))
    with open(os.path.join(src, "config.json")) as f, \
            open(os.path.join(out, "config.json"), "w") as g:
        g.write(f.read())


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """Per family: (model, source directory); per case: the JAX converter's
    output directory."""
    root = tmp_path_factory.mktemp("hf")
    models = {f: (build_family(f, str(root / f)), str(root / f)) for f in FAMILIES}
    for kind in ("awq", "gptq"):
        awq_source(models["qwen2"][1], str(root / kind), kind)
        models[kind] = (None, str(root / kind))
    outs = {}
    for case in CASES:
        fam, bits, head_bits, sym = case
        out = str(root / ("jax-" + case_id(case)))
        jconvert_hf(models[fam][1], out, bits=bits, block_size=BLOCK, sym=sym,
                    lm_head_bits=head_bits)
        outs[case] = out
    return dict(models=models, outs=outs)


def assert_same_checkpoint(a_dir, b_dir):
    with StFile(os.path.join(a_dir, "model.safetensors")) as a, \
            StFile(os.path.join(b_dir, "model.safetensors")) as b:
        assert sorted(a.names) == sorted(b.names)
        md_a, md_b = a.metadata(), b.metadata()
        assert sorted(md_a) == sorted(md_b) == ["casts", "quant"]
        for k in md_a:
            assert json.loads(md_a[k]) == json.loads(md_b[k]), k
        for k in a.names:
            x, y = a.tensor(k), b.tensor(k)
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8)), k
    for name in ("config.json", "runtime.json"):
        with open(os.path.join(a_dir, name)) as f, open(os.path.join(b_dir, name)) as g:
            assert json.load(f) == json.load(g), name


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_convert_hf_matches_jax(hf, case, tmp_path):
    fam, bits, head_bits, sym = case
    out = str(tmp_path / "port")
    config, params = convert_hf(hf["models"][fam][1], out, bits=bits, block_size=BLOCK,
                                sym=sym, lm_head_bits=head_bits, device="cpu")
    assert_same_checkpoint(out, hf["outs"][case])
    # what it returns is what it wrote, contiguous as the kernels take it
    cfg2, params2, _ = load_checkpoint(out, device="cpu")
    assert cfg2 == config
    assert_params_equal(params2, params)
    assert all(t.is_contiguous() for t in flatten(params)[0].values())
    if fam == "qwen2_tied" and not head_bits:
        assert params.lm_head is None


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_w8_logits_match_transformers(hf, fam, tmp_path):
    model, src = hf["models"][fam]
    out = str(tmp_path / "w8")
    convert_hf(src, out, bits=8, block_size=BLOCK, device="cpu")
    config, params, _ = load_checkpoint(out, device="cpu")
    with torch.no_grad():
        want = model(torch.tensor([IDS])).logits.float()
    cache = kvcache.create(config.num_layers, 1, config.num_kv_heads, 16,
                           config.head_dim, quantized=False)
    got, _ = decoder.forward(params, config, torch.tensor([IDS]), cache, all_logits=True)
    r = float((got.float() - want).norm() / want.norm())
    assert r < 0.06, r
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.75


def awq_tensors(kind, gptq_v2=False):
    rng = np.random.default_rng(4)
    k, n, group = 64, 48, 16
    q = rng.integers(0, 16, (k, n)).astype(np.uint8)
    z = rng.integers(1, 15, (k // group, n)).astype(np.uint8)
    s = rng.uniform(0.01, 0.1, (k // group, n)).astype(np.float16)
    if kind == "awq":
        return {"l.qweight": _pack_awq_axis1(q), "l.qzeros": _pack_awq_axis1(z), "l.scales": s}
    return {"l.qweight": _pack_seq_axis0(q),
            "l.qzeros": _pack_seq_axis1(z if gptq_v2 else z - 1), "l.scales": s}


@pytest.mark.parametrize("kind,v2", [("awq", False), ("gptq", False), ("gptq", True)])
def test_load_awq_weight_matches_jax(kind, v2):
    t = awq_tensors(kind, v2)
    want, wgroup = jawq.load_awq_weight(t, "l", gptq_v2=v2)
    got, group = awq.load_awq_weight({k: torch.from_numpy(v) for k, v in t.items()},
                                     "l", gptq_v2=v2)
    assert group == wgroup == 16
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    unpack, junpack = ((awq.unpack_awq, jawq.unpack_awq) if kind == "awq"
                       else (awq.unpack_gptq, jawq.unpack_gptq))
    for a, b in zip(unpack(torch.from_numpy(t["l.qweight"]), torch.from_numpy(t["l.qzeros"]),
                           torch.from_numpy(t["l.scales"])),
                    junpack(t["l.qweight"], t["l.qzeros"], t["l.scales"])):
        assert np.array_equal(a.numpy(), b)
    q = np.random.default_rng(0).integers(0, 16, (32, 16)).astype(np.uint8)
    z = np.full((2, 16), 3, np.uint8)
    s = np.full((2, 16), 0.5, np.float32)
    assert np.array_equal(awq.dequantize_awq_layer(*map(torch.from_numpy, (q, s, z)), 16).numpy(),
                          jawq.dequantize_awq_layer(q, s, z, 16))
    assert awq.AWQ_ORDER == tuple(jawq._AWQ_ORDER)


def test_gemma2_conversion_offsets_norms(tmp_path):
    """A tiny Gemma2 HF directory converts, its norms carrying gemma's `1 + w`
    offset and its sandwich norms in place (`tests/test_torch_gemma_convert.py`
    holds the bytes to the JAX converter's)."""
    cfg = transformers.Gemma2Config(
        vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=4,
        query_pre_attn_scalar=16, pad_token_id=0, bos_token_id=1, eos_token_id=2)
    torch.manual_seed(0)
    model = transformers.Gemma2ForCausalLM(cfg).eval()
    with torch.no_grad():
        model.model.layers[0].pre_feedforward_layernorm.weight.uniform_(-0.5, 0.5)
    d = str(tmp_path / "gemma")
    model.save_pretrained(d, safe_serialization=True)
    config, params = convert_hf(d, str(tmp_path / "out"), device="cpu")
    assert config.sandwich_norm and config.swa_every_other and config.embed_scale
    want = model.model.layers[0].pre_feedforward_layernorm.weight.float() + 1.0
    assert torch.equal(params.layers.pre_ffn_norm[0], want)
    assert params.layers.post_ffn_norm.shape == (1, 64)


# --------------------------------------------------------------------------
# the CLI's model commands, on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_model(hf, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli") / "ckpt")
    cli.main(["convert", "--hf", hf["models"]["qwen2"][1], "--out", out,
              "--lm-head-bits", "4", "--block", str(BLOCK), "--device", "cpu"])
    return out


MODEL_ARGS = ["--device", "cpu", "--max-seq-len", "64", "--prefill-chunk", "16",
              "--sampler", "greedy", "--max-new-tokens", "3"]


def test_cli_convert_matches_api(hf, cli_model, tmp_path):
    out = str(tmp_path / "api")
    convert_hf(hf["models"]["qwen2"][1], out, block_size=BLOCK, lm_head_bits=4,
               device="cpu")
    assert_same_checkpoint(cli_model, out)


def test_cli_run_model(cli_model, capsys, monkeypatch):
    # --model wins over --synthetic
    cli.main(["run", "--model", cli_model, "--synthetic", "qwen2-0.5b", "--raw",
              *MODEL_ARGS, "hi"])
    err = capsys.readouterr().err
    assert "[cpu] prefill 2 tok" in err and "decode 3 tok" in err
    assert "synthetic" not in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):   # no fallback
        cli.main(["run", "--model", cli_model, "hi"])


def test_cli_eval_model(cli_model, capsys):
    cli.main(["eval", "--model", cli_model, *MODEL_ARGS,
              "--text", "the quick brown fox jumps over the lazy dog"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"] == 43 and np.isfinite(out["perplexity"]) and out["perplexity"] > 1


def test_cli_chat_model(cli_model, capsys, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\n/reset\nhi\n/exit\nnever\n"))
    cli.main(["chat", "--model", cli_model, *MODEL_ARGS])
    captured = capsys.readouterr()
    assert captured.err.count("decode 3 tok") == 0  # the chat prints rates only
    assert captured.err.count("tok/s]") == 2 and "[context cleared]" in captured.err
    assert captured.out.count("> ") == 4             # hello, /reset, hi, /exit


def test_cli_serve_model(cli_model, monkeypatch):
    from mnn_tpu_torch.serve import server

    seen = {}
    monkeypatch.setattr(server, "serve", lambda llm, **kw: seen.update(llm=llm, **kw))
    cli.main(["serve", "--model", cli_model, *MODEL_ARGS, "--batch", "2", "--port", "0"])
    llm = seen["llm"]
    assert llm.config.name == "qwen2" and llm.device.type == "cpu"
    assert isinstance(llm.params.lm_head.bits, int) and llm.params.lm_head.bits == 4
    assert seen["batch"] == 2 and llm.rt.max_seq_len == 64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--model", cli_model])


@pytest.mark.parametrize("bits,sym", [(4, False), (8, True)])
def test_quantize_of_a_transposed_matrix(bits, sym):
    """The converter quantizes [out, in] HF weights transposed: the packed
    result is contiguous and equal to that of the copied matrix."""
    from mnn_tpu_torch.quant.quantize import quantize

    w = torch.randn((96, 64), generator=torch.Generator().manual_seed(bits))
    a = quantize(w.T, bits=bits, block_size=32, sym=sym)
    b = quantize(w.T.contiguous(), bits=bits, block_size=32, sym=sym)
    for f in ("packed", "scale", "bias"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.is_contiguous() and torch.equal(x, y), f
