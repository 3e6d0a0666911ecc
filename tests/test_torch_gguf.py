"""The port's GGUF importer against the JAX package's, on the CPU.

GGUF files are written by the test-side writer and block encoders of
`tests/test_gguf.py`. Each ggml block decoder must give the JAX decoder's
values bit for bit; `read_gguf` the same metadata and tensors; `gguf_to_hf`
the same HF config and tensors (llama's rope permutation undone); the
port's `convert_gguf(device="cpu")` the same checkpoint bytes as the JAX
`convert_gguf`, its tokenizer files included; and `reconstruct_tokenizer`
the same files for a BPE and a sentencepiece vocabulary.
"""

import json
import os

import numpy as np
import pytest
import torch

from mnn_tpu.convert import gguf as JG
from mnn_tpu_torch.convert import gguf as G
from tests.test_gguf import (_enc_q4_0, _enc_q4_k, _enc_q6_k, _enc_q8_0, _kv_arr_str,
                             _kv_scalar, _kv_str, write_gguf)
from tests.test_torch_convert import assert_same_checkpoint

N_ELEMS = 1024


def random_blocks(ttype, rng):
    """Raw bytes of N_ELEMS elements of a block type, with random quant bytes
    and finite f16 scale fields."""
    bsz, belems = G._TYPE_SIZES[ttype]
    raw = rng.integers(0, 256, (N_ELEMS // belems, bsz)).astype(np.uint8)
    scale_bytes = {G.Q4_1: (0, 2), G.Q5_0: (0,), G.Q5_1: (0, 2), G.Q4_0: (0,),
                   G.Q8_0: (0,), G.Q4_K: (0, 2), G.Q6_K: (208,)}[ttype]
    for at in scale_bytes:
        f16 = rng.uniform(-0.1, 0.1, len(raw)).astype(np.float16)
        raw[:, at:at + 2] = f16.view(np.uint8).reshape(-1, 2)
    return raw.reshape(-1)


BLOCK_TYPES = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q6_K"]


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_block_decoder_matches_jax(name):
    ttype = getattr(G, name)
    assert ttype == getattr(JG, name)
    raw = random_blocks(ttype, np.random.default_rng(ttype))
    got = G.decode_tensor(raw, ttype, (N_ELEMS // 64, 64))
    want = JG.decode_tensor(raw, ttype, (N_ELEMS // 64, 64))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (64, 16)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name,enc", [("Q4_0", _enc_q4_0), ("Q8_0", _enc_q8_0),
                                      ("Q6_K", _enc_q6_k), ("Q4_K", _enc_q4_k)])
def test_block_decoder_on_encoded_weights(name, enc):
    w = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    raw = np.frombuffer(enc(w), np.uint8)
    ttype = getattr(G, name)
    got = G.decode_tensor(raw, ttype, (512,))
    assert np.array_equal(got, JG.decode_tensor(raw, ttype, (512,)))
    assert np.abs(got - w).max() / np.abs(w).max() < 0.08


@pytest.mark.parametrize("name,dtype", [("F32", np.float32), ("F16", np.float16),
                                        ("BF16", np.uint16), ("I8", np.int8),
                                        ("I16", np.int16), ("I32", np.int32)])
def test_plain_types_match_jax(name, dtype):
    rng = np.random.default_rng(2)
    if dtype == np.uint16:
        vals = (rng.standard_normal(60).astype(np.float32).view(np.uint32) >> 16)
        raw = vals.astype(np.uint16).view(np.uint8)
    elif np.issubdtype(dtype, np.floating):
        raw = rng.standard_normal(60).astype(dtype).view(np.uint8)
    else:
        raw = rng.integers(-100, 100, 60).astype(dtype).view(np.uint8)
    ttype = getattr(G, name)
    got, want = G.decode_tensor(raw, ttype, (6, 10)), JG.decode_tensor(raw, ttype, (6, 10))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def llama_gguf(path, quant: bool):
    """A 2-layer llama GGUF with a BPE vocabulary: F32 tensors, or (quant)
    the attention and MLP weights in Q8_0 / Q4_0 / Q4_K / Q6_K blocks."""
    rng = np.random.default_rng(3)
    hidden, inter, vocab, heads, kv = 64, 256, 96, 4, 2
    kvs = [_kv_str("general.architecture", "llama"),
           _kv_scalar("llama.embedding_length", 4, "I", hidden),
           _kv_scalar("llama.feed_forward_length", 4, "I", inter),
           _kv_scalar("llama.block_count", 4, "I", 2),
           _kv_scalar("llama.attention.head_count", 4, "I", heads),
           _kv_scalar("llama.attention.head_count_kv", 4, "I", kv),
           _kv_scalar("llama.context_length", 4, "I", 128),
           _kv_scalar("llama.rope.freq_base", 6, "f", 10000.0),
           _kv_scalar("llama.attention.layer_norm_rms_epsilon", 6, "f", 1e-5),
           _kv_str("tokenizer.ggml.model", "gpt2"),
           _kv_arr_str("tokenizer.ggml.tokens", [f"t{i}" for i in range(vocab)]),
           _kv_arr_str("tokenizer.ggml.merges", ["t 1", "t 2"]),
           _kv_scalar("tokenizer.ggml.eos_token_id", 4, "I", 2)]
    tensors = []

    def add(name, shape, enc=None, ttype=G.F32):
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        if name.endswith("norm.weight"):
            w = 1 + w
        raw = np.frombuffer(enc(w) if enc else w.tobytes(), np.uint8)
        tensors.append((name, shape, ttype, raw))

    q = {"q8": (_enc_q8_0, G.Q8_0), "q4": (_enc_q4_0, G.Q4_0),
         "q4k": (_enc_q4_k, G.Q4_K), "q6k": (_enc_q6_k, G.Q6_K)}
    pick = lambda kind: q[kind] if quant else (None, G.F32)
    add("token_embd.weight", (vocab, hidden))
    add("output_norm.weight", (hidden,))
    add("output.weight", (vocab, hidden), *pick("q8"))
    for i in range(2):
        b = f"blk.{i}."
        add(b + "attn_q.weight", (hidden, hidden), *pick("q8"))
        add(b + "attn_k.weight", (kv * 16, hidden), *pick("q4"))
        add(b + "attn_v.weight", (kv * 16, hidden), *pick("q8"))
        add(b + "attn_output.weight", (hidden, hidden), *pick("q4"))
        add(b + "ffn_gate.weight", (inter, hidden), *pick("q8"))
        add(b + "ffn_up.weight", (inter, hidden), *pick("q8"))
        add(b + "ffn_down.weight", (hidden, inter), *pick("q4k" if i else "q6k"))
        add(b + "attn_norm.weight", (hidden,))
        add(b + "ffn_norm.weight", (hidden,))
    write_gguf(path, b"".join(kvs), len(kvs), tensors)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "blocks"])
def test_read_gguf_and_gguf_to_hf_match_jax(tmp_path, quant):
    path = str(tmp_path / "m.gguf")
    llama_gguf(path, quant)
    meta, tensors = G.read_gguf(path)
    jmeta, jtensors = JG.read_gguf(path)
    assert meta == jmeta and sorted(tensors) == sorted(jtensors)
    for k in tensors:
        assert np.array_equal(tensors[k], jtensors[k]), k
    cfg, hf = G.gguf_to_hf(path)
    jcfg, jhf = JG.gguf_to_hf(path)
    assert cfg == jcfg and cfg["num_hidden_layers"] == 2
    assert sorted(hf) == sorted(jhf)
    for k in hf:
        assert hf[k].dtype == jhf[k].dtype and np.array_equal(hf[k], jhf[k]), k


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "blocks"])
def test_convert_gguf_matches_jax(tmp_path, quant):
    path = str(tmp_path / "m.gguf")
    llama_gguf(path, quant)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    config, _ = G.convert_gguf(path, ours, bits=4, block_size=32, lm_head_bits=4,
                               device="cpu")
    JG.convert_gguf(path, theirs, bits=4, block_size=32, lm_head_bits=4)
    assert config.num_layers == 2 and not config.tie_word_embeddings
    assert_same_checkpoint(ours, theirs)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


SPM_META = {
    "tokenizer.ggml.model": "llama",
    "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "▁hello", "▁world", "▁",
                              "h", "e", "l", "o", "w", "r", "d"],
    "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0, -1.5, -3.0] + [-5.0] * 7,
    "tokenizer.ggml.token_type": [2, 3, 3] + [1] * 10,
    "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
    "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.add_bos_token": True,
    "tokenizer.chat_template": "{{ messages }}",
}
BPE_META = {
    "tokenizer.ggml.model": "gpt2",
    "tokenizer.ggml.tokens": ["h", "e", "l", "o", "he", "ll", "hell", "hello", "</s>"],
    "tokenizer.ggml.merges": ["h e", "l l", "he ll", "hell o"],
    "tokenizer.ggml.token_type": [1] * 8 + [3],
    "tokenizer.ggml.eos_token_id": 8,
}


@pytest.mark.parametrize("meta", [SPM_META, BPE_META], ids=["spm", "bpe"])
def test_reconstruct_tokenizer_matches_jax(tmp_path, meta):
    tokenizers = pytest.importorskip("tokenizers")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert G.reconstruct_tokenizer(meta, ours) and JG.reconstruct_tokenizer(meta, theirs)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    tok = tokenizers.Tokenizer.from_file(os.path.join(ours, "tokenizer.json"))
    assert tok.encode("hello").ids
    assert json.load(open(os.path.join(ours, "tokenizer_config.json")))["eos_token"] == (
        meta["tokenizer.ggml.tokens"][meta["tokenizer.ggml.eos_token_id"]])
    assert not G.reconstruct_tokenizer({}, str(tmp_path / "none"))
