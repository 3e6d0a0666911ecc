"""GGUF checkpoint ingest.

Counterpart of `mnn_tpu/convert/gguf.py`: reads a llama.cpp GGUF file off
the binary spec (header, typed KV metadata, tensor directory, aligned data
section), dequantizes the ggml block formats (F32/F16/BF16, Q4_0/Q4_1,
Q5_0/Q5_1, Q8_0, and the K-quants Q4_K/Q6_K) to float, maps llama.cpp
tensor names onto the HF layout, rebuilds the tokenizer from the metadata,
and hands the tensors to `convert/hf.py` `convert_hf`, which quantizes
them on its device. Parsing a file format is host work: the block decoders
are numpy, as in the JAX package. The file is mapped, not read into memory;
the decoded arrays of F32 / integer tensors are views of the map, which
they keep alive.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, Tuple

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF"

# ggml tensor types (ggml.h)
F32, F16 = 0, 1
Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1 = 2, 3, 6, 7, 8, 9
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_K = 10, 11, 12, 13, 14, 15
I8, I16, I32, I64, F64 = 24, 25, 26, 27, 28
BF16 = 30

_QK = 32      # elements per simple quant block
_QK_K = 256   # elements per K-quant super-block

# (block bytes, elements per block)
_TYPE_SIZES = {
    F32: (4, 1), F16: (2, 1), BF16: (2, 1), F64: (8, 1),
    I8: (1, 1), I16: (2, 1), I32: (4, 1), I64: (8, 1),
    Q4_0: (18, _QK), Q4_1: (20, _QK), Q5_0: (22, _QK), Q5_1: (24, _QK),
    Q8_0: (34, _QK),
    Q4_K: (144, _QK_K), Q6_K: (210, _QK_K),
}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.p = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.p)
        self.p += struct.calcsize("<" + fmt)
        return vals[0] if len(vals) == 1 else vals

    def string(self) -> str:
        n = self.read("Q")
        s = self.buf[self.p: self.p + n].decode("utf-8", "replace")
        self.p += n
        return s

    def value(self, vtype: int):
        scalar = {0: "B", 1: "b", 2: "H", 3: "h", 4: "I", 5: "i", 6: "f",
                  7: "?", 10: "Q", 11: "q", 12: "d"}
        if vtype in scalar:
            return self.read(scalar[vtype])
        if vtype == 8:
            return self.string()
        if vtype == 9:  # array: [elem type u32][len u64][elems]
            et = self.read("I")
            n = self.read("Q")
            return [self.value(et) for _ in range(n)]
        raise ValueError(f"gguf: unknown kv type {vtype}")


def _f16(u: np.ndarray) -> np.ndarray:
    return u.view(np.float16).astype(np.float32)


# -- dequantizers: raw block bytes [n_blocks, block_bytes] -> [n_blocks, elems]

def _dq_q4_0(b):
    d = _f16(b[:, 0:2].copy().view(np.uint16))           # [n, 1]
    q = b[:, 2:18]
    lo = (q & 0x0F).astype(np.int8) - 8
    hi = (q >> 4).astype(np.int8) - 8
    return d * np.concatenate([lo, hi], 1).astype(np.float32)


def _dq_q4_1(b):
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    m = _f16(b[:, 2:4].copy().view(np.uint16))
    q = b[:, 4:20]
    lo, hi = (q & 0x0F), (q >> 4)
    return d * np.concatenate([lo, hi], 1).astype(np.float32) + m


def _dq_q5_0(b):
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    qh = b[:, 2:6].copy().view(np.uint32)                # [n, 1]
    q = b[:, 6:22]
    bits = ((qh >> np.arange(32, dtype=np.uint32)[None]) & 1).astype(np.uint8)
    lo = (q & 0x0F) | (bits[:, :16] << 4)
    hi = (q >> 4) | (bits[:, 16:] << 4)
    vals = np.concatenate([lo, hi], 1).astype(np.int16) - 16
    return d * vals.astype(np.float32)


def _dq_q5_1(b):
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    m = _f16(b[:, 2:4].copy().view(np.uint16))
    qh = b[:, 4:8].copy().view(np.uint32)
    q = b[:, 8:24]
    bits = ((qh >> np.arange(32, dtype=np.uint32)[None]) & 1).astype(np.uint8)
    lo = (q & 0x0F) | (bits[:, :16] << 4)
    hi = (q >> 4) | (bits[:, 16:] << 4)
    return d * np.concatenate([lo, hi], 1).astype(np.float32) + m


def _dq_q8_0(b):
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    q = b[:, 2:34].copy().view(np.int8)
    return d * q.astype(np.float32)


def _dq_q4_k(b):
    """Q4_K super-block: d f16, dmin f16, 12B packed 6-bit scales/mins for 8
    sub-blocks of 32, 128B nibbles (llama.cpp get_scale_min_k4 layout)."""
    n = b.shape[0]
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    dmin = _f16(b[:, 2:4].copy().view(np.uint16))
    sc_b = b[:, 4:16].astype(np.uint16)
    qs = b[:, 16:144]
    scales = np.empty((n, 8), np.float32)
    mins = np.empty((n, 8), np.float32)
    for j in range(8):
        if j < 4:
            sc = sc_b[:, j] & 63
            mn = sc_b[:, j + 4] & 63
        else:
            sc = (sc_b[:, j + 4] & 0x0F) | ((sc_b[:, j - 4] >> 6) << 4)
            mn = (sc_b[:, j + 4] >> 4) | ((sc_b[:, j] >> 6) << 4)
        scales[:, j] = sc
        mins[:, j] = mn
    out = np.empty((n, 256), np.float32)
    # nibbles: 4 chunks of 32 bytes; each chunk -> sub-blocks (2k, 2k+1)
    for k in range(4):
        chunk = qs[:, 32 * k: 32 * (k + 1)]
        out[:, 64 * k: 64 * k + 32] = (
            d * scales[:, 2 * k: 2 * k + 1] * (chunk & 0x0F)
            - dmin * mins[:, 2 * k: 2 * k + 1])
        out[:, 64 * k + 32: 64 * k + 64] = (
            d * scales[:, 2 * k + 1: 2 * k + 2] * (chunk >> 4)
            - dmin * mins[:, 2 * k + 1: 2 * k + 2])
    return out


def _dq_q6_k(b):
    """Q6_K: ql[128] low nibbles, qh[64] 2-bit highs, 16 int8 sub-scales,
    d f16; q = (low | high<<4) - 32 over two 128-element halves."""
    n = b.shape[0]
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210].copy().view(np.uint16))
    q = np.empty((n, 256), np.int16)
    for half in range(2):
        lo = ql[:, 64 * half: 64 * (half + 1)].astype(np.int16)
        hi = qh[:, 32 * half: 32 * (half + 1)].astype(np.int16)
        base = 128 * half
        q[:, base + 0: base + 32] = ((lo[:, :32] & 0x0F)
                                     | ((hi >> 0 & 3) << 4)) - 32
        q[:, base + 32: base + 64] = ((lo[:, 32:] & 0x0F)
                                      | ((hi >> 2 & 3) << 4)) - 32
        q[:, base + 64: base + 96] = ((lo[:, :32] >> 4)
                                      | ((hi >> 4 & 3) << 4)) - 32
        q[:, base + 96: base + 128] = ((lo[:, 32:] >> 4)
                                       | ((hi >> 6 & 3) << 4)) - 32
    out = q.astype(np.float32)
    for j in range(16):
        out[:, 16 * j: 16 * (j + 1)] *= sc[:, j: j + 1]
    return d * out


_DEQUANT = {Q4_0: _dq_q4_0, Q4_1: _dq_q4_1, Q5_0: _dq_q5_0, Q5_1: _dq_q5_1,
            Q8_0: _dq_q8_0, Q4_K: _dq_q4_k, Q6_K: _dq_q6_k}


def decode_tensor(raw: np.ndarray, ggml_type: int,
                  shape: Tuple[int, ...]) -> np.ndarray:
    """raw uint8 bytes -> float32/int array with ggml's row-major-in-
    reversed-dims convention (dims stored innermost-first)."""
    n_elems = int(np.prod(shape))
    if ggml_type == F32:
        return raw.view(np.float32)[:n_elems].reshape(shape[::-1])
    if ggml_type == F16:
        return raw.view(np.float16)[:n_elems].astype(np.float32
                                                     ).reshape(shape[::-1])
    if ggml_type == BF16:
        return (raw.view(np.uint16)[:n_elems].astype(np.uint32) << 16
                ).view(np.float32).reshape(shape[::-1])
    if ggml_type in (I8, I16, I32, I64, F64):
        dt = {I8: np.int8, I16: np.int16, I32: np.int32, I64: np.int64,
              F64: np.float64}[ggml_type]
        return raw.view(dt)[:n_elems].reshape(shape[::-1])
    if ggml_type not in _DEQUANT:
        raise NotImplementedError(f"gguf tensor type {ggml_type}")
    bsz, belems = _TYPE_SIZES[ggml_type]
    blocks = raw[: (n_elems // belems) * bsz].reshape(-1, bsz)
    return _DEQUANT[ggml_type](blocks).reshape(shape[::-1]
                                               ).astype(np.float32)


def read_gguf(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """-> (metadata kv dict, {tensor name: float/int array [rows, cols]})."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    r = _Reader(buf)
    magic, version = r.read("I"), r.read("I")
    if magic != GGUF_MAGIC:
        raise ValueError("not a GGUF file")
    if version < 2:
        raise ValueError(f"gguf version {version} unsupported (need >= 2)")
    n_tensors = r.read("Q")
    n_kv = r.read("Q")
    meta: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.read("I")
        meta[key] = r.value(vtype)

    infos = []
    for _ in range(n_tensors):
        name = r.string()
        nd = r.read("I")
        dims = tuple(r.read("Q") for _ in range(nd))
        ttype = r.read("I")
        off = r.read("Q")
        infos.append((name, dims, ttype, off))

    align = int(meta.get("general.alignment", 32))
    data0 = (r.p + align - 1) // align * align
    tensors = {}
    for name, dims, ttype, off in infos:
        n_elems = int(np.prod(dims))
        bsz, belems = _TYPE_SIZES.get(ttype, (None, None))
        if bsz is None:
            raise NotImplementedError(f"gguf tensor type {ttype} ({name})")
        nbytes = n_elems // belems * bsz
        raw = np.frombuffer(buf, np.uint8, nbytes, data0 + off)
        tensors[name] = decode_tensor(raw, ttype, dims)
    return meta, tensors


# ---------------------------------------------------------------------------
# llama.cpp -> HF mapping

_NAME_MAP = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output_norm.weight": "model.norm.weight",
    "output.weight": "lm_head.weight",
}
_BLK_MAP = {
    "attn_q": "self_attn.q_proj", "attn_k": "self_attn.k_proj",
    "attn_v": "self_attn.v_proj", "attn_output": "self_attn.o_proj",
    "ffn_gate": "mlp.gate_proj", "ffn_up": "mlp.up_proj",
    "ffn_down": "mlp.down_proj",
    "attn_norm": "input_layernorm", "ffn_norm": "post_attention_layernorm",
    "attn_q_norm": "self_attn.q_norm", "attn_k_norm": "self_attn.k_norm",
}


def _unpermute(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Undo llama.cpp's rope permutation. llama.cpp stores Q/K as
    `w.reshape(heads, 2, hd/2, in).swapaxes(1, 2)` of the HF layout
    (interleaving the two rope halves); the inverse regroups pairs back
    into contiguous halves."""
    out_dim, in_dim = w.shape
    hd = out_dim // n_heads
    return (w.reshape(n_heads, hd // 2, 2, in_dim)
            .transpose(0, 2, 1, 3).reshape(out_dim, in_dim))


def gguf_to_hf(path: str, return_meta: bool = False):
    """Read a llama-architecture GGUF -> (HF-style config dict,
    HF-named float tensor dict[, raw metadata])."""
    meta, tensors = read_gguf(path)
    arch = meta.get("general.architecture", "llama")

    def mkey(suffix, default=None):
        return meta.get(f"{arch}.{suffix}", default)

    n_heads = int(mkey("attention.head_count"))
    n_kv = int(mkey("attention.head_count_kv", n_heads))
    arch_map = {"llama": "LlamaForCausalLM",
                "qwen2": "Qwen2ForCausalLM",
                "qwen3": "Qwen3ForCausalLM",
                "mistral": "MistralForCausalLM"}
    if arch not in arch_map:
        raise NotImplementedError(
            f"gguf architecture {arch!r} not supported (have "
            f"{sorted(arch_map)}); converting from the HF checkpoint "
            "instead preserves exact semantics")
    scaling = mkey("rope.scaling.type")
    if scaling not in (None, "none"):
        raise NotImplementedError(
            f"gguf rope scaling type {scaling!r} unsupported; convert "
            "from the HF checkpoint")
    if "rope_freqs.weight" in tensors:
        # llama.cpp bakes Llama-3.x rope rescaling into a rope_freqs
        # tensor; silently dropping it would alias long positions
        raise NotImplementedError(
            "this GGUF carries a rope_freqs tensor (Llama-3.x rope "
            "scaling baked by llama.cpp); convert from the HF checkpoint "
            "so rope_scaling is applied exactly")
    hf_cfg = {
        "architectures": [arch_map[arch]],
        "vocab_size": int(meta.get("tokenizer.ggml.tokens") and
                          len(meta["tokenizer.ggml.tokens"]) or
                          mkey("vocab_size", 32000)),
        "hidden_size": int(mkey("embedding_length")),
        "intermediate_size": int(mkey("feed_forward_length")),
        "num_hidden_layers": int(mkey("block_count")),
        "num_attention_heads": n_heads,
        "num_key_value_heads": n_kv,
        "max_position_embeddings": int(mkey("context_length", 4096)),
        "rope_theta": float(mkey("rope.freq_base", 10000.0)),
        "rms_norm_eps": float(mkey("attention.layer_norm_rms_epsilon", 1e-5)),
        "tie_word_embeddings": "output.weight" not in tensors,
    }
    hidden = hf_cfg["hidden_size"]
    head_dim = int(mkey("attention.key_length", hidden // n_heads))
    hf_cfg["head_dim"] = head_dim
    permute = arch in ("llama", "mistral")  # llama.cpp permutes rope dims

    out = {}
    for name, arr in tensors.items():
        if name in _NAME_MAP:
            out[_NAME_MAP[name]] = np.asarray(arr, np.float32)
            continue
        if not name.startswith("blk."):
            continue  # tokenizer / rope freq tensors
        _, idx, rest = name.split(".", 2)
        part, kind = rest.rsplit(".", 1)
        hf_part = _BLK_MAP.get(part)
        if hf_part is None:
            raise NotImplementedError(f"gguf tensor {name}")
        arr = np.asarray(arr, np.float32)
        if kind == "weight" and permute and arr.ndim == 2:
            if part == "attn_q":
                arr = _unpermute(arr, n_heads)
            elif part == "attn_k":
                arr = _unpermute(arr, n_kv)
        out[f"model.layers.{idx}.{hf_part}.{kind}"] = arr
    if return_meta:
        return hf_cfg, out, meta
    return hf_cfg, out


# llama.cpp token_type values (llama.h llama_token_type)
_TT_NORMAL, _TT_UNKNOWN, _TT_CONTROL = 1, 2, 3
_TT_USER_DEFINED, _TT_UNUSED, _TT_BYTE = 4, 5, 6


def reconstruct_tokenizer(meta: Dict[str, Any], out_dir: str) -> bool:
    """Rebuild HF-format tokenizer files from `tokenizer.ggml.*` metadata.

    Without this, a GGUF-only convert silently degrades to the byte
    tokenizer and produces garbage text. Emits `tokenizer.json` (BPE for the "gpt2"
    model, Unigram for "llama"/sentencepiece) + `tokenizer_config.json`
    (bos/eos + chat template) beside the checkpoint so
    runtime/tokenizer.load_tokenizer picks them up. Returns False when the
    file carries no vocabulary.
    """
    import json
    import os

    tokens = meta.get("tokenizer.ggml.tokens")
    if not tokens:
        return False
    model = meta.get("tokenizer.ggml.model", "gpt2")
    types = meta.get("tokenizer.ggml.token_type") or [_TT_NORMAL] * len(tokens)
    scores = meta.get("tokenizer.ggml.scores")
    merges = meta.get("tokenizer.ggml.merges")

    added = [
        {"id": i, "content": tok, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, (tok, tt) in enumerate(zip(tokens, types))
        if tt in (_TT_CONTROL, _TT_UNKNOWN)
    ]

    if model in ("llama", "spm"):
        # sentencepiece -> HF Unigram with byte fallback; GGUF stores the
        # "▁"-space convention and <0xNN> byte pieces directly
        vocab = [
            [tok, float(scores[i]) if scores else 0.0]
            for i, tok in enumerate(tokens)
        ]
        unk_id = int(meta.get("tokenizer.ggml.unknown_token_id", 0))
        tok_json = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": added,
            "normalizer": {
                "type": "Sequence",
                "normalizers": [
                    {"type": "Prepend", "prepend": "▁"},
                    {"type": "Replace",
                     "pattern": {"String": " "}, "content": "▁"},
                ],
            },
            "pre_tokenizer": None,
            "post_processor": None,
            "decoder": {
                "type": "Sequence",
                "decoders": [
                    {"type": "Replace",
                     "pattern": {"String": "▁"}, "content": " "},
                    {"type": "ByteFallback"},
                    {"type": "Fuse"},
                    {"type": "Strip", "content": " ", "start": 1, "stop": 0},
                ],
            },
            "model": {
                "type": "Unigram",
                "unk_id": unk_id,
                "vocab": vocab,
                "byte_fallback": True,
            },
        }
    else:
        # byte-level BPE ("gpt2"): tokens are already in the byte-level
        # alphabet; merges come straight from the metadata
        vocab = {tok: i for i, tok in enumerate(tokens)}
        tok_json = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {
                "type": "ByteLevel", "add_prefix_space": False,
                "trim_offsets": True, "use_regex": True,
            },
            "post_processor": {
                "type": "ByteLevel", "add_prefix_space": False,
                "trim_offsets": False, "use_regex": True,
            },
            "decoder": {
                "type": "ByteLevel", "add_prefix_space": False,
                "trim_offsets": True, "use_regex": True,
            },
            "model": {
                "type": "BPE",
                "dropout": None,
                "unk_token": None,
                "continuing_subword_prefix": "",
                "end_of_word_suffix": "",
                "fuse_unk": False,
                "byte_fallback": False,
                "vocab": vocab,
                "merges": [m for m in (merges or [])],
            },
        }

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump(tok_json, f, ensure_ascii=False)

    cfg: Dict[str, Any] = {"tokenizer_class": "PreTrainedTokenizerFast"}
    for key, name in (("bos_token_id", "bos_token"),
                      ("eos_token_id", "eos_token"),
                      ("padding_token_id", "pad_token"),
                      ("unknown_token_id", "unk_token")):
        tid = meta.get(f"tokenizer.ggml.{key}")
        if tid is not None and 0 <= int(tid) < len(tokens):
            cfg[name] = tokens[int(tid)]
    if meta.get("tokenizer.ggml.add_bos_token") is not None:
        cfg["add_bos_token"] = bool(meta["tokenizer.ggml.add_bos_token"])
    tmpl = meta.get("tokenizer.chat_template")
    if tmpl:
        cfg["chat_template"] = tmpl
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f, ensure_ascii=False)
    return True


def convert_gguf(path: str, out_dir: str, **convert_kwargs):
    """GGUF -> quantized checkpoint directory (requantized on this
    package's grid; `convert_kwargs` as `convert_hf` takes them, `device`
    included). Also rebuilds the tokenizer from the metadata (vocab, merges,
    special tokens, chat template), so the converted model chats without the
    original HF files. Returns `convert_hf`'s (config, params)."""
    from mnn_tpu_torch.convert.hf import convert_hf

    hf_cfg, tensors, meta = gguf_to_hf(path, return_meta=True)
    out = convert_hf(None, out_dir, hf_config=hf_cfg, tensors=tensors,
                     **convert_kwargs)
    reconstruct_tokenizer(meta, out_dir)
    return out
