"""Model + runtime configuration (a copy of the JAX package's
`models/config.py`).

The port keeps its own copy so that it imports nothing from the JAX
package. `ModelConfig`, `RuntimeConfig`, `PRESETS` and
`_parse_rope_scaling` are field-for-field the same as the reference's, so
a configuration means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture description."""

    name: str = "custom"
    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_bias: bool = True   # qwen2 uses qkv bias
    qk_norm: bool = False         # qwen3 per-head RMSNorm on q/k
    max_position_embeddings: int = 32768
    # long-context handling (reference CPUAttention sliding window + sink)
    sliding_window: int = 0        # 0 = full attention
    attention_sink: int = 0        # always-visible prefix positions
    # Llama-3.x rope frequency rescale (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings); None = plain rope
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    # Multimodal rope (qwen2-vl/omni "mrope"): frequency-band split among
    # (temporal, height, width) position components. None = 1D rope. The
    # reference computes this inside its RoPE execution for Omni models
    # (transformers/llm/engine/src/omni.cpp mrope position ids).
    mrope_section: Optional[Tuple[int, ...]] = None
    # Gemma-family knobs. RMSNorm's (1 + w) offset is baked into the stored
    # weights at conversion, so no runtime flag is needed for it.
    mlp_act: str = "silu"          # "gelu_tanh" (gemma) | "silu"
    embed_scale: bool = False      # multiply embeddings by sqrt(hidden)
    sandwich_norm: bool = False    # gemma2/3: norms AFTER each sublayer too
    attn_softcap: float = 0.0      # gemma2: tanh softcap on attn scores
    final_softcap: float = 0.0     # gemma2: tanh softcap on logits
    query_scale: float = 0.0       # 0 = 1/sqrt(head_dim); gemma2 overrides
    swa_every_other: bool = False  # gemma2: even layers use sliding window
    # gemma3: every swa_pattern-th layer ((i+1) % p == 0) is GLOBAL (full
    # attention + rope_theta); the rest slide with rope_local_theta
    swa_pattern: int = 0
    rope_local_theta: float = 0.0
    # Hadamard-rotate Q/K/V per head dim before the (quantized) KV cache —
    # the WHT half of the reference's TurboQuant TQ3/TQ4
    # (source/backend/cpu/compute/TurboQuant.hpp:5-24). Scores are exactly
    # invariant (H orthonormal); quantization error drops because rotation
    # flattens per-channel outliers. Attention output is un-rotated.
    kv_rotate: bool = False
    # MoE (0 experts = dense). Mirrors qwen2/3-moe HF config fields.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0  # qwen2-moe shared expert
    norm_topk_prob: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def from_hf_config(cls, d: dict, name: str = "custom") -> "ModelConfig":
        """Build from a HuggingFace config.json dict (qwen2/qwen3/llama)."""
        head_dim = d.get("head_dim") or d["hidden_size"] // d["num_attention_heads"]
        arch = (d.get("architectures") or [""])[0].lower()
        gemma = "gemma" in arch
        gemma3 = "gemma3" in arch
        swa_pattern = 0
        rope_local_theta = 0.0
        if gemma3:
            # dual rope theta + N:1 sliding/full pattern (HF layer_types or
            # sliding_window_pattern; every p-th layer is full attention)
            lt = d.get("layer_types")
            if lt:
                fulls = [i for i, t in enumerate(lt) if t == "full_attention"]
                swa_pattern = (fulls[0] + 1) if fulls else len(lt) + 1
                # BOTH directions: every full layer at a periodic position
                # AND every periodic position full — else e.g.
                # fulls=[2,5,11] would silently treat layer 8 as global
                want = {i for i in range(len(lt))
                        if (i + 1) % swa_pattern == 0}
                if set(fulls) != want:
                    raise NotImplementedError(
                        "irregular gemma3 layer_types (non-periodic "
                        "full-attention layers)")
            else:
                swa_pattern = int(d.get("sliding_window_pattern") or 6)
            rope_local_theta = float(d.get("rope_local_base_freq", 10000.0))
        return cls(
            name=name,
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=head_dim,
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=d.get("tie_word_embeddings", gemma),
            attention_bias=d.get("attention_bias", "qwen2" in arch),
            qk_norm="qwen3" in arch or gemma3,
            max_position_embeddings=d.get("max_position_embeddings", 32768),
            sliding_window=(d.get("sliding_window") or 0)
            if (d.get("use_sliding_window") or "mistral" in arch
                or "phi3" in arch or "gemma2" in arch or gemma3) else 0,
            mlp_act="gelu_tanh"
            if d.get("hidden_act", d.get("hidden_activation",
                                         "silu")).startswith("gelu")
            or gemma else "silu",
            embed_scale=gemma,
            sandwich_norm="gemma2" in arch or "gemma3" in arch,
            attn_softcap=d.get("attn_logit_softcapping") or 0.0,
            final_softcap=d.get("final_logit_softcapping") or 0.0,
            query_scale=(d["query_pre_attn_scalar"] ** -0.5)
            if d.get("query_pre_attn_scalar") else 0.0,
            swa_every_other="gemma2" in arch,
            swa_pattern=swa_pattern,
            rope_local_theta=rope_local_theta,
            rope_scaling=_parse_rope_scaling(d.get("rope_scaling")),
            mrope_section=tuple((d.get("rope_scaling") or {}).get(
                "mrope_section")) if (d.get("rope_scaling") or {}).get(
                "mrope_section") else None,
            num_experts=d.get("num_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            moe_intermediate_size=d.get("moe_intermediate_size", 0),
            shared_expert_intermediate_size=d.get(
                "shared_expert_intermediate_size", 0),
            norm_topk_prob=d.get("norm_topk_prob", True),
        )


# Presets matching the driver configs (BASELINE.json) — dims from the public
# HF configs of each family.
PRESETS = {
    "qwen2-0.5b": ModelConfig(
        name="qwen2-0.5b", vocab_size=151936, hidden_size=896,
        intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
        head_dim=64, tie_word_embeddings=True, attention_bias=True,
    ),
    "qwen2-1.5b": ModelConfig(
        name="qwen2-1.5b", vocab_size=151936, hidden_size=1536,
        intermediate_size=8960, num_layers=28, num_heads=12, num_kv_heads=2,
        head_dim=128, tie_word_embeddings=True, attention_bias=True,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, tie_word_embeddings=False, attention_bias=True,
    ),
    "qwen3-0.6b": ModelConfig(
        name="qwen3-0.6b", vocab_size=151936, hidden_size=1024,
        intermediate_size=3072, num_layers=28, num_heads=16, num_kv_heads=8,
        head_dim=128, tie_word_embeddings=True, attention_bias=False,
        qk_norm=True,
    ),
    "llama3.2-1b": ModelConfig(
        name="llama3.2-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500000.0, tie_word_embeddings=True,
        attention_bias=False, rope_scaling=(32.0, 1.0, 4.0, 8192),
    ),
    "llama3.2-3b": ModelConfig(
        name="llama3.2-3b", vocab_size=128256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, tie_word_embeddings=True,
        attention_bias=False, rope_scaling=(32.0, 1.0, 4.0, 8192),
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=10000.0, tie_word_embeddings=False,
        attention_bias=False, sliding_window=4096,
    ),
    # driver config 5 (MoE): Qwen1.5-MoE-A2.7B (60 experts top-4 + shared)
    # and Qwen3-30B-A3B (128 experts top-8, qk-norm) — dims from the public
    # HF configs
    "qwen1.5-moe-a2.7b": ModelConfig(
        name="qwen1.5-moe-a2.7b", vocab_size=151936, hidden_size=2048,
        intermediate_size=5632, num_layers=24, num_heads=16, num_kv_heads=16,
        head_dim=128, rope_theta=1000000.0, tie_word_embeddings=False,
        attention_bias=True, num_experts=60, num_experts_per_tok=4,
        moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
        norm_topk_prob=False,
    ),
    # gemma2-2b (public HF config): gelu MLP, sandwich norms, score/logit
    # softcaps, alternating sliding-window layers, 256-wide heads
    "gemma2-2b": ModelConfig(
        name="gemma2-2b", vocab_size=256000, hidden_size=2304,
        intermediate_size=9216, num_layers=26, num_heads=8, num_kv_heads=4,
        head_dim=256, rope_theta=10000.0, tie_word_embeddings=True,
        attention_bias=False, sliding_window=4096, mlp_act="gelu_tanh",
        embed_scale=True, sandwich_norm=True, attn_softcap=50.0,
        final_softcap=30.0, query_scale=256.0 ** -0.5,
        swa_every_other=True,
    ),
    # gemma3-4b (public HF config): 5:1 sliding/full layer pattern with
    # dual rope theta (1M global / 10k local), qk-norm, sandwich norms,
    # gelu MLP, 256-wide heads, no score softcap (unlike gemma2)
    "gemma3-4b": ModelConfig(
        name="gemma3-4b", vocab_size=262208, hidden_size=2560,
        intermediate_size=10240, num_layers=34, num_heads=8, num_kv_heads=4,
        head_dim=256, rope_theta=1000000.0, tie_word_embeddings=True,
        attention_bias=False, sliding_window=1024, mlp_act="gelu_tanh",
        embed_scale=True, sandwich_norm=True, qk_norm=True,
        query_scale=256.0 ** -0.5, swa_pattern=6, rope_local_theta=10000.0,
    ),
    "qwen3-moe-30b-a3b": ModelConfig(
        name="qwen3-moe-30b-a3b", vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, num_layers=48, num_heads=32, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, tie_word_embeddings=False,
        attention_bias=False, qk_norm=True, num_experts=128,
        num_experts_per_tok=8, moe_intermediate_size=768,
        norm_topk_prob=True,
    ),
    # tiny config for tests (CPU interpret mode friendly)
    "tiny": ModelConfig(
        name="tiny", vocab_size=256, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
        tie_word_embeddings=True, attention_bias=True,
    ),
}


def _parse_rope_scaling(rs) -> Optional[Tuple[float, float, float, int]]:
    """HF rope_scaling dict -> static tuple (llama3 rule only; linear/yarn
    unsupported -> error rather than silently wrong positions)."""
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind in ("default", "mrope"):  # mrope carried via mrope_section
        return None
    if kind == "linear":  # gemma3 global rope: all freqs / factor
        return (float(rs["factor"]), 0.0, 0.0, -1)
    if kind != "llama3":
        raise ValueError(f"unsupported rope_scaling type: {kind}")
    return (
        float(rs["factor"]),
        float(rs.get("low_freq_factor", 1.0)),
        float(rs.get("high_freq_factor", 4.0)),
        int(rs.get("original_max_position_embeddings", 8192)),
    )


@dataclasses.dataclass
class RuntimeConfig:
    """Runtime knobs (≈ MNN-LLM config.json subset, llmconfig.hpp)."""

    quant_bits: int = 4            # quant_bit
    quant_block: int = 128         # quant_block
    quant_sym: bool = False        # sym
    act_bits: int = 16             # 8 = dynamic int8 activations (W4A8)
    lm_head_bits: int = 0          # quantized output projection (0 = bf16;
                                   # int8 halves head HBM but costs VPU casts
                                   # — wins only when HBM-capacity-bound)
    # prefill-only dynamic int8 activations (W4A8 on the int8 MXU; the
    # reference's MNNDynamicQuant + int8 GEMM prefill path). Decode keeps
    # bf16 activations — measured neutral there (HBM-bound, not MXU-bound)
    prefill_act_bits: int = 16
    kv_quant: bool = True          # attention mode quantized-KV (MNN KVCacheInfo)
    kv_bits: int = 8               # 8 = int8 KV; 4 = packed int4; 3 = TQ3
    kv_codebook: bool = False      # at kv_bits=4: TQ4 Lloyd-Max codebook
    # numerics debug: raise on NaN/Inf in any jitted computation
    # (jax_debug_nans ≈ the reference's checkInvalidValue.out /
    # MNN_DEBUG_* debug builds, tools/cpp/checkInvalidValue.cpp)
    debug_nans: bool = False
    kv_rotate: bool = False        # Hadamard-rotate KV before quantization
    max_seq_len: int = 4096        # kvcache capacity per sequence
    max_batch: int = 1
    prefill_chunk: int = 512       # chunked prefill (MNN `chunk`)
    decode_block: int = 16         # tokens decoded per device dispatch
    dtype: str = "bfloat16"
    # sampler (MNN sampler.hpp defaults)
    sampler: str = "mixed"         # greedy|temperature|topK|topP|minP|mixed
    temperature: float = 1.0
    top_k: int = 40
    top_p: float = 0.9
    min_p: float = 0.05
    penalty: float = 1.0           # repetition penalty
    penalty_ngram: int = 8
    seed: int = 0
    max_new_tokens: int = 512
    # OpenAI-style per-token additive bias {token_id: bias}; stored as a
    # tuple of (id, bias) pairs so the config stays hashable
    # (reference llmconfig.hpp:517-520)
    logit_bias: Optional[tuple] = None
    # wall-clock generation deadline, seconds; 0 = unlimited (reference
    # llm.hpp:95-103 TIMEOUT status, generate.cpp:52-56 decode-loop check)
    timeout_s: float = 0.0
    # speculative decoding (reference: speculative_decoding/generate.hpp)
    speculative: str = "none"      # none | lookahead | eagle | eagle-tree | mtp
    draft_len: int = 7
    ngram: int = 3
    tree_fanout: int = 3           # eagle-tree: K sibling chains (K x depth)

    @classmethod
    def from_json(cls, path: str) -> "RuntimeConfig":
        with open(path) as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def merge(self, **kwargs) -> "RuntimeConfig":
        return dataclasses.replace(self, **{k: v for k, v in kwargs.items() if v is not None})
