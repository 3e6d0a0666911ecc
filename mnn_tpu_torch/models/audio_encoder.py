"""Whisper-style audio encoder.

Counterpart of the JAX package's `models/audio_encoder.py`: two
convolutions over the log-mel spectrogram (the second of stride 2), exact
GELU, the fixed sinusoid positions, a pre-LN transformer stack and a final
layer norm. Weights are an f32 dict keyed by the HF `WhisperModel.encoder`
names (`from_hf_whisper_encoder`), linear weights stored [in, out] and the
convolutions [k, in, out]. Plain torch ops in the JAX package's order and
dtypes; the projections are `torch.matmul` (the reference runs plain
`jnp.dot` there, no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import attention, layer_norm, linear, t_lin, t_vec
from mnn_tpu_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    n_mels: int = 80
    hidden_size: int = 384       # whisper-tiny; base 512, small 768, large 1280
    num_layers: int = 4
    num_heads: int = 6
    ffn_size: int = 1536
    max_positions: int = 1500    # 30 s at 50 features a second


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1):
    """x [B, T, Cin], w [k, Cin, Cout] -> [B, T', Cout] (padding 1), f32
    products, the result in x's dtype."""
    out = F.conv1d(x.float().transpose(1, 2), w.float().permute(2, 1, 0),
                   stride=stride, padding=1).transpose(1, 2)
    return (out + b).to(x.dtype)


def audio_encoder_forward(p: Dict[str, torch.Tensor], cfg: AudioEncoderConfig,
                          mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, T] (whisper_fbank's features, transposed) ->
    features [B, T//2, hidden]. Inputs longer than the position table are
    cut to 2 * max_positions frames (whisper's 30-second window)."""
    if mel.shape[2] > 2 * cfg.max_positions:
        mel = mel[:, :, : 2 * cfg.max_positions]
    x = mel.transpose(1, 2)                                    # [B, T, n_mels]
    x = F.gelu(_conv1d(x, p["conv1.weight"], p["conv1.bias"]))
    x = F.gelu(_conv1d(x, p["conv2.weight"], p["conv2.bias"], stride=2))
    x = x + p["embed_positions.weight"][None, : x.shape[1]].to(x.dtype)

    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        h = layer_norm(x, p[pre + "self_attn_layer_norm.weight"],
                       p[pre + "self_attn_layer_norm.bias"])
        q = linear(h, p[pre + "self_attn.q_proj.weight"], p[pre + "self_attn.q_proj.bias"])
        k = linear(h, p[pre + "self_attn.k_proj.weight"])      # whisper: no k bias
        v = linear(h, p[pre + "self_attn.v_proj.weight"], p[pre + "self_attn.v_proj.bias"])
        o = attention(q, k, v, cfg.num_heads)
        x = x + linear(o, p[pre + "self_attn.out_proj.weight"],
                       p[pre + "self_attn.out_proj.bias"])
        h = layer_norm(x, p[pre + "final_layer_norm.weight"], p[pre + "final_layer_norm.bias"])
        h = F.gelu(linear(h, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
        x = x + linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"])

    return layer_norm(x, p["layer_norm.weight"], p["layer_norm.bias"])


def from_hf_whisper_encoder(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a HF WhisperModel (or WhisperForConditionalGeneration) encoder
    state dict, of tensors or arrays, to f32 on `device` (None: tensors stay
    on their device, arrays go to the card)."""
    out = {}
    for key, val in state_dict.items():
        if "decoder." in key or key == "proj_out.weight":
            continue
        key = key.removeprefix("model.").removeprefix("encoder.")
        if key.startswith("conv") and val.ndim == 3:
            # torch Conv1d [out, in, k] -> [k, in, out]
            out[key] = t_vec(val, device).permute(2, 1, 0).contiguous()
        elif key.endswith(".weight") and val.ndim == 2 and "embed" not in key:
            out[key] = t_lin(val, device)
        else:
            out[key] = t_vec(val, device)
    return out


def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoid table [n_pos, dim] f32 (HF's init) on
    `device` (None: the card)."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(n_pos)[:, None] * inv[None]
    return torch.from_numpy(np.concatenate([np.sin(scaled), np.cos(scaled)], 1).astype(
        np.float32)).to(resolve_device(device))


def random_hf_whisper_encoder(cfg: AudioEncoderConfig, generator: torch.Generator,
                              scale: float = 0.02) -> Dict[str, torch.Tensor]:
    """Seeded random weights of a HF WhisperModel encoder, in its names
    ("encoder." prefix) and layouts (linear [out, in], Conv1d [out, in, k]),
    f32 on the generator's device: normal(0, scale) weights and biases,
    norms 1 + normal(0, 0.1), the sinusoid position table."""
    dev = generator.device
    d, f = cfg.hidden_size, cfg.ffn_size
    n = lambda *s: torch.randn(s, generator=generator, device=dev) * scale
    norm = lambda: 1 + torch.randn((d,), generator=generator, device=dev) * 0.1
    sd = {"conv1.weight": n(d, cfg.n_mels, 3), "conv1.bias": n(d),
          "conv2.weight": n(d, d, 3), "conv2.bias": n(d),
          "embed_positions.weight": sinusoidal_positions(cfg.max_positions, d, dev),
          "layer_norm.weight": norm(), "layer_norm.bias": n(d)}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[pre + name + ".weight"] = norm()
            sd[pre + name + ".bias"] = n(d)
        for name in ("q_proj", "v_proj", "out_proj"):
            sd[pre + f"self_attn.{name}.weight"] = n(d, d)
            sd[pre + f"self_attn.{name}.bias"] = n(d)
        sd[pre + "self_attn.k_proj.weight"] = n(d, d)
        sd.update({pre + "fc1.weight": n(f, d), pre + "fc1.bias": n(f),
                   pre + "fc2.weight": n(d, f), pre + "fc2.bias": n(d)})
    return {"encoder." + k: v for k, v in sd.items()}


def init_audio_encoder_params(cfg: AudioEncoderConfig, generator: torch.Generator,
                              device=None) -> Dict[str, torch.Tensor]:
    """Random encoder weights in the encoder's own layout: those of
    `random_hf_whisper_encoder`, mapped, on `device` (None: the card)."""
    dev = resolve_device(device)
    return from_hf_whisper_encoder(random_hf_whisper_encoder(cfg, generator), dev)
