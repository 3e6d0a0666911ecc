"""Talker: speech out of Omni (codec tokens, then mel, then waveform).

Counterpart of the JAX package's `models/talker.py`:

* the codec decoder is the port's own decoder stack (`models/decoder.
  forward`) on a codec vocabulary. Its prefill runs once over the whole
  reply, neither chunked nor bucketed, over `inputs_embeds`: the f32 product
  of the thinker's hidden states and `in_proj`, plus the talker's embedding
  rows of the thinker's tokens, cast to bf16, into a bf16 cache. Then greedy
  decode, one host read a token against `codec_eos_ids`; a decode step goes
  through the whole-model kernel (its head fused) when `decode_model.
  supports()` accepts;
* codec -> mel: the flow-matching Euler sampler (`diffusion/scheduler.
  FlowMatchEulerScheduler`) over a velocity model (x, t, codec) -> v; the
  start is `scheduler.noise` of a CPU generator seeded with `seed`;
* mel -> wav: `audio/vocoder.py` (BigVGAN) in f32.

`conv_mel_denoiser` is the small convolutional velocity model the JAX
package provides for tests and random-weight runs; the talker takes any
such callable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mnn_tpu_torch.audio.vocoder import VocoderConfig, vocoder_forward
from mnn_tpu_torch.diffusion import scheduler as sched
from mnn_tpu_torch.diffusion.nn import _f32, no_tf32, silu
from mnn_tpu_torch.diffusion.scheduler import FlowMatchEulerScheduler
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.kernels.decode_model import lowest_argmax
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.decoder import forward as decoder_forward
from mnn_tpu_torch.runtime import kvcache


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    model: ModelConfig                       # the codec-vocabulary decoder stack
    thinker_hidden: int = 896                # the thinker's hidden size
    codec_eos_ids: Sequence[int] = (8292, 8294)  # the reference's stop ids
    max_new_tokens: int = 2048
    n_mels: int = 80
    mel_per_codec: int = 2                   # the reference: max_duration = 2x


@dataclasses.dataclass
class TalkerPerf:
    """The last call's times on the host clock, each ended by a host read or
    a device synchronize."""
    prompt_len: int = 0
    prefill_s: float = 0.0       # the codec prefill, to its first token's read
    codec_tokens: int = 0
    decode_s: float = 0.0
    mel_s: float = 0.0           # the flow-matching ODE
    vocoder_s: float = 0.0
    samples: int = 0

    @property
    def codec_tok_s(self) -> float:
        return self.codec_tokens / self.decode_s if self.decode_s else 0.0


class Talker:
    """Greedy codec-token generation conditioned on the thinker's hidden
    states, and its render to a waveform."""

    def __init__(self, cfg: TalkerConfig, params, in_proj, *,
                 mel_denoiser: Optional[Callable] = None, vocoder_params=None,
                 vocoder_cfg: Optional[VocoderConfig] = None, device=None):
        """`params`: decoder `Params` (codec vocabulary) on `device` (None:
        the card); `in_proj` [thinker_hidden, talker_hidden], a tensor or an
        array, taken there in f32."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.in_proj = _f32(in_proj, self.device)
        self.mel_denoiser = mel_denoiser     # (mel_t, t, codec) -> velocity
        self.vocoder_params = vocoder_params
        self.vocoder_cfg = vocoder_cfg
        self.perf = TalkerPerf()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- codec token generation -------------------------------------------
    def generate_codec(self, thinker_hidden, thinker_tokens: Optional[Sequence[int]] = None,
                       max_new: Optional[int] = None, capacity: int = 2048) -> List[int]:
        """thinker_hidden [T, thinker_hidden] -> codec token ids.

        The prefill's embeddings are proj(thinker_hidden), plus the
        talker's embedding rows of the thinker's tokens when given (the
        reference feeds both)."""
        m = self.cfg.model
        h = _f32(thinker_hidden, self.device)
        t = h.shape[0]
        self.perf = TalkerPerf(prompt_len=t)
        t0 = time.perf_counter()
        with no_tf32():
            embeds = torch.matmul(h, self.in_proj)
        if thinker_tokens is not None:
            ids = torch.as_tensor(np.asarray(thinker_tokens, np.int64) % m.vocab_size,
                                  device=self.device)
            embeds = embeds + self.params.embedding[ids].float()
        cache = kvcache.create(m.num_layers, 1, m.num_kv_heads, capacity, m.head_dim,
                               quantized=False, device=self.device)
        logits, cache = decoder_forward(
            self.params, m, torch.zeros((1, t), dtype=torch.int64, device=self.device),
            cache, inputs_embeds=embeds[None].to(torch.bfloat16))
        tok = lowest_argmax(logits)

        out: List[int] = []
        stop = set(int(i) for i in self.cfg.codec_eos_ids)
        limit = max_new or self.cfg.max_new_tokens
        t1 = None
        for _ in range(min(limit, capacity - t - 1)):
            tid = int(tok[0])                # one host read a token
            if t1 is None:
                t1 = time.perf_counter()
                self.perf.prefill_s = t1 - t0
            if tid in stop:
                break
            out.append(tid)
            (_, tok), cache = decoder_forward(self.params, m, tok[:, None].long(), cache,
                                              return_token=True)
        if t1 is not None:
            self.perf.decode_s = time.perf_counter() - t1
        self.perf.codec_tokens = len(out)
        return out

    # -- codec -> mel (flow matching) ---------------------------------------
    def codec_to_mel(self, codec_tokens: Sequence[int], *, num_steps: int = 10,
                     seed: int = 0) -> torch.Tensor:
        """Integrate the velocity field from noise to a mel chunk [1, n_mels,
        mel_per_codec * len(codec)] f32."""
        if self.mel_denoiser is None:
            raise ValueError("no mel denoiser configured")
        t_mel = self.cfg.mel_per_codec * len(codec_tokens)
        sch = FlowMatchEulerScheduler()
        sch.set_timesteps(num_steps)
        x = sched.noise(torch.Generator().manual_seed(seed), (1, self.cfg.n_mels, t_mel),
                        self.device)
        codec = torch.tensor([list(codec_tokens)], dtype=torch.int64, device=self.device)
        with no_tf32():
            for i in range(len(sch.timesteps)):
                s = torch.tensor(float(sch.sigmas[i]), dtype=torch.float32, device=self.device)
                x = sch.step_index(self.mel_denoiser(x, s, codec), i, x)
        return x

    # -- mel -> waveform ------------------------------------------------------
    def token2wav(self, codec_tokens: Sequence[int], *, num_steps: int = 10,
                  seed: int = 0) -> np.ndarray:
        """Codec tokens -> mel (the flow ODE) -> waveform, a 1-D f32 numpy
        array (the reference's `Talker::token2wav`)."""
        t0 = time.perf_counter()
        mel = self.codec_to_mel(codec_tokens, num_steps=num_steps, seed=seed)
        self._sync()
        t1 = time.perf_counter()
        self.perf.mel_s = t1 - t0
        if self.vocoder_params is None:
            raise ValueError("no vocoder configured")
        wav = vocoder_forward(self.vocoder_params, self.vocoder_cfg, mel.float())
        out = wav[0].cpu().numpy()
        self.perf.vocoder_s = time.perf_counter() - t1
        self.perf.samples = out.shape[0]
        return out


def conv_mel_denoiser(params: dict, cfg: TalkerConfig):
    """The JAX package's small convolutional velocity model: codec tokens
    embedded and repeated to the mel rate, concatenated with (x_t, t), two
    1 x 1 mixes with SiLU between. `params`: "codec_embed" [vocab, 32], "w1"
    [n_mels + 33, width], "w2" [width, n_mels], f32 on the mel's device."""

    def fn(x, t, codec):
        emb = params["codec_embed"][codec]                       # [1, Tc, 32]
        emb = emb.repeat_interleave(cfg.mel_per_codec, dim=1)   # the mel rate
        h = torch.cat([x, emb.transpose(1, 2), t.to(x.dtype).expand(x[:, :1].shape)],
                      dim=1)
        h = silu(torch.einsum("bct,cd->bdt", h, params["w1"]))
        return torch.einsum("bct,cd->bdt", h, params["w2"])

    return fn


def init_conv_mel_denoiser(cfg: TalkerConfig, codec_vocab: int, generator: torch.Generator,
                           width: int = 64, device=None) -> dict:
    """Random `conv_mel_denoiser` weights (normal * 0.1), drawn from
    `generator` on its own device and moved to `device` (None: the card)."""
    dev = resolve_device(device)
    rnd = lambda *s: (torch.randn(s, generator=generator, device=generator.device)
                      * 0.1).to(dev)
    cin = cfg.n_mels + 32 + 1
    return {"codec_embed": rnd(codec_vocab, 32), "w1": rnd(cin, width),
            "w2": rnd(width, cfg.n_mels)}
