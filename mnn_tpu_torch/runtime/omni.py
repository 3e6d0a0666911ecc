"""Omni: multimodal input (text + images + audio in), text and speech out.

Counterpart of the JAX package's `runtime/omni.py`:

* vision: any callable pixels [1, 3, H, W] -> [n, D_v] (`models/
  vision_encoder.py`'s CLIP, `models/qwen_vl_vision.py`'s tower), fed by
  `preprocess_image` (CLIP mean and std, 224 x 224, whatever the tower);
* audio: `audio/audio.py`'s `whisper_fbank`, then any callable mel
  [1, n_mels, T] -> [1, n, D_a] (`models/audio_encoder.py`);
* each modality's features, projected to the LLM's width, replace their
  placeholder runs in the prompt (`splice_embeds`); prefill runs over the
  bf16 embeddings (`generate.run_prefill_embeds`), then `Llm`'s decode loop
  (the whole-model kernel when it is eligible, one host read a block, the
  tail rolled back on EOS).

Positions are sequential (`cache.length + t`) for prefill and decode, as in
the JAX package. Exact Qwen2-VL mrope runs through `decoder.forward(
position_ids=...)` with `vision_encoder.build_mrope_positions`, and decode
continues at max(position) + 1 with all three components equal (the HF
convention).

Speech out: with a `models/talker.Talker` attached, `respond_mm(speak=True)`
renders the reply, as the JAX package does: the talker is conditioned on
the thinker's embedding rows of the reply (f32) and its tokens, generates
codec tokens, integrates the flow-matching mel ODE and runs the BigVGAN
vocoder; it returns (tokens, wav), the wav a 1-D f32 numpy array.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from mnn_tpu_torch.audio.audio import whisper_fbank
from mnn_tpu_torch.cv.geometric import resize
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.runtime import generate as gen
from mnn_tpu_torch.runtime.llm import Llm, PerfContext

# CLIP's normalisation
_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(image, size: int = 224, mean=_CLIP_MEAN, std=_CLIP_STD,
                     device=None) -> torch.Tensor:
    """HWC uint8 or float image -> [1, 3, size, size] normalised f32 on
    `device` (None: a tensor's own device, the card for an array; raises
    when there is none), values above 2 taken as 0..255."""
    if isinstance(image, torch.Tensor):
        x = image.float() if device is None else image.float().to(device)
    else:
        x = torch.as_tensor(np.asarray(image, np.float32), device=resolve_device(device))
    if float(x.max()) > 2.0:
        x = x / 255.0
    x = resize(x, (size, size))
    x = (x - torch.as_tensor(mean, device=x.device)) / torch.as_tensor(std, device=x.device)
    return x.permute(2, 0, 1)[None]


def splice_embeds(embedding: torch.Tensor, token_ids: Sequence[int],
                  features: List[torch.Tensor], placeholder_id: int) -> torch.Tensor:
    """Replace each run of `placeholder_id` (one run a features entry, in
    order) with that entry's rows -> [1, T', H] in the embedding's dtype."""
    return _splice_embeds_mixed(embedding, token_ids, features, placeholder_id,
                                [], placeholder_id - 10**9)


def _splice_embeds_mixed(embedding, token_ids, img_feats, img_id, aud_feats, aud_id):
    """Splice both modalities in one pass: each run of `img_id` takes the
    next image's rows, each run of `aud_id` the next audio's."""
    ids = list(token_ids)
    parts = []
    it_img, it_aud = iter(img_feats), iter(aud_feats)
    i = 0
    while i < len(ids):
        tid = ids[i]
        j = i
        if tid in (img_id, aud_id):
            while j < len(ids) and ids[j] == tid:
                j += 1
            feats = next(it_img) if tid == img_id else next(it_aud)
            parts.append(feats.to(embedding.dtype))
        else:
            while j < len(ids) and ids[j] not in (img_id, aud_id):
                j += 1
            parts.append(embedding[torch.tensor(ids[i:j], dtype=torch.int64,
                                                device=embedding.device)])
        i = j
    return torch.cat(parts, dim=0)[None]


class Omni(Llm):
    """Text + images + audio in, text (and speech through an attached
    talker) out: `Llm` with a vision and an audio tower and their
    projections into the LLM's width."""

    def __init__(self, config, params, rt=None, tokenizer=None, *,
                 vision_encode=None,       # pixels [1, 3, H, W] -> [n, D_v]
                 vision_proj: Optional[torch.Tensor] = None,   # [D_v, hidden]
                 image_token_id: int = -1,
                 audio_encode=None,        # mel [1, n_mels, T] -> [1, n, D_a]
                 audio_proj: Optional[torch.Tensor] = None,    # [D_a, hidden]
                 audio_token_id: int = -2,
                 audio_n_mels: int = 128,
                 talker=None,              # models.talker.Talker: speech out
                 device=None):
        super().__init__(config, params, rt, tokenizer=tokenizer, device=device)
        self.vision_encode = vision_encode
        self.vision_proj = vision_proj
        self.image_token_id = image_token_id
        self.audio_encode = audio_encode
        self.audio_proj = audio_proj
        self.audio_token_id = audio_token_id
        self.audio_n_mels = audio_n_mels
        self.talker = talker

    # -- modality embeddings ---------------------------------------------

    def embed_image(self, image: np.ndarray) -> torch.Tensor:
        """A raw HWC image -> projected features [n_tokens, hidden]."""
        feats = self.vision_encode(preprocess_image(image, device=self.device))
        if feats.dim() == 3:
            feats = feats[0]
        if self.vision_proj is not None:
            feats = feats.float() @ self.vision_proj
        return feats

    def embed_audio(self, wav: np.ndarray, sample_rate: int = 16000) -> torch.Tensor:
        """A waveform [n] -> projected features [n_tokens, hidden]."""
        mel = whisper_fbank(wav, sample_rate=sample_rate, n_mels=self.audio_n_mels,
                            device=self.device)
        feats = self.audio_encode(mel.t()[None])
        if feats.dim() == 3:
            feats = feats[0]
        if self.audio_proj is not None:
            feats = feats.float() @ self.audio_proj
        return feats

    # -- generation -------------------------------------------------------

    def stream_mm(self, token_ids: Sequence[int], *,
                  images: Sequence[np.ndarray] = (),
                  audios: Sequence[np.ndarray] = (),
                  max_new_tokens: Optional[int] = None) -> Iterator[int]:
        """Generate from `token_ids` holding placeholder runs
        (`image_token_id` / `audio_token_id`, one run an input, each as long
        as that input's encoded token count)."""
        rt = self.rt
        max_new = max_new_tokens or rt.max_new_tokens
        eos = getattr(self.tokenizer, "eos_ids", set())
        table = self.params.embedding
        img_feats = [self.embed_image(im) for im in images]
        aud_feats = [self.embed_audio(a) for a in audios]
        if img_feats or aud_feats:
            embeds = _splice_embeds_mixed(table, token_ids, img_feats, self.image_token_id,
                                          aud_feats, self.audio_token_id)
        else:
            embeds = table[torch.tensor(list(token_ids), dtype=torch.int64,
                                        device=table.device)][None]
        embeds = embeds.to(torch.bfloat16).expand(rt.max_batch, -1, -1)

        self.perf = PerfContext(prompt_len=embeds.shape[1])
        t0 = time.perf_counter()
        logits, cache = gen.run_prefill_embeds(self.params, self.config, rt, embeds,
                                               self.cache)
        self._sync()
        self.perf.prefill_s = time.perf_counter() - t0
        self.last_prefill_logits = logits
        yield from self._decode(logits, cache, max_new, eos, 0.0, t0)

    def respond_mm(self, token_ids, *, images=(), audios=(), max_new_tokens=None,
                   speak: bool = False):
        """The tokens of `stream_mm`, all at once; with `speak=True`, (tokens,
        wav) rendered by the attached talker (the reference's interleaved
        thinker / talker loop, run one after the other). Raises ValueError
        with no talker attached or when its `thinker_hidden` is not the
        model's hidden size."""
        out = list(self.stream_mm(token_ids, images=images, audios=audios,
                                  max_new_tokens=max_new_tokens))
        if not speak:
            return out
        if self.talker is None:
            raise ValueError("no talker attached")
        # the reply's embedding rows condition the talker (the reference
        # feeds the thinker's embeddings and hidden states; the embeddings
        # are what streaming keeps)
        table = self.params.embedding
        hidden = table[torch.tensor(out, dtype=torch.int64, device=table.device)].float()
        if hidden.shape[-1] != self.talker.cfg.thinker_hidden:
            raise ValueError("talker thinker_hidden != model hidden")
        codec = self.talker.generate_codec(hidden, thinker_tokens=out)
        wav = self.talker.token2wav(codec or [0])
        return out, wav
