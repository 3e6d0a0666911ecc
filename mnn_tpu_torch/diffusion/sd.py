"""Stable Diffusion text-to-image (load, denoise loop, decode).

Counterpart of the JAX package's `diffusion/sd.py`: the CLIP text encoder,
the UNet and the VAE composed with a scheduler. Classifier-free guidance
runs as one batch-2 UNet call a step, in the order [uncond, cond], its
output cast to f32 before the guidance. Weights load from the diffusers
directory layout (unet/ text_encoder/ vae/ tokenizer/ scheduler/) through
the port's safetensors reader (`convert/stfile.py`).

The prompt is tokenized by transformers' `CLIPTokenizer` when the
directory has a tokenizer/ (transformers is imported only then, and its
absence raises); without one, by the JAX package's byte mapping. All
sampler noise comes from one CPU `torch.Generator(seed)`
(`scheduler.noise`). The image is `(img + 1) * 127.5` clipped to [0, 255]
and truncated to uint8, as the JAX package makes it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from mnn_tpu_torch.convert.stfile import StFile
from mnn_tpu_torch.diffusion import clip_text, unet as unet_lib, vae as vae_lib
from mnn_tpu_torch.diffusion import scheduler as sched
from mnn_tpu_torch.diffusion.scheduler import SCHEDULERS
from mnn_tpu_torch.kernels.common import resolve_device


def _load_safetensors(path: str, device) -> dict:
    """name -> tensor (the file's dtype) copied from the mapped file onto
    `device`."""
    with StFile(path) as f:
        return {n: f.tensor(n).to(device, copy=True) for n in f.names}


def _find_weights(subdir: str) -> str:
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    cands = [f for f in os.listdir(subdir) if f.endswith(".safetensors")]
    if not cands:
        raise FileNotFoundError(f"no .safetensors in {subdir}")
    return os.path.join(subdir, sorted(cands)[0])


def load_clip_tokenizer(tok_dir: str):
    """transformers' CLIPTokenizer from the checkpoint's tokenizer/ (its
    local vocab.json and merges.txt)."""
    from transformers import CLIPTokenizer
    return CLIPTokenizer(os.path.join(tok_dir, "vocab.json"),
                         os.path.join(tok_dir, "merges.txt"))


class StableDiffusion:
    def __init__(self, *, unet_params, unet_cfg, text_params, text_cfg, vae_params,
                 vae_cfg, tokenizer=None, scheduler="ddim", dtype=torch.bfloat16,
                 device=None):
        """Parameters (dicts of tensors) are moved to `device` (None: the
        card), their f32 tensors cast to `dtype`."""
        self.device = resolve_device(device)
        cast = lambda tree: {k: v.to(self.device, dtype if v.dtype == torch.float32
                                     else v.dtype) for k, v in tree.items()}
        self.unet_params = cast(unet_params)
        self.unet_cfg = unet_cfg
        self.text_params = cast(text_params)
        self.text_cfg = text_cfg
        self.vae_params = cast(vae_params)
        self.vae_cfg = vae_cfg
        self.tokenizer = tokenizer
        self.scheduler = SCHEDULERS[scheduler]() if isinstance(scheduler, str) else scheduler
        self.dtype = dtype
        # the VAE's spatial down-factor (8 for SD: 3 stride-2 stages)
        self.vae_scale = 2 ** (len(vae_cfg.block_out_channels) - 1)

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, scheduler="ddim", dtype=torch.bfloat16,
                        device=None):
        """Load a diffusers-format SD checkpoint directory onto `device`
        (None: the card)."""
        dev = resolve_device(device)
        with open(os.path.join(path, "unet", "config.json")) as f:
            uc = json.load(f)
        heads = uc.get("num_attention_heads") or uc.get("attention_head_dim", 8)
        if isinstance(heads, (list, tuple)):
            heads = heads[0]
        unet_cfg = unet_lib.UNetConfig(
            in_channels=uc.get("in_channels", 4),
            out_channels=uc.get("out_channels", 4),
            block_out_channels=tuple(uc["block_out_channels"]),
            cross_attn_blocks=tuple("CrossAttn" in t for t in uc["down_block_types"]),
            layers_per_block=uc.get("layers_per_block", 2),
            cross_attention_dim=uc.get("cross_attention_dim", 768),
            num_heads=int(heads),
            transformer_layers=uc.get("transformer_layers_per_block", 1),
            groups=uc.get("norm_num_groups", 32),
        )
        unet_params = unet_lib.from_diffusers(
            _load_safetensors(_find_weights(os.path.join(path, "unet")), dev))
        unet_lib.validate_params(unet_cfg, unet_params)

        with open(os.path.join(path, "vae", "config.json")) as f:
            vc = json.load(f)
        vae_cfg = vae_lib.VAEConfig(
            latent_channels=vc.get("latent_channels", 4),
            block_out_channels=tuple(vc["block_out_channels"]),
            layers_per_block=vc.get("layers_per_block", 2),
            groups=vc.get("norm_num_groups", 32),
            scaling_factor=vc.get("scaling_factor", 0.18215),
        )
        vae_params = vae_lib.from_diffusers(
            _load_safetensors(_find_weights(os.path.join(path, "vae")), dev))
        vae_lib.validate_params(vae_cfg, vae_params)

        with open(os.path.join(path, "text_encoder", "config.json")) as f:
            tc = json.load(f)
        text_cfg = clip_text.ClipTextConfig(
            vocab_size=tc.get("vocab_size", 49408),
            hidden_size=tc.get("hidden_size", 768),
            intermediate_size=tc.get("intermediate_size", 3072),
            num_layers=tc.get("num_hidden_layers", 12),
            num_heads=tc.get("num_attention_heads", 12),
            max_position_embeddings=tc.get("max_position_embeddings", 77),
            act=tc.get("hidden_act", "quick_gelu"),
            eos_token_id=tc.get("eos_token_id", 49407),
        )
        text_params = clip_text.from_hf_clip_text(
            _load_safetensors(_find_weights(os.path.join(path, "text_encoder")), dev))

        tok = None
        tok_dir = os.path.join(path, "tokenizer")
        if os.path.isdir(tok_dir):
            tok = load_clip_tokenizer(tok_dir)
        sched_cfg = {}
        sp = os.path.join(path, "scheduler", "scheduler_config.json")
        if os.path.exists(sp):
            with open(sp) as f:
                sc = json.load(f)
            sched_cfg = dict(
                num_train_timesteps=sc.get("num_train_timesteps", 1000),
                beta_start=sc.get("beta_start", 0.00085),
                beta_end=sc.get("beta_end", 0.012),
                schedule=sc.get("beta_schedule", "scaled_linear"),
                prediction_type=sc.get("prediction_type", "epsilon"),
            )
        return cls(unet_params=unet_params, unet_cfg=unet_cfg, text_params=text_params,
                   text_cfg=text_cfg, vae_params=vae_params, vae_cfg=vae_cfg,
                   tokenizer=tok, scheduler=SCHEDULERS[scheduler](**sched_cfg),
                   dtype=dtype, device=dev)

    # -- inference ----------------------------------------------------------
    def prompt_ids(self, prompt: str) -> list:
        """The prompt's ids, padded to the text encoder's positions."""
        n = self.text_cfg.max_position_embeddings
        if self.tokenizer is not None:
            return self.tokenizer(prompt, padding="max_length", max_length=n,
                                  truncation=True)["input_ids"]
        # the JAX package's byte mapping (no vocab): distinct prompts still
        # condition distinctly
        body = [b % self.text_cfg.vocab_size for b in prompt.encode()][: n - 1]
        return body + [self.text_cfg.eos_token_id] * (n - len(body))

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        ids = torch.tensor([self.prompt_ids(prompt)], dtype=torch.int64, device=self.device)
        hidden, _ = clip_text.clip_text_forward(self.text_params, self.text_cfg, ids)
        return hidden

    def denoise_step(self, latent, t, t_prev, ctx2, guidance: float,
                     generator: torch.Generator) -> torch.Tensor:
        """One CFG step: the batch-2 UNet [uncond, cond], the guidance in
        f32, the scheduler's step."""
        sch = self.scheduler
        lat_in = latent
        if hasattr(sch, "scale_model_input"):
            lat_in = sch.scale_model_input(latent, t)
        lat2 = torch.cat([lat_in, lat_in], dim=0)
        out = unet_lib.unet_forward(self.unet_params, self.unet_cfg, lat2.to(self.dtype),
                                    int(t), ctx2)
        out_u, out_c = out.float().chunk(2, dim=0)
        model_out = out_u + guidance * (out_c - out_u)
        return sch.step(model_out, t, t_prev, latent, generator)

    def txt2img(self, prompt: str, *, negative_prompt: str = "", num_steps: int = 20,
                seed: int = 0, guidance_scale: float = 7.5, height: int = 512,
                width: int = 512, callback: Optional[Callable] = None,
                output: str = "image") -> np.ndarray:
        """An HWC uint8 image (or the final f32 latent, output="latent")."""
        cond = self.encode_prompt(prompt)
        uncond = self.encode_prompt(negative_prompt)
        ctx2 = torch.cat([uncond, cond], dim=0).to(self.dtype)

        lat_shape = (1, self.unet_cfg.in_channels, height // self.vae_scale,
                     width // self.vae_scale)
        gen = torch.Generator().manual_seed(seed)
        latent = sched.noise(gen, lat_shape, self.device)
        if isinstance(self.scheduler, SCHEDULERS["euler"]):
            latent = latent * torch.sqrt(self.scheduler.sigma(
                self.scheduler.num_train_timesteps - 1, self.device) ** 2 + 1)

        timesteps = self.scheduler.set_timesteps(num_steps)
        for i, t in enumerate(timesteps):
            t_prev = timesteps[i + 1] if i + 1 < len(timesteps) else -1
            latent = self.denoise_step(latent, int(t), int(t_prev), ctx2,
                                       float(np.float32(guidance_scale)), gen)
            if callback is not None:
                callback(i, latent)

        if output == "latent":
            return latent.cpu().numpy()
        img = vae_lib.vae_decode(self.vae_params, self.vae_cfg, latent.to(self.dtype))
        img = img.float().cpu().numpy()[0].transpose(1, 2, 0)
        return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)
