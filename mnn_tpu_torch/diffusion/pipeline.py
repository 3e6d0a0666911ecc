"""Text-to-image diffusion pipeline: the classifier-free-guidance loop over
three callables.

Counterpart of the JAX package's `diffusion/pipeline.py`: a denoiser
(latent, t, cond) -> model output, an optional text encoder (prompt) ->
cond and an optional VAE decode (latent) -> image, composed with a
scheduler; a progress callback after every step. The initial latent, and
any noise a scheduler step draws, come from one CPU `torch.Generator(seed)`
through `scheduler.noise`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mnn_tpu_torch.diffusion import scheduler as sched
from mnn_tpu_torch.diffusion.scheduler import SCHEDULERS, Scheduler
from mnn_tpu_torch.kernels.common import resolve_device


class DiffusionPipeline:
    def __init__(
        self,
        denoiser: Callable,                        # (latent, t, cond) -> model_out
        text_encoder: Optional[Callable] = None,   # (prompt) -> cond
        vae_decode: Optional[Callable] = None,     # latent -> image
        scheduler: str | Scheduler = "ddim",
        latent_shape=(4, 64, 64),
        guidance_scale: float = 7.5,
        device=None,
    ):
        self.denoiser = denoiser
        self.text_encoder = text_encoder
        self.vae_decode = vae_decode
        self.scheduler = SCHEDULERS[scheduler]() if isinstance(scheduler, str) else scheduler
        self.latent_shape = latent_shape
        self.guidance_scale = guidance_scale
        self.device = resolve_device(device)

    def run(self, prompt=None, *, cond=None, uncond=None, num_steps: int = 20,
            seed: int = 0, callback: Optional[Callable[[int, torch.Tensor], None]] = None):
        """Denoise from pure noise; returns the decoded image (or the final
        latent without a VAE decode)."""
        sch = self.scheduler
        if cond is None and self.text_encoder is not None:
            cond = self.text_encoder(prompt)
            if uncond is None and self.guidance_scale > 1:
                uncond = self.text_encoder("")
        timesteps = sch.set_timesteps(num_steps)
        gen = torch.Generator().manual_seed(seed)
        latent = sched.noise(gen, (1, *self.latent_shape), self.device)
        if hasattr(sch, "sigma"):
            # Euler-discrete: the initial noise lives at sigma_max's scale
            # (scale_model_input renormalizes the denoiser's input)
            latent = latent * torch.sqrt(
                sch.sigma(sch.num_train_timesteps - 1, latent.device) ** 2 + 1)

        for i, t in enumerate(timesteps):
            t_prev = timesteps[i + 1] if i + 1 < len(timesteps) else -1
            lat_in = latent
            if hasattr(sch, "scale_model_input"):
                lat_in = sch.scale_model_input(latent, t)
            if self.guidance_scale > 1 and uncond is not None:
                out_c = self.denoiser(lat_in, t, cond)
                out_u = self.denoiser(lat_in, t, uncond)
                model_out = out_u + self.guidance_scale * (out_c - out_u)
            else:
                model_out = self.denoiser(lat_in, t, cond)
            latent = sch.step(model_out, t, t_prev, latent, gen)
            if callback is not None:
                callback(i, latent)

        if self.vae_decode is not None:
            return self.vae_decode(latent)
        return latent
