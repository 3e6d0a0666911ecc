"""Diffusion on the port: schedulers, the CFG pipeline, and the SD-class
models (UNet, CLIP text encoder, AutoencoderKL VAE) loadable from diffusers
checkpoints; the counterpart of the JAX package's `diffusion/`."""

from mnn_tpu_torch.diffusion.pipeline import DiffusionPipeline
from mnn_tpu_torch.diffusion.scheduler import (SCHEDULERS, DDIMScheduler, DDPMScheduler,
                                               EulerDiscreteScheduler, Scheduler)
from mnn_tpu_torch.diffusion.sd import StableDiffusion
