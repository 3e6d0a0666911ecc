"""Diffusion noise schedulers: DDPM, DDIM, Euler-discrete and the
flow-matching Euler sampler.

Counterpart of the JAX package's `diffusion/scheduler.py`. The tables are
built in float64 numpy and cast to f32 once, in the same order, so
`alphas_cumprod`, the timesteps and the flow-matching sigmas equal the JAX
package's bit for bit. A step is a few elementwise torch ops on the
sample's device; `t` and `t_prev` are integer timesteps, `t_prev < 0` the
last step.

Randomness: `jax.random` draws cannot be reproduced in torch. Every draw of
sampler noise here, in `sd.py`, `pipeline.py` and the talker's mel ODE goes
through `noise`: standard normal f32 from a CPU `torch.Generator`, then
moved to the device, so a seed gives the same noise on the card and on the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 noise of `shape`, drawn on the CPU from
    `generator` and moved to `device`."""
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32).to(device)


@dataclasses.dataclass
class Scheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    schedule: str = "scaled_linear"   # scaled_linear | linear
    prediction_type: str = "epsilon"  # epsilon | v_prediction

    def __post_init__(self):
        if self.schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                self.num_train_timesteps) ** 2
        else:
            betas = np.linspace(self.beta_start, self.beta_end,
                                self.num_train_timesteps)
        # the f64 cumprod, then one cast to f32, as the JAX package does
        self.alphas_cumprod = torch.from_numpy(
            np.cumprod(1.0 - betas).astype(np.float32))
        self.timesteps = None
        self._tables = {}

    def set_timesteps(self, num_steps: int) -> np.ndarray:
        step = self.num_train_timesteps // num_steps
        self.timesteps = np.arange(self.num_train_timesteps - 1, -1, -step)[
            :num_steps].astype(np.int32)
        return self.timesteps

    def _alpha(self, t, device) -> torch.Tensor:
        """alphas_cumprod[t] as a 0-d f32 tensor on `device`."""
        table = self._tables.get(device)
        if table is None:
            table = self._tables[device] = self.alphas_cumprod.to(device)
        return table[int(t)]

    def _alpha_prev(self, t_prev, device) -> torch.Tensor:
        """alphas_cumprod[t_prev], or 1 past the last step (t_prev < 0)."""
        if int(t_prev) >= 0:
            return self._alpha(t_prev, device)
        return torch.ones((), dtype=torch.float32, device=device)

    def add_noise(self, x0, noise_, t):
        a = self._alpha(t, x0.device)
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise_

    def _predict_x0(self, sample, model_out, t):
        a = self._alpha(t, sample.device)
        if self.prediction_type == "v_prediction":
            return torch.sqrt(a) * sample - torch.sqrt(1 - a) * model_out
        return (sample - torch.sqrt(1 - a) * model_out) / torch.sqrt(a)


@dataclasses.dataclass
class DDIMScheduler(Scheduler):
    eta: float = 0.0

    def step(self, model_out, t, t_prev, sample,
             generator: Optional[torch.Generator] = None):
        a_t = self._alpha(t, sample.device)
        a_prev = self._alpha_prev(t_prev, sample.device)
        x0 = self._predict_x0(sample, model_out, t)
        eps = (sample - torch.sqrt(a_t) * x0) / torch.sqrt(1 - a_t)
        sigma = self.eta * torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        dir_term = torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2, min=0.0)) * eps
        prev = torch.sqrt(a_prev) * x0 + dir_term
        if self.eta > 0 and generator is not None:
            prev = prev + sigma * noise(generator, sample.shape, sample.device)
        return prev


@dataclasses.dataclass
class DDPMScheduler(Scheduler):
    def step(self, model_out, t, t_prev, sample, generator: torch.Generator):
        a_t = self._alpha(t, sample.device)
        a_prev = self._alpha_prev(t_prev, sample.device)
        alpha = a_t / a_prev
        x0 = torch.clamp(self._predict_x0(sample, model_out, t), -1.0, 1.0)
        coef_x0 = torch.sqrt(a_prev) * (1 - alpha) / (1 - a_t)
        coef_xt = torch.sqrt(alpha) * (1 - a_prev) / (1 - a_t)
        mean = coef_x0 * x0 + coef_xt * sample
        var = (1 - a_prev) / (1 - a_t) * (1 - alpha)
        # drawn on every step, the last too, as the JAX package draws it
        z = noise(generator, sample.shape, sample.device)
        if int(t_prev) >= 0:
            return mean + torch.sqrt(torch.clamp(var, min=1e-20)) * z
        return mean


@dataclasses.dataclass
class EulerDiscreteScheduler(Scheduler):
    def sigma(self, t, device=torch.device("cpu")) -> torch.Tensor:
        a = self._alpha(t, device)
        return torch.sqrt((1 - a) / a)

    def scale_model_input(self, sample, t):
        return sample / torch.sqrt(self.sigma(t, sample.device) ** 2 + 1)

    def step(self, model_out, t, t_prev, sample, generator=None):
        s_t = self.sigma(t, sample.device)
        s_prev = (self.sigma(t_prev, sample.device) if int(t_prev) >= 0
                  else torch.zeros((), dtype=torch.float32, device=sample.device))
        # epsilon prediction: the x0 estimate, then an Euler step over sigma
        x0 = sample - s_t * model_out
        d = (sample - x0) / s_t
        return sample + d * (s_prev - s_t)


@dataclasses.dataclass
class FlowMatchEulerScheduler(Scheduler):
    """Rectified-flow / flow-matching Euler sampler (SD3 and the talker's
    mel ODE): x_s = (1 - s) x0 + s n, the model predicts v = n - x0, Euler
    steps from s = 1 to 0."""

    shift: float = 1.0  # SD3 timestep shift

    def set_timesteps(self, num_steps: int) -> np.ndarray:
        s = np.linspace(1.0, 0.0, num_steps + 1)
        if self.shift != 1.0:
            s = self.shift * s / (1 + (self.shift - 1) * s)
        self.sigmas = s.astype(np.float32)
        # integer "timesteps" for models conditioned on t in [0, T)
        self.timesteps = (s[:-1] * self.num_train_timesteps).astype(np.int32)
        return self.timesteps

    def sigma_of(self, i):
        return self.sigmas[i]

    def step_index(self, model_out, i: int, sample):
        """Euler step from sigma[i] to sigma[i + 1] (index-based API)."""
        return sample + float(self.sigmas[i + 1] - self.sigmas[i]) * model_out

    def step(self, model_out, t, t_prev, sample, generator=None):
        """The pipeline's signature: t / t_prev are integer timesteps."""
        n = np.float32(self.num_train_timesteps)
        s_t = np.float32(t) / n
        s_prev = np.maximum(np.float32(t_prev), np.float32(0)) / n
        return sample + float(s_prev - s_t) * model_out


SCHEDULERS = {
    "ddim": DDIMScheduler,
    "ddpm": DDPMScheduler,
    "euler": EulerDiscreteScheduler,
    "flow_match": FlowMatchEulerScheduler,
}
