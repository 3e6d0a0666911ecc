"""Training: the loss, optimizers with their schedules, train steps.

Counterpart of `mnn_tpu/train/trainer.py`, where `jax.grad` and optax do
the work; here autograd and `torch.optim`. Two entry points, as there:

* any model: `make_train_step(loss_fn, optimizer)` differentiates every
  tensor of a parameter dict (or list);
* a quantized LLM: `make_lora_train_step(config, optimizer)` differentiates
  only the LoRA adapters. The packed base weights stay frozen; every
  projection and the quantized head run their dequant-matmul kernel inside
  its autograd node (`kernels/dequant_matmul.DequantMatmulFn`), whose
  backward is the JAX package's VJP, and attention runs in plain,
  differentiable torch ops, as the JAX trainer's XLA path does.

`make_optimizer` gives optax's optimizers as `torch.optim` ones: `sgd`
(momentum 0.9), `adam`, `adamw` (weight decay passed explicitly: torch's
default is 1e-2, optax's 1e-4, the JAX `make_optimizer`'s 0), with optax's
schedules. Update k (from 0) takes the schedule's value at count k, as
optax's `scale_by_learning_rate` does: a warmup from 0 makes the first
update zero. The optimizer works on the tensors in place; a step returns
them for the JAX signature's sake.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.models.decoder import LoraParams, Params, forward
from mnn_tpu_torch.runtime import kvcache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross entropy of logits [..., C] (any float dtype, taken in
    f32) against int labels [...]; with `label_smoothing`, against the
    one-hot target mixed with the uniform one, as the JAX function does."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    c = logits.shape[-1]
    if label_smoothing:
        onehot = torch.nn.functional.one_hot(labels.long(), c).float()
        target = onehot * (1 - label_smoothing) + label_smoothing / c
        return -(target * logp).sum(-1).mean()
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Callable:
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    `warmup_steps`, then cosine down to `end_value` by `decay_steps` (which
    includes the warmup)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine part needs decay_steps > warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable:
    """optax.exponential_decay, continuous: init * rate^(count / steps)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    return lambda count: (init_value if count <= 0
                          else init_value * decay_rate ** (count / transition_steps))


def _leaves(params) -> list:
    """The tensors of a parameter collection: a LoraParams' adapters, a
    dict's values, a list or tuple's items, or one tensor."""
    if isinstance(params, LoraParams):
        return params.tensors()
    if isinstance(params, dict):
        return [t for t in params.values() if t is not None]
    if isinstance(params, (list, tuple)):
        return [t for t in params if t is not None]
    return [params]


@dataclasses.dataclass
class OptState:
    """A torch optimizer over a collection's tensors, with the schedule's
    update count."""

    opt: torch.optim.Optimizer
    schedule: Callable
    count: int = 0

    def step(self):
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What `make_optimizer` returns: `init(params)` marks the collection's
    tensors as trainable and gives the state a train step updates (optax's
    `init`)."""

    name: str
    schedule: Callable
    weight_decay: float = 0.0

    def init(self, params) -> OptState:
        leaves = [t.requires_grad_(True) for t in _leaves(params)]
        lr = self.schedule(0)
        if self.name == "sgd":
            opt = torch.optim.SGD(leaves, lr=lr, momentum=0.9)
        elif self.name == "adam":
            opt = torch.optim.Adam(leaves, lr=lr)
        else:
            opt = torch.optim.AdamW(leaves, lr=lr, weight_decay=self.weight_decay)
        return OptState(opt, self.schedule)


def make_optimizer(
    name: str = "adamw",
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    schedule: Optional[str] = None,
    total_steps: int = 1000,
    warmup_steps: int = 0,
) -> Optimizer:
    """SGD / Adam / AdamW with a constant, "cosine" (warmup from 0, then
    cosine to 0 at `total_steps`) or "exponential" (x0.9 every tenth of
    `total_steps`) learning rate, as the JAX package configures optax."""
    if name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {name}")
    if schedule == "cosine":
        sched = warmup_cosine_decay(0.0, lr, warmup_steps, total_steps)
    elif schedule == "exponential":
        sched = exponential_decay(lr, total_steps // 10 or 1, 0.9)
    else:
        sched = lambda count: lr
    return Optimizer(name, sched, weight_decay)


def make_train_step(loss_fn: Callable, optimizer: Optimizer):
    """Any model: loss_fn(params, batch) -> scalar tensor. The step
    differentiates every tensor that `optimizer.init(params)` took and
    returns (params, opt_state, loss)."""

    def step(params, opt_state: OptState, batch):
        loss = loss_fn(params, batch)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def lm_loss(
    params: Params,
    lora: Optional[LoraParams],
    config: ModelConfig,
    tokens: torch.Tensor,        # [B, T] whole sequences: inputs and shifted targets
    cache_template=None,
) -> torch.Tensor:
    """Teacher-forced next-token loss over [B, T]: one forward over a bf16
    cache of capacity T with the logits of every position."""
    b, t = tokens.shape
    cache = cache_template or kvcache.create(
        config.num_layers, b, config.num_kv_heads, t, config.head_dim,
        quantized=False, device=tokens.device)
    logits, _ = forward(params, config, tokens, cache, all_logits=True, lora=lora)
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


def make_lora_train_step(config: ModelConfig, optimizer: Optimizer):
    """LoRA fine-tuning: step(params, lora, opt_state, tokens) -> (lora,
    opt_state, loss); only the adapters get gradients."""

    def step(params: Params, lora: LoraParams, opt_state: OptState, tokens):
        loss = lm_loss(params, lora, config, tokens)
        loss.backward()
        opt_state.step()
        return lora, opt_state, loss.detach()

    return step
