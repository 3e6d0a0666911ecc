"""Training on the port: LoRA adapters, losses, optimizers, train steps
(`lora.py`, `trainer.py`), datasets (`datasets.py`), QAT and pruning
(`compress.py`)."""

from mnn_tpu_torch.train.lora import init_lora, merge_lora
from mnn_tpu_torch.train.trainer import (
    cross_entropy_loss,
    lm_loss,
    make_lora_train_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "cross_entropy_loss", "init_lora", "lm_loss", "make_lora_train_step",
    "make_optimizer", "make_train_step", "merge_lora",
]
