"""Shared helpers for the port's kernels: the device policy and tiling math.

Counterpart of `mnn_tpu/kernels/common.py`. The JAX package picks between
a Pallas kernel, the Pallas interpreter and a pure-XLA reference by
backend. Here the tensor decides: a CPU tensor takes the kernel's plain
PyTorch version, a CUDA tensor launches the hand-written CUDA kernel or
raises. Nothing falls back from CUDA to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """Entry-point device: None means CUDA. Raises when CUDA is wanted but
    absent, so a run never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True: launch the CUDA kernel. False: run the plain version.

    All tensors must lie on one device; CPU tensors select the plain
    version, CUDA tensors the kernel."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    """Wrapper-side validation before a pointer reaches a kernel."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
