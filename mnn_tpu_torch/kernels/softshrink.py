"""Softshrink, the plugin example kernel: y = sign(x) * max(|x| - lam, 0).

Replaces the Pallas kernel of the JAX package's plugin example
(`tests/test_plugin.py:19` `_softshrink_kernel`, `docs/plugins.md`): the
kernel a user backs an op of the ONNX, TF, TFLite or Caffe table with
through `plugin.register_op`. CUDA source: `csrc/plugin_softshrink.cu`
(bound by bytes: one 16-byte vector a thread on a grid that covers the
tensor, evict-first loads and streaming stores; the source records the
designs that were timed against it and lost).

Rounding points, JAX's: `lam` is a weak-typed Python scalar there, so it
takes x's dtype before the subtraction (bf16(lam) for bf16 x), |x| - lam is
rounded to x's dtype, and sign(x) * max(., 0) is exact, with `jnp.sign`'s
signed zero (sign(-0.0) is -0.0 in JAX, +0.0 in `torch.sign`): so both
versions write it as copysign(max(|x| - lam, 0), x). The plain version
`softshrink_plain` and the kernel round at the same points and give the
same bits. A CPU tensor takes the plain version; a CUDA tensor the kernel,
or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from mnn_tpu_torch.kernels.build import F, I, P, kernel
from mnn_tpu_torch.kernels.common import use_kernel

# int mnn_softshrink(x, y, n, lam, dtype, stream)
_KERNEL = kernel("mnn_softshrink", [P, P, ctypes.c_longlong, F, I])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softshrink_plain(x: torch.Tensor, lam: float) -> torch.Tensor:
    """sign(x) * clamp(|x| - lam, min=0) with JAX's signed zeros, lam
    rounded to x's dtype first."""
    lam_t = torch.full((), lam, dtype=x.dtype, device=x.device)   # no host copy: capturable
    return torch.copysign(torch.clamp(x.abs() - lam_t, min=0), x)


def softshrink(x: torch.Tensor, lam: float) -> torch.Tensor:
    if not use_kernel(x):
        return softshrink_plain(x, lam)
    if x.dtype not in DTYPES:
        raise TypeError(f"softshrink kernel takes f32 or bf16, got {x.dtype}")
    x = x.contiguous()
    # y at x's offset within 16 bytes, so that both take the vector path
    off = (x.data_ptr() & 15) // x.element_size()
    y = (torch.empty_like(x) if not off else
         torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[off:].view(x.shape))
    lam_x = float(torch.tensor(lam, dtype=x.dtype))      # JAX's rounding of lam
    _KERNEL(x.data_ptr(), y.data_ptr(), x.numel(), lam_x, DTYPES[x.dtype])
    return y
