"""Image resize, with the JAX package's `jax.image.resize` arithmetic.

Counterpart of `resize` in the JAX package's `cv/geometric.py` (the rest of
`cv/` is not ported yet). Its "linear" method antialiases when it
downsamples: each axis is a matrix of triangle-kernel weights widened by the
scale factor and normalised per output pixel (JAX's `scale_and_translate`). The two
per-axis matrices are built here as JAX builds them, in f32, and applied as
two products: on the CPU this stays within 1e-6 of the 0-255 range of the
JAX resize where `F.interpolate(antialias=True)`, whose sample coordinates
round differently, misses it by more than 1e-5 (480 x 640 -> 1344 x 1792,
`tests/test_torch_vision.py`). An axis whose size does not change is left
as it is, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mnn_tpu_torch.kernels.common import resolve_device


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in_size, out_size] f32 weights of JAX's antialiased linear resize
    along one axis (`compute_weight_mat` with the triangle kernel)."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    # one rounding of (i + 0.5) * inv_scale - 0.5, as XLA's fused multiply-add
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5).double()
                * inv_scale.double() - 0.5).float()
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1 - (x / kernel_scale).abs(), min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    """Source row of each output row: floor((i + 0.5) * in / out), with the
    constants folded as XLA folds them, in_size * f32(1 / out_size), so
    that the ties fall as in JAX (20 -> 50 picks row 0 for output 2)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    scale = torch.tensor(float(in_size), dtype=torch.float32) * (one / out_size)
    off = (torch.arange(out_size, dtype=torch.float32) + 0.5) * scale
    return torch.floor(off).long().to(device)


def resize(img, size: Tuple[int, int], method: str = "bilinear", device=None):
    """Resize an [H, W] or [H, W, C] image (a tensor or an array) to size =
    (height, width) on `device`; with device None a tensor stays on its own
    device and an array goes to the card (raises when there is none).
    "bilinear" / "linear" (JAX's antialiased linear) or "nearest". Float
    math in f32; uint8 in gives uint8 out (rounded half to even, clipped to
    0..255). Returns a tensor."""
    if isinstance(img, torch.Tensor):
        x = img if device is None else img.to(device)
    else:
        x = torch.as_tensor(np.asarray(img), device=resolve_device(device))
    dtype = x.dtype
    hwc = x[..., None] if x.dim() == 2 else x
    out = hwc.float()
    h, w = size
    dev = out.device
    if method == "nearest":
        if out.shape[0] != h:
            out = out[_nearest_index(out.shape[0], h, dev)]
        if out.shape[1] != w:
            out = out[:, _nearest_index(out.shape[1], w, dev)]
    else:
        if out.shape[0] != h:
            wh = _linear_weights(out.shape[0], h, dev)
            out = torch.einsum("hwc,hH->Hwc", out, wh)
        if out.shape[1] != w:
            ww = _linear_weights(out.shape[1], w, dev)
            out = torch.einsum("hwc,wW->hWc", out, ww)
    if dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out[..., 0] if x.dim() == 2 else out
