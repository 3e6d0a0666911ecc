"""Argument handling shared by the port's `cv/` modules.

The JAX package's image functions take numpy or JAX arrays and compute on
its device. Here an image function takes a tensor or an array: with
`device` None a tensor stays on its own device and an array goes to the
card (`resolve_device`: raises when there is none). An array arrives as
JAX would hold it without 64-bit mode: float64 as f32, int64 as int32.
Host-side helpers (drawing, hulls, rectangles) read tensors back with
`host`.
"""

from __future__ import annotations

import numpy as np
import torch

from mnn_tpu_torch.kernels.common import resolve_device

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def as_image(img, device=None) -> torch.Tensor:
    """`img` (a tensor or an array) as a tensor on `device`."""
    if isinstance(img, torch.Tensor):
        return img if device is None else img.to(device)
    a = np.asarray(img)
    if a.dtype in _NARROW:
        a = a.astype(_NARROW[a.dtype])
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
