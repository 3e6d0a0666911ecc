"""Geometric image transforms: resize, crop, flip, rotate, pad, warpAffine.

Counterpart of the JAX package's `cv/geometric.py`. Functions take a tensor
or an array (`common.as_image`) and return a tensor.

`resize` keeps `jax.image.resize`'s arithmetic. Its "linear" method
antialiases when it downsamples: each axis is a matrix of triangle-kernel
weights widened by the scale factor and normalised per output pixel (JAX's
`scale_and_translate`). The two per-axis matrices are built here as JAX
builds them, in f32, and applied as two products: on the CPU this stays
within 1e-6 of the 0-255 range of the JAX resize where
`F.interpolate(antialias=True)`, whose sample coordinates round differently,
misses it by more than 1e-5 (480 x 640 -> 1344 x 1792,
`tests/test_torch_vision.py`). An axis whose size does not change is left
as it is, as in JAX.

`warp_affine` maps each output pixel through the inverse of the src -> dst
matrix (taken in float64 numpy, then f32, as the JAX package takes it) and
samples bilinearly or by the nearest pixel, the sample coordinates in f32
in the JAX package's order of operations; uint8 comes back rounded and
clipped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mnn_tpu_torch.cv.common import as_image, host


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
    x = as_image(img, device)
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


def crop(img, y: int, x: int, h: int, w: int, device=None):
    return as_image(img, device)[y:y + h, x:x + w]


def center_crop(img, size: Tuple[int, int], device=None):
    h, w = size
    x = as_image(img, device)
    top = max((x.shape[0] - h) // 2, 0)
    left = max((x.shape[1] - w) // 2, 0)
    return crop(x, top, left, h, w)


def flip(img, horizontal: bool = True, device=None):
    return as_image(img, device).flip(1 if horizontal else 0)


def rotate90(img, k: int = 1, device=None):
    return torch.rot90(as_image(img, device), k, dims=(0, 1))


def pad(img, top: int, bottom: int, left: int, right: int, value=0, device=None):
    x = as_image(img, device)
    widths = (0, 0) * (x.dim() - 2) + (left, right, top, bottom)
    return torch.nn.functional.pad(x, widths, value=value)


def get_affine_transform(center, angle_deg: float, scale: float = 1.0,
                         translate=(0.0, 0.0)) -> np.ndarray:
    """2 x 3 rotation matrix (cv2.getRotationMatrix2D semantics), f32 numpy."""
    a = np.deg2rad(angle_deg)
    alpha, beta = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy + translate[0]],
        [-beta, alpha, beta * cx + (1 - alpha) * cy + translate[1]],
    ], np.float32)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    a = np.vstack([m, [0, 0, 1]]).astype(np.float64)
    return np.linalg.inv(a)[:2].astype(np.float32)


def warp_affine(img, matrix, out_size: Tuple[int, int], method: str = "bilinear",
                fill=0.0, device=None):
    """matrix: 2 x 3 src -> dst affine; out_size = (height, width)."""
    src = as_image(img, device)
    oh, ow = out_size
    x = (src[..., None] if src.dim() == 2 else src).float()
    h, w, _ = x.shape
    dev = x.device
    inv = torch.from_numpy(_invert_affine(host(matrix))).to(dev)
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    fill_t = torch.tensor(float(fill), dtype=torch.float32, device=dev)

    if method == "nearest":
        ix = torch.round(sx).to(torch.int32)
        iy = torch.round(sy).to(torch.int32)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ix = torch.clamp(ix, 0, w - 1).long()
        iy = torch.clamp(iy, 0, h - 1).long()
        out = torch.where(valid[..., None], x[iy, ix], fill_t)
    else:
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        fx = sx - x0
        fy = sy - y0

        def sample(yy, xx):
            valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            xi = torch.clamp(xx.to(torch.int32), 0, w - 1).long()
            yi = torch.clamp(yy.to(torch.int32), 0, h - 1).long()
            return torch.where(valid[..., None], x[yi, xi], fill_t)

        out = (sample(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
               + sample(y0, x0 + 1) * (fx * (1 - fy))[..., None]
               + sample(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
               + sample(y0 + 1, x0 + 1) * (fx * fy)[..., None])

    if src.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out[..., 0] if src.dim() == 2 else out
