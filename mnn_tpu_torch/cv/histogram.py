"""Histograms and the miscellaneous imgproc family: thresholds, integral
images, linear blend.

Counterpart of the JAX package's `cv/histogram.py`: a histogram is an
`index_add_` of f32 ones (exact integer counts below 2^24, whatever order
the card adds them in), thresholds are elementwise selects, an integral
image two cumulative sums. Functions take a tensor or an array
(`common.as_image`) and return a tensor on its device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mnn_tpu_torch.cv.common import as_image

# OpenCV threshold types
THRESH_BINARY, THRESH_BINARY_INV, THRESH_TRUNC = 0, 1, 2
THRESH_TOZERO, THRESH_TOZERO_INV = 3, 4
ADAPTIVE_THRESH_MEAN_C, ADAPTIVE_THRESH_GAUSSIAN_C = 0, 1


def calc_hist(img, channel: int = 0, bins: int = 256,
              value_range: Tuple[float, float] = (0.0, 256.0), mask=None,
              device=None) -> torch.Tensor:
    """Histogram of one channel of [H, W] or [H, W, C]: f32 counts [bins]."""
    x = as_image(img, device)
    if x.dim() == 3:
        x = x[..., channel]
    lo, hi = value_range
    idx = torch.clamp(((x.float() - lo) * bins / (hi - lo)).to(torch.int32), 0, bins - 1)
    w = torch.ones(idx.shape, dtype=torch.float32, device=x.device)
    if mask is not None:
        w = w * (as_image(mask, x.device) > 0)
    out = torch.zeros(bins, dtype=torch.float32, device=x.device)
    return out.index_add_(0, idx.reshape(-1).long(), w.reshape(-1))


def equalize_hist(img, device=None) -> torch.Tensor:
    """Global histogram equalisation of a uint8 gray image (OpenCV's rule:
    the cdf scaled from the lowest nonzero bin)."""
    x = as_image(img, device)
    h = calc_hist(x, bins=256)
    cdf = torch.cumsum(h, 0)
    total = cdf[-1]
    cdf_min = torch.min(torch.where(h > 0, cdf, torch.full_like(cdf, float("inf"))))
    lut = torch.round((cdf - cdf_min) / torch.clamp(total - cdf_min, min=1.0) * 255.0)
    lut = torch.clamp(lut, 0, 255).to(torch.uint8)
    return lut[x.long()]


def threshold(img, thresh: float, maxval: float, type_: int = THRESH_BINARY, device=None):
    src = as_image(img, device)
    x = src.float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    top = torch.full((), float(maxval), dtype=torch.float32, device=x.device)
    if type_ == THRESH_BINARY:
        out = torch.where(x > thresh, top, zero)
    elif type_ == THRESH_BINARY_INV:
        out = torch.where(x > thresh, zero, top)
    elif type_ == THRESH_TRUNC:
        out = torch.clamp(x, max=float(thresh))
    elif type_ == THRESH_TOZERO:
        out = torch.where(x > thresh, x, zero)
    elif type_ == THRESH_TOZERO_INV:
        out = torch.where(x > thresh, zero, x)
    else:
        raise ValueError(f"threshold type {type_}")
    return out.to(src.dtype)


def adaptive_threshold(img, max_value: float, adaptive_method: int, threshold_type: int,
                       block_size: int, c: float, device=None):
    """Per-pixel threshold: the local mean (or Gaussian-weighted mean) - c."""
    from mnn_tpu_torch.cv.filter import box_filter, gaussian_blur

    src = as_image(img, device)
    x = src.float()
    if adaptive_method == ADAPTIVE_THRESH_MEAN_C:
        local = box_filter(x, (block_size, block_size))
    else:
        local = gaussian_blur(x, (block_size, block_size), 0.0)
    t = local - c
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    top = torch.full((), float(max_value), dtype=torch.float32, device=x.device)
    if threshold_type == THRESH_BINARY:
        out = torch.where(x > t, top, zero)
    else:
        out = torch.where(x > t, zero, top)
    return out.to(src.dtype)


def integral(img, device=None) -> torch.Tensor:
    """Summed-area table with OpenCV's zero first row and column: [H + 1,
    W + 1(, C)], f32 (float64 for a float64 tensor)."""
    src = as_image(img, device)
    x = src if src.dtype == torch.float64 else src.float()
    s = torch.cumsum(torch.cumsum(x, 0), 1)
    h, w = s.shape[:2]
    out = torch.zeros((h + 1, w + 1) + tuple(s.shape[2:]), dtype=s.dtype, device=s.device)
    out[1:, 1:] = s
    return out


def blend_linear(src1, src2, w1, w2, device=None):
    a = as_image(src1, device).float()
    b = as_image(src2, a.device).float()
    w1 = as_image(w1, a.device).float()
    w2 = as_image(w2, a.device).float()
    if a.dim() == 3 and w1.dim() == 2:
        w1, w2 = w1[..., None], w2[..., None]
    return (a * w1 + b * w2) / (w1 + w2 + 1e-5)
