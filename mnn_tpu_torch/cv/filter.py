"""Image filtering: blur, separable and 2-D correlation, derivatives,
morphology, pyramids, bilateral.

Counterpart of the JAX package's `cv/filter.py`. Every filter is a
depthwise `F.conv2d` over an [H, W, C] image (one group a channel) in f32,
on the image's device; borders are OpenCV's BORDER_REFLECT_101 (reflect
without repeating the edge). Erode and dilate take the min / max over the
kernel's support with +inf / -inf padding, exact in any order. Functions
take a tensor or an array (`common.as_image`) and return a tensor; the
kernel helpers return small f32 CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.cv.common import as_image, host

# getStructuringElement shapes (OpenCV / MNN enums)
MORPH_RECT, MORPH_CROSS, MORPH_ELLIPSE = 0, 1, 2


def _ensure_hwc(x: torch.Tensor):
    return (x[..., None] if x.dim() == 2 else x), x.dim() == 2


def _kernel(k, device) -> torch.Tensor:
    k = k if isinstance(k, torch.Tensor) else torch.from_numpy(np.asarray(k, np.float32))
    return k.to(device, torch.float32)


def filter2d(img, kernel, *, anchor: Optional[Tuple[int, int]] = None, device=None):
    """Correlate img [H, W(, C)] with kernel [kh, kw] (OpenCV filter2D:
    correlation, not convolution); f32 out, or the input's float dtype."""
    src = as_image(img, device)
    x, squeeze = _ensure_hwc(src)
    k = _kernel(kernel, x.device)
    kh, kw = k.shape
    c = x.shape[-1]
    xp = x.float().permute(2, 0, 1)[None]                   # [1, C, H, W]
    if kh // 2 or kw // 2:
        xp = F.pad(xp, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    out = F.conv2d(xp, k.expand(c, 1, kh, kw), groups=c)[0].permute(1, 2, 0)
    if src.is_floating_point():
        out = out.to(src.dtype)
    return out[..., 0] if squeeze else out


def sep_filter2d(img, kx, ky, device=None):
    """Separable filter: rows with kx, then columns with ky."""
    x = as_image(img, device)
    kx = _kernel(kx, x.device).reshape(-1)
    ky = _kernel(ky, x.device).reshape(-1)
    return filter2d(filter2d(x, kx[None, :]), ky[:, None])


_SMALL_GAUSS = {  # OpenCV small_gaussian_tab: fixed kernels for sigma <= 0
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def get_gaussian_kernel(n: int, sigma: float) -> torch.Tensor:
    """1-D Gaussian kernel, OpenCV getGaussianKernel semantics (sigma <= 0:
    the fixed table for n <= 7, else sigma = 0.3 ((n - 1) / 2 - 1) + 0.8),
    built in float64, one cast to f32."""
    if sigma <= 0 and n in _SMALL_GAUSS:
        return torch.tensor(_SMALL_GAUSS[n], dtype=torch.float32)
    if sigma <= 0:
        sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    xs = np.arange(n, dtype=np.float64) - (n - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def gaussian_blur(img, ksize: Tuple[int, int], sigma_x: float, sigma_y: float = 0.0,
                  device=None):
    kw, kh = ksize
    kx = get_gaussian_kernel(kw, sigma_x)
    ky = get_gaussian_kernel(kh, sigma_y if sigma_y > 0 else sigma_x)
    return sep_filter2d(img, kx, ky, device)


def box_filter(img, ksize: Tuple[int, int], normalize: bool = True, device=None):
    kw, kh = ksize
    k = torch.ones((kh, kw), dtype=torch.float32)
    if normalize:
        k = k / (kh * kw)
    return filter2d(img, k, device=device)


def blur(img, ksize: Tuple[int, int], device=None):
    return box_filter(img, ksize, normalize=True, device=device)


def sqr_box_filter(img, ksize: Tuple[int, int], normalize: bool = True, device=None):
    return box_filter(as_image(img, device).float() ** 2, ksize, normalize=normalize)


def get_deriv_kernels(dx: int, dy: int, ksize: int = 3):
    """Sobel derivative kernel pair (kx, ky), OpenCV getDerivKernels' rule:
    the order-n difference kernel convolved with binomial smoothing up to
    length `ksize` (ksize 1: the 3-point difference, no smoothing on the
    derivative axis)."""
    def k1(order):
        if order == 0:
            k = np.array([1.0])
        elif order == 1:
            k = np.array([-1.0, 0.0, 1.0])
        else:
            k = np.array([1.0, -2.0, 1.0])
            for _ in range(order - 2):
                k = np.convolve(k, np.array([-1.0, 0.0, 1.0]))
        target = 3 if ksize == 1 and order > 0 else max(ksize, 1)
        while len(k) < target:
            k = np.convolve(k, np.array([1.0, 2.0, 1.0]))
        return torch.from_numpy(k.astype(np.float32))

    return k1(dx), k1(dy)


def _scaled(out, scale: float):
    return out * scale if scale != 1.0 else out


def sobel(img, dx: int, dy: int, ksize: int = 3, scale: float = 1.0, device=None):
    kx, ky = get_deriv_kernels(dx, dy, ksize)
    return _scaled(sep_filter2d(as_image(img, device).float(), kx, ky), scale)


def scharr(img, dx: int, dy: int, scale: float = 1.0, device=None):
    kd = torch.tensor([-1.0, 0.0, 1.0])
    ks = torch.tensor([3.0, 10.0, 3.0])
    out = sep_filter2d(as_image(img, device).float(), kd if dx else ks, kd if dy else ks)
    return _scaled(out, scale)


def laplacian(img, ksize: int = 1, scale: float = 1.0, device=None):
    x = as_image(img, device)
    if ksize == 1:
        k = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=torch.float32)
        out = filter2d(x.float(), k)
    else:
        out = sobel(x, 2, 0, ksize) + sobel(x, 0, 2, ksize)
    return _scaled(out, scale)


def spatial_gradient(img, ksize: int = 3, device=None):
    x = as_image(img, device)
    return sobel(x, 1, 0, ksize), sobel(x, 0, 1, ksize)


def get_structuring_element(shape: int, ksize: Tuple[int, int]) -> torch.Tensor:
    """uint8 [kh, kw] rectangle, cross or ellipse (OpenCV's row-span rule:
    integer half-axes, the half-width of each row rounded)."""
    kw, kh = ksize
    if shape == MORPH_RECT:
        return torch.ones((kh, kw), dtype=torch.uint8)
    e = np.zeros((kh, kw), np.uint8)
    if shape == MORPH_CROSS:
        e[kh // 2, :] = 1
        e[:, kw // 2] = 1
        return torch.from_numpy(e)
    r, c = kh // 2, kw // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(kh):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * math.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            e[i, max(c - dx, 0): min(c + dx + 1, kw)] = 1
    return torch.from_numpy(e)


def _morph(img, kernel, op: str, device=None):
    """Erode / dilate: the min / max of the shifted images over the
    kernel's support, the border padded with +inf / -inf."""
    src = as_image(img, device)
    x, squeeze = _ensure_hwc(src)
    k = host(kernel) > 0
    kh, kw = k.shape
    h, w = x.shape[:2]
    fill = math.inf if op == "erode" else -math.inf
    xp = F.pad(x.float(), (0, 0, kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
               value=fill)
    red = None
    pick = torch.minimum if op == "erode" else torch.maximum
    for i in range(kh):
        for j in range(kw):
            if k[i, j]:
                win = xp[i:i + h, j:j + w]
                red = win if red is None else pick(red, win)
    red = red.to(x.dtype)
    return red[..., 0] if squeeze else red


def erode(img, kernel, device=None):
    return _morph(img, kernel, "erode", device)


def dilate(img, kernel, device=None):
    return _morph(img, kernel, "dilate", device)


def morphology_ex(img, op: str, kernel, device=None):
    """open | close | gradient | tophat | blackhat."""
    x = as_image(img, device)
    if op == "open":
        return dilate(erode(x, kernel), kernel)
    if op == "close":
        return erode(dilate(x, kernel), kernel)
    if op == "gradient":
        return dilate(x, kernel).float() - erode(x, kernel).float()
    if op == "tophat":
        return x.float() - morphology_ex(x, "open", kernel).float()
    if op == "blackhat":
        return morphology_ex(x, "close", kernel).float() - x.float()
    raise ValueError(op)


_PYR_K = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]) / 256.0


def pyr_down(img, device=None):
    sm = filter2d(as_image(img, device).float(), _PYR_K)
    return sm[::2, ::2]


def pyr_up(img, device=None):
    x, squeeze = _ensure_hwc(as_image(img, device).float())
    h, w, c = x.shape
    up = torch.zeros((2 * h, 2 * w, c), dtype=torch.float32, device=x.device)
    up[::2, ::2] = x
    out = filter2d(up, 4.0 * _PYR_K)
    return out[..., 0] if squeeze else out


def bilateral_filter(img, d: int, sigma_color: float, sigma_space: float, device=None):
    """Edge-preserving smoothing: a spatial Gaussian times a range Gaussian
    over a window of diameter d (d <= 0: from sigma_space, OpenCV's rule),
    summed shift by shift in the JAX package's order."""
    x, squeeze = _ensure_hwc(as_image(img, device).float())
    if d <= 0:
        d = max(int(round(sigma_space * 1.5)) * 2 + 1, 3)
    r = d // 2
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    sw = np.exp(-(ys ** 2 + xs ** 2) / (2 * sigma_space ** 2))
    sw[ys ** 2 + xs ** 2 > r * r] = 0.0   # circular support (OpenCV)
    xp = F.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode="reflect")[0].permute(1, 2, 0)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    inv2sc = 1.0 / (2 * sigma_color ** 2)
    h, w, _ = x.shape
    for i in range(d):
        for j in range(d):
            shifted = xp[i:i + h, j:j + w]
            wgt = float(sw[i, j]) * torch.exp(-((shifted - x) ** 2) * inv2sc)
            num = num + wgt * shifted
            den = den + wgt
    out = num / den
    return out[..., 0] if squeeze else out
