"""Colour-space conversions of HWC uint8 or float images.

Counterpart of the JAX package's `cv/color.py`: RGB / BGR / RGBA / GRAY /
YUV-NV12 / NV21 with the reference's BT.601 coefficients, each an
elementwise torch op in the JAX package's order (f32 math; uint8 results
truncated, or rounded half to even and clipped for YUV). Functions take a
tensor or an array (`common.as_image`) and return a tensor.
"""

from __future__ import annotations

import torch

from mnn_tpu_torch.cv.common import as_image


def rgb_to_bgr(img, device=None):
    return as_image(img, device).flip(-1)


bgr_to_rgb = rgb_to_bgr


def rgb_to_gray(img, device=None):
    """BT.601: y = 0.299 R + 0.587 G + 0.114 B, uint8 in gives uint8 out."""
    x = as_image(img, device)
    f = x.float()
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return y.to(torch.uint8) if x.dtype == torch.uint8 else y


def gray_to_rgb(img, device=None):
    x = as_image(img, device)
    return torch.stack([x, x, x], dim=-1)


def rgba_to_rgb(img, device=None):
    return as_image(img, device)[..., :3]


def rgb_to_rgba(img, alpha=255, device=None):
    x = as_image(img, device)
    return torch.cat([x, torch.full(x.shape[:-1] + (1,), alpha, dtype=x.dtype,
                                    device=x.device)], dim=-1)


def yuv_nv12_to_rgb(y, uv, device=None):
    """y [H, W], uv [H/2, W/2, 2] (U then V) -> RGB uint8 [H, W, 3]."""
    y = as_image(y, device)
    uv = as_image(uv, y.device)
    yf = y.float()
    u = uv[..., 0].float() - 128.0
    v = uv[..., 1].float() - 128.0
    u = u.repeat_interleave(2, 0).repeat_interleave(2, 1)[:yf.shape[0], :yf.shape[1]]
    v = v.repeat_interleave(2, 0).repeat_interleave(2, 1)[:yf.shape[0], :yf.shape[1]]
    r = yf + 1.402 * v
    g = yf - 0.344136 * u - 0.714136 * v
    b = yf + 1.772 * u
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def yuv_nv21_to_rgb(y, vu, device=None):
    y = as_image(y, device)
    return yuv_nv12_to_rgb(y, as_image(vu, y.device).flip(-1))


CONVERSIONS = {
    ("rgb", "bgr"): rgb_to_bgr,
    ("bgr", "rgb"): bgr_to_rgb,
    ("rgb", "gray"): rgb_to_gray,
    ("bgr", "gray"): lambda x: rgb_to_gray(bgr_to_rgb(x)),
    ("gray", "rgb"): gray_to_rgb,
    ("rgba", "rgb"): rgba_to_rgb,
    ("rgb", "rgba"): rgb_to_rgba,
}


def cvt_color(img, src: str, dst: str, device=None):
    x = as_image(img, device)
    src, dst = src.lower(), dst.lower()
    if src == dst:
        return x
    fn = CONVERSIONS.get((src, dst))
    if fn is None:
        raise ValueError(f"unsupported conversion {src} -> {dst}")
    return fn(x)
