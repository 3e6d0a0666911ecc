"""Drawing primitives, host-side numpy (OpenCV style).

Counterpart of the JAX package's `cv/draw.py` (the reference's tools/cv
rectangle / line / circle): drawing is annotation work, not accelerator
work, so it stays on the host, in place on a numpy image.
"""

from __future__ import annotations

import numpy as np


def rectangle(img, pt1, pt2, color, thickness: int = 1):
    """Draw (or fill, thickness -1) an axis-aligned rectangle. In place."""
    img = np.asarray(img)
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    h, w = img.shape[:2]
    if thickness < 0:
        img[max(y1, 0):min(y2 + 1, h), max(x1, 0):min(x2 + 1, w)] = color
        return img
    t = thickness
    rectangle(img, (x1, y1), (x2, y1 + t - 1), color, -1)
    rectangle(img, (x1, y2 - t + 1), (x2, y2), color, -1)
    rectangle(img, (x1, y1), (x1 + t - 1, y2), color, -1)
    rectangle(img, (x2 - t + 1, y1), (x2, y2), color, -1)
    return img


def line(img, pt1, pt2, color, thickness: int = 1):
    """A Bresenham-style line with a square brush. In place."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    n = max(abs(x2 - x1), abs(y2 - y1), 1)
    xs = np.round(np.linspace(x1, x2, n + 1)).astype(int)
    ys = np.round(np.linspace(y1, y2, n + 1)).astype(int)
    r = max(thickness // 2, 0)
    for x, y in zip(xs, ys):
        img[max(y - r, 0):min(y + r + 1, h), max(x - r, 0):min(x + r + 1, w)] = color
    return img


def circle(img, center, radius: int, color, thickness: int = 1):
    """A circle outline, or a filled disk (thickness -1). In place."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    ys, xs = np.ogrid[:h, :w]
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2
    if thickness < 0:
        mask = d2 <= radius ** 2
    else:
        inner = max(radius - thickness, 0)
        mask = (d2 <= radius ** 2) & (d2 >= inner ** 2)
    img[mask] = color
    return img
