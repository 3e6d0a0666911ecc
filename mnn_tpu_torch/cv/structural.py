"""Structural analysis: connected components, contour measures, hulls.

Counterpart of the JAX package's `cv/structural.py`. Connected components
run on the image's device: every foreground pixel is seeded with its
raster index + 1 and min-pooled over its neighbourhood until nothing
changes (the JAX package's `lax.while_loop` of reduce-windows). The limit
is each component's smallest seed, whatever the number of steps past it,
so the loop reads the card once every `CC_CHECK` steps, not every step.
The small geometric reductions (hull, rectangles, areas) stay host-side
numpy on the point lists they are given, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mnn_tpu_torch.cv.common import as_image, host

BIG = int(np.iinfo(np.int32).max)   # background and border: min's identity
CC_CHECK = 8                        # min-pool steps between fixed-point checks


def bounding_rect(points) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of the up-right bounding rectangle."""
    p = host(points).reshape(-1, 2)
    x0, y0 = p.min(axis=0)
    x1, y1 = p.max(axis=0)
    return (int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1))


def contour_area(points, oriented: bool = False) -> float:
    """Shoelace area of a closed polygon [N, 2] (OpenCV contourArea)."""
    p = host(points).astype(np.float64).reshape(-1, 2)
    x, y = p[:, 0], p[:, 1]
    s = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return float(s if oriented else abs(s))


def convex_hull(points, clockwise: bool = False) -> np.ndarray:
    """Hull vertices [M, 2] (Andrew's monotone chain)."""
    p = np.unique(host(points).astype(np.float64).reshape(-1, 2), axis=0)
    if len(p) <= 2:
        return p
    p = p[np.lexsort((p[:, 1], p[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(tuple(q))
    for q in p[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(tuple(q))
    hull = np.asarray(lower[:-1] + upper[:-1])
    return hull[::-1] if clockwise else hull


def min_area_rect(points):
    """((cx, cy), (w, h), angle_deg): the minimum-area rotated rectangle, by
    rotating calipers over the hull's edges."""
    hull = convex_hull(points)
    if len(hull) == 1:
        return ((float(hull[0][0]), float(hull[0][1])), (0.0, 0.0), 0.0)
    best = None
    n = len(hull)
    for i in range(n):
        e = hull[(i + 1) % n] - hull[i]
        norm = math.hypot(*e)
        if norm == 0:
            continue
        ux, uy = e / norm
        r = hull @ np.asarray([[ux, -uy], [uy, ux]])   # rotate onto the edge
        w = r[:, 0].max() - r[:, 0].min()
        h = r[:, 1].max() - r[:, 1].min()
        area = w * h
        if best is None or area < best[0]:
            cx = (r[:, 0].max() + r[:, 0].min()) / 2
            cy = (r[:, 1].max() + r[:, 1].min()) / 2
            c = np.asarray([cx, cy]) @ np.asarray([[ux, uy], [-uy, ux]])   # back
            best = (area, (float(c[0]), float(c[1])), (float(w), float(h)),
                    math.degrees(math.atan2(uy, ux)))
    return best[1], best[2], best[3]


def box_points(rect) -> np.ndarray:
    """The 4 corners [4, 2] of a ((cx, cy), (w, h), angle) rotated rect."""
    (cx, cy), (w, h), ang = rect
    a = math.radians(ang)
    ux, uy = math.cos(a), math.sin(a)
    dx = np.asarray([ux, uy]) * w / 2
    dy = np.asarray([-uy, ux]) * h / 2
    c = np.asarray([cx, cy])
    return np.stack([c - dx - dy, c + dx - dy, c + dx + dy, c - dx + dy])


def _min3(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The min over a 3-wide window along `dim`, BIG past the border."""
    n = a.shape[dim]
    if n == 1:
        return a
    fill = torch.full_like(a.narrow(dim, 0, 1), BIG)
    prev = torch.cat([fill, a.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([a.narrow(dim, 1, n - 1), fill], dim)
    return torch.minimum(a, torch.minimum(prev, nxt))


def connected_components(img, connectivity: int = 8, device=None):
    """Label the nonzero pixels of a binary image [H, W]: (n_labels, labels
    [H, W] int32 tensor), background 0, components numbered 1..n - 1 in the
    order of their first pixel in raster order."""
    x = as_image(img, device) != 0
    h, w = x.shape
    seed = torch.arange(1, h * w + 1, dtype=torch.int32, device=x.device).reshape(h, w)
    big = torch.full((), BIG, dtype=torch.int32, device=x.device)
    lab = torch.where(x, seed, big)

    def step(lab):
        if connectivity == 8:      # the 3 x 3 window, as rows then columns
            m = _min3(_min3(lab, 0), 1)
        else:                      # the cross: a (3, 1) and a (1, 3) window
            m = torch.minimum(_min3(lab, 0), _min3(lab, 1))
        return torch.where(x, torch.minimum(lab, m), big)

    while True:
        before = lab
        for _ in range(CC_CHECK):
            lab = step(lab)
        if torch.equal(lab, before):
            break
    lab = torch.where(x, lab, torch.zeros_like(lab))
    ids, inverse = torch.unique(lab, return_inverse=True)
    has_background = bool(ids[0] == 0)
    out = (inverse if has_background else inverse + 1).to(torch.int32)
    return int(ids.numel()) + (0 if has_background else 1), out


def connected_components_with_stats(img, connectivity: int = 8, device=None):
    """(n, labels, stats [n, 5] int64 = (x, y, w, h, area), centroids [n, 2]
    float64), on the image's device; a label with no pixel (the background
    of an all-foreground image) has zero stats."""
    x = as_image(img, device)
    n, labels = connected_components(x, connectivity)
    h, w = labels.shape
    flat = labels.reshape(-1).long()
    ys = torch.arange(h, device=x.device).repeat_interleave(w)
    xs = torch.arange(w, device=x.device).repeat(h)
    area = torch.bincount(flat, minlength=n)

    def reduce(src, how, init):
        out = torch.full((n,), init, dtype=torch.int64, device=x.device)
        return out.scatter_reduce_(0, flat, src, reduce=how, include_self=False)

    x0, x1 = reduce(xs, "amin", w), reduce(xs, "amax", -1)
    y0, y1 = reduce(ys, "amin", h), reduce(ys, "amax", -1)
    stats = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1, area], dim=1)
    stats = torch.where((area > 0)[:, None], stats, torch.zeros_like(stats))
    # integer sums (exact in float64), then one division: numpy's mean
    sx = torch.zeros(n, dtype=torch.float64, device=x.device).index_add_(0, flat, xs.double())
    sy = torch.zeros(n, dtype=torch.float64, device=x.device).index_add_(0, flat, ys.double())
    cnt = torch.clamp(area, min=1).double()
    cents = torch.where((area > 0)[:, None], torch.stack([sx / cnt, sy / cnt], dim=1),
                        torch.zeros((n, 2), dtype=torch.float64, device=x.device))
    return n, labels, stats, cents
