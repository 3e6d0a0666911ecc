"""Offline calibration: KL / EMA activation scales and ADMM weights.

Counterpart of `mnn_tpu/quant/calibrate.py`. The observers and the KL
threshold sweep are host-side numpy, as there (a tensor given to `update`
is read back to the host); `admm_quantize_weight` runs in torch on the
weight's device and returns a standard QuantizedLinear, so the kernels
take it unchanged.

* `HistogramObserver` accumulates an |x| histogram (2,048 bins), rebinned
  onto a wider range when a batch exceeds it.
* `kl_scale` sweeps clip thresholds and keeps the one whose int8
  requantized distribution is closest in KL divergence (the TensorRT rule).
* `EmaObserver` / `ema_scale`: the moving-absmax observer.
* `admm_quantize_weight` alternates q = clip(round(W / s)) and the
  least-squares scale s = <W, q> / <q, q> per (block, column), then rounds
  s to bf16 and picks q against the rounded scale.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mnn_tpu_torch.quant.quantize import (QuantizedLinear, _check_args, as_f32,
                                          choose_block_size, pack_q)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class HistogramObserver:
    """Accumulates an |x| histogram over calibration batches."""

    def __init__(self, bins: int = 2048):
        self.bins = bins
        self.absmax = 0.0
        self.hist: Optional[np.ndarray] = None

    def update(self, x) -> None:
        ax = np.abs(_host(x)).reshape(-1)
        mx = float(ax.max()) if ax.size else 0.0
        if mx == 0.0:
            return
        if self.hist is None or mx > self.absmax:
            # rebin the existing histogram onto the wider range
            old_hist, old_max = self.hist, self.absmax
            self.absmax = max(mx, self.absmax)
            self.hist = np.zeros(self.bins, np.float64)
            if old_hist is not None:
                centers = (np.arange(self.bins) + 0.5) * old_max / self.bins
                idx = np.minimum((centers / self.absmax * self.bins).astype(int),
                                 self.bins - 1)
                np.add.at(self.hist, idx, old_hist)
        h, _ = np.histogram(ax, bins=self.bins, range=(0.0, self.absmax))
        self.hist += h

    def scale(self, method: str = "kl", levels: int = 128) -> float:
        if self.hist is None:
            return 1.0
        if method == "max":
            return self.absmax / (levels - 1)
        return kl_scale(self.hist, self.absmax, levels)


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    mask = p > 0
    qm = np.where(q > 0, q, 1e-12)
    return float(np.sum(p[mask] * np.log(p[mask] / qm[mask])))


def kl_scale(hist: np.ndarray, absmax: float, levels: int = 128) -> float:
    """The KL threshold sweep; returns the int8 scale threshold / (levels-1)."""
    hist = np.asarray(hist, np.float64)
    bins = hist.size
    best_div, best_t = np.inf, bins
    for t in range(levels, bins + 1, max(1, bins // 256)):
        # reference distribution: everything past t clipped into bin t-1
        p = hist[:t].copy()
        p[t - 1] += hist[t:].sum()
        if p.sum() == 0:
            continue
        p /= p.sum()
        # candidate: the first t bins requantized onto `levels` buckets
        chunk = t / levels
        q = np.zeros(t, np.float64)
        for i in range(levels):
            lo, hi = int(i * chunk), max(int((i + 1) * chunk), int(i * chunk) + 1)
            seg = hist[lo:hi]
            nz = (seg > 0).sum()
            if nz:
                q[lo:hi] = np.where(seg > 0, seg.sum() / nz, 0)
        if q.sum() == 0:
            continue
        q /= q.sum()
        d = _kl_divergence(p, q)
        if d < best_div:
            best_div, best_t = d, t
    threshold = (best_t + 0.5) * absmax / bins
    return threshold / (levels - 1)


class EmaObserver:
    """Exponential moving average of the per-batch absmax."""

    def __init__(self, decay: float = 0.99):
        self.decay = decay
        self.val: Optional[float] = None

    def update(self, x) -> None:
        mx = float(np.abs(_host(x)).max())
        self.val = mx if self.val is None else (
            self.decay * self.val + (1 - self.decay) * mx)

    def scale(self, levels: int = 128) -> float:
        return (self.val or 1.0) / (levels - 1)


def ema_scale(batches, decay: float = 0.99, levels: int = 128) -> float:
    obs = EmaObserver(decay)
    for b in batches:
        obs.update(b)
    return obs.scale(levels)


def admm_quantize_weight(
    w,
    bits: int = 4,
    block_size: int = 128,
    iters: int = 30,
    out_bias=None,
    act_bits: int = 16,
    device=None,
) -> QuantizedLinear:
    """Symmetric per-block ADMM weight quantization of float [K, N] on
    `device` (None: a tensor's own device, the card for an array). Each
    step lowers ||W - s q||^2 per (block, column)."""
    w = as_f32(w, device)
    k, n = w.shape
    block_size = choose_block_size(k, block_size)
    _check_args(k, bits, block_size)
    center = 1 << (bits - 1)
    qlim = center - 1
    blocks = w.reshape(k // block_size, block_size, n)

    scale = torch.clamp(blocks.abs().amax(dim=1) / torch.full((), float(qlim),
                                                             device=w.device), min=1e-12)
    for _ in range(iters):
        q = torch.clamp(torch.round(blocks / scale[:, None, :]), -qlim, qlim)
        num = (blocks * q).sum(dim=1)
        den = torch.clamp((q * q).sum(dim=1), min=1e-12)
        scale = torch.where(den > 1e-9, num / den, scale)
    # the solved scale goes to the bf16 storage grid first, and q is chosen
    # against the rounded value the kernels read back
    scale = scale.to(torch.bfloat16).float()
    q = torch.clamp(torch.round(blocks / scale[:, None, :]), -qlim, qlim)
    qu = (q + center).to(torch.int32).reshape(k, n)      # unsigned storage
    bias = -float(center) * scale                         # exact in bf16
    packed = pack_q(qu, bits, block_size)
    ob = None if out_bias is None else as_f32(out_bias, w.device)
    return QuantizedLinear(packed=packed, scale=scale.to(torch.bfloat16),
                           bias=bias.to(torch.bfloat16), out_bias=ob, bits=bits,
                           block_size=block_size, act_bits=act_bits)
