"""On-device timing helpers.

Counterpart of the JAX package's `utils/benchit.py`. `chain` runs `fn`
`iters` times with each call's input made from the previous call's output,
`x * (1 + eps * acc)` with `acc` a sum of the last output, so that no call
can start before the one before it has finished (the JAX version threads
the same dependency through a `fori_loop` so that XLA cannot hoist the
body). On the card the loop is timed with CUDA events around the `iters`
launches (no host read inside); on the CPU with `perf_counter`. `sync`
waits for the device, `once` times one call.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree):
    """Wait for the device work behind every tensor of `tree`; returns it."""
    for dev in {t.device for t in _leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def chain(fn: Callable, x: torch.Tensor, iters: int = 20, warmup: int = 1) -> float:
    """Seconds per call of `fn(x)` repeated with a forced dependency between
    calls. `fn` maps one tensor to one tensor (any shapes). The best of
    `warmup` timed loops after one untimed loop (allocator, cuDNN plans)."""
    eps = torch.tensor(1e-30, dtype=torch.float32, device=x.device)

    def loop():
        y = fn(x)
        for _ in range(iters):
            acc = torch.sum(y, dtype=torch.float32) * 1e-30
            y = fn(x * (1.0 + eps * acc).to(x.dtype))
        return y

    sync(loop())
    times = []
    for _ in range(max(warmup, 1)):
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / (iters + 1))
        else:
            t0 = time.perf_counter()
            loop()
            times.append((time.perf_counter() - t0) / (iters + 1))
    return min(times)


def once(fn: Callable, *args) -> float:
    """Wall time of one call after one warm-up call, each ended by a sync."""
    sync(fn(*args))
    t0 = time.perf_counter()
    sync(fn(*args))
    return time.perf_counter() - t0
