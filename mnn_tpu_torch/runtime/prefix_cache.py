"""Prefix-cache files: save a prompt's KV and resume from it.

Counterpart of `mnn_tpu/runtime/prefix_cache.py`, in the same `.npz`
layout, so a file written by either package loads in the other: the token
ids (`tokens`, int32), slot `slot`'s valid prefix of every layer (`k`, `v`:
[L, Hkv, n, D or the packed width]; bf16 as its uint16 bits with `kv_dtype`
"bfloat16"), `quantized`, `bits`, and the f32 `k_scale` / `v_scale`
[L, Hkv, n] of a quantized cache. Loading writes the rows into the device
cache in place and moves the slot's length on the device; generation then
continues from the cached context with no prefill of it.

As in the JAX package, a load checks the capacity, the quantization mode
and the bits, not the codebook: a TQ4 file loads into a uniform int4 cache
(and back) without an error.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mnn_tpu_torch.runtime.kvcache import KVCache, with_length


def _to_np(t: torch.Tensor):
    """(numpy array that `np.savez` can hold, dtype name): bf16 crosses as
    its uint16 bits, as the JAX package writes it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_np(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """The inverse of `_to_np`, onto `device`."""
    a = np.require(a, requirements=["C", "W"])
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def save_prefix(path: str, cache: KVCache, token_ids: List[int],
                slot: int = 0) -> int:
    """Write slot `slot`'s valid prefix to `path`; returns its token count."""
    n = int(cache.length[slot])
    k, k_dt = _to_np(cache.k[:, slot, :, :n])
    v, _ = _to_np(cache.v[:, slot, :, :n])
    data = {
        "tokens": np.asarray(token_ids[:n], np.int32),
        "k": k, "v": v,
        "kv_dtype": np.asarray(k_dt),
        "quantized": np.asarray(cache.quantized),
        "bits": np.asarray(cache.bits),
    }
    if cache.quantized:
        data["k_scale"] = _to_np(cache.k_scale[:, slot, :, :n])[0]
        data["v_scale"] = _to_np(cache.v_scale[:, slot, :, :n])[0]
    # through a file handle: np.savez(str) appends ".npz" to a path without it
    with open(path, "wb") as fh:
        np.savez(fh, **data)
    return n


def write_rows(cache: KVCache, slot: int, k, v, k_scale, v_scale,
               kv_dtype: str, n: int) -> KVCache:
    """Write n saved positions ([L, Hkv, n, ...] numpy arrays) into slot
    `slot` of `cache`, in place, after checking that they fit; returns the
    cache with the slot's length set to n on the device."""
    want = (cache.k.shape[0], cache.k.shape[2], n, cache.k.shape[4])
    if n > cache.capacity:
        raise ValueError(f"prefix length {n} exceeds capacity {cache.capacity}")
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"saved KV of shape {tuple(k.shape)} does not fit this "
                         f"cache's {want}")
    dev = cache.k.device
    cache.k[:, slot, :, :n] = _from_np(k, kv_dtype, dev).to(cache.k.dtype)
    cache.v[:, slot, :, :n] = _from_np(v, kv_dtype, dev).to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[:, slot, :, :n] = _from_np(k_scale, "float32", dev)
        cache.v_scale[:, slot, :, :n] = _from_np(v_scale, "float32", dev)
    length = cache.length.clone()
    length[slot] = n
    return with_length(cache, length)


def load_prefix(path: str, cache: KVCache, slot: int = 0
                ) -> Tuple[KVCache, List[int]]:
    """Restore a saved prefix into slot `slot` of `cache`, in place. Returns
    (cache with the slot's new length, token ids). The cache must have the
    saved layer, head and head-dim shapes, a capacity of at least the saved
    length, and the saved quantization mode and bits."""
    with np.load(path) as z:
        n = int(z["tokens"].shape[0])
        if n > cache.capacity:
            raise ValueError(f"prefix length {n} exceeds capacity {cache.capacity}")
        if bool(z["quantized"]) != cache.quantized:
            raise ValueError("prefix cache quantization mode mismatch")
        saved_bits = int(z["bits"]) if "bits" in z else (8 if cache.quantized else 16)
        if saved_bits != cache.bits:
            raise ValueError(
                f"prefix cache kv bits mismatch: saved {saved_bits}, cache {cache.bits}")
        kv_dtype = str(z["kv_dtype"]) if "kv_dtype" in z else ""
        scales = ((z["k_scale"], z["v_scale"]) if cache.quantized else (None, None))
        cache = write_rows(cache, slot, z["k"], z["v"], *scales, kv_dtype, n)
        return cache, [int(t) for t in z["tokens"]]
