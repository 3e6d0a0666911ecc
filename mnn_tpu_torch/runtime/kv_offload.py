"""KV host offload: shelve a sequence's KV out of device memory and back.

Counterpart of `mnn_tpu/runtime/kv_offload.py`. Device memory is the
scarce tier, host memory the large one, disk the cold one:

    device slot  --shelve-->  host (numpy arrays)  --LRU spill-->  .npz file
                 <--restore--                      <--reload--

* `shelve` copies one slot's valid KV prefix to the host (one copy a
  tensor) and leaves the slot free for another sequence;
* `restore` writes it back into a slot of the device cache in place and
  moves the slot's length on the device: generation continues with no
  second prefill;
* the pool holds at most `max_bytes` (least recently used first out, but
  never its last entry); an entry it evicts goes to `spill_dir` as one
  `.npz` (the JAX package's format: `tokens`, `k`, `v`, `kv_dtype`, `bits`
  and the scales of a quantized cache) and reloads on `restore`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from mnn_tpu_torch.runtime.kvcache import KVCache
from mnn_tpu_torch.runtime.prefix_cache import _to_np, write_rows


@dataclasses.dataclass
class HostKV:
    """One sequence's KV prefix in host memory."""
    tokens: List[int]
    k: np.ndarray          # [L, Hkv, n, D] (uint16 bits when bf16)
    v: np.ndarray
    k_scale: Optional[np.ndarray]
    v_scale: Optional[np.ndarray]
    kv_dtype: str
    bits: int
    last_used: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def nbytes(self) -> int:
        n = self.k.nbytes + self.v.nbytes
        if self.k_scale is not None:
            n += self.k_scale.nbytes + self.v_scale.nbytes
        return n


class KVOffloadPool:
    """LRU host pool of shelved KV contexts with a byte budget and a disk
    tier."""

    def __init__(self, max_bytes: int = 4 << 30, spill_dir: Optional[str] = None):
        self.max_bytes = max_bytes
        self.spill_dir = spill_dir
        self._pool: "OrderedDict[str, HostKV]" = OrderedDict()
        self._spilled: Dict[str, str] = {}   # key -> path
        self.bytes = 0

    # -- device -> host ---------------------------------------------------

    def shelve(self, key: str, cache: KVCache, token_ids: List[int],
               slot: int = 0) -> int:
        """Copy slot `slot`'s valid prefix to the host; returns its token count."""
        n = int(cache.length[slot])
        k, dt = _to_np(cache.k[:, slot, :, :n])
        v, _ = _to_np(cache.v[:, slot, :, :n])
        scale = lambda t: None if t is None else np.array(_to_np(t[:, slot, :, :n])[0])
        # copies (np.array): on the CPU `_to_np` gives views of the live cache
        entry = HostKV(tokens=list(token_ids[:n]), k=np.array(k), v=np.array(v),
                       k_scale=scale(cache.k_scale), v_scale=scale(cache.v_scale),
                       kv_dtype=dt, bits=cache.bits)
        old = self._pool.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        self._pool[key] = entry
        self.bytes += entry.nbytes
        self._enforce_budget()
        return n

    # -- host -> device ---------------------------------------------------

    def restore(self, key: str, cache: KVCache, slot: int = 0
                ) -> Optional[Tuple[KVCache, List[int]]]:
        """Write `key`'s KV back into slot `slot` of `cache`, in place.
        Returns (cache with the slot's length, token ids), or None if the
        key is unknown."""
        entry = self._pool.get(key)
        if entry is None and key in self._spilled:
            entry = self._reload(key)
        if entry is None:
            return None
        entry.last_used = time.monotonic()
        self._pool.move_to_end(key)
        cache = write_rows(cache, slot, entry.k, entry.v, entry.k_scale,
                           entry.v_scale, entry.kv_dtype, len(entry.tokens))
        return cache, list(entry.tokens)

    def drop(self, key: str) -> bool:
        e = self._pool.pop(key, None)
        if e is not None:
            self.bytes -= e.nbytes
        p = self._spilled.pop(key, None)
        if p and os.path.exists(p):
            os.unlink(p)
        return e is not None or p is not None

    def __contains__(self, key: str) -> bool:
        return key in self._pool or key in self._spilled

    def stats(self) -> dict:
        return {"entries": len(self._pool), "bytes": self.bytes,
                "spilled": len(self._spilled)}

    # -- LRU and the disk tier ----------------------------------------------

    def _enforce_budget(self):
        while self.bytes > self.max_bytes and len(self._pool) > 1:
            key, entry = self._pool.popitem(last=False)   # least recently used
            self.bytes -= entry.nbytes
            if self.spill_dir:
                self._spill(key, entry)

    def _spill(self, key: str, entry: HostKV):
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, f"kv_{abs(hash(key)):x}.npz")
        data = dict(tokens=np.asarray(entry.tokens, np.int32), k=entry.k, v=entry.v,
                    kv_dtype=np.asarray(entry.kv_dtype), bits=np.asarray(entry.bits))
        if entry.k_scale is not None:
            data["k_scale"] = entry.k_scale
            data["v_scale"] = entry.v_scale
        with open(path, "wb") as fh:
            np.savez(fh, **data)
        self._spilled[key] = path

    def _reload(self, key: str) -> Optional[HostKV]:
        path = self._spilled.pop(key, None)
        if path is None or not os.path.exists(path):
            return None
        with np.load(path) as z:
            entry = HostKV(
                tokens=z["tokens"].tolist(), k=z["k"], v=z["v"],
                k_scale=z["k_scale"] if "k_scale" in z else None,
                v_scale=z["v_scale"] if "v_scale" in z else None,
                kv_dtype=str(z["kv_dtype"]), bits=int(z["bits"]))
        os.unlink(path)
        self._pool[key] = entry
        self.bytes += entry.nbytes
        self._enforce_budget()
        return entry
