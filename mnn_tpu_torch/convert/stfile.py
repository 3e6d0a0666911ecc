"""Safetensors reader and writer in pure Python, on torch tensors.

Counterpart of the JAX package's native mmap reader (`utils/native.py`
`StFile`) and of the `safetensors` package as its converters use it. No
C++ toolchain and no `safetensors` install are needed to load a model.

Format: an 8-byte little-endian header length, a JSON header
`{"__metadata__": {str: str}, name: {"dtype", "shape", "data_offsets"}}`
padded with spaces to a multiple of 8, then the tensors' bytes.

A reader maps the file (copy-on-write: a view can be written without
touching the file) and gives each tensor as a `torch.frombuffer` view of the
map. Such a view holds no reference to the map: copy it, to a device with
`.to(device)` or on the CPU with `.clone()`, before `close()`. BF16 lands as
`torch.bfloat16`. The writer lays a file out as the `safetensors` package
does (metadata first, tensors ordered by dtype as it orders them, then by
name), so the same tensors give the same bytes, and it moves one tensor at
a time to the host: a model on the card is written without a host copy of
all of it.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, Optional

import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "U16": torch.uint16, "F16": torch.float16,
    "BF16": torch.bfloat16, "I32": torch.int32, "U32": torch.uint32,
    "F32": torch.float32, "F64": torch.float64, "I64": torch.int64,
    "U64": torch.uint64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# the `safetensors` writer lays tensors out in descending order of this rank
_RANK = {name: i for i, name in enumerate(DTYPES)}


class StFile:
    """One safetensors file, mapped. `names` in file order; `tensor(name)`
    is a view of the map (valid until `close`)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: not a safetensors file")
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        (n,) = struct.unpack("<Q", self._map[:8])
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes past the file's end")
        header = json.loads(self._map[8:8 + n])
        self._meta = header.pop("__metadata__", None) or {}
        self._start = 8 + n
        self._info = header
        self.names = sorted(header, key=lambda k: header[k]["data_offsets"][0])

    def metadata(self) -> Dict[str, str]:
        return dict(self._meta)

    def tensor(self, name: str) -> torch.Tensor:
        """A view of the map; copy it before `close`."""
        info = self._info[name]
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: {name}: unsupported dtype {info['dtype']}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{self.path}: {name}: {end - begin} bytes for "
                             f"{info['dtype']} {list(shape)}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        offset = self._start + begin
        if offset % dtype.itemsize:       # misaligned: take a copy
            raw = bytearray(self._map[offset:offset + end - begin])
            return torch.frombuffer(raw, dtype=dtype).reshape(shape)
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=offset).reshape(shape)

    def close(self):
        if self._map is not None:
            self._map.close()
            self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StDir(Mapping):
    """Every `*.safetensors` file of a directory (a sharded checkpoint, read
    in sorted file order as the JAX converter reads it) as one mapping from
    tensor name to a view. A name in several files takes the last file's."""

    def __init__(self, model_dir: str):
        paths = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
        if not paths:
            raise FileNotFoundError(f"no *.safetensors under {model_dir}")
        self.files = [StFile(p) for p in paths]
        self._where = {}
        for f in self.files:
            for k in f.names:
                self._where[k] = f

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].tensor(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, name) -> bool:
        return name in self._where

    def close(self):
        for f in self.files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (on any device) to `path`, one tensor at a time."""
    order = sorted(tensors, key=lambda k: (-_RANK[_NAMES[tensors[k].dtype]], k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(metadata[k]) for k in sorted(metadata)}
    off = 0
    for k in order:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = tensors[k].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
