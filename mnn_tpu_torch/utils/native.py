"""ctypes bindings for the repo's C++ runtime library (`native/mnn_tpu_native.cpp`).

Counterpart of the JAX package's `utils/native.py`. The library is built on
first use with `g++` straight from that source into the git-ignored
`mnn_tpu_torch/_build/native-<hash>/` (the hash covers the source and the
flags; nothing is written under `native/`), and exposes:

* `StFile`: a zero-copy mmap safetensors reader, whose tensors are
  `torch.frombuffer` views with the dtypes of `convert/stfile.py` (BF16 as
  `torch.bfloat16`). `convert/stfile.py` stays the port's checkpoint
  reader; this one reads the same bytes;
* `NativeNgramIndex`: the lookahead draft's suffix index, proposing what
  `runtime.speculative.NgramDraft` proposes.

`available()` says whether the library built and loaded; the lookahead
prefers the index when it did, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from mnn_tpu_torch.convert.stfile import DTYPES

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "mnn_tpu_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lib = None
_tried = False


def _lib_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"native-{key}" / "libmnn_tpu_native.so"


def _build(path: Path) -> None:
    """g++ the source into a temporary name beside `path`, then rename it, so
    that a process never loads a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    c_void_p, c_int, c_char_p = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    sigs = {
        "mnnst_open": (c_void_p, [c_char_p]),
        "mnnst_num_tensors": (c_int, [c_void_p]),
        "mnnst_name": (c_char_p, [c_void_p, c_int]),
        "mnnst_dtype": (c_char_p, [c_void_p, c_int]),
        "mnnst_ndim": (c_int, [c_void_p, c_int]),
        "mnnst_shape": (None, [c_void_p, c_int, ctypes.POINTER(ctypes.c_int64)]),
        "mnnst_data": (c_void_p, [c_void_p, c_int, ctypes.POINTER(ctypes.c_uint64)]),
        "mnnst_header": (c_char_p, [c_void_p]),
        "mnnst_close": (None, [c_void_p]),
        "mnnng_create": (c_void_p, [c_int, c_int]),
        "mnnng_extend": (None, [c_void_p, ctypes.POINTER(ctypes.c_int32), c_int]),
        "mnnng_propose": (c_int, [c_void_p, ctypes.POINTER(ctypes.c_int32)]),
        "mnnng_history_len": (c_int, [c_void_p]),
        "mnnng_destroy": (None, [c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load(raise_on_error: bool = False):
    """The library, built on first use; None when it cannot be built or
    loaded (or raise, with `raise_on_error`)."""
    global _lib, _tried
    if _lib is not None or (_tried and not raise_on_error):
        return _lib
    _tried = True
    try:
        path = _lib_path()
        if not path.exists():
            _build(path)
        _lib = _bind(ctypes.CDLL(str(path)))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        if raise_on_error:
            raise
        return None
    return _lib


def available() -> bool:
    return load() is not None


def _need():
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


class StFile:
    """Zero-copy mmap safetensors reader (native). `names` in the header's
    order; `tensor(name)` is a view of the map, valid until `close`."""

    def __init__(self, path: str):
        self._lib = lib = _need()
        self._h = lib.mnnst_open(str(path).encode())
        if not self._h:
            raise OSError(f"failed to open safetensors file {path}")
        self.names = []
        self._index = {}
        for i in range(lib.mnnst_num_tensors(self._h)):
            name = lib.mnnst_name(self._h, i).decode()
            self.names.append(name)
            self._index[name] = i

    def metadata(self) -> dict:
        header = json.loads(self._lib.mnnst_header(self._h).decode())
        return header.get("__metadata__", {}) or {}

    def tensor(self, name: str) -> torch.Tensor:
        i = self._index[name]
        lib = self._lib
        nd = lib.mnnst_ndim(self._h, i)
        shape = (ctypes.c_int64 * max(nd, 1))()
        lib.mnnst_shape(self._h, i, shape)
        dtype_s = lib.mnnst_dtype(self._h, i).decode()
        dtype = DTYPES.get(dtype_s)
        if dtype is None:
            raise ValueError(f"unsupported dtype {dtype_s}")
        nbytes = ctypes.c_uint64()
        ptr = lib.mnnst_data(self._h, i, ctypes.byref(nbytes))
        dims = tuple(shape[j] for j in range(nd))
        if nbytes.value == 0:
            return torch.empty(dims, dtype=dtype)
        buf = (ctypes.c_char * nbytes.value).from_address(ptr)
        return torch.frombuffer(buf, dtype=dtype).reshape(dims)

    def close(self):
        if self._h:
            self._lib.mnnst_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NativeNgramIndex:
    """Native counterpart of `runtime.speculative.NgramDraft`."""

    def __init__(self, max_n: int = 4, draft_len: int = 7):
        self._lib = lib = _need()
        self.draft_len = draft_len
        self._h = lib.mnnng_create(max_n, draft_len)

    def extend(self, tokens):
        arr = (ctypes.c_int32 * len(tokens))(*[int(t) for t in tokens])
        self._lib.mnnng_extend(self._h, arr, len(tokens))

    def propose(self) -> Optional[list]:
        out = (ctypes.c_int32 * self.draft_len)()
        n = self._lib.mnnng_propose(self._h, out)
        return [out[i] for i in range(n)] if n else None

    def __len__(self):
        return self._lib.mnnng_history_len(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mnnng_destroy(self._h)
            self._h = None
