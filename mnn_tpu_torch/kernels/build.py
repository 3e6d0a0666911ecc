"""Build the hand-written CUDA kernels and bind them with ctypes.

The JAX package has no counterpart: Pallas kernels are compiled by JAX.
Here every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
one shared library with a plain C interface, at first use, inside the
CUDA branch of a wrapper. Importing this module touches no compiler, so
the package imports and its CPU tests run where there is no `nvcc`.

* One `nvcc -c` per source, all started together, then one link.
* The library lands in `mnn_tpu_torch/_build/<hash of the sources>/`
  (ignored by git), so an edit to any source rebuilds it; nvcc's output
  (`-Xptxas -v`) lies beside it as `nvcc_log.txt`.
* Every C entry returns `cudaGetLastError()` after its launch;
  `CudaKernel.__call__` raises if it is not 0, because a refused launch
  (too many threads, too much shared memory) never runs and a later
  `synchronize()` does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
lib_path: Optional[Path] = None          # the loaded library
build_log: str = ""                      # nvcc's output (-Xptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit with sm_90a support")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(files: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise with the output of any failure."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    outs, failed = [], []
    for c, p in procs:
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(outs)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib, lib_path, build_log
    with _lock:
        if _lib is not None:
            return _lib
        cus, cuhs = _sources()
        out_dir = BUILD_ROOT / _digest(cus + cuhs)
        so = out_dir / "libmnn_tpu_torch_kernels.so"
        if not so.exists():
            nvcc = _nvcc()
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(dir=out_dir))
            objs = [tmp / (cu.stem + ".o") for cu in cus]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v",
                             "-I", str(CSRC), "-c", str(cu), "-o", str(o)]
                            for cu, o in zip(cus, objs)])
            tmp_so = tmp / so.name
            log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o",
                              str(tmp_so), *map(str, objs)]])
            (out_dir / "nvcc_log.txt").write_text(log)
            os.replace(tmp_so, so)      # atomic: concurrent builders agree
            shutil.rmtree(tmp, ignore_errors=True)
            build_log = log
        _lib = ctypes.CDLL(str(so))
        lib_path = so
        return _lib


class CudaKernel:
    """One C entry point of the library, with its launch count.

    `launches` rises by one on every launch through `__call__` and
    nowhere else, so a run can show that its path went through the kernel.
    """

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA launch error {err}")
        self.launches += 1


KERNELS: list[CudaKernel] = []


def kernel(name: str, argtypes: Sequence) -> CudaKernel:
    """Declare a C entry point; every declared kernel is listed in KERNELS."""
    k = CudaKernel(name, argtypes)
    KERNELS.append(k)
    return k


def reset_launches():
    for k in KERNELS:
        k.launches = 0


P = ctypes.c_void_p     # device pointer (tensor.data_ptr())
I = ctypes.c_int
F = ctypes.c_float
