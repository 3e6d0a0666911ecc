"""Dataset loaders and a batch iterator.

Counterpart of `mnn_tpu/train/datasets.py`: the MNIST idx parser for the
classic ubyte files (gzipped or not), `ImageFolderDataset` over a
class-per-directory tree (PIL is imported when one is made, never with the
module), and `DataLoader`, which shuffles with the same numpy generator as
the JAX loader, so one seed gives the same batches in both packages, and
yields tensors on a device.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Tuple

import numpy as np
import torch

from mnn_tpu_torch.kernels.common import resolve_device


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def load_mnist_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic {magic:#x}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def load_mnist_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic {magic:#x}")
        return np.frombuffer(f.read(n), np.uint8).copy()


class ImageFolderDataset:
    """A class-per-subdirectory image tree: item i is (HWC uint8 RGB array
    resized to `size`, class index)."""

    def __init__(self, root: str, size: Tuple[int, int] = (224, 224)):
        from PIL import Image  # noqa: F401  (fail here, not at the first item)

        self.root = root
        self.size = size
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        self.samples = []
        for ci, cls in enumerate(self.classes):
            for fn in sorted(os.listdir(os.path.join(root, cls))):
                if fn.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.samples.append((os.path.join(root, cls, fn), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB").resize(self.size[::-1])
        return np.asarray(img), label


class DataLoader:
    """Shuffling batch iterator over numpy arrays, yielding (data, labels)
    tensors on `device` (None: the card)."""

    def __init__(self, data: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 device=None):
        self.data = data
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator:
        n = len(self.data)
        idx = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = n - (n % self.batch_size) if self.drop_last else n
        for off in range(0, stop, self.batch_size):
            sel = idx[off:off + self.batch_size]
            yield (torch.from_numpy(np.ascontiguousarray(self.data[sel])).to(self.device),
                   torch.from_numpy(np.ascontiguousarray(self.labels[sel])).to(self.device))

    def __len__(self):
        n = len(self.data)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
