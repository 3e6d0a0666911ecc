"""Classification top-k accuracy harness.

Counterpart of the JAX package's `runtime/classify.py`: the ImageNet eval
recipe (resize the shorter side to size / crop_pct with `jax.image.resize`'s
antialiased bilinear weights, `cv/geometric.resize`; center-crop; normalize)
and top-1 / top-k over an image folder or in-memory (images, labels), in
batches. The JAX package jits the model for one batch shape and pads the
last batch to it with copies of its last image; so does this one, so both
see the same batches.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mnn_tpu_torch.cv.common import as_image
from mnn_tpu_torch.cv.geometric import resize

# ImageNet normalization (the reference's imageInputConfig defaults)
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_classification(image, size: int = 224, crop_pct: float = 0.875,
                              device=None) -> torch.Tensor:
    """HWC uint8 (a tensor or an array) -> CHW f32 tensor: resize the
    shorter side to size / crop_pct, center-crop, normalize. An array goes
    to `device` (the card when None), a tensor stays on its own. Every
    division is by a tensor on the image's device, as JAX divides."""
    img = as_image(image, device)
    dev = img.device
    x = img.float() / torch.tensor(255.0, device=dev)
    h, w = x.shape[:2]
    short = int(round(size / crop_pct))
    if h < w:
        nh, nw = short, int(round(w * short / h))
    else:
        nh, nw = int(round(h * short / w)), short
    x = resize(x, (nh, nw), method="bilinear")
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[top: top + size, left: left + size]
    x = (x - torch.from_numpy(_MEAN).to(dev)) / torch.from_numpy(_STD).to(dev)
    return x.permute(2, 0, 1).contiguous()


def topk_eval(model_fn: Callable, images: Sequence, labels: Sequence[int], *,
              k: int = 5, batch_size: int = 32, device=None) -> dict:
    """model_fn [B, 3, H, W] -> [B, classes] logits over preprocessed CHW
    images (tensors or arrays; arrays go to `device`, the card when None).
    Returns {"top1": float, "topk": float, "k": k, "n": N}."""
    n = len(images)
    top1 = topk = 0
    for off in range(0, n, batch_size):
        batch = [as_image(im, device) for im in images[off: off + batch_size]]
        valid = len(batch)
        if valid < batch_size:  # pad to the batch shape, as the JAX package does
            batch = batch + [batch[-1]] * (batch_size - valid)
        with torch.no_grad():
            logits = model_fn(torch.stack(batch)).float().cpu().numpy()[:valid]
        want = np.asarray(labels[off: off + valid])
        order = np.argsort(-logits, axis=-1)
        top1 += int((order[:, 0] == want).sum())
        topk += int((order[:, :k] == want[:, None]).any(-1).sum())
    return {"top1": top1 / n, "topk": topk / n, "k": k, "n": n}


def eval_folder(model_fn: Callable, root: str, *, size: int = 224, k: int = 5,
                batch_size: int = 32, limit: Optional[int] = None, device=None) -> dict:
    """Top-k accuracy over an ImageFolder layout (root/<class>/<img>...),
    classes sorted alphabetically, each original image through
    `preprocess_classification` on `device`. Needs PIL."""
    from PIL import Image

    from mnn_tpu_torch.train.datasets import ImageFolderDataset

    ds = ImageFolderDataset(root, size=(size, size))
    idx = range(len(ds) if limit is None else min(limit, len(ds)))
    images, labels = [], []
    for i in idx:
        path, lab = ds.samples[i]
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
        images.append(preprocess_classification(img, size=size, device=device))
        labels.append(int(lab))
    return topk_eval(model_fn, images, labels, k=k, batch_size=batch_size, device=device)
