"""ImageProcess: format conversion, affine resample or resize, then
normalisation, in one configured call.

Counterpart of the JAX package's `cv/image_process.py` (the reference's
`CV::ImageProcess`): a raw camera or file image in any supported format
becomes a normalised model input, (x - mean) * normal, NCHW or NHWC, f32
or bf16, with a batch axis, on `device` (None: a tensor stays on its own
device, an array goes to the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mnn_tpu_torch.cv.color import cvt_color
from mnn_tpu_torch.cv.common import as_image
from mnn_tpu_torch.cv.geometric import resize, warp_affine


@dataclasses.dataclass
class ImageProcessConfig:
    source_format: str = "rgb"          # rgb | bgr | rgba | gray
    dest_format: str = "rgb"
    mean: Sequence[float] = (0.0, 0.0, 0.0)
    normal: Sequence[float] = (1.0, 1.0, 1.0)
    target_size: Optional[Tuple[int, int]] = None  # (H, W)
    matrix: Optional[np.ndarray] = None            # 2 x 3 src -> dst affine
    layout: str = "nchw"                           # nchw | nhwc
    dtype: str = "float32"


class ImageProcess:
    def __init__(self, config: ImageProcessConfig, device=None):
        self.config = config
        self.device = device

    def __call__(self, img) -> torch.Tensor:
        c = self.config
        out = cvt_color(as_image(img, self.device), c.source_format, c.dest_format)
        if c.matrix is not None:
            if c.target_size is None:
                raise ValueError("matrix requires target_size")
            out = warp_affine(out, c.matrix, c.target_size)
        elif c.target_size is not None and tuple(out.shape[:2]) != tuple(c.target_size):
            out = resize(out, c.target_size)
        out = out.float()
        mean = torch.tensor(c.mean, dtype=torch.float32, device=out.device)
        normal = torch.tensor(c.normal, dtype=torch.float32, device=out.device)
        if out.dim() == 2:
            out = out[..., None]
        out = (out - mean) * normal
        if c.dtype == "bfloat16":
            out = out.to(torch.bfloat16)
        if c.layout == "nchw":
            out = out.permute(2, 0, 1)
        return out[None]   # the batch axis
