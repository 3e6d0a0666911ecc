"""Per-family vision preprocessing: one image -> the model's pixel or patch
layout and the number of image tokens to splice into the prompt.

Counterpart of the JAX package's `runtime/vision_preprocess.py`, numpy in
and numpy out, the resize through `cv/geometric.py` (the JAX package's
antialiased linear resize) on `device` (None: the card, which raises when
there is none; pass `device="cpu"` to resize on the host):

  qwen2    : align H/W to patch*merge (28), duplicate the frame to fill the
             temporal patch, [grid_t*grid_h*grid_w, patch_pixels] flattened
             patches (tokens = grid / merge^2 after the 2x2 merger)
  smolvlm  : one global image at size_unit^2 plus, when larger, an aligned
             grid of size_unit^2 tiles
  minicpm  : the best slice grid <= max_slices by aspect ratio, a global
             thumbnail first, then the slices
  hunyuan  : qwen2-style patch alignment (patch 16, merge 2, temporal 1)
  gemma4   : align to patch*pool (48), shrink until patches <= 2520; the
             3x3-pooled encoder emits <= 280 soft tokens
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from mnn_tpu_torch.cv.geometric import resize

# normalisation in 0..255 space (mean, 1/std)
CLIP_MEAN = np.asarray([122.7709383, 116.7460125, 104.09373615], np.float32)
CLIP_INV_STD = np.asarray([0.01459843, 0.01500777, 0.01422007], np.float32)


@dataclasses.dataclass
class VisionOut:
    pixels: np.ndarray        # family-specific layout (see each function)
    num_tokens: int           # image tokens to splice into the stream
    grid: Tuple[int, ...]     # family-specific grid info


def _resize_norm(image: np.ndarray, h: int, w: int, device=None,
                 mean=CLIP_MEAN, inv_std=CLIP_INV_STD) -> np.ndarray:
    """uint8 HWC RGB -> normalised f32 [h, w, 3] (antialiased linear)."""
    img = resize(image.astype(np.float32), (h, w), device=device).cpu().numpy()
    return (img - mean) * inv_std


def _round_align(v: int, align: int) -> int:
    return max(align, int(round(v / align)) * align)


def qwen2_preprocess(image: np.ndarray, *, patch: int = 14, merge: int = 2,
                     temporal: int = 2, device=None) -> VisionOut:
    """Qwen2-VL / Qwen2.5-VL: pixels [grid_t*grid_h*grid_w, temporal*patch*patch*3]."""
    ih, iw = image.shape[:2]
    align = patch * merge
    h = _round_align(ih, align)
    w = _round_align(iw, align)
    px = _resize_norm(image, h, w, device)              # [h, w, 3]
    frames = np.stack([px] * temporal)                   # temporal fill
    gt, gh, gw = 1, h // patch, w // patch
    pt = frames.reshape(gt, temporal, h // patch, patch, w // patch,
                        patch, 3)
    pt = pt.transpose(0, 2, 4, 1, 3, 5, 6)
    patches = pt.reshape(gt * gh * gw, temporal * patch * patch * 3)
    return VisionOut(pixels=patches,
                     num_tokens=gt * (gh // merge) * (gw // merge),
                     grid=(gt, gh, gw))


def hunyuan_preprocess(image: np.ndarray, *, patch: int = 16,
                       merge: int = 2, device=None) -> VisionOut:
    """Hunyuan: qwen2's layout with temporal_patch_size 1."""
    ih, iw = image.shape[:2]
    align = patch * merge
    h = _round_align(ih, align)
    w = _round_align(iw, align)
    px = _resize_norm(image, h, w, device)
    gh, gw = h // patch, w // patch
    pt = px.reshape(gh, patch, gw, patch, 3).transpose(0, 2, 1, 3, 4)
    patches = pt.reshape(gh * gw, patch * patch * 3)
    return VisionOut(pixels=patches,
                     num_tokens=(gh // merge) * (gw // merge),
                     grid=(1, gh, gw))


def smolvlm_preprocess(image: np.ndarray, *, size_unit: int = 512,
                       max_size: int = 2048,
                       tokens_per_tile: int = 64, device=None) -> VisionOut:
    """SmolVLM: a global tile + aligned grid of
    size_unit tiles when the image exceeds one tile. pixels: [n_tiles+1,
    size_unit, size_unit, 3], tiles row-major then the global image."""
    ih, iw = image.shape[:2]
    tiles = []
    grid_h = grid_w = 0
    if ih > size_unit or iw > size_unit:
        h = min(_round_align(ih, size_unit), max_size)
        w = min(_round_align(iw, size_unit), max_size)
        px = _resize_norm(image, h, w, device)
        grid_h, grid_w = h // size_unit, w // size_unit
        for r in range(grid_h):
            for c in range(grid_w):
                tiles.append(px[r * size_unit:(r + 1) * size_unit,
                                c * size_unit:(c + 1) * size_unit])
    tiles.append(_resize_norm(image, size_unit, size_unit, device))  # global
    n_tiles = len(tiles)
    return VisionOut(pixels=np.stack(tiles),
                     num_tokens=n_tiles * tokens_per_tile,
                     grid=(grid_h, grid_w))


def _minicpm_best_grid(ih: int, iw: int, max_slices: int) -> Tuple[int, int]:
    """Pick the slice grid (rows, cols) <= max_slices whose aspect ratio is
    closest to the image's (the minicpm-V adaptive slicing rule)."""
    log_ratio = math.log(iw / ih)
    best = (1, 1)
    best_err = float("inf")
    for n in range(1, max_slices + 1):
        for rows in range(1, n + 1):
            if n % rows:
                continue
            cols = n // rows
            err = abs(log_ratio - math.log(cols / rows))
            if err < best_err or (err == best_err and n > best[0] * best[1]):
                best_err = err
                best = (rows, cols)
    return best


def minicpm_preprocess(image: np.ndarray, *, slice_size: int = 448,
                       max_slices: int = 9,
                       tokens_per_slice: int = 96, device=None) -> VisionOut:
    """MiniCPM-V: a global thumbnail plus an
    aspect-ratio-matched grid of slices. pixels: [n_slices+1, slice_size,
    slice_size, 3] (thumbnail first)."""
    ih, iw = image.shape[:2]
    rows, cols = _minicpm_best_grid(ih, iw, max_slices)
    out = [_resize_norm(image, slice_size, slice_size, device)]   # thumbnail
    if rows * cols > 1:
        px = _resize_norm(image, rows * slice_size, cols * slice_size, device)
        for r in range(rows):
            for c in range(cols):
                out.append(px[r * slice_size:(r + 1) * slice_size,
                              c * slice_size:(c + 1) * slice_size])
    return VisionOut(pixels=np.stack(out),
                     num_tokens=len(out) * tokens_per_slice,
                     grid=(rows, cols))


def gemma4_preprocess(image: np.ndarray, *, patch: int = 16, pool: int = 3,
                      max_soft_tokens: int = 280, device=None) -> VisionOut:
    """Gemma 4: align to patch*pool (48), shrink
    the longer side until total patches <= max_soft_tokens * pool² (2520);
    rescale-only normalization (mean 0, 1/255). pixels: [h, w, 3]."""
    ih, iw = image.shape[:2]
    align = patch * pool
    h = _round_align(ih, align)
    w = _round_align(iw, align)
    max_patches = max_soft_tokens * pool * pool
    while (h // patch) * (w // patch) > max_patches:
        if h >= w:
            h -= align
        else:
            w -= align
    px = _resize_norm(image, h, w, device, mean=np.zeros(3, np.float32),
                      inv_std=np.full(3, 1.0 / 255.0, np.float32))
    gh, gw = h // patch, w // patch
    return VisionOut(pixels=px,
                     num_tokens=(gh // pool) * (gw // pool),
                     grid=(1, gh, gw))


FAMILIES = {
    "qwen2": qwen2_preprocess,
    "hunyuan": hunyuan_preprocess,
    "smolvlm": smolvlm_preprocess,
    "minicpm": minicpm_preprocess,
    "gemma4": gemma4_preprocess,
}


def preprocess(family: str, image: np.ndarray, device=None, **kw) -> VisionOut:
    """The preprocessing of `family` (a key of FAMILIES) on `device`."""
    if family not in FAMILIES:
        raise ValueError(f"unknown vision family {family!r}; "
                         f"have {sorted(FAMILIES)}")
    return FAMILIES[family](image, device=device, **kw)
