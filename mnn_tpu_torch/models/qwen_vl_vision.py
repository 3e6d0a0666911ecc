"""Qwen2.5-VL vision tower: 3-D patch convolution, 2-D rope over the patch
grid, window attention with a few full-attention blocks, and the 2x2
merger.

Counterpart of the JAX package's `models/qwen_vl_vision.py`. The window and
merge reorderings depend only on `grid_thw` and are numpy; the attention is
dense under a window or full block mask (f32 scores, softmax and products).
Plain torch ops in the JAX package's order and dtypes, f32 weights
(`from_hf_qwen_vl_vision`); the projections are `torch.matmul`, as the
reference's are plain `jnp.dot` and no Pallas kernel. Weights map 1:1 from
a HF Qwen2_5_VisionTransformerPretrainedModel state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import t_lin, t_vec
from mnn_tpu_torch.models.layers import rms_norm


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rms_eps: float = 1e-6

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny():
        return QwenVLVisionConfig(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
            patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
            window_size=16, out_hidden_size=48, fullatt_block_indexes=(1,))


# ---------------------------------------------------------------------------
# position and window bookkeeping in numpy: it depends only on grid_thw

def _rot_pos_ids(cfg: QwenVLVisionConfig, grid_thw) -> np.ndarray:
    """(h, w) patch position per token, in HF's merge-group ordering."""
    m = cfg.spatial_merge_size
    out = []
    for t, h, w in grid_thw:
        hp = np.arange(h)[:, None].repeat(w, 1)
        wp = np.arange(w)[None, :].repeat(h, 0)
        # merge-group ordering: (h/m, m, w/m, m) -> (h/m, w/m, m, m)
        hp = hp.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wp = wp.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        pos = np.stack([hp, wp], -1)
        out.append(np.tile(pos, (t, 1)))
    return np.concatenate(out)


def _window_index(cfg: QwenVLVisionConfig, grid_thw):
    """HF get_window_index: permutation of merge-units into attention
    windows + per-token window id (for masking) + image id."""
    m = cfg.spatial_merge_size
    ws = cfg.window_size // m // cfg.patch_size  # merge-units per window edge
    index_all: List[np.ndarray] = []
    window_ids: List[np.ndarray] = []
    image_ids: List[np.ndarray] = []
    start = 0
    wid_base = 0
    for img_i, (t, h, w) in enumerate(grid_thw):
        lh, lw = h // m, w // m
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        ph = (-lh) % ws
        pw = (-lw) % ws
        idxp = np.pad(idx, ((0, 0), (0, ph), (0, pw)), constant_values=-100)
        nh, nw = (lh + ph) // ws, (lw + pw) // ws
        idxp = idxp.reshape(t, nh, ws, nw, ws).transpose(0, 1, 3, 2, 4)
        idxp = idxp.reshape(t * nh * nw, ws * ws)
        for wi, row in enumerate(idxp):
            valid = row[row != -100]
            if valid.size == 0:
                continue
            index_all.append(valid + start)
            window_ids.append(np.full(valid.size, wid_base + wi))
            image_ids.append(np.full(valid.size, img_i))
        start += t * lh * lw
        wid_base += idxp.shape[0]
    return (np.concatenate(index_all), np.concatenate(window_ids),
            np.concatenate(image_ids))


# ---------------------------------------------------------------------------

def _attention(x, qkv_w, qkv_b, proj_w, proj_b, cos, sin, mask, num_heads):
    """Self-attention of x [S, D] under the bool mask [S, S], with the 2-D
    rope phases cos / sin [S, head_dim]."""
    s, d = x.shape
    hd = d // num_heads
    qkv = (torch.matmul(x.float(), qkv_w.float()) + qkv_b).to(x.dtype)
    q, k, v = (a.reshape(s, num_heads, hd) for a in qkv.chunk(3, dim=-1))

    def rot(a):
        af = a.float()
        half = torch.cat([-af[..., hd // 2:], af[..., :hd // 2]], dim=-1)
        return (af * cos[:, None] + half * sin[:, None]).to(a.dtype)

    q, k = rot(q), rot(k)
    scores = torch.einsum("shd,thd->hst", q.float(), k.float()) / np.sqrt(hd)
    scores = scores.masked_fill(~mask[None], float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("hst,thd->shd", attn.float(), v.float()).to(v.dtype)
    o = o.reshape(s, d)
    return (torch.matmul(o.float(), proj_w.float()) + proj_b).to(x.dtype)


def qwen_vl_vision_forward(p: Dict[str, torch.Tensor], cfg: QwenVLVisionConfig,
                           patches: torch.Tensor,
                           grid_thw: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """patches [S, C*tp*p*p] (the HF processor's layout), grid_thw a list of
    (t, h, w) in patches -> features [S / merge^2, out_hidden_size]."""
    grid_thw = [tuple(int(v) for v in g) for g in grid_thw]
    mm = cfg.spatial_merge_size ** 2
    s = patches.shape[0]
    dev = patches.device

    x = torch.matmul(patches.float(), p["patch_embed.proj.weight"].float()).to(patches.dtype)

    pos = _rot_pos_ids(cfg, grid_thw)                       # [S, 2]
    widx, window_id, image_id = _window_index(cfg, grid_thw)
    # the merge-unit permutation at token granularity, and each token's
    # window and image after it
    tok_perm = (widx[:, None] * mm + np.arange(mm)[None]).reshape(-1)
    tok_window = torch.from_numpy(np.repeat(window_id, mm)).to(dev)
    tok_image = torch.from_numpy(np.repeat(image_id, mm)).to(dev)

    half = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, half, 2) / half))
    angles = np.concatenate([pos[:, 0:1] * inv_freq[None],
                             pos[:, 1:2] * inv_freq[None]], -1)   # [S, hd/2]
    angles = angles[tok_perm]
    emb = np.concatenate([angles, angles], -1)
    cos = torch.from_numpy(np.cos(emb).astype(np.float32)).to(dev)
    sin = torch.from_numpy(np.sin(emb).astype(np.float32)).to(dev)

    win_mask = tok_window[:, None] == tok_window[None, :]
    full_mask = tok_image[:, None] == tok_image[None, :]

    x = x[torch.from_numpy(tok_perm).to(dev)]
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        mask = full_mask if i in cfg.fullatt_block_indexes else win_mask
        h = rms_norm(x, p[pre + "norm1.weight"], cfg.rms_eps)
        x = x + _attention(h, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"],
                           p[pre + "attn.proj.weight"], p[pre + "attn.proj.bias"],
                           cos, sin, mask, cfg.num_heads)
        h = rms_norm(x, p[pre + "norm2.weight"], cfg.rms_eps)
        gate = h @ p[pre + "mlp.gate_proj.weight"] + p[pre + "mlp.gate_proj.bias"]
        up = h @ p[pre + "mlp.up_proj.weight"] + p[pre + "mlp.up_proj.bias"]
        ff = F.silu(gate.float()).to(up.dtype) * up
        x = x + (ff @ p[pre + "mlp.down_proj.weight"]
                 + p[pre + "mlp.down_proj.bias"]).to(x.dtype)

    # merger: RMSNorm, the 2x2 merge units side by side, an MLP with
    # exact-erf GELU (HF's nn.GELU())
    x = rms_norm(x, p["merger.ln_q.weight"], cfg.rms_eps)
    x = x.reshape(s // mm, mm * cfg.hidden_size)
    x = x @ p["merger.mlp.0.weight"] + p["merger.mlp.0.bias"]
    x = F.gelu(x.float()).to(patches.dtype)
    x = x @ p["merger.mlp.2.weight"] + p["merger.mlp.2.bias"]
    # undo the window permutation (at merge-unit granularity)
    return x[torch.from_numpy(np.argsort(widx)).to(dev)]


def from_hf_qwen_vl_vision(state_dict, device=None) -> Dict[str, torch.Tensor]:
    """Map a HF Qwen2_5_VisionTransformerPretrainedModel state dict (also a
    whole checkpoint's, under "visual."), of tensors or arrays, to f32 on
    `device` (None: tensors stay on their device, arrays go to the card):
    linear weights [in, out], the patch convolution [C*tp*p*p, D]."""
    out = {}
    for key, val in state_dict.items():
        key = key.removeprefix("visual.")
        if key == "patch_embed.proj.weight":
            # Conv3d [D, C, tp, p, p] -> [C*tp*p*p, D]
            w = t_vec(val, device)
            out[key] = w.reshape(w.shape[0], -1).t().contiguous()
        elif key.endswith(".weight") and val.ndim == 2:
            out[key] = t_lin(val, device)
        else:
            out[key] = t_vec(val, device)
    return out


def random_hf_state_dict(cfg: QwenVLVisionConfig, generator: torch.Generator,
                         scale: float = 0.02) -> Dict[str, torch.Tensor]:
    """Seeded random weights in the HF layout and names (linear [out, in],
    Conv3d [D, C, tp, p, p], no prefix), f32 on the generator's device:
    normal(0, scale) weights and biases, norms 1 + normal(0, 0.1)."""
    dev = generator.device
    d, i, mm = cfg.hidden_size, cfg.intermediate_size, cfg.spatial_merge_size ** 2
    n = lambda *s: torch.randn(s, generator=generator, device=dev) * scale
    norm = lambda: 1 + torch.randn((d,), generator=generator, device=dev) * 0.1
    sd = {"patch_embed.proj.weight": n(d, cfg.in_channels, cfg.temporal_patch_size,
                                       cfg.patch_size, cfg.patch_size),
          "merger.ln_q.weight": norm(), "merger.mlp.0.weight": n(mm * d, mm * d),
          "merger.mlp.0.bias": n(mm * d), "merger.mlp.2.weight": n(cfg.out_hidden_size, mm * d),
          "merger.mlp.2.bias": n(cfg.out_hidden_size)}
    for b in range(cfg.depth):
        p = f"blocks.{b}."
        sd.update({p + "norm1.weight": norm(), p + "norm2.weight": norm(),
                   p + "attn.qkv.weight": n(3 * d, d), p + "attn.qkv.bias": n(3 * d),
                   p + "attn.proj.weight": n(d, d), p + "attn.proj.bias": n(d),
                   p + "mlp.gate_proj.weight": n(i, d), p + "mlp.gate_proj.bias": n(i),
                   p + "mlp.up_proj.weight": n(i, d), p + "mlp.up_proj.bias": n(i),
                   p + "mlp.down_proj.weight": n(d, i), p + "mlp.down_proj.bias": n(d)})
    return sd
