"""AWQ: activation-aware weight quantization, the scale search and clipping.

Counterpart of `mnn_tpu/quant/awq_search.py`, in torch on the device the
inputs lie on (the converter runs it on the card a layer at a time).
Salient weight channels, those that multiply large activations, are
scaled up before quantization, so they use more of the grid, and the
matching input channel is scaled down by folding the inverse into the
producing op, which keeps the float function:

    y = x @ W = (x / s) @ (s * W)        s >= 1 on salient channels

The folds (each exact in float):
    qkv        <- input RMSNorm weight      (norm(x) g -> norm(x) (g / s))
    gate/up    <- post-attention RMSNorm weight
    o_proj     <- V columns of wqkv         (att = P @ V, channel by channel)
    down_proj  <- UP columns of wgu         (act_i = silu(g_i) u_i)

`search_scale` / `search_clip` work on one (x samples, W) pair;
`awq_scale_block` searches and folds the four of one decoder layer.

On the card every product is an f32 matmul, so TF32 must be off
(PyTorch's default): the search compares errors a few ulps apart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mnn_tpu_torch.quant.quantize import as_f32, choose_block_size, dequantize, quantize


SCALE_GRID = 20     # ratios r = i / SCALE_GRID, i < SCALE_GRID
CLIP_GRID = 10      # clip steps alpha = 1 - max_shrink i / CLIP_GRID, i <= CLIP_GRID


def _check_precision(t: torch.Tensor):
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the AWQ search needs f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _quant_err(x, w, bits, block_size, sym, y_ref, inv_s=None) -> torch.Tensor:
    """MSE of x' @ dequant(quantize(w)) against y_ref (x' = x inv_s)."""
    ql = quantize(w, bits=bits, block_size=choose_block_size(w.shape[0], block_size),
                  sym=sym)
    xs = x if inv_s is None else x * inv_s
    return ((xs @ dequantize(ql) - y_ref) ** 2).mean()


def _search_scale(x, w, *, bits=4, block_size=128, sym=False, n_grid=SCALE_GRID,
                  channel_groups=None):
    """search_scale on f32 tensors of one device: s and the grid step i it
    chose (r = i / n_grid; 0: the identity), both on the device."""
    _check_precision(x)
    y_ref = x @ w
    act = x.abs().mean(dim=0) + 1e-8                           # [K]
    if channel_groups is not None:
        g = torch.as_tensor(np.asarray(channel_groups), device=x.device).long()
        ng = int(np.max(channel_groups)) + 1
        sums = torch.zeros(ng, device=x.device).index_add_(0, g, act)
        counts = torch.zeros(ng, device=x.device).index_add_(0, g, torch.ones_like(act))
        act = (sums / counts)[g]
    best_s = torch.ones(w.shape[0], device=x.device)
    best_i = torch.zeros((), dtype=torch.int32, device=x.device)
    best_err = _quant_err(x, w, bits, block_size, sym, y_ref)
    for i in range(1, n_grid):       # the choice stays on the device
        s = act ** (i / n_grid)
        s = torch.clamp(s / torch.sqrt(s.max() * s.min()), 1e-4, 1e4)
        err = _quant_err(x, w * s[:, None], bits, block_size, sym, y_ref,
                         inv_s=1.0 / s)
        better = err < best_err
        best_s = torch.where(better, s, best_s)
        best_i = torch.where(better, i, best_i)
        best_err = torch.minimum(err, best_err)
    return best_s, best_i


def search_scale(
    x,                     # [S, K] sampled layer inputs
    w,                     # [K, N] float weights (possibly several fused)
    *,
    bits: int = 4,
    block_size: int = 128,
    sym: bool = False,
    n_grid: int = SCALE_GRID,
    channel_groups: Optional[np.ndarray] = None,   # [K] int group ids
    device=None,
) -> torch.Tensor:
    """Grid search of the per-input-channel scale s [K], on `device`
    (None: x's own device if a tensor, else the card).

    The candidate at ratio r is s = mean|x|^r, normalized so that
    sqrt(max s * min s) = 1; r = 0 is the identity. The r whose quantized
    reconstruction of x @ w has the least MSE wins. `channel_groups` holds
    s constant within each group (statistics pooled by group): under GQA
    every query head of a KV group reads the same V column, so the o_proj
    scale must be uniform over the group for the V fold to stay exact."""
    x = as_f32(x, device)
    return _search_scale(x, as_f32(w, x.device), bits=bits, block_size=block_size,
                         sym=sym, n_grid=n_grid, channel_groups=channel_groups)[0]


def _search_clip(x, w, *, bits=4, block_size=128, sym=False, n_grid=CLIP_GRID,
                 max_shrink=0.5):
    """search_clip on f32 tensors of one device: the weights and each
    column's step i (alpha = 1 - max_shrink i / n_grid; 0: unclipped)."""
    _check_precision(x)
    y_ref = x @ w                                              # [S, N]
    bs = choose_block_size(w.shape[0], block_size)

    def col_err(wc):
        ql = quantize(wc, bits=bits, block_size=bs, sym=sym)
        return ((x @ dequantize(ql) - y_ref) ** 2).mean(dim=0)   # [N]

    lo = w.amin(dim=0, keepdim=True)
    hi = w.amax(dim=0, keepdim=True)
    best_w, best_err = w, col_err(w)
    best_i = torch.zeros(w.shape[1], dtype=torch.int32, device=x.device)
    steps = max(1, n_grid)
    for i in range(1, steps + 1):
        alpha = 1.0 - max_shrink * i / steps
        wc = torch.clamp(w, lo * alpha, hi * alpha)
        err = col_err(wc)
        keep = err < best_err
        best_w = torch.where(keep[None, :], wc, best_w)
        best_i = torch.where(keep, i, best_i)
        best_err = torch.minimum(err, best_err)
    return best_w, best_i


def search_clip(
    x,                     # [S, K]
    w,                     # [K, N]
    *,
    bits: int = 4,
    block_size: int = 128,
    sym: bool = False,
    n_grid: int = CLIP_GRID,
    max_shrink: float = 0.5,
    device=None,
) -> torch.Tensor:
    """Per-output-channel clipping of the weight range before quantization:
    the range [wmin, wmax] narrowed by alpha = 1 - max_shrink i / n_grid
    trades a little clamping error on outliers for a finer grid on the
    bulk; each column keeps the alpha of least reconstruction MSE on the
    sampled inputs. Returns the clipped float weights, on `device` (as
    `search_scale`)."""
    x = as_f32(x, device)
    return _search_clip(x, as_f32(w, x.device), bits=bits, block_size=block_size,
                        sym=sym, n_grid=n_grid, max_shrink=max_shrink)[0]


@dataclasses.dataclass
class AwqLayerResult:
    """The float AWQ transform of one decoder layer, folds complete, with
    what the search chose: `ratios` (the scale ratio r of qkv, o, gu and
    down; 0 is the identity) and `clip_steps` (how many columns of o,
    down and gu took each clip step, 0 unclipped to CLIP_GRID, the
    narrowest)."""
    wqkv: torch.Tensor          # scaled [K, Nq]
    wo: torch.Tensor
    wgu: torch.Tensor           # gate/up interleaved [K, 2I]
    wdown: torch.Tensor
    input_norm: torch.Tensor    # 1 / s_qkv folded in
    post_norm: torch.Tensor     # 1 / s_gu folded in
    qkv_bias: Optional[torch.Tensor]   # the V slice rescaled with the o fold
    ratios: Dict[str, float] = dataclasses.field(default_factory=dict)
    clip_steps: Dict[str, list] = dataclasses.field(default_factory=dict)


def awq_scale_block(
    acts: Dict[str, object],   # inputs of 'qkv', 'o', 'gu', 'down': [S, K]
    wqkv, wo, wgu, wdown, input_norm, post_norm,
    *,
    v_cols,                    # wqkv output columns holding V
    up_cols,                   # wgu output columns holding UP
    qkv_bias=None,
    o_groups: Optional[np.ndarray] = None,   # [q_dim] KV group of each channel
    bits: int = 4,
    block_size: int = 128,
    sym: bool = False,
    clip: bool = True,
    device=None,
) -> AwqLayerResult:
    """Search and fold the four scale vectors of one decoder layer, on
    `device` (None: acts["qkv"]'s own device if a tensor, else the card).
    Weights are [K, N] (contraction first). The folds keep the float
    function up to reassociation; only the quantization error changes."""
    dev = as_f32(acts["qkv"], device).device
    a = {k: as_f32(v, dev) for k, v in acts.items()}
    w_qkv, w_o, w_gu, w_dn = (as_f32(m, dev).clone() for m in (wqkv, wo, wgu, wdown))
    g_in, g_post = as_f32(input_norm, dev), as_f32(post_norm, dev)
    kw = dict(bits=bits, block_size=block_size, sym=sym)
    grid = {}                   # each scale's grid step, on the device

    s_qkv, grid["qkv"] = _search_scale(a["qkv"], w_qkv, **kw)
    w_qkv = w_qkv * s_qkv[:, None]
    g_in = g_in / s_qkv

    s_gu, grid["gu"] = _search_scale(a["gu"], w_gu, **kw)
    w_gu = w_gu * s_gu[:, None]
    g_post = g_post / s_gu

    s_o, grid["o"] = _search_scale(a["o"], w_o, channel_groups=o_groups, **kw)
    w_o = w_o * s_o[:, None]
    # attention channel j comes from a V column: 1 / s goes into the V
    # columns and the V bias (attention is linear in V). Under GQA s_o is
    # constant on each group (o_groups): one value a V channel
    if o_groups is not None:
        groups = np.asarray(o_groups)
        first = np.array([int(np.argmax(groups == gid))
                          for gid in range(int(groups.max()) + 1)])
        s_v = s_o[torch.as_tensor(first, device=dev)]
    else:
        s_v = s_o
    v_idx = torch.as_tensor(np.arange(w_qkv.shape[1])[v_cols], device=dev)
    w_qkv[:, v_idx] = w_qkv[:, v_idx] / s_v[None, :]
    bias_out = None
    if qkv_bias is not None:
        bias_out = as_f32(qkv_bias, dev).clone()
        bias_out[v_idx] = bias_out[v_idx] / s_v

    s_dn, grid["down"] = _search_scale(a["down"], w_dn, **kw)
    w_dn = w_dn * s_dn[:, None]
    up_idx = torch.as_tensor(np.asarray(up_cols), device=dev)
    w_gu[:, up_idx] = w_gu[:, up_idx] / s_dn[None, :]

    steps = {}
    if clip:
        # the consumers of searched scales (qkv is fused and rope follows q
        # and k, so it is left unclipped)
        w_o, steps["o"] = _search_clip(a["o"] * (1.0 / s_o), w_o, **kw)
        w_dn, steps["down"] = _search_clip(a["down"] * (1.0 / s_dn), w_dn, **kw)
        w_gu, steps["gu"] = _search_clip(a["gu"] * (1.0 / s_gu), w_gu, **kw)
    return AwqLayerResult(
        wqkv=w_qkv, wo=w_o, wgu=w_gu, wdown=w_dn, input_norm=g_in, post_norm=g_post,
        qkv_bias=bias_out, ratios={k: int(v) / SCALE_GRID for k, v in grid.items()},
        clip_steps={k: torch.bincount(v.long(), minlength=CLIP_GRID + 1).tolist()
                    for k, v in steps.items()})
