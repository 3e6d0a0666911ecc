"""SmoothQuant: migrating activation outliers into the weights for W8A8 / W4A8.

Counterpart of `mnn_tpu/quant/smooth.py`, which needs only numpy; the port
keeps its own copy. Per input channel j a factor

    s_j = max|X_j|^alpha / max|W_j|^(1 - alpha)

divides the activations and multiplies the weights (X' = X / s, W' = s W),
an exact identity in float that moves the outliers that dominate per-token
int8 error into the weights, where per-block scales absorb them. The
division folds into the preceding RMSNorm weight (gamma' = gamma / s), so
it costs nothing at run time. `collect_act_stats_torch` records each
`torch.nn.Linear`'s input-channel |X| max over a forward of a torch model.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def smooth_scales(
    act_absmax: np.ndarray,   # [K] per-channel |X| max from calibration
    w_absmax: np.ndarray,     # [K] per-channel |W| max (rows of [K, N])
    alpha: float = 0.5,
    eps: float = 1e-5,
) -> np.ndarray:
    a = np.maximum(np.asarray(act_absmax, np.float64), eps)
    w = np.maximum(np.asarray(w_absmax, np.float64), eps)
    s = a ** alpha / w ** (1.0 - alpha)
    # normalize so the typical channel is untouched (keeps norm gamma sane)
    s = s / np.exp(np.mean(np.log(s)))
    return np.clip(s, 1e-3, 1e3).astype(np.float32)


def fold_smoothing(
    norm_weight: np.ndarray,  # [K] RMSNorm gamma feeding the linear(s)
    weights: Dict[str, np.ndarray],  # name -> [K, N] linears sharing the input
    act_absmax: np.ndarray,
    alpha: float = 0.5,
):
    """Returns (norm_weight / s, {name: s[:, None] * W}) — exact in float."""
    w_absmax = np.max(
        np.stack([np.abs(np.asarray(w)).max(axis=1) for w in weights.values()]),
        axis=0,
    )
    s = smooth_scales(act_absmax, w_absmax, alpha)
    new_norm = np.asarray(norm_weight, np.float32) / s
    new_w = {k: np.asarray(w, np.float32) * s[:, None]
             for k, w in weights.items()}
    return new_norm, new_w, s


def collect_act_stats_torch(model, input_ids, layer_filter=None
                            ) -> Dict[str, np.ndarray]:
    """Per-Linear input-channel |X| max via torch forward hooks, over one
    no-grad forward of `model` on `input_ids`; `layer_filter(name)` picks
    the layers. The ids go to the device of the model's parameters."""
    stats: Dict[str, np.ndarray] = {}
    hooks = []

    def make_hook(name):
        def hook(mod, args, out):
            x = args[0].detach()
            m = x.abs().reshape(-1, x.shape[-1]).max(dim=0).values
            m = m.float().cpu().numpy()
            stats[name] = np.maximum(stats.get(name, 0.0), m)
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear) and (
                layer_filter is None or layer_filter(name)):
            hooks.append(mod.register_forward_hook(make_hook(name)))
    try:
        with torch.no_grad():
            dev = next(model.parameters()).device
            model(torch.as_tensor(input_ids, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return stats
