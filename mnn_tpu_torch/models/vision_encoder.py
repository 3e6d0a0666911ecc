"""CLIP vision transformer, Qwen2-VL mrope position ids and the LLaVA-style
image splice.

Counterpart of the JAX package's `models/vision_encoder.py`, in plain torch
ops in its order and dtypes: f32 weights (`from_hf_clip`), the patch
convolution as a reshape and a product, pre-LN blocks with f32 attention
(scores, softmax) and quick_gelu / gelu / gelu_new. The projections are
`torch.matmul`: the reference runs plain `jnp.dot` and einsum there, no
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import types
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.diffusion.nn import t_lin, t_vec


def _ln(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class VitLayer:
    """Per-layer weights stacked on a leading layer axis, linear weights
    stored [in, out]."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wq: torch.Tensor    # [L, D, D]
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_w: torch.Tensor  # [L, D, 4D]
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor


@dataclasses.dataclass(frozen=True)
class VitParams:
    patch_embed: torch.Tensor            # [3*P*P, D], the flattened convolution
    class_embed: Optional[torch.Tensor]  # [D] (CLIP's CLS token)
    pos_embed: torch.Tensor              # [n_pos, D]
    pre_ln_w: Optional[torch.Tensor]
    pre_ln_b: Optional[torch.Tensor]
    post_ln_w: torch.Tensor
    post_ln_b: torch.Tensor
    layers: VitLayer
    num_heads: int = 12
    patch: int = 32
    act: str = "quick_gelu"


def vit_forward(p: VitParams, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W] -> features [B, tokens, D] f32 (CLIP's last
    hidden state, before the pooled CLS's post-LN)."""
    b, c, hh, ww = pixels.shape
    ph = p.patch
    d = p.patch_embed.shape[1]
    x = pixels.reshape(b, c, hh // ph, ph, ww // ph, ph)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, c * ph * ph)
    x = torch.matmul(x.float(), p.patch_embed.float())
    if p.class_embed is not None:
        cls = p.class_embed[None, None].expand(b, 1, d)
        x = torch.cat([cls, x.to(cls.dtype)], dim=1)
    x = x + p.pos_embed[None, : x.shape[1]]
    if p.pre_ln_w is not None:
        x = _ln(x, p.pre_ln_w, p.pre_ln_b)
    x = x.float()

    nh = p.num_heads
    hd = d // nh
    lay = p.layers
    heads = lambda t: t.reshape(b, -1, nh, hd).transpose(1, 2)
    for i in range(lay.wq.shape[0]):
        h = _ln(x, lay.ln1_w[i], lay.ln1_b[i])
        q = heads(h @ lay.wq[i] + lay.bq[i])
        k = heads(h @ lay.wk[i] + lay.bk[i])
        v = heads(h @ lay.wv[i] + lay.bv[i])
        s = (q @ k.transpose(-1, -2)) / (hd ** 0.5)
        a = torch.softmax(s.float(), dim=-1).to(v.dtype)
        o = (a @ v).transpose(1, 2).reshape(b, -1, d)
        x = x + (o @ lay.wo[i] + lay.bo[i])
        h2 = _ln(x, lay.ln2_w[i], lay.ln2_b[i])
        pre = h2 @ lay.fc1_w[i] + lay.fc1_b[i]
        if p.act == "quick_gelu":   # CLIP's default
            ff = pre * torch.sigmoid(1.702 * pre)
        else:
            ff = F.gelu(pre, approximate="tanh" if p.act == "gelu_new" else "none")
        x = x + (ff @ lay.fc2_w[i] + lay.fc2_b[i])
    return x


def vit_pooled(p: VitParams, features: torch.Tensor) -> torch.Tensor:
    """CLIP's pooled output, the post-LN CLS token: [B, T, D] -> [B, D]."""
    return _ln(features[:, 0], p.post_ln_w, p.post_ln_b)


def from_hf_clip(sd, cfg, device=None) -> VitParams:
    """Map a CLIPVisionModel's weights, `from_hf_clip(m.state_dict(),
    m.config)`: `sd` in HF names under "vision_model." (tensors or arrays,
    to f32 on `device`; None: tensors stay on their device, arrays go to the
    card), `cfg` with num_hidden_layers, num_attention_heads, patch_size
    and, optionally, hidden_act."""
    pre = "vision_model."
    n_layers = cfg.num_hidden_layers

    def stack(fmt, transpose=False):
        conv = t_lin if transpose else t_vec
        return torch.stack([conv(sd[pre + fmt.format(i)], device) for i in range(n_layers)])

    def vec(key):
        return t_vec(sd[pre + key], device)

    conv = vec("embeddings.patch_embedding.weight")               # [D, 3, P, P]
    layers = VitLayer(
        ln1_w=stack("encoder.layers.{}.layer_norm1.weight"),
        ln1_b=stack("encoder.layers.{}.layer_norm1.bias"),
        wq=stack("encoder.layers.{}.self_attn.q_proj.weight", True),
        bq=stack("encoder.layers.{}.self_attn.q_proj.bias"),
        wk=stack("encoder.layers.{}.self_attn.k_proj.weight", True),
        bk=stack("encoder.layers.{}.self_attn.k_proj.bias"),
        wv=stack("encoder.layers.{}.self_attn.v_proj.weight", True),
        bv=stack("encoder.layers.{}.self_attn.v_proj.bias"),
        wo=stack("encoder.layers.{}.self_attn.out_proj.weight", True),
        bo=stack("encoder.layers.{}.self_attn.out_proj.bias"),
        ln2_w=stack("encoder.layers.{}.layer_norm2.weight"),
        ln2_b=stack("encoder.layers.{}.layer_norm2.bias"),
        fc1_w=stack("encoder.layers.{}.mlp.fc1.weight", True),
        fc1_b=stack("encoder.layers.{}.mlp.fc1.bias"),
        fc2_w=stack("encoder.layers.{}.mlp.fc2.weight", True),
        fc2_b=stack("encoder.layers.{}.mlp.fc2.bias"),
    )
    return VitParams(
        patch_embed=conv.reshape(conv.shape[0], -1).t().contiguous(),
        class_embed=vec("embeddings.class_embedding"),
        pos_embed=vec("embeddings.position_embedding.weight"),
        pre_ln_w=vec("pre_layrnorm.weight"), pre_ln_b=vec("pre_layrnorm.bias"),
        post_ln_w=vec("post_layernorm.weight"), post_ln_b=vec("post_layernorm.bias"),
        layers=layers, num_heads=cfg.num_attention_heads, patch=cfg.patch_size,
        act=getattr(cfg, "hidden_act", "quick_gelu"))


def random_hf_clip(generator: torch.Generator, *, hidden: int, heads: int,
                   patch: int, image: int, layers: int, inter: int,
                   act: str = "quick_gelu", scale: float = 0.02):
    """Seeded random CLIP vision weights in the HF names and layouts, and
    their config, for `from_hf_clip(*random_hf_clip(...))`: f32 on the
    generator's device, normal(0, scale) weights and biases, norms
    1 + normal(0, 0.1)."""
    dev = generator.device
    n = lambda *s: torch.randn(s, generator=generator, device=dev) * scale
    norm = lambda: 1 + torch.randn((hidden,), generator=generator, device=dev) * 0.1
    pre = "vision_model."
    sd = {pre + "embeddings.patch_embedding.weight": n(hidden, 3, patch, patch),
          pre + "embeddings.class_embedding": n(hidden),
          pre + "embeddings.position_embedding.weight": n((image // patch) ** 2 + 1, hidden),
          pre + "pre_layrnorm.weight": norm(), pre + "pre_layrnorm.bias": n(hidden),
          pre + "post_layernorm.weight": norm(), pre + "post_layernorm.bias": n(hidden)}
    for i in range(layers):
        p = f"{pre}encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{name}.weight"] = n(hidden, hidden)
            sd[p + f"self_attn.{name}.bias"] = n(hidden)
        for name in ("layer_norm1", "layer_norm2"):
            sd[p + name + ".weight"] = norm()
            sd[p + name + ".bias"] = n(hidden)
        sd.update({p + "mlp.fc1.weight": n(inter, hidden), p + "mlp.fc1.bias": n(inter),
                   p + "mlp.fc2.weight": n(hidden, inter), p + "mlp.fc2.bias": n(hidden)})
    cfg = types.SimpleNamespace(num_hidden_layers=layers, num_attention_heads=heads,
                                patch_size=patch, hidden_act=act)
    return sd, cfg


def build_mrope_positions(token_ids, image_token_id=None, grid_hw=None,
                          start: int = 0) -> np.ndarray:
    """Qwen2-VL (temporal, height, width) position ids [1, T, 3] int32.

    Text tokens advance all three components together (mrope then equals
    plain rope). A run of gh * gw image tokens (row-major over `grid_hw`)
    shares one temporal position while height and width walk the grid;
    positions resume after the image at that position + max(gh, gw)."""
    ids = list(token_ids)
    pos = np.zeros((len(ids), 3), np.int32)
    cur = start
    i = 0
    while i < len(ids):
        if image_token_id is not None and ids[i] == image_token_id:
            gh, gw = grid_hw
            n = gh * gw
            run = ids[i:i + n]
            if len(run) != n or any(t != image_token_id for t in run):
                raise ValueError("image token run shorter than grid")
            rows = np.repeat(np.arange(gh, dtype=np.int32), gw)
            cols = np.tile(np.arange(gw, dtype=np.int32), gh)
            pos[i:i + n, 0] = cur
            pos[i:i + n, 1] = cur + rows
            pos[i:i + n, 2] = cur + cols
            cur += int(max(gh, gw))
            i += n
        else:
            pos[i] = cur
            cur += 1
            i += 1
    return pos[None]


def embed_multimodal(embedding: torch.Tensor, token_ids: List[int],
                     image_features: torch.Tensor, image_token_id: int) -> torch.Tensor:
    """Replace the one <image> placeholder in `token_ids` with the image's
    embeddings [n, H] -> [1, T - 1 + n, H] in the embedding's dtype."""
    ids = list(token_ids)
    idx = lambda a: torch.tensor(a, dtype=torch.int64, device=embedding.device)
    if image_token_id in ids:
        pos = ids.index(image_token_id)
        parts = [embedding[idx(ids[:pos])], image_features.to(embedding.dtype),
                 embedding[idx(ids[pos + 1:])]]
    else:
        parts = [embedding[idx(ids)]]
    return torch.cat(parts, dim=0)[None]
