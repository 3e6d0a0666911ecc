"""The port's vision input against the JAX package, on the CPU: the
Qwen2.5-VL tower, the CLIP ViT, their `from_hf_*` mappings of seeded
HF-layout state dicts, the image resize, the five per-family
preprocessings and Omni's `preprocess_image`.

The JAX side is computed once in a module-scoped fixture. Bounds:

* towers (f32 weights and activations on both sides): rel-L2 1e-5 (the
  JAX tests hold the JAX tower to HF's torch model at atol 2e-4 and rtol
  2e-3, `tests/test_qwen_vl_vision.py`);
* `from_hf_*`: every mapped tensor equal;
* resize on 0..255 floats: within 1e-3 (4e-6 of the range), and within
  1e-6 of the range at an upscale where `F.interpolate(antialias=True)`
  misses by more than 1e-5; uint8: at most one level apart, in at most 0.1%
  of the values; nearest: equal;
* preprocessed pixels (normalised): within 1e-4; token counts and grids
  equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.cv import geometric as jgeo
from mnn_tpu.models import qwen_vl_vision as jqv
from mnn_tpu.models import vision_encoder as jve
from mnn_tpu.runtime import omni as jomni
from mnn_tpu.runtime import vision_preprocess as jvp
from mnn_tpu_torch.cv import geometric
from mnn_tpu_torch.models import qwen_vl_vision as qv
from mnn_tpu_torch.models import vision_encoder as ve
from mnn_tpu_torch.runtime import omni, vision_preprocess as vp
from tests.test_torch_decoder import rel

TOWER_REL = 1e-5
VL = qv.QwenVLVisionConfig.tiny()
# one image, a grid whose 3 x 5 merge units pad the 2-unit windows, two images
VL_GRIDS = {"one": [(1, 8, 8)], "padded": [(1, 6, 10)], "two": [(1, 4, 4), (1, 8, 4)]}
CLIP_ACTS = ("quick_gelu", "gelu", "gelu_new")
CLIP = dict(hidden=32, heads=2, patch=8, image=32, layers=2, inter=64)
IMAGE_HW = (900, 380)          # smolvlm tiles it (2 x 1), minicpm slices it
# a downscale, an upscale whose nearest rows tie, one axis unchanged
RESIZES = [((480, 640), (224, 224)), ((30, 20), (64, 50)), ((37, 53), (37, 90))]
# an upscale where F.interpolate(antialias=True) misses the JAX resize
UPSCALE = ((480, 640), (1344, 1792))


def vl_state_dict(cfg, rng) -> dict:
    """A seeded HF Qwen2_5_VisionTransformerPretrainedModel state dict
    (torch layouts: linear [out, in], Conv3d [D, C, tp, p, p]) under the
    "visual." prefix of a whole checkpoint."""
    d, i, mm = cfg.hidden_size, cfg.intermediate_size, cfg.spatial_merge_size ** 2
    n = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    sd = {"patch_embed.proj.weight": n(d, cfg.in_channels, cfg.temporal_patch_size,
                                       cfg.patch_size, cfg.patch_size),
          "merger.ln_q.weight": 1 + n(d), "merger.mlp.0.weight": n(mm * d, mm * d),
          "merger.mlp.0.bias": n(mm * d), "merger.mlp.2.weight": n(cfg.out_hidden_size, mm * d),
          "merger.mlp.2.bias": n(cfg.out_hidden_size)}
    for b in range(cfg.depth):
        p = f"blocks.{b}."
        sd.update({p + "norm1.weight": 1 + n(d), p + "norm2.weight": 1 + n(d),
                   p + "attn.qkv.weight": n(3 * d, d), p + "attn.qkv.bias": n(3 * d),
                   p + "attn.proj.weight": n(d, d), p + "attn.proj.bias": n(d),
                   p + "mlp.gate_proj.weight": n(i, d), p + "mlp.gate_proj.bias": n(i),
                   p + "mlp.up_proj.weight": n(i, d), p + "mlp.up_proj.bias": n(i),
                   p + "mlp.down_proj.weight": n(d, i), p + "mlp.down_proj.bias": n(d)})
    return {"visual." + k: v for k, v in sd.items()}


def clip_model(act: str, rng):
    """An object shaped like a CLIPVisionModel (`state_dict()` of seeded
    tensors in HF names, `config`), which the JAX `from_hf_clip` reads and
    the port's reads as `from_hf_clip(m.state_dict(), m.config)`."""
    c = CLIP
    d, n_pos = c["hidden"], (c["image"] // c["patch"]) ** 2 + 1
    n = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))
    pre = "vision_model."
    sd = {pre + "embeddings.patch_embedding.weight": n(d, 3, c["patch"], c["patch"]),
          pre + "embeddings.class_embedding": n(d),
          pre + "embeddings.position_embedding.weight": n(n_pos, d),
          pre + "pre_layrnorm.weight": 1 + n(d), pre + "pre_layrnorm.bias": n(d),
          pre + "post_layernorm.weight": 1 + n(d), pre + "post_layernorm.bias": n(d)}
    for i in range(c["layers"]):
        p = f"{pre}encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{name}.weight"] = n(d, d)
            sd[p + f"self_attn.{name}.bias"] = n(d)
        for name in ("layer_norm1", "layer_norm2"):
            sd[p + name + ".weight"] = 1 + n(d)
            sd[p + name + ".bias"] = n(d)
        sd.update({p + "mlp.fc1.weight": n(c["inter"], d), p + "mlp.fc1.bias": n(c["inter"]),
                   p + "mlp.fc2.weight": n(d, c["inter"]), p + "mlp.fc2.bias": n(d)})
    cfg = types.SimpleNamespace(num_hidden_layers=c["layers"], num_attention_heads=c["heads"],
                                patch_size=c["patch"], hidden_act=act)
    return types.SimpleNamespace(state_dict=lambda: sd, config=cfg)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(21)
    out = dict(vl_sd=vl_state_dict(VL, rng), vl={}, clip={}, pre={}, resize={})
    jp = jqv.from_hf_qwen_vl_vision(out["vl_sd"])
    out["vl_params"] = {k: np.asarray(v) for k, v in jp.items()}
    dim = VL.in_channels * VL.temporal_patch_size * VL.patch_size ** 2
    # jitted (one XLA graph a grid: a quarter of the eager dispatch's time)
    tower = jax.jit(jqv.qwen_vl_vision_forward, static_argnums=(1, 3))
    for name, grids in VL_GRIDS.items():
        s = sum(t * h * w for t, h, w in grids)
        patches = rng.standard_normal((s, dim)).astype(np.float32)
        out["vl"][name] = (patches, np.asarray(
            tower(jp, VL, jnp.asarray(patches), tuple(grids))))
    pixels = rng.standard_normal((2, 3, CLIP["image"], CLIP["image"])).astype(np.float32)
    out["pixels"] = pixels
    for act in CLIP_ACTS:
        model = clip_model(act, rng)
        p = jve.from_hf_clip(model)
        feats = jve.vit_forward(p, jnp.asarray(pixels))
        out["clip"][act] = (model, p, np.asarray(feats),
                            np.asarray(jve.vit_pooled(p, feats)))
    image = rng.integers(0, 256, (*IMAGE_HW, 3), dtype=np.uint8)
    out["image"] = image
    for fam in jvp.FAMILIES:
        o = jvp.preprocess(fam, image)
        out["pre"][fam] = (np.asarray(o.pixels), o.num_tokens, tuple(o.grid))
    for src, dst in RESIZES:
        img = rng.integers(0, 256, (*src, 3)).astype(np.float32)
        out["resize"][src, dst] = (img, {
            "float": np.asarray(jgeo.resize(jnp.asarray(img), dst)),
            "uint8": np.asarray(jgeo.resize(jnp.asarray(img.astype(np.uint8)), dst)),
            "nearest": np.asarray(jgeo.resize(jnp.asarray(img), dst, method="nearest"))})
    img = out["resize"][RESIZES[1]][0][..., 0]          # one gray (2-D) image
    out["gray"] = (img, np.asarray(jgeo.resize(jnp.asarray(img), RESIZES[1][1])))
    img = rng.integers(0, 256, (*UPSCALE[0], 3)).astype(np.float32)
    out["upscale"] = (img, np.asarray(jgeo.resize(jnp.asarray(img), UPSCALE[1])))
    out["clip_image"] = np.asarray(jomni.preprocess_image(image[:200, :300]))
    return out


def test_from_hf_qwen_vl_vision_matches_jax(ref):
    got = qv.from_hf_qwen_vl_vision(ref["vl_sd"], "cpu")
    want = ref["vl_params"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # tensors map too, and stay on their device
    t = qv.from_hf_qwen_vl_vision({k: torch.from_numpy(v) for k, v in ref["vl_sd"].items()})
    assert all(torch.equal(t[k], got[k]) for k in got)


@pytest.mark.parametrize("case", list(VL_GRIDS))
def test_qwen_vl_tower_matches_jax(ref, case):
    params = qv.from_hf_qwen_vl_vision(ref["vl_sd"], "cpu")
    patches, want = ref["vl"][case]
    got = qv.qwen_vl_vision_forward(params, VL, torch.from_numpy(patches), VL_GRIDS[case])
    n_tok = sum(t * h * w for t, h, w in VL_GRIDS[case]) // VL.spatial_merge_size ** 2
    assert tuple(got.shape) == want.shape == (n_tok, VL.out_hidden_size)
    assert rel(got.numpy(), want) <= TOWER_REL, rel(got.numpy(), want)


def test_qwen_vl_windows_and_rope_order_match_jax():
    for grids in VL_GRIDS.values():
        np.testing.assert_array_equal(qv._rot_pos_ids(VL, grids), jqv._rot_pos_ids(VL, grids))
        for a, b in zip(qv._window_index(VL, grids), jqv._window_index(VL, grids)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act", CLIP_ACTS)
def test_clip_vit_matches_jax(ref, act):
    model, jp, feats, pooled = ref["clip"][act]
    p = ve.from_hf_clip(model.state_dict(), model.config)
    assert p.act == act and p.patch == CLIP["patch"] and p.num_heads == CLIP["heads"]
    np.testing.assert_array_equal(p.patch_embed.numpy(), np.asarray(jp.patch_embed))
    np.testing.assert_array_equal(p.layers.wq.numpy(), np.asarray(jp.layers.wq))
    got = ve.vit_forward(p, torch.from_numpy(ref["pixels"]))
    assert tuple(got.shape) == feats.shape == (2, (CLIP["image"] // CLIP["patch"]) ** 2 + 1,
                                               CLIP["hidden"])
    assert rel(got.numpy(), feats) <= TOWER_REL
    assert rel(ve.vit_pooled(p, got).numpy(), pooled) <= TOWER_REL


@pytest.mark.parametrize("fam", list(jvp.FAMILIES))
def test_preprocess_families_match_jax(ref, fam):
    want, n_tok, grid = ref["pre"][fam]
    got = vp.preprocess(fam, ref["image"], device="cpu")
    assert got.num_tokens == n_tok and tuple(got.grid) == grid
    assert got.pixels.shape == want.shape and got.pixels.dtype == np.float32
    np.testing.assert_allclose(got.pixels, want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="unknown vision family"):
        vp.preprocess("nope", ref["image"])


@pytest.mark.parametrize("shapes", RESIZES, ids=lambda s: f"{s[0]}->{s[1]}")
def test_resize_matches_jax(ref, shapes):
    img, want = ref["resize"][shapes]
    dst = shapes[1]
    np.testing.assert_allclose(geometric.resize(img, dst, device="cpu").numpy(),
                               want["float"], atol=1e-3, rtol=0)
    u8 = geometric.resize(img.astype(np.uint8), dst, device="cpu").numpy()
    assert u8.dtype == np.uint8
    off = np.abs(u8.astype(int) - want["uint8"].astype(int))
    assert off.max() <= 1 and (off > 0).mean() <= 1e-3
    np.testing.assert_array_equal(geometric.resize(img, dst, "nearest", "cpu").numpy(),
                                  want["nearest"])


def test_resize_takes_a_gray_image(ref):
    img, want = ref["gray"]
    got = geometric.resize(torch.from_numpy(img), RESIZES[1][1])
    assert tuple(got.shape) == want.shape == RESIZES[1][1]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_resize_is_nearer_jax_than_interpolate(ref):
    """Why `resize` builds JAX's weights: at this upscale
    `F.interpolate(antialias=True)` sits more than 1e-5 of the 0..255 range
    from the JAX resize (its sample coordinates round differently); the
    port's stays within 1e-6 of the range."""
    img, want = ref["upscale"]
    got = geometric.resize(img, UPSCALE[1], device="cpu").numpy()
    interp = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(2, 0, 1)[None], size=UPSCALE[1], mode="bilinear",
        antialias=True, align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(got - want).max() / 255 <= 1e-6
    assert np.abs(interp - want).max() / 255 > 1e-5


def test_preprocess_image_matches_jax(ref):
    got = omni.preprocess_image(ref["image"][:200, :300], device="cpu")
    assert tuple(got.shape) == (1, 3, 224, 224)
    np.testing.assert_allclose(got.numpy(), ref["clip_image"], atol=1e-4, rtol=0)


DEFAULT_DEVICE_CALLS = {
    "preprocess_image": lambda r: omni.preprocess_image(r["image"][:64, :64]),
    "preprocess": lambda r: vp.preprocess("qwen2", r["image"]),
    "resize": lambda r: geometric.resize(r["image"], (32, 32)),
    "from_hf_qwen_vl_vision": lambda r: qv.from_hf_qwen_vl_vision(r["vl_sd"]),
    "from_hf_clip": lambda r: ve.from_hf_clip(
        {k: v.numpy() for k, v in r["clip"]["gelu"][0].state_dict().items()},
        r["clip"]["gelu"][0].config),
}


@pytest.mark.parametrize("entry", list(DEFAULT_DEVICE_CALLS))
def test_array_inputs_need_a_device_or_the_card(ref, entry):
    """Given arrays and no device, the vision entry points go to the card
    and raise without one, as `Llm` does; they never run quietly on the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry](ref)


def test_embed_multimodal_splices_one_image():
    emb = torch.randn(16, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    feats = torch.ones(3, 8)
    got = ve.embed_multimodal(emb, [1, 2, -1, 3], feats, -1)
    assert tuple(got.shape) == (1, 6, 8) and got.dtype == torch.bfloat16
    assert torch.equal(got[0, 2:5], torch.ones(3, 8, dtype=torch.bfloat16))
    assert torch.equal(got[0, [0, 1, 5]], emb[[1, 2, 3]])
    want = jve.embed_multimodal(jnp.asarray(emb.float().numpy()), [1, 2, -1, 3],
                                jnp.ones((3, 8)), -1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))
    assert torch.equal(ve.embed_multimodal(emb, [4, 5], feats, -1)[0], emb[[4, 5]])
