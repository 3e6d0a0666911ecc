"""The port's diffusion package against the JAX package, on the CPU: the
`nn` primitives, the CLIP text encoder, the UNet, the VAE, the CFG pipeline,
`StableDiffusion` (`txt2img`, `from_pretrained`) and `cli txt2img`.

Shapes are the JAX tests' own: `UNetConfig.tiny()`, `VAEConfig.tiny()` and
the tiny `ClipTextConfig` of `tests/test_diffusion_models.py:170`. Weights
are seeded numpy arrays in the diffusers / HF layouts, mapped by each
package's own `from_diffusers` / `from_hf_clip_text`. The JAX side runs
once, in a module-scoped fixture. `jax.random` draws cannot be made in
torch: the port's noise helper (`diffusion.scheduler.noise`) is replaced by
JAX's draws, in the order JAX's `txt2img` splits its key. Bounds:

* `nn` primitives, CLIP text, one UNet forward, VAE decode and encode, in
  f32: within 1e-4 (rel-L2 for the models, whose outputs run to 1e2);
* the pipeline and `txt2img` latents after 3 steps in f32, for `ddim`,
  `ddpm` and `euler`: rel-L2 1e-3; the f32 image: within one level
  (`np.clip(...).astype(np.uint8)` truncates, so a value within an ulp of
  an integer can fall either side);
* bf16: the first CFG step's batch-2 UNet output and the latents of 3 steps
  at guidance 1: rel-L2 3e-2. At CFG 7.5 the first DDIM step (t = 999)
  multiplies the UNet's bf16 rounding noise by the guidance scale and by
  1 / sqrt(alphas_cumprod[999]), about 14.6: there the JAX package's own
  jitted and eager bf16 paths end about as far apart as the port is from
  either, near 3e-2, and the gap grows in proportion to the guidance scale,
  so the latents are held where the bound can tell a rounding-point fault
  from summation order (the port's sigmoid keeps JAX's three bf16 roundings
  for that reason, `diffusion/nn.sigmoid`);
* `from_pretrained`: the JAX package's parameters, mapped to the port's
  layouts, bit for bit.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.diffusion import clip_text as jclip
from mnn_tpu.diffusion import nn as jnn
from mnn_tpu.diffusion import unet as junet
from mnn_tpu.diffusion import vae as jvae
from mnn_tpu.diffusion.pipeline import DiffusionPipeline as JPipeline
from mnn_tpu.diffusion.sd import StableDiffusion as JSD
from mnn_tpu_torch import diffusion
from mnn_tpu_torch.convert import stfile
from mnn_tpu_torch.diffusion import clip_text, nn, unet, vae
from mnn_tpu_torch.diffusion import scheduler as sched
from tests.test_torch_decoder import rel

UCFG, VCFG = junet.UNetConfig.tiny(), jvae.VAEConfig.tiny()
TCFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
            max_position_embeddings=8, eos_token_id=2)
TCFG_GELU = dict(TCFG, act="gelu", eos_token_id=63)   # HF's pooling at the first EOS
SCHEDS = ("ddim", "ddpm", "euler")
STEPS, SIZE, SEED = 3, 16, 0
LAT = (1, 4, SIZE // 2, SIZE // 2)       # the tiny VAE halves once
PROMPT, NEG = "a red bicycle", "blurry"


def torch_layout(shapes, rng):
    """Seeded numpy weights for JAX-layout `shapes`, in the torch layouts a
    diffusers checkpoint holds (convolutions OIHW, linears [out, in]):
    weights normal / sqrt(fan-in), norm weights 1 + normal(0.1), biases
    normal(0.1)."""
    sd = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("bias"):
            a = rng.normal(0, 0.1, shape)
        elif len(shape) == 1:
            a = 1 + rng.normal(0, 0.1, shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            a = a.transpose(3, 2, 0, 1) if len(shape) == 4 else a.T
        sd[name] = np.ascontiguousarray(a, np.float32)
    return sd


def clip_sd(cfg, rng):
    shapes = jax.eval_shape(lambda: jclip.init_clip_text_params(cfg, jax.random.PRNGKey(0)))
    sd = {}
    for name, v in sorted(shapes.items()):
        shape = v.shape
        if name.endswith("bias"):
            a = rng.normal(0, 0.1, shape)
        elif len(shape) == 1:
            a = 1 + rng.normal(0, 0.1, shape)
        elif "embedding" in name:
            a = rng.normal(0, 0.5, shape)
        else:
            a = (rng.standard_normal(shape) / np.sqrt(shape[0])).T
        sd["text_model." + name] = np.ascontiguousarray(a, np.float32)
    return sd


def jax_draws(seed, n, shape):
    """JAX `txt2img`'s draws: its key split once for the latent, then once a
    step, each sub-key drawn at `shape`."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return out


def jax_sd(params, scheduler, dtype=jnp.float32):
    """The JAX package's tiny SD over `params` (unet / text / vae, already in
    `dtype`: its own cast would compile one conversion a tensor)."""
    return JSD(unet_params=params["unet"], unet_cfg=UCFG, text_params=params["text"],
               text_cfg=jclip.ClipTextConfig(**TCFG), vae_params=params["vae"], vae_cfg=VCFG,
               scheduler=scheduler, dtype=dtype)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(31)
    out = {}
    # -- nn primitives (JAX NHWC against the port's NCHW) --------------------
    x = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)              # NCHW
    w3 = (rng.standard_normal((4, 6, 3, 3)) * 0.3).astype(np.float32)     # OIHW
    w1 = (rng.standard_normal((4, 6, 1, 1)) * 0.3).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    out["nn_x"], out["nn_w3"], out["nn_w1"], out["nn_b"] = x, w3, w1, b
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    out["conv"] = {
        "s1": to_nchw(jnn.conv2d(xh, jnn.t_conv(w3), jnp.asarray(b))),
        "s2": to_nchw(jnn.conv2d(xh, jnn.t_conv(w3), jnp.asarray(b), stride=2)),
        "1x1": to_nchw(jnn.conv2d(xh, jnn.t_conv(w1), jnp.asarray(b), padding=0)),
    }
    gw, gb = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    out["gn_wb"] = gw, gb
    out["group_norm"] = to_nchw(jnn.group_norm(xh, jnp.asarray(gw), jnp.asarray(gb), groups=3,
                                               eps=1e-6))
    out["upsample"] = to_nchw(jnn.upsample_nearest_2x(xh))
    out["silu"] = np.asarray(jnn.silu(jnp.asarray(x)))
    ts = np.array([0, 17, 999], np.int32)
    out["temb"] = {(32, True): np.asarray(jnn.timestep_embedding(ts, 32)),
                   (33, False): np.asarray(jnn.timestep_embedding(
                       ts, 33, flip_sin_to_cos=False, freq_shift=1.0))}

    # -- CLIP text ---------------------------------------------------------
    out["ids"] = np.array([[5, 9, 60, 2, 2, 2, 2, 2], [7, 63, 11, 12, 2, 63, 2, 2]], np.int32)
    out["clip"] = {}
    for name, kw in (("quick_gelu", TCFG), ("gelu", TCFG_GELU)):
        cfg = jclip.ClipTextConfig(**kw)
        sd = clip_sd(cfg, rng)
        p = jclip.from_hf_clip_text(sd)
        h, pooled = jax.jit(lambda p, i: jclip.clip_text_forward(p, cfg, i))(
            p, jnp.asarray(out["ids"]))
        out["clip"][name] = (sd, np.asarray(h), np.asarray(pooled))

    # -- the UNet and the VAE ----------------------------------------------
    out["unet_sd"] = torch_layout(junet.param_shapes(UCFG), rng)
    out["vae_sd"] = torch_layout(jvae.param_shapes(VCFG), rng)
    jup = junet.from_diffusers(out["unet_sd"])
    jvp = jvae.from_diffusers(out["vae_sd"])
    out["latent"] = rng.standard_normal(LAT).astype(np.float32)
    out["ctx"] = rng.standard_normal((1, 8, 32)).astype(np.float32)
    out["ctx_u"] = rng.standard_normal((1, 8, 32)).astype(np.float32)
    jfwd = jax.jit(lambda lat, t, c: junet.unet_forward(jup, UCFG, lat, t, c))
    out["unet"] = np.asarray(jfwd(jnp.asarray(out["latent"]), 500, jnp.asarray(out["ctx"])))
    out["vae_dec"] = np.asarray(jax.jit(lambda z: jvae.vae_decode(jvp, VCFG, z))(
        jnp.asarray(out["latent"])))
    out["image"] = np.tanh(rng.standard_normal((1, 3, SIZE, SIZE))).astype(np.float32)
    enc = jax.jit(lambda im, k: jvae.vae_encode(jvp, VCFG, im, k))
    out["vae_enc"] = np.asarray(jax.jit(lambda im: jvae.vae_encode(jvp, VCFG, im))(
        jnp.asarray(out["image"])))
    key = jax.random.PRNGKey(9)
    # JAX draws the posterior noise in its NHWC layout
    out["vae_enc_noise"] = np.asarray(jax.random.normal(key, (1, *LAT[2:], LAT[1]))).transpose(
        0, 3, 1, 2)
    out["vae_enc_sampled"] = np.asarray(enc(jnp.asarray(out["image"]), key))

    # -- the pipeline: euler, cond and uncond given --------------------------
    pipe = JPipeline(jfwd, scheduler="euler", latent_shape=LAT[1:])
    steps = []
    out["pipeline"] = np.asarray(pipe.run(cond=jnp.asarray(out["ctx"]),
                                          uncond=jnp.asarray(out["ctx_u"]), num_steps=STEPS,
                                          seed=SEED, callback=lambda i, _: steps.append(i)))
    assert steps == [0, 1, 2]

    # -- StableDiffusion ---------------------------------------------------
    p32 = dict(unet=jup, vae=jvp, text=jclip.from_hf_clip_text(out["clip"]["quick_gelu"][0]))
    p16 = jax.jit(lambda tree: jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree))(p32)
    out["draws"] = jax_draws(SEED, STEPS + 1, LAT)
    out["txt2img"] = {}
    for name in SCHEDS:
        s = jax_sd(p32, name)
        out["txt2img"][name] = s.txt2img(PROMPT, negative_prompt=NEG, num_steps=STEPS,
                                         seed=SEED, height=SIZE, width=SIZE, output="latent")
        if name == "ddim":
            out["cond"] = np.asarray(s.encode_prompt(PROMPT))
            out["png"] = s.txt2img(PROMPT, negative_prompt=NEG, num_steps=STEPS, seed=SEED,
                                   height=SIZE, width=SIZE)
    # bf16: the first CFG step's batch-2 UNet output at CFG 7.5, and the
    # latents of 3 steps at guidance 1 (the module docstring says why)
    s = jax_sd(p16, "ddim", jnp.bfloat16)
    ctx2 = jnp.concatenate([s.encode_prompt(NEG), s.encode_prompt(PROMPT)], axis=0)
    lat2 = jnp.asarray(np.concatenate([out["draws"][0]] * 2)).astype(jnp.bfloat16)
    out["cfg_unet_bf16"] = np.asarray(jax.jit(lambda lat, t, c: junet.unet_forward(
        p16["unet"], UCFG, lat, t, c))(lat2, 999, ctx2), np.float32)
    out["txt2img_bf16"] = s.txt2img(PROMPT, negative_prompt=NEG, num_steps=STEPS, seed=SEED,
                                    guidance_scale=1.0, height=SIZE, width=SIZE,
                                    output="latent")
    return out


@pytest.fixture
def jax_noise(monkeypatch):
    """Replace the port's noise helper with a queue of given arrays."""
    queue = []

    def draw(generator, shape, device):
        a = queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    monkeypatch.setattr(sched, "noise", draw)
    return queue


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# nn primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["s1", "s2", "1x1"])
def test_conv2d_matches_jax(ref, kind):
    x, b = t(ref["nn_x"]), t(ref["nn_b"])
    w = t(ref["nn_w1"] if kind == "1x1" else ref["nn_w3"])
    got = nn.conv2d(x, nn.t_conv(w), b, stride=2 if kind == "s2" else 1,
                    padding=0 if kind == "1x1" else 1)
    want = ref["conv"][kind]
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # bf16 activations come back in bf16 (the f32 sum rounded once)
    assert nn.conv2d(x.bfloat16(), w, b).dtype == torch.bfloat16


def test_norm_upsample_silu_match_jax(ref):
    x = t(ref["nn_x"])
    gw, gb = ref["gn_wb"]
    np.testing.assert_allclose(nn.group_norm(x, t(gw), t(gb), groups=3, eps=1e-6).numpy(),
                               ref["group_norm"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(nn.upsample_nearest_2x(x).numpy(), ref["upsample"])
    np.testing.assert_allclose(nn.silu(x).numpy(), ref["silu"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dim,flip", [(32, True), (33, False)])
def test_timestep_embedding_matches_jax(ref, dim, flip):
    ts = np.array([0, 17, 999], np.int32)
    kw = {} if flip else dict(flip_sin_to_cos=False, freq_shift=1.0)
    got = nn.timestep_embedding(ts, dim, device="cpu", **kw)
    assert tuple(got.shape) == (3, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["temb"][dim, flip], atol=1e-4, rtol=0)
    # a tensor stays on its device
    assert nn.timestep_embedding(torch.tensor(5), dim).shape == (1, dim)


# --------------------------------------------------------------------------
# CLIP text
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_text_matches_jax(ref, act):
    sd, want_h, want_p = ref["clip"][act]
    cfg = clip_text.ClipTextConfig(**(TCFG if act == "quick_gelu" else TCFG_GELU))
    p = clip_text.from_hf_clip_text({k: t(v) for k, v in sd.items()})
    want_keys = jclip.from_hf_clip_text(sd)
    assert sorted(p) == sorted(want_keys)
    for k, v in want_keys.items():
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(v), err_msg=k)
    h, pooled = clip_text.clip_text_forward(p, cfg, t(ref["ids"]).long())
    assert tuple(h.shape) == want_h.shape == (2, 8, 32)
    assert rel(h.numpy(), want_h) <= 1e-4
    assert rel(pooled.numpy(), want_p) <= 1e-4


def test_init_clip_text_params_layout():
    cfg = clip_text.ClipTextConfig(**TCFG)
    p = clip_text.init_clip_text_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.eval_shape(lambda: jclip.init_clip_text_params(
        jclip.ClipTextConfig(**TCFG), jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}


# --------------------------------------------------------------------------
# the UNet and the VAE
# --------------------------------------------------------------------------

def port_unet(ref):
    return unet.from_diffusers({k: t(v) for k, v in ref["unet_sd"].items()})


def port_vae(ref):
    return vae.from_diffusers({k: t(v) for k, v in ref["vae_sd"].items()})


def test_unet_forward_matches_jax(ref):
    p = port_unet(ref)
    unet.validate_params(UCFG, p)
    got = unet.unet_forward(p, UCFG, t(ref["latent"]), 500, t(ref["ctx"]))
    assert tuple(got.shape) == LAT and got.dtype == torch.float32
    assert rel(got.numpy(), ref["unet"]) <= 1e-4


def test_unet_param_shapes_and_init():
    """The port's shapes are the JAX package's in torch layouts; a random
    init fills them and passes validation; a wrong shape raises."""
    want = junet.param_shapes(UCFG)
    got = unet.param_shapes(UCFG)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k] == ((s[3], s[2], s[0], s[1]) if len(s) == 4 else s), k
    assert len(unet.param_shapes(unet.UNetConfig())) == len(junet.param_shapes(junet.UNetConfig()))
    p = unet.init_unet_params(UCFG, torch.Generator().manual_seed(0), "cpu")
    unet.validate_params(UCFG, p)
    assert float(p["conv_norm_out.weight"].min()) == 1.0 and float(p["conv_in.bias"].abs().max()) == 0
    p["conv_in.weight"] = p["conv_in.weight"][:1]
    with pytest.raises(ValueError, match="conv_in.weight"):
        unet.validate_params(UCFG, p)
    del p["conv_out.bias"]
    with pytest.raises(ValueError, match="missing 1"):
        unet.validate_params(UCFG, p)


def test_vae_decode_and_encode_match_jax(ref, jax_noise):
    p = port_vae(ref)
    vae.validate_params(VCFG, p)
    img = vae.vae_decode(p, VCFG, t(ref["latent"]))
    assert tuple(img.shape) == (1, 3, SIZE, SIZE)
    assert rel(img.numpy(), ref["vae_dec"]) <= 1e-4
    z = vae.vae_encode(p, VCFG, t(ref["image"]))
    assert tuple(z.shape) == LAT
    assert rel(z.numpy(), ref["vae_enc"]) <= 1e-4
    jax_noise.append(ref["vae_enc_noise"])
    z = vae.vae_encode(p, VCFG, t(ref["image"]), torch.Generator().manual_seed(9))
    assert not jax_noise and rel(z.numpy(), ref["vae_enc_sampled"]) <= 1e-4


def test_vae_legacy_attention_keys_and_shapes():
    sd = {"decoder.mid_block.attentions.0.query.weight": np.zeros((8, 8), np.float32),
          "decoder.mid_block.attentions.0.proj_attn.weight": np.zeros((8, 8, 1, 1), np.float32),
          "decoder.mid_block.attentions.0.key.bias": np.zeros(8, np.float32)}
    out = vae.from_diffusers(sd, "cpu")
    assert sorted(out) == sorted(jvae.from_diffusers(sd))
    assert tuple(out["decoder.mid_block.attentions.0.to_out.0.weight"].shape) == (8, 8)
    assert "decoder.mid_block.attentions.0.to_k.bias" in out
    full = vae.param_shapes(vae.VAEConfig())
    assert len(full) == 248 and full["decoder.conv_in.weight"] == (512, 4, 3, 3)
    p = vae.init_vae_params(VCFG, torch.Generator().manual_seed(0), "cpu")
    vae.validate_params(VCFG, p)


# --------------------------------------------------------------------------
# the pipeline and StableDiffusion
# --------------------------------------------------------------------------

def test_pipeline_matches_jax(ref, jax_noise):
    p = port_unet(ref)
    jax_noise.append(ref["draws"][0])
    pipe = diffusion.DiffusionPipeline(
        lambda lat, ts, c: unet.unet_forward(p, UCFG, lat, ts, c), scheduler="euler",
        latent_shape=LAT[1:], device="cpu")
    steps = []
    got = pipe.run(cond=t(ref["ctx"]), uncond=t(ref["ctx_u"]), num_steps=STEPS, seed=SEED,
                   callback=lambda i, _: steps.append(i))
    assert steps == [0, 1, 2] and tuple(got.shape) == LAT
    assert rel(got.numpy(), ref["pipeline"]) <= 1e-3


def test_pipeline_with_encoder_and_decoder(ref):
    """A text encoder and a VAE decode given as callables: the prompt and
    "" condition, the decode's output is returned."""
    seen = []
    pipe = diffusion.DiffusionPipeline(
        lambda lat, ts, c: lat * c, text_encoder=lambda s: (seen.append(s), 0.5)[1],
        vae_decode=lambda lat: lat + 1, scheduler="ddim", latent_shape=(2, 2), device="cpu")
    out = pipe.run("hi", num_steps=2)
    assert seen == ["hi", ""] and tuple(out.shape) == (1, 2, 2)


def port_sd(ref, scheduler, dtype=torch.float32):
    return diffusion.StableDiffusion(
        unet_params=port_unet(ref), unet_cfg=unet.UNetConfig.tiny(),
        text_params=clip_text.from_hf_clip_text(ref["clip"]["quick_gelu"][0], "cpu"),
        text_cfg=clip_text.ClipTextConfig(**TCFG), vae_params=port_vae(ref),
        vae_cfg=vae.VAEConfig.tiny(), scheduler=scheduler, dtype=dtype, device="cpu")


@pytest.mark.parametrize("name", SCHEDS)
def test_txt2img_latents_match_jax(ref, jax_noise, name):
    s = port_sd(ref, name)
    jax_noise.extend(ref["draws"])
    steps = []
    got = s.txt2img(PROMPT, negative_prompt=NEG, num_steps=STEPS, seed=SEED, height=SIZE,
                    width=SIZE, output="latent", callback=lambda i, _: steps.append(i))
    # ddpm draws at every step, the others only the start
    assert len(jax_noise) == (0 if name == "ddpm" else STEPS)
    assert steps == [0, 1, 2] and got.shape == LAT and got.dtype == np.float32
    assert rel(got, ref["txt2img"][name]) <= 1e-3


def test_txt2img_image_and_prompt_match_jax(ref, jax_noise):
    s = port_sd(ref, "ddim")
    body = [b % 64 for b in PROMPT.encode()][:7]
    assert s.prompt_ids(PROMPT) == body + [2] * (8 - len(body))
    assert rel(s.encode_prompt(PROMPT).numpy(), ref["cond"]) <= 1e-4
    jax_noise.extend(ref["draws"][:1])
    img = s.txt2img(PROMPT, negative_prompt=NEG, num_steps=STEPS, seed=SEED, height=SIZE,
                    width=SIZE)
    want = ref["png"]
    assert img.dtype == np.uint8 and img.shape == want.shape == (SIZE, SIZE, 3)
    assert np.abs(img.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_txt2img_bf16_matches_jax(ref, jax_noise):
    """bf16 weights and activations: the first CFG step's batch-2 UNet
    output [uncond, cond] at t = 999 within rel-L2 3e-2, and the latents of
    3 steps at guidance 1 within 3e-2."""
    s = port_sd(ref, "ddim", torch.bfloat16)
    assert s.unet_params["conv_in.weight"].dtype == torch.bfloat16
    ctx2 = torch.cat([s.encode_prompt(NEG), s.encode_prompt(PROMPT)], dim=0)
    assert ctx2.dtype == torch.bfloat16
    lat2 = t(np.concatenate([ref["draws"][0]] * 2)).to(torch.bfloat16)
    out = unet.unet_forward(s.unet_params, s.unet_cfg, lat2, 999, ctx2)
    assert out.dtype == torch.bfloat16
    assert rel(out.float().numpy(), ref["cfg_unet_bf16"]) <= 3e-2
    jax_noise.extend(ref["draws"][:1])
    got = s.txt2img(PROMPT, negative_prompt=NEG, num_steps=STEPS, seed=SEED,
                    guidance_scale=1.0, height=SIZE, width=SIZE, output="latent")
    assert np.isfinite(got).all() and rel(got, ref["txt2img_bf16"]) <= 3e-2


def test_txt2img_seeded_without_a_patch(ref):
    """The same seed gives the same latent; the CPU generator's draws."""
    s = port_sd(ref, "ddpm")
    a = s.txt2img("x", num_steps=2, seed=7, height=SIZE, width=SIZE, output="latent")
    b = s.txt2img("x", num_steps=2, seed=7, height=SIZE, width=SIZE, output="latent")
    c = s.txt2img("x", num_steps=2, seed=8, height=SIZE, width=SIZE, output="latent")
    assert np.array_equal(a, b) and not np.array_equal(a, c)


# --------------------------------------------------------------------------
# from_pretrained and the CLI
# --------------------------------------------------------------------------

UNET_JSON = dict(in_channels=4, out_channels=4, block_out_channels=[32, 64],
                 down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=1,
                 cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8)
VAE_JSON = dict(latent_channels=4, block_out_channels=[16, 32], layers_per_block=1,
                norm_num_groups=4, scaling_factor=0.18215)
TEXT_JSON = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                 num_attention_heads=2, max_position_embeddings=8, hidden_act="quick_gelu",
                 eos_token_id=2)
SCHED_JSON = dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                  beta_schedule="scaled_linear", prediction_type="epsilon")


@pytest.fixture(scope="module")
def sd_dir(ref, tmp_path_factory):
    """A tiny diffusers-layout directory written with the port's writer."""
    root = tmp_path_factory.mktemp("sd")
    for sub, cfg, sd, fname in (
            ("unet", UNET_JSON, ref["unet_sd"], "diffusion_pytorch_model.safetensors"),
            ("vae", VAE_JSON, ref["vae_sd"], "diffusion_pytorch_model.safetensors"),
            ("text_encoder", TEXT_JSON, ref["clip"]["quick_gelu"][0], "model.safetensors")):
        (root / sub).mkdir()
        (root / sub / "config.json").write_text(json.dumps(cfg))
        stfile.save_file({k: t(v) for k, v in sd.items()}, str(root / sub / fname))
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHED_JSON))
    return root


def test_from_pretrained_gives_the_jax_parameters(sd_dir):
    got = diffusion.StableDiffusion.from_pretrained(str(sd_dir), dtype=torch.float32,
                                                    device="cpu")
    want = JSD.from_pretrained(str(sd_dir), dtype=jnp.float32)
    assert got.unet_cfg == unet.UNetConfig(**dataclasses.asdict(want.unet_cfg))
    assert got.vae_cfg == vae.VAEConfig(**dataclasses.asdict(want.vae_cfg))
    assert got.text_cfg == clip_text.ClipTextConfig(**dataclasses.asdict(want.text_cfg))
    assert got.tokenizer is None and got.vae_scale == 2
    assert type(got.scheduler).__name__ == type(want.scheduler).__name__ == "DDIMScheduler"
    for mine, theirs in ((got.unet_params, want.unet_params), (got.vae_params, want.vae_params),
                         (got.text_params, want.text_params)):
        assert sorted(mine) == sorted(theirs)
        for k, v in theirs.items():
            v = np.asarray(v)
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
            assert mine[k].dtype == torch.float32
            np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


def test_tokenizer_dir_needs_transformers(sd_dir, tmp_path, monkeypatch):
    """With a tokenizer/ directory transformers is imported, and its absence
    raises; without one the byte mapping runs (the test above)."""
    import shutil
    d = tmp_path / "sd"
    shutil.copytree(sd_dir, d)
    (d / "tokenizer").mkdir()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        diffusion.StableDiffusion.from_pretrained(str(d), device="cpu")


def test_cli_txt2img_writes_an_image(sd_dir, tmp_path, capsys, monkeypatch):
    from mnn_tpu_torch import cli

    out = tmp_path / "img.png"
    cli.main(["txt2img", "--model", str(sd_dir), "--device", "cpu", "--steps", "2",
              "--size", str(SIZE), "--out", str(out), "a cat"])
    text = capsys.readouterr().out
    assert "step 2/2" in text and f"saved {out}" in text
    from PIL import Image
    assert Image.open(out).size == (SIZE, SIZE)
    # without PIL the image is saved as .npy, as the JAX CLI does
    monkeypatch.setitem(sys.modules, "PIL", None)
    cli.main(["txt2img", "--model", str(sd_dir), "--device", "cpu", "--steps", "1",
              "--size", str(SIZE), "--out", str(tmp_path / "x.png"), "a cat"])
    arr = np.load(tmp_path / "x.png.npy")
    assert arr.shape == (SIZE, SIZE, 3) and arr.dtype == np.uint8


DEFAULT_DEVICE_CALLS = {
    "StableDiffusion": lambda r: diffusion.StableDiffusion(
        unet_params={}, unet_cfg=UCFG, text_params={}, text_cfg=None, vae_params={},
        vae_cfg=VCFG),
    "DiffusionPipeline": lambda r: diffusion.DiffusionPipeline(lambda *a: a[0]),
    "from_diffusers": lambda r: unet.from_diffusers(r["unet_sd"]),
    "vae_from_diffusers": lambda r: vae.from_diffusers(r["vae_sd"]),
    "from_hf_clip_text": lambda r: clip_text.from_hf_clip_text(r["clip"]["gelu"][0]),
    "init_unet_params": lambda r: unet.init_unet_params(UCFG, torch.Generator()),
    "timestep_embedding": lambda r: nn.timestep_embedding(np.array([1]), 8),
    "cli": lambda r: cli_main(["txt2img", "--model", "/nonexistent", "x"]),
}


def cli_main(argv):
    from mnn_tpu_torch import cli
    cli.main(argv)


@pytest.mark.parametrize("entry", list(DEFAULT_DEVICE_CALLS))
def test_entry_points_need_a_device_or_the_card(ref, entry):
    """Given arrays and no device, the entry points go to the card and raise
    without one; they never run quietly on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry](ref)


def test_package_exports_what_the_jax_package_exports():
    import mnn_tpu.diffusion as jdiff
    want = {n for n in dir(jdiff) if not n.startswith("_") and n[0].isupper()} | {"SCHEDULERS"}
    assert want <= set(dir(diffusion))
    assert sorted(diffusion.SCHEDULERS) == sorted(jdiff.SCHEDULERS)
