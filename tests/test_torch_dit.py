"""The port's diffusion transformers against the JAX package, on the CPU:
SD3's MMDiT, Sana with its DC-AE decoder, and Wan's video DiT with its
causal 3-D VAE, each with its pipeline where it has one.

Shapes are the JAX tests' own: `MMDiTConfig.tiny()`, `SanaConfig.tiny()`,
`WanConfig.tiny()` and the latents of `tests/test_mmdit.py`,
`tests/test_sana.py` and `tests/test_wan.py`. Weights are seeded numpy
arrays: MMDiT's in the diffusers layout, mapped by each package's own
`from_diffusers_sd3`; Sana's and Wan's are seeded normal(0.02) arrays at
the JAX inits' shapes and keys (biases too: the inits' are zero), carried
over by the port's `params_from_numpy`. The JAX side runs once, in a module-scoped
fixture. `jax.random` draws cannot be made in torch: the pipelines' noise
helper (`diffusion.scheduler.noise`) is replaced by JAX's draw. Bounds:

* f32 forwards and decoders: rel-L2 1e-4;
* 3-step pipelines in f32, JAX's draw patched in: rel-L2 1e-3;
* one bf16 CFG forward (batch 2): rel-L2 3e-2. JAX's Sana refuses bf16
  weights (`lax.conv_general_dilated` wants one dtype and the timestep
  embedding makes the activations f32), so Sana's bf16 weights are held to
  the JAX f32 forward over the same weights rounded to bf16;
* `from_diffusers_sd3`, the weight carry-over and `param_shapes`: bit for
  bit; `validate_params` raises where the JAX one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.diffusion import mmdit as jmmdit
from mnn_tpu.diffusion import sana as jsana
from mnn_tpu.diffusion import wan as jwan
from mnn_tpu_torch.diffusion import mmdit, sana, wan
from mnn_tpu_torch.diffusion import scheduler as sched
from tests.test_torch_decoder import rel

MCFG, SCFG, WCFG = jmmdit.MMDiTConfig.tiny(), jsana.SanaConfig.tiny(), jwan.WanConfig.tiny()
STEPS = 3


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def sd3_state_dict(rng):
    """Seeded SD3 weights in the diffusers layouts (the patch conv [D, C, p,
    p], linears [out, in]): weights normal / sqrt(fan-in), 1-D norm weights
    1 + normal(0.1), biases normal(0.1), the position table normal(0.5)."""
    sd = {}
    ps, d = MCFG.patch_size, MCFG.hidden_size
    for name, shape in sorted(jmmdit.param_shapes(MCFG).items()):
        if name == "pos_embed.proj.weight":
            a = rng.standard_normal((d, MCFG.in_channels, ps, ps)) / np.sqrt(shape[0])
        elif name == "pos_embed.pos_embed":
            a = rng.normal(0, 0.5, shape)
        elif name.endswith("bias"):
            a = rng.normal(0, 0.1, shape)
        elif len(shape) == 1:
            a = 1 + rng.normal(0, 0.1, shape)
        else:
            a = (rng.standard_normal(shape) / np.sqrt(shape[0])).T
        sd[name] = np.ascontiguousarray(a, np.float32)
    return sd


def seeded(init, rng, scale=0.02):
    """Seeded normal(scale) numpy arrays at the shapes of a JAX init (its
    layouts and keys; `jax.eval_shape` traces it without drawing: the
    eager init compiles one draw a shape)."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))
    return {k: rng.normal(0, scale, v.shape).astype(np.float32)
            for k, v in sorted(shapes.items())}


def jax_draw(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


def bf16_rounded(params):
    return {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(22)
    out = {}
    # -- MMDiT ---------------------------------------------------------------
    out["sd3"] = sd3_state_dict(rng)
    jp = jmmdit.from_diffusers_sd3(out["sd3"])
    out["m_lat"] = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    out["m_lat_rect"] = rng.standard_normal((1, 4, 8, 12)).astype(np.float32)
    out["m_ctx"] = rng.standard_normal((2, 5, 16)).astype(np.float32)
    out["m_pool"] = rng.standard_normal((2, 24)).astype(np.float32)
    fwd = jax.jit(lambda p, lat, ts, c, pl: jmmdit.mmdit_forward(p, MCFG, lat, ts, c, pl))
    out["mmdit"] = np.asarray(fwd(jp, out["m_lat"], jnp.float32(500), out["m_ctx"],
                                  out["m_pool"]))
    out["mmdit_rect"] = np.asarray(fwd(jp, out["m_lat_rect"], jnp.float32(100),
                                       out["m_ctx"][:1], out["m_pool"][:1]))
    p16 = jax.jit(lambda tree: jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree))(jp)
    out["mmdit_bf16"] = np.asarray(fwd(p16, jnp.asarray(out["m_lat"], jnp.bfloat16),
                                       jnp.float32(951), jnp.asarray(out["m_ctx"], jnp.bfloat16),
                                       jnp.asarray(out["m_pool"], jnp.bfloat16)), np.float32)

    # -- Sana ----------------------------------------------------------------
    out["s_p"] = seeded(lambda k: jsana.init_sana_params(SCFG, k), rng)
    out["s_lat"] = rng.standard_normal((2, 8, 8, SCFG.in_channels)).astype(np.float32)
    out["s_txt"] = rng.standard_normal((2, 5, SCFG.text_dim)).astype(np.float32)
    sfwd = jax.jit(lambda p, lat, ts, c: jsana.sana_forward(p, SCFG, lat, ts, c))
    ts = jnp.asarray([500.0, 100.0])
    out["sana"] = np.asarray(sfwd(out["s_p"], out["s_lat"], ts, out["s_txt"]))
    out["sana_bf16w"] = np.asarray(sfwd(bf16_rounded(out["s_p"]), out["s_lat"], ts,
                                        out["s_txt"]))
    out["dcae3"] = seeded(lambda k: jsana.init_dcae_decoder(k, latent_ch=4, width=16, stages=3),
                          rng)
    out["dcae_lat"] = rng.standard_normal((1, 2, 2, 4)).astype(np.float32)
    out["dcae"] = np.asarray(jax.jit(lambda p, z: jsana.dcae_decode(p, z, stages=3))(
        out["dcae3"], out["dcae_lat"]))
    out["dcae2"] = seeded(lambda k: jsana.init_dcae_decoder(k, latent_ch=4, width=16, stages=2),
                          rng)
    out["s_cond"] = rng.standard_normal((1, 4, SCFG.text_dim)).astype(np.float32)
    out["s_uncond"] = np.zeros((1, 4, SCFG.text_dim), np.float32)
    pipe = jsana.SanaPipeline(SCFG, out["s_p"], out["dcae2"], dcae_stages=2)
    out["sana_pipe"] = np.asarray(pipe(jnp.asarray(out["s_cond"]), jnp.asarray(out["s_uncond"]),
                                       latent_hw=(4, 4), steps=STEPS, guidance=3.0, seed=0))
    out["sana_draw"] = jax_draw(0, (1, 4, 4, SCFG.in_channels))

    # -- Wan -----------------------------------------------------------------
    out["w_p"] = seeded(lambda k: jwan.init_wan_params(WCFG, k), rng)
    out["w_lat"] = rng.standard_normal((2, 2, 4, 4, WCFG.in_channels)).astype(np.float32)
    out["w_txt"] = rng.standard_normal((2, 6, WCFG.text_dim)).astype(np.float32)
    out["w_mask"] = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], np.float32)
    wfwd = jax.jit(lambda p, lat, ts, c, m: jwan.wan_forward(p, WCFG, lat, ts, c, m))
    ts = jnp.asarray([500.0, 100.0])
    out["wan"] = np.asarray(wfwd(out["w_p"], out["w_lat"], ts, out["w_txt"], None))
    out["wan_mask"] = np.asarray(wfwd(out["w_p"], out["w_lat"], ts, out["w_txt"],
                                      out["w_mask"]))
    wp16 = jax.jit(lambda tree: jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree))(out["w_p"])
    out["wan_bf16"] = np.asarray(wfwd(wp16, out["w_lat"], jnp.asarray([951.0, 951.0]),
                                      out["w_txt"], out["w_mask"]), np.float32)
    out["vae2"] = seeded(lambda k: jwan.init_wan_vae(k, latent_ch=4, width=8, spatial_stages=2),
                         rng)
    out["vae_lat"] = rng.standard_normal((1, 3, 2, 2, 4)).astype(np.float32)
    out["wan_vae"] = np.asarray(jax.jit(lambda p, z: jwan.wan_vae_decode(p, z, spatial_stages=2))(
        out["vae2"], out["vae_lat"]))
    out["wan_vae_flat"] = np.asarray(jax.jit(lambda p, z: jwan.wan_vae_decode(
        p, z, spatial_stages=2, temporal_up=False))(out["vae2"], out["vae_lat"]))
    out["vae1"] = seeded(lambda k: jwan.init_wan_vae(k, latent_ch=4, width=8, spatial_stages=1),
                         rng)
    out["w_cond"] = rng.standard_normal((1, 4, WCFG.text_dim)).astype(np.float32)
    out["w_uncond"] = np.zeros((1, 4, WCFG.text_dim), np.float32)
    out["w_pmask"] = np.array([[1, 1, 1, 0]], np.float32)
    wpipe = jwan.WanPipeline(WCFG, out["w_p"], out["vae1"], vae_stages=1)
    out["wan_pipe"] = np.asarray(wpipe(jnp.asarray(out["w_cond"]), jnp.asarray(out["w_uncond"]),
                                       latent_thw=(2, 4, 4), steps=STEPS, seed=0,
                                       text_mask=jnp.asarray(out["w_pmask"])))
    out["wan_draw"] = jax_draw(0, (1, 2, 4, 4, WCFG.in_channels))
    return out


@pytest.fixture
def jax_noise(monkeypatch):
    """Replace the port's noise helper with a queue of given arrays."""
    queue = []

    def draw(generator, shape, device):
        a = queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return t(a).to(device)
    monkeypatch.setattr(sched, "noise", draw)
    return queue


# --------------------------------------------------------------------------
# MMDiT
# --------------------------------------------------------------------------

def port_mmdit(ref, dtype=torch.float32):
    p = mmdit.from_diffusers_sd3({k: torch.from_numpy(v) for k, v in ref["sd3"].items()})
    return {k: v.to(dtype) for k, v in p.items()}


def test_mmdit_from_diffusers_bit_for_bit(ref):
    want = jmmdit.from_diffusers_sd3(ref["sd3"])
    got = port_mmdit(ref)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # arrays go to the given device as well
    arr = mmdit.from_diffusers_sd3({"pos_embed.proj.weight": ref["sd3"]["pos_embed.proj.weight"]},
                                   device="cpu")
    np.testing.assert_array_equal(arr["pos_embed.proj.weight"].numpy(),
                                  np.asarray(want["pos_embed.proj.weight"]))
    # the JAX package's own dict carries over unchanged, and rounds to bf16
    # as JAX rounds it
    rounded = jax.jit(lambda tree: jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), tree))(want)
    for dtype, jax_side in ((torch.float32, want), (torch.bfloat16, rounded)):
        mine = mmdit.params_from_numpy({k: np.asarray(v) for k, v in want.items()}, "cpu", dtype)
        for k, v in jax_side.items():
            np.testing.assert_array_equal(mine[k].float().numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("case", ["square", "rect"])
def test_mmdit_forward_matches_jax(ref, case):
    p = port_mmdit(ref)
    mmdit.validate_params(MCFG, p)
    if case == "square":
        got = mmdit.mmdit_forward(p, MCFG, t(ref["m_lat"]), 500, t(ref["m_ctx"]),
                                  t(ref["m_pool"]))
        want = ref["mmdit"]
    else:   # a 4 x 6 patch grid, cropped off the table's centre
        got = mmdit.mmdit_forward(p, MCFG, t(ref["m_lat_rect"]), torch.tensor([100.0]),
                                  t(ref["m_ctx"][:1]), t(ref["m_pool"][:1]))
        want = ref["mmdit_rect"]
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert rel(got.numpy(), want) <= 1e-4


def test_mmdit_bf16_cfg_forward_matches_jax(ref):
    p = port_mmdit(ref, torch.bfloat16)
    got = mmdit.mmdit_forward(p, MCFG, t(ref["m_lat"]).bfloat16(), 951,
                              t(ref["m_ctx"]).bfloat16(), t(ref["m_pool"]).bfloat16())
    assert got.dtype == torch.bfloat16
    assert rel(got.float().numpy(), ref["mmdit_bf16"]) <= 3e-2


def test_mmdit_param_shapes_init_and_validate():
    for jcfg in (MCFG, jmmdit.MMDiTConfig()):
        cfg = mmdit.MMDiTConfig(**jcfg.__dict__)
        assert mmdit.param_shapes(cfg) == jmmdit.param_shapes(jcfg)
    p = mmdit.init_mmdit_params(MCFG, torch.Generator().manual_seed(0), "cpu")
    mmdit.validate_params(MCFG, p)
    assert float(p["transformer_blocks.0.attn.norm_q.weight"].min()) == 1.0
    assert float(p["context_embedder.bias"].abs().max()) == 0.0
    # a missing key and a wrong shape raise in both packages
    jp = {k: np.zeros(s, np.float32) for k, s in jmmdit.param_shapes(MCFG).items()}
    for mutate in ("missing", "shape"):
        jbad, bad = dict(jp), dict(p)
        if mutate == "missing":
            del jbad["proj_out.bias"], bad["proj_out.bias"]
        else:
            jbad["proj_out.bias"] = np.zeros(3, np.float32)
            bad["proj_out.bias"] = torch.zeros(3)
        with pytest.raises(ValueError):
            jmmdit.validate_params(MCFG, jbad)
        with pytest.raises(ValueError, match="proj_out.bias"):
            mmdit.validate_params(MCFG, bad)


# --------------------------------------------------------------------------
# Sana
# --------------------------------------------------------------------------

def test_sana_params_carry_over_bit_for_bit(ref):
    got = sana.params_from_numpy(ref["s_p"], device="cpu")
    assert sorted(got) == sorted(ref["s_p"])
    np.testing.assert_array_equal(got["blocks.0.ffn.dw.w"][:, 0].permute(1, 2, 0).numpy(),
                                  ref["s_p"]["blocks.0.ffn.dw.w"])
    np.testing.assert_array_equal(got["blocks.1.attn.q.w"].numpy(),
                                  ref["s_p"]["blocks.1.attn.q.w"])
    dc = sana.params_from_numpy(ref["dcae3"], device="cpu")
    for k, v in ref["dcae3"].items():
        g = dc[k].numpy()
        if v.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        elif k.endswith("dw.w"):
            g = g[:, 0].transpose(1, 2, 0)
        np.testing.assert_array_equal(g, v, err_msg=k)
    # the port's random inits have the carried-over shapes
    mine = sana.init_sana_params(sana.SanaConfig.tiny(), torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape)
                                                             for k, v in got.items()}
    mine = sana.init_dcae_decoder(torch.Generator().manual_seed(0), latent_ch=4, width=16,
                                  stages=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape)
                                                             for k, v in dc.items()}


def test_sana_linear_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 17, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(jsana.linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4))
    got = sana.linear_attention(t(q), t(k), t(v), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_sana_forward_matches_jax(ref, weights):
    dtype = torch.float32 if weights == "f32" else torch.bfloat16
    p = sana.params_from_numpy(ref["s_p"], device="cpu", dtype=dtype)
    got = sana.sana_forward(p, sana.SanaConfig.tiny(), t(ref["s_lat"]),
                            torch.tensor([500.0, 100.0]), t(ref["s_txt"]))
    assert tuple(got.shape) == ref["s_lat"].shape and got.dtype == torch.float32
    if weights == "f32":
        assert rel(got.numpy(), ref["sana"]) <= 1e-4
    else:
        assert rel(got.numpy(), ref["sana_bf16w"]) <= 3e-2


def test_dcae_decode_matches_jax(ref):
    p = sana.params_from_numpy(ref["dcae3"], device="cpu")
    got = sana.dcae_decode(p, t(ref["dcae_lat"]), stages=3)
    assert tuple(got.shape) == ref["dcae"].shape == (1, 16, 16, 3)
    assert rel(got.numpy(), ref["dcae"]) <= 1e-4


def test_sana_pipeline_matches_jax(ref, jax_noise):
    jax_noise.append(ref["sana_draw"])
    pipe = sana.SanaPipeline(sana.SanaConfig.tiny(),
                             sana.params_from_numpy(ref["s_p"], device="cpu"),
                             sana.params_from_numpy(ref["dcae2"], device="cpu"), dcae_stages=2)
    steps = []
    got = pipe(t(ref["s_cond"]), t(ref["s_uncond"]), latent_hw=(4, 4), steps=STEPS,
               guidance=3.0, seed=0, callback=lambda i, _: steps.append(i))
    assert steps == list(range(STEPS)) and not jax_noise
    assert tuple(got.shape) == ref["sana_pipe"].shape == (1, 16, 16, 3)
    assert rel(got.numpy(), ref["sana_pipe"]) <= 1e-3


# --------------------------------------------------------------------------
# Wan
# --------------------------------------------------------------------------

def test_wan_params_carry_over_bit_for_bit(ref):
    got = wan.params_from_numpy(ref["w_p"], device="cpu")
    for k, v in ref["w_p"].items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    vp = wan.params_from_numpy(ref["vae2"], device="cpu")
    for k, v in ref["vae2"].items():
        g = vp[k].numpy()
        np.testing.assert_array_equal(g.transpose(2, 3, 4, 1, 0) if v.ndim == 5 else g, v,
                                      err_msg=k)
    mine = wan.init_wan_params(wan.WanConfig.tiny(), torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape)
                                                             for k, v in got.items()}
    mine = wan.init_wan_vae(torch.Generator().manual_seed(0), latent_ch=4, width=8,
                            spatial_stages=2, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape)
                                                             for k, v in vp.items()}


@pytest.mark.parametrize("thw,dim", [((1, 1, 6), 24), ((2, 3, 4), 24), ((5, 60, 104), 128)])
def test_wan_rope_3d_bit_for_bit(thw, dim):
    cos, sin = wan.rope_3d(thw, dim, device="cpu")
    jc, js = jwan.rope_3d(thw, dim)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(js))


@pytest.mark.parametrize("masked", [False, True])
def test_wan_forward_matches_jax(ref, masked):
    p = wan.params_from_numpy(ref["w_p"], device="cpu")
    got = wan.wan_forward(p, wan.WanConfig.tiny(), t(ref["w_lat"]), torch.tensor([500.0, 100.0]),
                          t(ref["w_txt"]), t(ref["w_mask"]) if masked else None)
    want = ref["wan_mask" if masked else "wan"]
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert rel(got.numpy(), want) <= 1e-4


def test_wan_bf16_cfg_forward_matches_jax(ref):
    p = wan.params_from_numpy(ref["w_p"], device="cpu", dtype=torch.bfloat16)
    got = wan.wan_forward(p, wan.WanConfig.tiny(), t(ref["w_lat"]), torch.tensor([951.0, 951.0]),
                          t(ref["w_txt"]), t(ref["w_mask"]))
    assert rel(got.float().numpy(), ref["wan_bf16"]) <= 3e-2


def test_wan_causal_conv_sees_no_later_frame():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2, 2, 3, 3, 3), generator=g) * 0.1
    x = torch.randn((1, 2, 5, 4, 4), generator=g)
    y0 = wan._conv3d_causal(x, w, torch.zeros(2))
    x2 = x.clone()
    x2[:, :, -1] += 100.0
    y1 = wan._conv3d_causal(x2, w, torch.zeros(2))
    assert torch.equal(y0[:, :, :4], y1[:, :, :4])
    assert float((y0[:, :, 4] - y1[:, :, 4]).abs().max()) > 1.0


@pytest.mark.parametrize("temporal_up", [True, False])
def test_wan_vae_decode_matches_jax(ref, temporal_up):
    p = wan.params_from_numpy(ref["vae2"], device="cpu")
    got = wan.wan_vae_decode(p, t(ref["vae_lat"]), spatial_stages=2, temporal_up=temporal_up)
    want = ref["wan_vae" if temporal_up else "wan_vae_flat"]
    assert tuple(got.shape) == want.shape
    assert want.shape == ((1, 6, 8, 8, 3) if temporal_up else (1, 3, 8, 8, 3))
    assert rel(got.numpy(), want) <= 1e-4


def test_wan_pipeline_matches_jax(ref, jax_noise):
    jax_noise.append(ref["wan_draw"])
    pipe = wan.WanPipeline(wan.WanConfig.tiny(), wan.params_from_numpy(ref["w_p"], device="cpu"),
                           wan.params_from_numpy(ref["vae1"], device="cpu"), vae_stages=1)
    got = pipe(t(ref["w_cond"]), t(ref["w_uncond"]), latent_thw=(2, 4, 4), steps=STEPS, seed=0,
               text_mask=t(ref["w_pmask"]))
    assert not jax_noise
    assert tuple(got.shape) == ref["wan_pipe"].shape == (1, 4, 8, 8, 3)
    assert rel(got.numpy(), ref["wan_pipe"]) <= 1e-3
