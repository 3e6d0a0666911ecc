"""The port's speech-out path against the JAX package, on the CPU: the
diffusion schedulers (tables, timesteps, sigmas and one step of each), the
BigVGAN vocoder and its primitives, the talker (codec tokens, the mel ODE,
token2wav) and `Omni.respond_mm(speak=True)`.

Shapes are the JAX tests' own (`tests/test_talker_vocoder.py`):
`VocoderConfig.tiny()`, the tiny talker (the `tiny` preset on a 64-token
codec vocabulary, W8, tied head, 8 mels) and `tests/test_torch_omni.py`'s
tiny Omni as the thinker (here at W8, the talker's stack its own layers). The JAX side runs once, in a module-scoped
fixture. `jax.random` draws cannot be made in torch: where a JAX function
draws noise, the port's one noise helper (`diffusion.scheduler.noise`) is
replaced by the same JAX draw. Bounds:

* scheduler tables, timesteps and sigmas: bit for bit; one step of each
  scheduler on the same inputs and noise: rel-L2 1e-6;
* the vocoder in f32, with and without the anti-aliased activations, and
  its primitives: within 1e-4; `from_bigvgan`: within 1e-6 of the JAX
  package's tensors mapped to the port's layouts;
* the codec decoder: logits within rel-L2 5e-2 at every step
  (`tests/test_decode_model.py:97`); codec ids equal up to the first step
  whose JAX top-2 margin is not above the largest logit difference;
* `codec_to_mel` with JAX's noise: within 1e-4; token2wav: 1e-3 (the
  vocoder's convolutions sum in another order);
* `respond_mm(speak=True)`: tokens equal, the wav within 1e-3 given the
  same codec ids and noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.audio import vocoder as jvoc
from mnn_tpu.diffusion import scheduler as jsched
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import talker as jtalk
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.runtime import omni as jomni
from mnn_tpu_torch.audio import vocoder as voc
from mnn_tpu_torch.diffusion import scheduler as sched
from mnn_tpu_torch.models import decoder, talker
from mnn_tpu_torch.models.config import PRESETS, RuntimeConfig
from mnn_tpu_torch.runtime import kvcache, omni
from tests.test_torch_decoder import numpy_fields, rel

SCHED = ("ddim", "ddpm", "euler", "flow_match")
SHAPE = (1, 4, 8, 8)
# (name, scheduler kwargs, t, t_prev, draws noise): mid steps and last steps
STEP_CASES = [
    ("ddim", {}, 761, 711, False), ("ddim", {}, 41, -1, False),
    ("ddim_eta", {"eta": 0.5}, 761, 711, True),
    ("ddim_v", {"prediction_type": "v_prediction"}, 500, 450, False),
    ("ddpm", {}, 761, 711, True), ("ddpm", {}, 41, -1, True),
    ("ddpm_linear", {"schedule": "linear"}, 300, 250, True),
    ("euler", {}, 761, 711, False), ("euler", {}, 41, -1, False),
    ("flow_match", {}, 900, 800, False), ("flow_match", {}, 100, -1, False),
]
KIND = {"ddim": "ddim", "ddim_eta": "ddim", "ddim_v": "ddim", "ddpm": "ddpm",
        "ddpm_linear": "ddpm", "euler": "euler", "flow_match": "flow_match"}
TALK_MODEL = dataclasses.replace(J_PRESETS["tiny"], vocab_size=64, tie_word_embeddings=True)
TALK_CFG = dict(thinker_hidden=128, codec_eos_ids=(62,), n_mels=8, mel_per_codec=2,
                max_new_tokens=8)
CODEC = [5, 17, 33, 2, 61, 40]        # a fixed codec stream
# the thinker: tests/test_torch_omni.py's tiny Omni (W8 here), greedy, a
# bf16 cache; its reply is 8 tokens, as long as the talker's own prompt
# below, so the JAX talker compiles its prefill once
OMNI_RT = dict(max_batch=1, max_seq_len=128, prefill_chunk=32, decode_block=4,
               sampler="greedy", kv_quant=False, max_new_tokens=8)
OMNI_IDS = [3, 7, 11, 2, 19, 23]
REPLY = 8
CAP = 2048                            # the talker's default cache capacity
REL = 5e-2


def jax_codec_trace(params, m, embeds, toks, capacity):
    """The logits rows of the JAX talker's prefill and of a decode step fed
    each of `toks`: the same `forward` calls as `Talker.generate_codec`."""
    cache = jkv.create(m.num_layers, 1, m.num_kv_heads, capacity, m.head_dim, quantized=False)
    t = embeds.shape[0]
    logits, cache = jax.jit(lambda p, e, c: jdec.forward(
        p, m, jnp.zeros((1, t), jnp.int32), c, inputs_embeds=e))(
            params, embeds[None].astype(jnp.bfloat16), cache)
    rows = [np.asarray(logits, np.float32)]
    step = jax.jit(lambda p, tok, c: jdec.forward(p, m, tok, c))
    for tok in toks:
        logits, cache = step(params, jnp.asarray([[tok]], jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return rows


def recording(obj, name, store):
    """Wrap obj.name so each return value is appended to `store`."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        store.append(out)
        return out
    setattr(obj, name, wrapped)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(21)
    out = {}
    # -- schedulers --------------------------------------------------------
    out["tables"] = {}
    for name in SCHED:
        s = jsched.SCHEDULERS[name]()
        out["tables"][name] = np.asarray(s.alphas_cumprod)
    out["tables"]["linear"] = np.asarray(jsched.Scheduler(schedule="linear").alphas_cumprod)
    out["timesteps"] = {n: jsched.DDIMScheduler().set_timesteps(n) for n in (7, 20, 50)}
    out["flow"] = {}
    for shift in (1.0, 3.0):
        for n in (8, 10):
            s = jsched.FlowMatchEulerScheduler(shift=shift)
            out["flow"][shift, n] = (s.set_timesteps(n), s.sigmas)
    sample = rng.standard_normal(SHAPE).astype(np.float32)
    model_out = rng.standard_normal(SHAPE).astype(np.float32)
    out["sample"], out["model_out"] = sample, model_out
    out["steps"], out["noise"] = [], []
    for k, (name, kw, t, t_prev, draws) in enumerate(STEP_CASES):
        s = jsched.SCHEDULERS[KIND[name]](**kw)
        key = jax.random.PRNGKey(100 + k)
        out["noise"].append(np.asarray(jax.random.normal(key, SHAPE)))
        out["steps"].append(np.asarray(s.step(jnp.asarray(model_out), t, t_prev,
                                              jnp.asarray(sample), key)))
    d = jsched.EulerDiscreteScheduler()
    out["euler_scaled"] = np.asarray(d.scale_model_input(jnp.asarray(sample), 761))
    out["euler_sigma"] = np.asarray(d.sigma(999))
    out["add_noise"] = np.asarray(jsched.DDPMScheduler().add_noise(
        jnp.asarray(sample), jnp.asarray(model_out), 333))
    f = jsched.FlowMatchEulerScheduler(shift=3.0)
    f.set_timesteps(6)
    out["flow_index"] = np.asarray(f.step_index(jnp.asarray(model_out), 2, jnp.asarray(sample)))

    # -- the vocoder -------------------------------------------------------
    # seeded numpy weights in the JAX layouts, random alphas and biases too
    vcfg = jvoc.VocoderConfig.tiny()
    shapes = jax.eval_shape(lambda: jvoc.init_vocoder_params(vcfg, jax.random.PRNGKey(0)))
    out["voc_params"] = {k: rng.normal(0, 0.05 if len(v.shape) == 3 else 0.3,
                                       v.shape).astype(np.float32) for k, v in shapes.items()}
    vp = {k: jnp.asarray(v) for k, v in out["voc_params"].items()}
    out["mel"] = rng.standard_normal((2, vcfg.n_mels, 7)).astype(np.float32)
    out["wav"] = {}
    for aa in (False, True):
        c = dataclasses.replace(vcfg, use_aa_filters=aa)
        out["wav"][aa] = np.asarray(jax.jit(lambda p, m: jvoc.vocoder_forward(p, c, m))(
            vp, jnp.asarray(out["mel"])))
    x = rng.standard_normal((1, 6, 9)).astype(np.float32)
    out["convt_in"] = x
    out["convt"] = {}
    for rate, ksz in ((4, 8), (2, 4)):        # pad 2 and pad 1
        w = rng.standard_normal((6, 5, ksz)).astype(np.float32)      # torch [I, O, k]
        b = rng.standard_normal(5).astype(np.float32)
        pad = (ksz - rate) // 2
        y = jvoc._conv_transpose1d(jnp.asarray(x), jnp.asarray(w.transpose(2, 1, 0)),
                                   jnp.asarray(b), stride=rate, pad=pad)
        out["convt"][rate] = (w, b, pad, np.asarray(y))
    wc = rng.standard_normal((5, 6, 3)).astype(np.float32)            # torch [O, I, k]
    out["conv"] = (wc, np.asarray(jvoc._conv1d(jnp.asarray(x), jnp.asarray(wc.transpose(2, 1, 0)),
                                               pad=3, dilation=3)))
    out["aa_alpha"] = rng.normal(0, 0.3, 6).astype(np.float32)
    out["aa"] = np.asarray(jvoc._aa_activation(jnp.asarray(x), jnp.asarray(out["aa_alpha"]),
                                               True))
    # a synthetic weight-normed BigVGAN state dict in the torch layouts
    sd = {}
    for k, v in out["voc_params"].items():
        if v.ndim == 3:
            tv = np.ascontiguousarray(v.transpose(2, 1, 0))    # back to the torch layout
            sd[k[:-len("weight")] + "weight_v"] = tv
            sd[k[:-len("weight")] + "weight_g"] = np.abs(
                rng.standard_normal((tv.shape[0], 1, 1))).astype(np.float32) + 0.5
        elif k.endswith(".act.alpha") and "resblocks.0." in k:
            sd[k.replace(".act.alpha", ".alpha")] = v       # the short alpha name
        else:
            sd[k] = v
    out["bigvgan_sd"] = sd
    out["bigvgan"] = {k: np.asarray(v) for k, v in jvoc.from_bigvgan(sd).items()}

    # -- the thinker and the talker ----------------------------------------
    # the talker's decoder is the thinker's stack on the first 64 rows of its
    # embedding, tied (the tiny talker of tests/test_talker_vocoder.py, W8):
    # one random init, one set of compiled layer shapes
    jcfg = J_PRESETS["tiny"]
    jp = jax.jit(lambda k: jdec.init_random_params(   # one compile, not one an op
        jcfg, k, quant_bits=8, scale=0.05, fast=True, lm_head_bits=4))(jax.random.PRNGKey(0))
    tp = dataclasses.replace(jp, embedding=jp.embedding[:TALK_MODEL.vocab_size], lm_head=None)
    out["omni_params"], out["talk_params"] = numpy_fields(jp), numpy_fields(tp)
    tcfg = jtalk.TalkerConfig(model=TALK_MODEL, **TALK_CFG)
    out["in_proj"] = (rng.standard_normal((128, TALK_MODEL.hidden_size)) * 0.1).astype(np.float32)
    out["denoiser"] = {k: (rng.standard_normal(s_) * 0.1).astype(np.float32) for k, s_ in (
        ("codec_embed", (64, 32)), ("w1", (8 + 32 + 1, 64)), ("w2", (64, 8)))}
    jt = jtalk.Talker(tcfg, tp, jnp.asarray(out["in_proj"]),
                      mel_denoiser=jtalk.conv_mel_denoiser(
                          {k: jnp.asarray(v) for k, v in out["denoiser"].items()}, tcfg),
                      vocoder_params=vp, vocoder_cfg=vcfg)
    hidden = (rng.standard_normal((REPLY, 128)) * 0.05).astype(np.float32)
    toks = rng.integers(0, 256, REPLY).tolist()
    out["hidden"], out["hidden_toks"] = hidden, toks
    out["codec"] = jt.generate_codec(jnp.asarray(hidden), thinker_tokens=toks)
    embeds = (jnp.dot(jnp.asarray(hidden), jnp.asarray(out["in_proj"]))
              + tp.embedding[jnp.asarray(toks) % 64].astype(jnp.float32))
    out["codec_rows"] = jax_codec_trace(tp, TALK_MODEL, embeds, out["codec"], CAP)

    # -- Omni speaking -----------------------------------------------------
    codecs, mels = [], []
    recording(jt, "generate_codec", codecs)
    recording(jt, "codec_to_mel", mels)
    o = jomni.Omni(jcfg, jp, JRuntimeConfig(**OMNI_RT), talker=jt)
    out["omni_tokens"], out["omni_wav"] = o.respond_mm(OMNI_IDS, speak=True)
    assert len(out["omni_tokens"]) == REPLY
    out["omni_codec"], out["omni_mel"] = codecs[0], np.asarray(mels[0])
    n = max(len(codecs[0]), 1)
    out["mel_noise"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 8, 2 * n)))
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


# --------------------------------------------------------------------------
# schedulers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCHED + ("linear",))
def test_scheduler_tables_bit_for_bit(ref, name):
    s = (sched.Scheduler(schedule="linear") if name == "linear"
         else sched.SCHEDULERS[name]())
    got = s.alphas_cumprod
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref["tables"][name].view(np.int32))


def test_timesteps_and_sigmas_bit_for_bit(ref):
    for n, want in ref["timesteps"].items():
        got = sched.DDIMScheduler().set_timesteps(n)
        assert got.dtype == np.int32 and np.array_equal(got, want), n
    for (shift, n), (ts, sig) in ref["flow"].items():
        s = sched.FlowMatchEulerScheduler(shift=shift)
        got = s.set_timesteps(n)
        assert got.dtype == np.int32 and np.array_equal(got, ts), (shift, n)
        assert s.sigmas.dtype == np.float32
        np.testing.assert_array_equal(s.sigmas.view(np.int32), sig.view(np.int32))


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in STEP_CASES])
def test_scheduler_step_matches_jax(ref, jax_noise, case):
    name, kw, t, t_prev, draws = STEP_CASES[case]
    s = sched.SCHEDULERS[KIND[name]](**kw)
    if draws:
        jax_noise.append(ref["noise"][case])
    gen = torch.Generator().manual_seed(0)
    got = s.step(torch.from_numpy(ref["model_out"]), np.int32(t), np.int32(t_prev),
                 torch.from_numpy(ref["sample"]), gen)
    assert not jax_noise, "the step drew no noise"
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    assert rel(got.numpy(), ref["steps"][case]) <= 1e-6


def test_scheduler_helpers_match_jax(ref):
    x = torch.from_numpy(ref["sample"])
    d = sched.EulerDiscreteScheduler()
    assert rel(d.scale_model_input(x, 761).numpy(), ref["euler_scaled"]) <= 1e-6
    assert float(d.sigma(999)) == float(ref["euler_sigma"])
    got = sched.DDPMScheduler().add_noise(x, torch.from_numpy(ref["model_out"]), 333)
    assert rel(got.numpy(), ref["add_noise"]) <= 1e-6
    f = sched.FlowMatchEulerScheduler(shift=3.0)
    f.set_timesteps(6)
    assert rel(f.step_index(torch.from_numpy(ref["model_out"]), 2, x).numpy(),
               ref["flow_index"]) <= 1e-6


def test_noise_is_drawn_on_the_cpu_then_moved():
    """The same seed gives the same noise on any device: the draw is the
    CPU generator's."""
    a = sched.noise(torch.Generator().manual_seed(4), (2, 3), "cpu")
    b = torch.randn((2, 3), generator=torch.Generator().manual_seed(4))
    assert a.dtype == torch.float32 and torch.equal(a, b)


# --------------------------------------------------------------------------
# the vocoder
# --------------------------------------------------------------------------

def port_vocoder_params(ref):
    return voc.params_from_numpy(ref["voc_params"], "cpu")


@pytest.mark.parametrize("rate", [4, 2], ids=["pad2", "pad1"])
def test_conv_transpose_matches_jax(ref, rate):
    w, b, pad, want = ref["convt"][rate]
    got = voc._conv_transpose1d(torch.from_numpy(ref["convt_in"]), torch.from_numpy(w),
                                torch.from_numpy(b), stride=rate, pad=pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_vocoder_primitives_match_jax(ref):
    x = torch.from_numpy(ref["convt_in"])
    wc, want = ref["conv"]
    np.testing.assert_allclose(voc._conv1d(x, torch.from_numpy(wc), pad=3, dilation=3).numpy(),
                               want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(voc._kaiser_sinc_filter(0.25, 0.3, 12),
                                  jvoc._kaiser_sinc_filter(0.25, 0.3, 12))
    xs = torch.linspace(-2, 2, 9)[None, None]
    np.testing.assert_allclose(voc._snake(xs, torch.zeros(1), True).numpy(),
                               (xs + torch.sin(xs) ** 2).numpy(), atol=1e-6)
    got = voc._aa_activation(x, torch.from_numpy(ref["aa_alpha"]), True)
    assert tuple(got.shape) == ref["aa"].shape == (1, 6, 9)
    np.testing.assert_allclose(got.numpy(), ref["aa"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("aa", [False, True], ids=["snake", "aa_filters"])
def test_vocoder_forward_matches_jax(ref, aa):
    cfg = dataclasses.replace(voc.VocoderConfig.tiny(), use_aa_filters=aa)
    got = voc.vocoder_forward(port_vocoder_params(ref), cfg, torch.from_numpy(ref["mel"]))
    want = ref["wav"][aa]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 7 * 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_from_bigvgan_matches_jax(ref):
    """Weight norm fused and `.alpha` renamed, in the port's layouts: the
    JAX package's tensors transposed back to [O, I, k] / [I, O, k]."""
    sd = {k: torch.from_numpy(v) for k, v in ref["bigvgan_sd"].items()}
    got = voc.from_bigvgan(sd)
    want = ref["bigvgan"]
    assert sorted(got) == sorted(want) == sorted(ref["voc_params"])
    for k, w in want.items():
        w = w.transpose(2, 1, 0) if w.ndim == 3 else w
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6, rtol=0, err_msg=k)
    # arrays go to the asked device
    assert voc.from_bigvgan(ref["bigvgan_sd"], "cpu")["conv_pre.weight"].shape == \
        got["conv_pre.weight"].shape


def test_vocoder_layouts_and_init(ref):
    p = port_vocoder_params(ref)
    cfg = voc.VocoderConfig.tiny()
    assert tuple(p["conv_pre.weight"].shape) == (16, 8, 7)          # [O, I, k]
    assert tuple(p["ups.0.0.weight"].shape) == (16, 8, 8)           # [I, O, k]
    q = voc.init_vocoder_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in q.items()} == {k: tuple(v.shape) for k, v in p.items()}
    r = voc.init_vocoder_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(q[k], r[k]) for k in q)
    assert cfg.hop_length == 8 and voc.VocoderConfig().hop_length == 256


# --------------------------------------------------------------------------
# the talker
# --------------------------------------------------------------------------

def port_talker(ref, thinker_hidden=128):
    model = dataclasses.replace(PRESETS["tiny"], vocab_size=64, tie_word_embeddings=True)
    cfg = talker.TalkerConfig(model=model, **dict(TALK_CFG, thinker_hidden=thinker_hidden))
    params = decoder.params_from_numpy(ref["talk_params"], cfg.model, "cpu")
    dn = {k: torch.from_numpy(v) for k, v in ref["denoiser"].items()}
    return talker.Talker(cfg, params, ref["in_proj"],
                         mel_denoiser=talker.conv_mel_denoiser(dn, cfg),
                         vocoder_params=voc.params_from_numpy(ref["voc_params"], "cpu"),
                         vocoder_cfg=voc.VocoderConfig.tiny(), device="cpu")


def test_generate_codec_matches_jax(ref):
    tk = port_talker(ref)
    toks = ref["hidden_toks"]
    want_ids, want = ref["codec"], ref["codec_rows"]
    # teacher-forced with the JAX ids: the same forward calls as the talker
    m = tk.cfg.model
    embeds = (torch.from_numpy(ref["hidden"]) @ tk.in_proj
              + tk.params.embedding[torch.tensor(toks) % 64].float())
    cache = kvcache.create(m.num_layers, 1, m.num_kv_heads, CAP, m.head_dim,
                                   quantized=False, device="cpu")
    logits, cache = decoder.forward(tk.params, m, torch.zeros((1, REPLY), dtype=torch.int64),
                                    cache, inputs_embeds=embeds[None].to(torch.bfloat16))
    rows = [logits.float().numpy()]
    for tok in want_ids:
        logits, cache = decoder.forward(tk.params, m, torch.tensor([[tok]]), cache)
        rows.append(logits.float().numpy())
    assert len(rows) == len(want) == len(want_ids) + 1
    for s, (a, b) in enumerate(zip(rows, want)):
        assert a.shape == b.shape == (1, 64) and np.isfinite(a).all()
        assert rel(a, b) <= REL, f"step {s}: rel-L2 {rel(a, b):.3g}"
    got = tk.generate_codec(ref["hidden"], thinker_tokens=toks)
    assert all(0 <= c < 64 for c in got) and len(got) <= TALK_CFG["max_new_tokens"]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(rows, want))
    checked = 0
    for s in range(len(want_ids) + 1):
        top2 = np.sort(want[s][0])[-2:]
        if top2[1] - top2[0] <= diff:
            break
        if s == len(want_ids):        # the JAX stream stopped here (EOS or limit)
            assert got == want_ids
            break
        assert got[s] == want_ids[s], f"step {s}"
        checked += 1
    assert checked >= 1
    p = tk.perf
    assert p.prompt_len == REPLY and p.codec_tokens == len(got) and p.prefill_s > 0


def test_codec_to_mel_and_token2wav_match_jax(ref, jax_noise):
    """The JAX Omni's codec ids through the port's mel ODE (JAX's noise)
    and vocoder: its mel within 1e-4, its wav within 1e-3."""
    tk = port_talker(ref)
    codec = ref["omni_codec"] or [0]
    jax_noise.append(ref["mel_noise"])
    mel = tk.codec_to_mel(codec)
    assert mel.dtype == torch.float32 and tuple(mel.shape) == ref["omni_mel"].shape
    np.testing.assert_allclose(mel.numpy(), ref["omni_mel"], atol=1e-4, rtol=0)
    jax_noise.append(ref["mel_noise"])
    wav = tk.token2wav(codec)
    assert isinstance(wav, np.ndarray) and wav.dtype == np.float32
    assert wav.shape == ref["omni_wav"].shape == (2 * len(codec) * 8,)
    np.testing.assert_allclose(wav, ref["omni_wav"], atol=1e-3, rtol=0)
    assert tk.perf.samples == wav.shape[0]


def test_mel_start_is_the_seeded_cpu_draw(ref):
    """Without a patch the ODE starts from `noise` of Generator(seed): the
    same mel twice, another for another seed."""
    tk = port_talker(ref)
    a = tk.codec_to_mel(CODEC, num_steps=2, seed=1)
    assert tuple(a.shape) == (1, 8, 12)
    assert torch.equal(a, tk.codec_to_mel(CODEC, num_steps=2, seed=1))
    assert not torch.equal(a, tk.codec_to_mel(CODEC, num_steps=2, seed=2))


def test_init_conv_mel_denoiser_shapes(ref):
    cfg = port_talker(ref).cfg
    p = talker.init_conv_mel_denoiser(cfg, 64, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: jtalk.init_conv_mel_denoiser(
        jtalk.TalkerConfig(model=TALK_MODEL, **TALK_CFG), 64, jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    with pytest.raises(ValueError, match="no mel denoiser"):
        talker.Talker(cfg, None, ref["in_proj"], device="cpu").codec_to_mel([1])


# --------------------------------------------------------------------------
# Omni speaking
# --------------------------------------------------------------------------

def port_omni(ref, with_talker=True, thinker_hidden=128):
    params = decoder.params_from_numpy(ref["omni_params"], PRESETS["tiny"], "cpu")
    tk = port_talker(ref, thinker_hidden=thinker_hidden) if with_talker else None
    return omni.Omni(PRESETS["tiny"], params, RuntimeConfig(**OMNI_RT), talker=tk,
                     device="cpu")


def test_omni_speak_matches_jax(ref, jax_noise):
    o = port_omni(ref)
    codecs = []
    recording(o.talker, "generate_codec", codecs)
    want_codec = ref["omni_codec"]
    jax_noise.append(ref["mel_noise"])
    toks, wav = o.respond_mm(OMNI_IDS, speak=True)
    assert toks == ref["omni_tokens"]
    assert codecs[0] == want_codec
    assert isinstance(wav, np.ndarray) and wav.dtype == np.float32 and wav.ndim == 1
    assert wav.shape == ref["omni_wav"].shape == (2 * max(len(want_codec), 1) * 8,)
    np.testing.assert_allclose(wav, ref["omni_wav"], atol=1e-3, rtol=0)


def test_respond_mm_speak_needs_a_matching_talker(ref):
    o = port_omni(ref, with_talker=False)
    assert o.respond_mm(OMNI_IDS, max_new_tokens=2) == ref["omni_tokens"][:2]
    o.reset()
    with pytest.raises(ValueError, match="no talker attached"):
        o.respond_mm(OMNI_IDS, speak=True, max_new_tokens=2)
    o = port_omni(ref, thinker_hidden=64)
    with pytest.raises(ValueError, match="thinker_hidden"):
        o.respond_mm(OMNI_IDS, speak=True, max_new_tokens=2)


DEFAULT_DEVICE_CALLS = {
    "init_vocoder_params": lambda r: voc.init_vocoder_params(
        voc.VocoderConfig.tiny(), torch.Generator().manual_seed(0)),
    "params_from_numpy": lambda r: voc.params_from_numpy(r["voc_params"]),
    "from_bigvgan": lambda r: voc.from_bigvgan(r["bigvgan_sd"]),
    "Talker": lambda r: talker.Talker(None, None, r["in_proj"]),
    "init_conv_mel_denoiser": lambda r: talker.init_conv_mel_denoiser(
        port_talker(r).cfg, 64, torch.Generator().manual_seed(0)),
}


@pytest.mark.parametrize("entry", list(DEFAULT_DEVICE_CALLS))
def test_entry_points_need_a_device_or_the_card(ref, entry):
    """Given arrays and no device, the entry points go to the card and raise
    without one; they never run quietly on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry](ref)
