"""The port's audio input, `Omni` and `Llm.embed` / `rerank` against the JAX
package, on the CPU: the windows, spectrogram, mel filterbanks, Kaldi
fbank and whisper's features; the whisper encoder and its sinusoid table;
the mixed splice; `Omni.stream_mm` with `tests/test_omni.py`'s fake tower,
with a tiny Qwen2.5-VL tower and with a tiny audio encoder; and the
embedding and reranking entry points.

The model is the `tiny` preset with the JAX package's packed random weights
(its fast path, an int4 head), the runtime `tests/test_omni.py`'s: cache
128, chunk 32, decode blocks of 4, greedy, a bf16 cache. The JAX side runs
its plain XLA path and is computed once in a module-scoped fixture. Bounds:

* windows, mel filterbanks, the sinusoid table: within 1e-6;
* spectrogram: rel-L2 1e-5 (f32 FFTs on both sides);
* whisper features: within 1e-4 (f32 FFT rounding through log10; the
  clamp at max - 8 moves with the max by as much, so the clamped values
  keep that bound); fbank (natural log, no clamp): within 1e-3, a quiet
  bin's energy carrying the f32 rounding of its frame's loud bins (3.9e-4
  measured at a log-energy of -13.4);
* the audio encoder (f32): rel-L2 1e-5;
* streams: the greedy tokens equal;
* embeddings: rel-L2 2e-2 (the post-final-norm features' bound,
  `tests/test_attention.py:59`); yes-token scores within 5e-2 (logits'
  bound); cosine scores within 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.audio import audio as jaudio
from mnn_tpu.models import audio_encoder as jae
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import qwen_vl_vision as jqv
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime import omni as jomni
from mnn_tpu.runtime.llm import Llm as JLlm
from mnn_tpu_torch.audio import audio
from mnn_tpu_torch.models import audio_encoder as ae
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models import qwen_vl_vision as qv
from mnn_tpu_torch.models.config import PRESETS, RuntimeConfig
from mnn_tpu_torch.runtime import omni
from mnn_tpu_torch.runtime.llm import Llm
from tests.test_torch_decoder import numpy_fields, rel
from tests.test_torch_vision import vl_state_dict

CFG = PRESETS["tiny"]
J_CFG = J_PRESETS["tiny"]
RT_KW = dict(max_batch=1, max_seq_len=128, prefill_chunk=32, decode_block=4,
             sampler="greedy", kv_quant=False, max_new_tokens=8)
IMG, AUD = -1, -2
ACFG = ae.AudioEncoderConfig(n_mels=80, hidden_size=32, num_layers=1, num_heads=2,
                             ffn_size=64, max_positions=64)
# a Qwen2.5-VL tower at Omni's 224 x 224 pixels: 8 x 8 patches of 28, 16 tokens
VL = dataclasses.replace(qv.QwenVLVisionConfig.tiny(), patch_size=28, window_size=112)
VL_GRID = (1, 8, 8)
N_AUDIO = 50                        # 1 s of audio: 100 mel frames, 50 tokens
# two prompts of 76 positions (three 32-buckets, the last padded): text,
# an image run, text, an audio run, text
TEXT = np.random.default_rng(5).integers(0, 256, 40).tolist()
PROMPTS = {"fake_tower": TEXT[:10] + [IMG] * 4 + TEXT[10:16] + [AUD] * N_AUDIO + TEXT[16:22],
           "qwen_vl": TEXT[:4] + [IMG] * 16 + TEXT[4:7] + [AUD] * N_AUDIO + TEXT[7:10]}
QUERY = "which pet purrs"
DOCS = ["cats purr at rest", "dogs bark at cars", "fish swim in seas"]   # one length
YES = 89                            # the byte 'Y'
WINDOWS = ("hann", "hamming", "povey", "blackman")


def fake_vision(pixels):
    """tests/test_omni.py's tower: the image average-pooled into 4 tokens."""
    x = pixels[0].reshape(3, 4, 56, 4, 56).mean((0, 2, 4))
    return jnp.tile(x.reshape(4, 4), (1, 8))


def fake_vision_torch(pixels):
    x = pixels[0].reshape(3, 4, 56, 4, 56).mean((0, 2, 4))
    return x.reshape(4, 4).repeat(1, 8)


def vl_patches(hwc, xp):
    """Omni's [224, 224, 3] pixels in `qwen2_preprocess`'s patch layout
    (temporal fill 2, patch 28), for numpy-like `xp` (jnp) or torch."""
    p, (gt, gh, gw) = VL.patch_size, VL_GRID
    if xp is torch:
        frames = torch.stack([hwc, hwc])
        return frames.reshape(gt, 2, gh, p, gw, p, 3).permute(0, 2, 4, 1, 3, 5, 6).reshape(
            gt * gh * gw, -1)
    frames = xp.stack([hwc, hwc])
    return frames.reshape(gt, 2, gh, p, gw, p, 3).transpose(0, 2, 4, 1, 3, 5, 6).reshape(
        gt * gh * gw, -1)


def wav_of(rng, seconds=1.0):
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(31)
    out = {}
    wav = wav_of(rng, 1.5)
    out["wav"] = wav
    out["windows"] = {w: np.asarray(jaudio.WINDOWS[w](400)) for w in WINDOWS}
    out["spec"] = np.asarray(jaudio.spectrogram(wav, 400, 160, "hamming"))
    out["mel_slaney"] = np.asarray(jaudio.mel_filterbank(128, 400, 16000, norm="slaney"))
    out["mel_htk"] = np.asarray(jaudio.mel_filterbank(80, 400, 16000, fmin=20.0, htk=True))
    out["fbank"] = np.asarray(jaudio.fbank(wav))
    out["whisper"] = np.asarray(jaudio.whisper_fbank(wav, n_mels=80))
    # the audio encoder (seeded weights, random norms and biases too; jitted,
    # one graph a length): 1.5 s is 150 frames, cut to 2 * 64
    jcfg = jae.AudioEncoderConfig(**dataclasses.asdict(ACFG))
    shapes = jax.eval_shape(lambda: jae.init_audio_encoder_params(jcfg, jax.random.PRNGKey(3)))
    out["audio_shapes"] = {k: v.shape for k, v in shapes.items()}
    out["audio_params"] = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                           for k, v in shapes.items()}
    ap = {k: jnp.asarray(v) for k, v in out["audio_params"].items()}
    encode = jax.jit(lambda mel: jae.audio_encoder_forward(ap, jcfg, mel))
    out["encoded"] = np.asarray(encode(jnp.asarray(out["whisper"].T[None])))
    out["sinusoids"] = np.asarray(jae.sinusoidal_positions(ACFG.max_positions, 32))
    # the model, the projections, the Qwen-VL tower
    jp = jdec.init_random_params(J_CFG, jax.random.PRNGKey(0), scale=0.05, fast=True,
                                 lm_head_bits=4)
    out["params"] = numpy_fields(jp)
    projs = {k: (rng.standard_normal((d, 128)) * 0.05).astype(np.float32)
             for k, d in (("fake", 32), ("vl", VL.out_hidden_size), ("audio", 32))}
    out["projs"] = projs
    out["vl_sd"] = vl_state_dict(VL, rng)
    vlp = jqv.from_hf_qwen_vl_vision(out["vl_sd"])
    tower = jax.jit(lambda pt: jqv.qwen_vl_vision_forward(vlp, VL, pt, (VL_GRID,)))
    encoders = {"fake_tower": (fake_vision, projs["fake"]),
                "qwen_vl": (lambda px: tower(vl_patches(px[0].transpose(1, 2, 0), jnp)),
                            projs["vl"])}
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
              rng.integers(0, 256, (100, 80, 3), dtype=np.uint8)]
    out["images"] = images
    out["audio_wav"] = wav_of(rng)
    out["streams"] = {}
    for (name, (enc, proj)), image in zip(encoders.items(), images):
        o = jomni.Omni(J_CFG, jp, JRuntimeConfig(**RT_KW), vision_encode=enc,
                       vision_proj=jnp.asarray(proj), image_token_id=IMG,
                       audio_encode=encode,
                       audio_proj=jnp.asarray(projs["audio"]), audio_token_id=AUD,
                       audio_n_mels=80)
        out["streams"][name] = list(o.stream_mm(PROMPTS[name], images=[image],
                                                audios=[out["audio_wav"]]))
    # embedding and reranking through the JAX Llm (byte tokenizer)
    jllm = JLlm(J_CFG, jp, JRuntimeConfig(**RT_KW))
    out["embed"] = {p: jllm.embed(QUERY, pooling=p) for p in ("last", "mean")}
    out["rerank_yes"] = jllm.rerank(QUERY, DOCS, yes_token_id=YES)
    out["rerank_cos"] = jllm.rerank(QUERY, DOCS)
    return out


@pytest.fixture(scope="module")
def params(ref):
    return decoder.params_from_numpy(ref["params"], CFG, "cpu")


def test_windows_and_filterbanks_match_jax(ref):
    for w in WINDOWS:
        np.testing.assert_allclose(audio.WINDOWS[w](400, device="cpu").numpy(), ref["windows"][w],
                                   atol=1e-6, rtol=0, err_msg=w)
    np.testing.assert_allclose(audio.mel_filterbank(128, 400, 16000, norm="slaney", device="cpu").numpy(),
                               ref["mel_slaney"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        audio.mel_filterbank(80, 400, 16000, fmin=20.0, htk=True, device="cpu").numpy(), ref["mel_htk"],
        atol=1e-6, rtol=0)
    for htk in (False, True):
        f = np.array([0.0, 440.0, 1000.0, 7999.0])
        np.testing.assert_allclose(audio._mel_to_hz(audio._hz_to_mel(f, htk), htk), f,
                                   atol=1e-6)


def test_spectrogram_and_features_match_jax(ref):
    wav = ref["wav"]
    spec = audio.spectrogram(wav, 400, 160, "hamming", device="cpu")
    assert spec.dtype == torch.float32 and tuple(spec.shape) == ref["spec"].shape
    assert rel(spec.numpy(), ref["spec"]) <= 1e-5
    fb = audio.fbank(torch.from_numpy(wav))
    assert tuple(fb.shape) == ref["fbank"].shape == (148, 80)
    np.testing.assert_allclose(fb.numpy(), ref["fbank"], atol=1e-3, rtol=0)
    wf = audio.whisper_fbank(wav, n_mels=80, device="cpu")
    assert tuple(wf.shape) == ref["whisper"].shape == (150, 80)
    np.testing.assert_allclose(wf.numpy(), ref["whisper"], atol=1e-4, rtol=0)


DEFAULT_DEVICE_CALLS = {
    "whisper_fbank": lambda r: audio.whisper_fbank(r["wav"], n_mels=80),
    "fbank": lambda r: audio.fbank(r["wav"]),
    "mel_filterbank": lambda r: audio.mel_filterbank(80, 400, 16000),
    "hann_window": lambda r: audio.hann_window(400),
    "sinusoidal_positions": lambda r: ae.sinusoidal_positions(64, 32),
    "from_hf_whisper_encoder": lambda r: ae.from_hf_whisper_encoder(r["audio_params"]),
    "init_audio_encoder_params": lambda r: ae.init_audio_encoder_params(
        ACFG, torch.Generator().manual_seed(0)),
}


@pytest.mark.parametrize("entry", list(DEFAULT_DEVICE_CALLS))
def test_audio_entry_points_need_a_device_or_the_card(ref, entry):
    """Given arrays (or a CPU generator) and no device, the audio entry
    points go to the card and raise without one; they never run quietly on
    the host. A tensor given without a device stays on its own (the fbank
    test above)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry](ref)


def test_wav_round_trip(tmp_path):
    x = np.linspace(-0.5, 0.5, 800, dtype=np.float32)
    audio.save_wav(str(tmp_path / "a.wav"), torch.from_numpy(x), 16000)
    y, sr = audio.load_wav(str(tmp_path / "a.wav"))
    assert sr == 16000 and y.shape == x.shape and np.abs(y - x).max() <= 1 / 32768


def test_audio_encoder_matches_jax(ref):
    p = {k: torch.from_numpy(v.copy()) for k, v in ref["audio_params"].items()}
    np.testing.assert_allclose(ae.sinusoidal_positions(64, 32, "cpu").numpy(), ref["sinusoids"],
                               atol=1e-6, rtol=0)
    got = ae.audio_encoder_forward(p, ACFG, torch.from_numpy(ref["whisper"].T[None].copy()))
    assert tuple(got.shape) == ref["encoded"].shape == (1, ACFG.max_positions, 32)
    assert rel(got.numpy(), ref["encoded"]) <= 1e-5


def test_from_hf_whisper_encoder_maps_torch_layouts(ref):
    """HF names and layouts (linear [out, in], Conv1d [out, in, k], the
    "model.encoder." prefix; decoder weights skipped) map to the encoder's
    own, tensors left on their device; the JAX mapping gives the same."""
    p = ref["audio_params"]
    sd = {}
    for k, v in p.items():
        if k.startswith("conv"):
            v = v.transpose(2, 1, 0) if v.ndim == 3 else v
        elif k.endswith(".weight") and v.ndim == 2 and "embed" not in k:
            v = v.T
        sd["model.encoder." + k] = torch.from_numpy(np.ascontiguousarray(v))
    sd["model.decoder.layers.0.fc1.weight"] = torch.zeros(2, 2)
    sd["proj_out.weight"] = torch.zeros(2, 2)
    got = ae.from_hf_whisper_encoder(sd)
    want = jae.from_hf_whisper_encoder(sd)
    assert sorted(got) == sorted(want) == sorted(p)
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), p[k], err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_init_audio_encoder_params_shapes(ref):
    p = ae.init_audio_encoder_params(ACFG, torch.Generator().manual_seed(0), "cpu")
    q = ae.init_audio_encoder_params(ACFG, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert {k: tuple(v.shape) for k, v in p.items()} == ref["audio_shapes"]
    np.testing.assert_array_equal(p["embed_positions.weight"].numpy(), ref["sinusoids"])


def test_splice_embeds_mixed_runs_match_jax(params):
    emb = params.embedding
    ids = [5, IMG, IMG, 6, AUD, AUD, AUD, 7, IMG, 8]
    img = [torch.full((2, 128), 2.0), torch.full((1, 128), 3.0)]
    aud = [torch.full((3, 128), -1.0)]
    got = omni._splice_embeds_mixed(emb, ids, img, IMG, aud, AUD)
    want = jomni._splice_embeds_mixed(jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16),
                                      ids, [jnp.asarray(x.numpy()) for x in img], IMG,
                                      [jnp.asarray(x.numpy()) for x in aud], AUD)
    assert tuple(got.shape) == (1, 10, 128) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    one = omni.splice_embeds(emb, [1, IMG, IMG, 2], [torch.ones(2, 128)], IMG)
    assert torch.equal(one[0, 1:3].float(), torch.ones(2, 128))


def port_omni(ref, params, name):
    projs = ref["projs"]
    ap = {k: torch.from_numpy(v.copy()) for k, v in ref["audio_params"].items()}
    if name == "fake_tower":
        enc, proj = fake_vision_torch, projs["fake"]
    else:
        vlp = qv.from_hf_qwen_vl_vision(ref["vl_sd"], "cpu")
        enc = lambda px: qv.qwen_vl_vision_forward(
            vlp, VL, vl_patches(px[0].permute(1, 2, 0), torch), [VL_GRID])
        proj = projs["vl"]
    return omni.Omni(CFG, params, RuntimeConfig(**RT_KW), vision_encode=enc,
                     vision_proj=torch.from_numpy(proj), image_token_id=IMG,
                     audio_encode=lambda mel: ae.audio_encoder_forward(ap, ACFG, mel),
                     audio_proj=torch.from_numpy(projs["audio"]), audio_token_id=AUD,
                     audio_n_mels=80, device="cpu")


@pytest.mark.parametrize("name", list(PROMPTS))
def test_stream_mm_matches_jax(ref, params, name):
    o = port_omni(ref, params, name)
    image = ref["images"][list(PROMPTS).index(name)]
    assert o.embed_image(image).shape[0] == PROMPTS[name].count(IMG)
    assert o.embed_audio(ref["audio_wav"]).shape[0] == N_AUDIO
    got = list(o.stream_mm(PROMPTS[name], images=[image], audios=[ref["audio_wav"]]))
    assert got == ref["streams"][name]
    assert o.perf.prompt_len == len(PROMPTS[name]) and o.perf.gen_len == len(got)
    assert o.context_len == len(PROMPTS[name]) + len(got)


def test_text_only_stream_mm_is_llm_stream(ref, params):
    o = port_omni(ref, params, "fake_tower")
    ids = [3, 7, 11, 2]
    want = list(Llm(CFG, params, RuntimeConfig(**RT_KW), device="cpu").stream(
        token_ids=ids, max_new_tokens=8))
    assert list(o.stream_mm(ids, max_new_tokens=8)) == want
    o.reset()
    assert o.respond_mm(ids, max_new_tokens=8) == want
    # speech out needs a talker, as in the JAX package
    with pytest.raises(ValueError, match="no talker attached"):
        o.respond_mm(ids, speak=True)


def test_embed_and_rerank_match_jax(ref, params):
    llm = Llm(CFG, params, RuntimeConfig(**RT_KW), device="cpu")
    before = llm.cache.k.clone()
    for pooling in ("last", "mean"):
        v = llm.embed(QUERY, pooling=pooling)
        assert v.shape == (128,) and abs(float(np.linalg.norm(v)) - 1) < 1e-5
        assert rel(v, ref["embed"][pooling]) <= 2e-2, pooling
    yes = llm.rerank(QUERY, DOCS, yes_token_id=YES)
    np.testing.assert_allclose(yes, ref["rerank_yes"], atol=5e-2, rtol=0)
    cos = llm.rerank(QUERY, DOCS)
    np.testing.assert_allclose(cos, ref["rerank_cos"], atol=2e-2, rtol=0)
    assert llm.context_len == 0 and torch.equal(llm.cache.k, before)
