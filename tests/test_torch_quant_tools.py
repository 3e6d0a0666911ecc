"""The port's offline quantization tools against the JAX package's, on the
CPU: calibration observers, ADMM, HQQ, SmoothQuant, the AWQ search,
OmniQuant, and AWQ in `convert_hf` and the CLI.

Bounds: the observers, `kl_scale` and `ema_scale` equal (the same numpy
code); ADMM and HQQ the same codes, scales and biases, bit for bit (the
same f32 steps, every divisor a tensor); AWQ's `search_scale` picks the
JAX ratio (s within 1e-6) and `search_clip` the same clip of every column
(equal weights); OmniQuant, 150 Adam steps through a straight-through fake
quant whose trajectories part with the last bits of the gradients: the
reconstruction MSE within 10 % of the JAX function's and both below 0.8x
round to nearest's, the learned scale within rel-L2 0.1, and without LET
(no scale) at most 2 % of the codes differ. `convert_hf(awq=True)` on a
tiny Qwen2 directory: the same scale ratio at every layer (the norms that
carry 1 / s within 1e-5 of the JAX converter's) and logits within rel-L2
5e-2 of the JAX conversion's, both loaded by the port. The JAX side of each
comparison is computed once, in one module-scoped fixture.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.convert.hf import convert_hf as jconvert_hf
from mnn_tpu.quant import awq_search as jawq
from mnn_tpu.quant import calibrate as jcal
from mnn_tpu.quant import hqq as jhqq
from mnn_tpu.quant import omni_quant as jomni
from mnn_tpu.quant import smooth as jsmooth
from mnn_tpu.quant.quantize import dequantize as jdequantize
from mnn_tpu.quant.quantize import quantize as jquantize
from mnn_tpu_torch import cli
from mnn_tpu_torch.convert import stfile
from mnn_tpu_torch.convert.checkpoint import load_checkpoint
from mnn_tpu_torch.convert.hf import convert_hf
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.quant import awq_search, calibrate, hqq, omni_quant, smooth
from mnn_tpu_torch.quant.quantize import dequantize, quantize
from mnn_tpu_torch.runtime import kvcache
from tests.test_torch_decoder import rel

HF_CFG = dict(architectures=["Qwen2ForCausalLM"], vocab_size=256, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256, rope_theta=10000.0,
              rms_norm_eps=1e-6, tie_word_embeddings=True, hidden_act="silu")
CONVERT = dict(bits=4, block_size=32, lm_head_bits=0)


def write_qwen2_dir(path: str):
    """A Qwen2-layout HF directory (HF tensor names, f32, tied embedding,
    qkv bias) of seeded random weights, written with the port's own
    safetensors writer: linear weights N(0, 0.05^2), norms about 1."""
    rng = np.random.default_rng(6)
    h, i = HF_CFG["hidden_size"], HF_CFG["intermediate_size"]
    d = h // HF_CFG["num_attention_heads"]
    kv = d * HF_CFG["num_key_value_heads"]
    r = lambda *shape, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) * 0.05 + mean).astype(np.float32))
    t = {"model.embed_tokens.weight": r(HF_CFG["vocab_size"], h),
         "model.norm.weight": r(h, mean=1.0)}
    for layer in range(HF_CFG["num_hidden_layers"]):
        p = f"model.layers.{layer}."
        for name, n in (("q", h), ("k", kv), ("v", kv)):
            t[p + f"self_attn.{name}_proj.weight"] = r(n, h)
            t[p + f"self_attn.{name}_proj.bias"] = r(n)
        t[p + "self_attn.o_proj.weight"] = r(h, h)
        t[p + "mlp.gate_proj.weight"] = r(i, h)
        t[p + "mlp.up_proj.weight"] = r(i, h)
        t[p + "mlp.down_proj.weight"] = r(h, i)
        t[p + "input_layernorm.weight"] = r(h, mean=1.0)
        t[p + "post_attention_layernorm.weight"] = r(h, mean=1.0)
    os.makedirs(path)
    stfile.save_file(t, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(HF_CFG, f)


def heavy_tailed(shape, seed):
    return (np.random.default_rng(seed).standard_t(df=3, size=shape) * 0.05).astype(np.float32)


def omni_case():
    """tests/test_omni_quant.py's case: activation and weight outliers."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32) * 0.1
    x[:, rng.choice(64, size=4, replace=False)] *= 15.0
    w.reshape(-1)[rng.choice(64 * 32, size=8, replace=False)] *= 10.0
    return x, w


def awq_case():
    """tests/test_awq_search.py's case: a few salient activation channels."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 128)).astype(np.float32)
    x[:, rng.choice(128, size=6, replace=False)] *= 20.0
    w = rng.normal(size=(128, 64)).astype(np.float32) * 0.1
    wt = (rng.standard_t(df=2, size=(128, 64)) * 0.05).astype(np.float32)
    return x, w, wt


def batches():
    rng = np.random.default_rng(2)
    b = [rng.standard_normal(5000).astype(np.float32) for _ in range(3)]
    b[1][:10] *= 50.0                        # widens the range: a rebin
    return b


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = {}
    obs = jcal.HistogramObserver(bins=512)
    for b in batches():
        obs.update(b)
    out["hist"] = (obs.hist.copy(), obs.absmax, obs.scale("kl"), obs.scale("max"))
    out["ema"] = jcal.ema_scale(batches(), decay=0.9)
    w = heavy_tailed((256, 64), 4)
    out["admm"] = {bits: jcal.admm_quantize_weight(w, bits=bits, block_size=64)
                   for bits in (4, 8)}
    out["hqq"] = {bits: jhqq.quantize_hqq(w, bits=bits, block_size=64) for bits in (4, 8)}
    x, wo = omni_case()
    out["omni"] = {let: jomni.omni_quantize(jnp.asarray(wo), jnp.asarray(x), bits=4,
                                            block_size=32, iters=150, let=let)
                   for let in (True, False)}
    out["omni_rtn"] = jquantize(wo, bits=4, block_size=32)
    xa, wa, wt = awq_case()
    out["awq_scale"] = np.asarray(jawq.search_scale(jnp.asarray(xa), jnp.asarray(wa),
                                                    bits=4, block_size=64))
    groups = np.arange(128) // 4
    out["awq_scale_grouped"] = np.asarray(jawq.search_scale(
        jnp.asarray(xa), jnp.asarray(wa), bits=4, block_size=64, channel_groups=groups))
    out["awq_clip"] = np.asarray(jawq.search_clip(jnp.asarray(xa), jnp.asarray(wt), bits=4,
                                                  block_size=64))
    # a tiny Qwen2 directory, converted by the JAX package with AWQ
    root = tmp_path_factory.mktemp("awq")
    src = str(root / "hf")
    write_qwen2_dir(src)
    calib = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    jconvert_hf(src, str(root / "jax-awq"), awq=True, calib_tokens=calib, **CONVERT)
    out.update(root=root, src=src, calib=calib)
    return out


def test_histogram_and_kl_scale_match_jax(ref):
    obs = calibrate.HistogramObserver(bins=512)
    for b in batches():
        obs.update(torch.from_numpy(b))          # a tensor goes to the host
    hist, absmax, kl, mx = ref["hist"]
    np.testing.assert_array_equal(obs.hist, hist)
    assert (obs.absmax, obs.scale("kl"), obs.scale("max")) == (absmax, kl, mx)
    assert calibrate.kl_scale(hist, absmax, 64) == jcal.kl_scale(hist, absmax, 64)
    assert kl < mx * 0.5                     # the outliers are clipped


def test_ema_scale_matches_jax(ref):
    assert calibrate.ema_scale(batches(), decay=0.9) == ref["ema"]
    obs = calibrate.EmaObserver()
    assert obs.scale() == 1.0 / 127


@pytest.mark.parametrize("tool,bits", [("admm", 4), ("admm", 8), ("hqq", 4), ("hqq", 8)])
def test_admm_and_hqq_match_jax_bytes(ref, tool, bits):
    w = heavy_tailed((256, 64), 4)
    fn = calibrate.admm_quantize_weight if tool == "admm" else hqq.quantize_hqq
    got, want = fn(w, bits=bits, block_size=64, device="cpu"), ref[tool][bits]
    assert (got.bits, got.block_size, got.act_bits) == (want.bits, want.block_size,
                                                         want.act_bits)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    for part in ("scale", "bias"):
        np.testing.assert_array_equal(getattr(got, part).float().numpy(),
                                      np.asarray(getattr(want, part), np.float32))
    # and it beats round to nearest on these heavy tails
    rtn = quantize(w, bits=bits, block_size=64, sym=tool == "admm")
    err = lambda ql: float(((dequantize(ql) - torch.from_numpy(w)) ** 2).mean())
    assert err(got) < err(rtn)


def test_admm_and_hqq_take_sub4_layouts():
    w = heavy_tailed((128, 32), 8)
    for fn in (calibrate.admm_quantize_weight, hqq.quantize_hqq):
        for bits in (2, 3):
            ql = fn(torch.from_numpy(w), bits=bits, block_size=64)   # a CPU tensor stays
            assert ql.packed.shape == (128 * bits // 8, 32) and ql.packed.device.type == "cpu"
            assert float(((dequantize(ql) - torch.from_numpy(w)) ** 2).mean()) < 0.01


@pytest.mark.parametrize("let", [True, False])
def test_omni_quantize_matches_jax(ref, let):
    x, w = omni_case()
    ql, s = omni_quant.omni_quantize(w, x, bits=4, block_size=32, iters=150, let=let,
                                     device="cpu")
    jql, js = ref["omni"][let]
    js = np.asarray(js)

    def err(deq, sv):
        return float(np.mean(((x / sv) @ deq - x @ w) ** 2))

    got, want = err(dequantize(ql).numpy(), s.numpy()), err(np.asarray(jdequantize(jql)), js)
    rtn = err(np.asarray(jdequantize(ref["omni_rtn"])), np.ones(64, np.float32))
    assert abs(got - want) <= 0.1 * want and got < 0.8 * rtn and want < 0.8 * rtn
    if let:
        assert rel(s.numpy(), js) < 0.1
    else:
        assert torch.equal(s, torch.ones(64))
        assert np.mean(ql.packed.numpy() != np.asarray(jql.packed)) <= 0.02


def test_awq_search_picks_the_jax_ratios(ref):
    x, w, wt = map(torch.from_numpy, awq_case())
    s, step = awq_search._search_scale(x, w, bits=4, block_size=64)
    np.testing.assert_allclose(s.numpy(), ref["awq_scale"], rtol=1e-6)
    assert 0 < int(step) < awq_search.SCALE_GRID
    np.testing.assert_allclose(
        awq_search.search_scale(x.numpy(), w.numpy(), bits=4, block_size=64,
                                channel_groups=np.arange(128) // 4, device="cpu").numpy(),
        ref["awq_scale_grouped"], rtol=1e-6)
    clipped, steps = awq_search._search_clip(x, wt, bits=4, block_size=64)
    np.testing.assert_array_equal(clipped.numpy(), ref["awq_clip"])
    assert int(steps.max()) > 0                      # some column was clipped


def test_tools_take_arrays_to_the_card_unless_cpu_is_asked(monkeypatch):
    """An array given without a device goes to the card, which raises where
    there is none; a tensor stays on its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, x = heavy_tailed((64, 16), 1), heavy_tailed((8, 64), 2)
    for call in (lambda: calibrate.admm_quantize_weight(w, block_size=32),
                 lambda: hqq.quantize_hqq(w, block_size=32),
                 lambda: omni_quant.omni_quantize(w, x, block_size=32, iters=1),
                 lambda: awq_search.search_scale(x, w, block_size=32),
                 lambda: awq_search.search_clip(x, w, block_size=32)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert awq_search.search_clip(torch.from_numpy(x), w, block_size=32).device.type == "cpu"


def test_smooth_quant_matches_jax():
    rng = np.random.default_rng(1)
    act = np.abs(rng.standard_normal(32)).astype(np.float32) * 5
    ws = {"q": rng.standard_normal((32, 16)).astype(np.float32),
          "k": rng.standard_normal((32, 8)).astype(np.float32)}
    norm = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    got, want = smooth.fold_smoothing(norm, ws, act), jsmooth.fold_smoothing(norm, ws, act)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    for k in ws:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    model = torch.nn.Sequential(torch.nn.Embedding(16, 8), torch.nn.Linear(8, 8),
                                torch.nn.Linear(8, 4))
    a = smooth.collect_act_stats_torch(model, [[1, 2, 3]])
    b = jsmooth.collect_act_stats_torch(model, [[1, 2, 3]])
    assert sorted(a) == sorted(b) == ["1", "2"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def logits_of(ckpt):
    cfg, params, _ = load_checkpoint(ckpt, device="cpu")
    ids = torch.tensor([list(range(3, 99, 3))])
    cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim,
                           quantized=False, device="cpu")
    with torch.no_grad():
        return decoder.forward(params, cfg, ids, cache, all_logits=True)[0].numpy(), params


def test_convert_hf_awq_matches_jax(ref):
    out = str(ref["root"] / "port-awq")
    config, _ = convert_hf(ref["src"], out, awq=True, calib_tokens=ref["calib"],
                           device="cpu", **CONVERT)
    got, p = logits_of(out)
    want, jp = logits_of(str(ref["root"] / "jax-awq"))
    rtn_out = str(ref["root"] / "port-rtn")
    convert_hf(ref["src"], rtn_out, device="cpu", **CONVERT)
    rtn, rp = logits_of(rtn_out)
    assert rel(got, want) < 5e-2
    # the same scales: the norms carry 1 / s_qkv and 1 / s_gu
    for name in ("input_norm", "post_norm"):
        np.testing.assert_allclose(getattr(p.layers, name).numpy(),
                                   getattr(jp.layers, name).numpy(), rtol=1e-5)
        assert not torch.equal(getattr(p.layers, name), getattr(rp.layers, name))
    with open(os.path.join(out, "awq_search.json")) as f:
        log = json.load(f)
    assert log["calib_tokens"] == [2, 32] and len(log["layers"]) == config.num_layers
    for layer in log["layers"]:
        assert sorted(layer["ratios"]) == ["down", "gu", "o", "qkv"]
        assert all(sum(c) == n for c, n in zip(
            (layer["clip_steps"][k] for k in ("o", "down", "gu")),
            (HF_CFG["hidden_size"],) * 2 + (2 * HF_CFG["intermediate_size"],)))


def test_convert_hf_awq_refusals(ref, tmp_path):
    with pytest.raises(ValueError, match="calib_tokens"):
        convert_hf(ref["src"], str(tmp_path / "x"), awq=True, device="cpu")
    cfg = json.load(open(os.path.join(ref["src"], "config.json")))
    with pytest.raises(NotImplementedError, match="dense pre-norm"):
        convert_hf(None, str(tmp_path / "y"), awq=True, calib_tokens=ref["calib"],
                   hf_config=dict(cfg, architectures=["Gemma2ForCausalLM"],
                                  model_type="gemma2", head_dim=32),
                   tensors={}, device="cpu")


def test_cli_convert_awq_with_calib_data(ref, tmp_path, capsys):
    data = tmp_path / "calib.txt"
    data.write_text("the quick brown fox\n\njumps over the lazy dog today\n")
    out = str(tmp_path / "cli-awq")
    cli.main(["convert", "--hf", ref["src"], "--out", out, "--awq", "--calib-data",
              str(data), "--bits", "4", "--block", "32", "--device", "cpu"])
    assert "converted" in capsys.readouterr().out
    with open(os.path.join(out, "awq_search.json")) as f:
        # two non-empty lines, byte tokens: 29 ids the longer
        assert json.load(f)["calib_tokens"] == [2, 29]
    assert np.isfinite(logits_of(out)[0]).all()
