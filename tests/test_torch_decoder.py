"""The port's serving slice against the JAX package, on the CPU.

Weights come from the JAX package's `init_random_params` (the quantizing
path, an int4 lm head), cross to the port through `params_from_numpy`, and
the same prompt runs through both: chunked, bucketed prefill with int8
activations into an int8 KV cache, then greedy decode steps. The JAX side
runs `forward(..., interpret=True, megakernel=False)`, the per-layer Pallas
path in interpret mode; the port runs its kernels' plain versions. Logits
agree within rel-L2 5e-2 (the JAX megakernel bound,
`tests/test_decode_model.py:97`), and the tokens agree at every step where
the reference's top-2 margin exceeds the largest logit difference seen.

Also here: the sampling filters and layer primitives against JAX, the
device policy of the entry points, the CLI, and the rule that the port
imports neither JAX nor the JAX package. The JAX side of each comparison is
computed once per module: XLA:CPU fails after a few hundred compilations in
one process.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import layers as jlayers
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.runtime import generate as jgen
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu.runtime import sampler as jsamp
from mnn_tpu_torch.models import decoder, layers
from mnn_tpu_torch.models.config import PRESETS, RuntimeConfig
from mnn_tpu_torch.runtime import generate, sampler
from mnn_tpu_torch.runtime.llm import Llm

ROOT = Path(__file__).resolve().parent.parent
PROMPT_LEN = 45        # prefill chunk 32: a full chunk, then 13 of a 32-bucket
STEPS = 8
CAP = 128
REL = 5e-2
RT = RuntimeConfig(max_seq_len=CAP, prefill_chunk=32, decode_block=3,
                   sampler="greedy", kv_quant=True, kv_bits=8, quant_bits=4,
                   quant_block=128, lm_head_bits=4, prefill_act_bits=8,
                   max_new_tokens=STEPS)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def numpy_fields(obj, prefix=""):
    """JAX Params -> {dotted field name: numpy array or static int}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(numpy_fields(v, key + "."))
        elif isinstance(v, (int, bool)):
            out[key] = int(v)
        else:
            out[key] = np.asarray(v)
    return out


def jax_params(cfg):
    """The JAX package's random weights, with the biases and norms that its
    init leaves at 0 and 1 made random so that the slice uses them."""
    p = jdec.init_random_params(cfg, jax.random.PRNGKey(0), fast=False,
                                lm_head_bits=RT.lm_head_bits, scale=0.05)
    rng = np.random.default_rng(7)
    u = lambda *s: jnp.asarray(rng.uniform(0.7, 1.3, size=s), jnp.float32)
    lay = p.layers
    lay = dataclasses.replace(
        lay,
        wqkv=dataclasses.replace(lay.wqkv, out_bias=jnp.asarray(
            rng.normal(0, 0.1, size=lay.wqkv.out_bias.shape), jnp.float32)),
        input_norm=u(*lay.input_norm.shape), post_norm=u(*lay.post_norm.shape))
    return dataclasses.replace(p, layers=lay,
                               final_norm=u(*p.final_norm.shape))


def jax_greedy_trace(params, cfg, ids):
    """Prefill as `generate.run_prefill` chunks it, then STEPS greedy steps,
    every forward on the per-layer Pallas path in interpret mode."""
    fwd = lambda p, tok, cache, **kw: jdec.forward(
        p, cfg, tok, cache, interpret=True, megakernel=False, **kw)
    cache = jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, CAP, cfg.head_dim,
                       quantized=True, kv_bits=RT.kv_bits)
    pp = jgen.prefill_params_view(params, RT)
    tokens = jnp.asarray([ids], jnp.int32)
    off = 0
    for bucket in jgen.prefill_buckets(len(ids), RT.prefill_chunk):
        valid = min(bucket, len(ids) - off)
        chunk = jgen.pad_tokens(tokens[:, off:off + valid], bucket)
        logits, cache = fwd(pp, chunk, cache, all_logits=True)
        logits = logits[:, valid - 1]
        cache = dataclasses.replace(cache, length=cache.length - (bucket - valid))
        off += valid
    rows, toks = [np.asarray(logits, np.float32)], []
    for _ in range(STEPS):
        tok = int(np.argmax(rows[-1][0]))
        toks.append(tok)
        logits, cache = fwd(params, jnp.asarray([[tok]], jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return rows, toks


@pytest.fixture(scope="module")
def slice_ref():
    cfg = J_PRESETS["tiny"]
    params = jax_params(cfg)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
    rows, toks = jax_greedy_trace(params, cfg, ids)
    return dict(arrays=numpy_fields(params), ids=ids, rows=rows, toks=toks)


@pytest.fixture(scope="module")
def port_params(slice_ref):
    return decoder.params_from_numpy(slice_ref["arrays"], PRESETS["tiny"], "cpu")


def port_trace(params, cfg, ids, feed):
    """The port's prefill and STEPS decode steps, fed the tokens `feed`."""
    cache = Llm(cfg, params, RT, device="cpu")._new_cache()
    logits, cache = generate.run_prefill(
        params, cfg, RT, torch.tensor([ids], dtype=torch.int64), cache)
    rows = [logits.float().numpy()]
    for tok in feed:
        logits, cache = decoder.forward(
            params, cfg, torch.tensor([[tok]], dtype=torch.int64), cache)
        rows.append(logits.float().numpy())
    return rows, cache


def test_params_from_numpy_carries_every_field(slice_ref, port_params):
    arrays = slice_ref["arrays"]
    lay = port_params.layers
    head = port_params.lm_head
    assert head.bits == 4 and head.out_features == PRESETS["tiny"].vocab_size
    assert lay.wqkv.out_bias is not None and lay.wgu.act_bits == 16
    np.testing.assert_array_equal(lay.wqkv.packed.numpy(), arrays["layers.wqkv.packed"])
    np.testing.assert_array_equal(
        port_params.embedding.view(torch.int16).numpy(),
        arrays["embedding"].view(np.int16))
    np.testing.assert_array_equal(lay.input_norm.numpy(), arrays["layers.input_norm"])


def test_slice_matches_jax(slice_ref, port_params):
    cfg = PRESETS["tiny"]
    want, toks = slice_ref["rows"], slice_ref["toks"]
    got, cache = port_trace(port_params, cfg, slice_ref["ids"], toks)
    assert int(cache.length[0]) == PROMPT_LEN + STEPS
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    checked = 0
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (1, cfg.vocab_size)
        assert np.isfinite(a).all()
        assert rel(a, b) <= REL, f"step {s}: rel-L2 {rel(a, b):.3g}"
        top2 = np.sort(b[0])[-2:]
        if top2[1] - top2[0] > diff:
            checked += 1
            assert int(a.argmax()) == int(b.argmax()), f"step {s}"
    assert checked >= 1


def test_llm_stream_matches_jax_tokens(slice_ref, port_params):
    """The runtime's own greedy loop (decode blocks of 3, EOS-free byte
    vocab) reproduces the JAX tokens up to the first low-margin step."""
    cfg = PRESETS["tiny"]
    want, toks = slice_ref["rows"], slice_ref["toks"]
    llm = Llm(cfg, port_params, RT, device="cpu")
    out = list(llm.stream(token_ids=slice_ref["ids"]))
    assert len(out) == STEPS and llm.perf.gen_len == STEPS
    assert llm.context_len == PROMPT_LEN + STEPS
    got, _ = port_trace(port_params, cfg, slice_ref["ids"], toks)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    for s in range(STEPS):
        top2 = np.sort(want[s][0])[-2:]
        if top2[1] - top2[0] <= diff:
            break
        assert out[s] == toks[s], f"step {s}"
    llm.reset()
    assert llm.context_len == 0
    assert list(llm.stream(token_ids=slice_ref["ids"])) == out


def test_llm_rollback_and_info(port_params):
    llm = Llm(PRESETS["tiny"], port_params, RT, device="cpu")
    list(llm.stream(token_ids=[1, 2, 3, 4, 5], max_new_tokens=4))
    assert llm.context_len == 9
    llm.rollback(3)
    assert llm.context_len == 6
    info = llm.info()
    assert info["device"] == "cpu" and info["allocator"] is None
    assert info["kv_bits"] == 8 and info["kv_capacity"] == CAP
    # tiny has head_dim 32: the whole-model decode kernel does not take it
    assert info["decode_megakernel"] is False and info["decode_fused_head"] is True


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from mnn_tpu_torch import cli
    from mnn_tpu_torch.kernels.common import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Llm.synthetic("tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--synthetic", "tiny", "hello"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_run_on_cpu(capsys):
    from mnn_tpu_torch import cli

    cli.main(["run", "--synthetic", "tiny", "--device", "cpu", "--max-seq-len",
              "64", "--max-new-tokens", "3", "--sampler", "greedy", "--raw", "hi"])
    err = capsys.readouterr().err
    assert "[cpu] prefill 2 tok" in err and "decode 3 tok" in err


def test_cli_run_int4_cache_on_cpu(capsys):
    """`--kv-bits 4` reaches the cache: `tiny` then decodes per layer through
    the cache append and the flash decode kernel's plain version."""
    from mnn_tpu_torch import cli

    cli.main(["run", "--synthetic", "tiny", "--device", "cpu", "--kv-bits", "4",
              "--max-seq-len", "64", "--max-new-tokens", "3", "--sampler", "greedy",
              "--raw", "hi"])
    assert "decode 3 tok" in capsys.readouterr().err
    llm = Llm.synthetic("tiny", rt=dataclasses.replace(RT, kv_bits=4), device="cpu")
    assert llm.cache.bits == 4 and llm.cache.k.shape[-1] == PRESETS["tiny"].head_dim // 2
    assert len(list(llm.stream(token_ids=[1, 2, 3], max_new_tokens=4))) == 4
    assert llm.context_len == 7


def test_port_imports_no_jax():
    """The port and its chip script import neither JAX, optax, the JAX
    package nor `google.protobuf` (the card's machine has none: the ONNX,
    Caffe and GraphDef codecs are the port's own); no module imports
    `tensorflow`, `flatbuffers` or `huggingface_hub` at its top (the TFLite
    reader is the port's own; `download` imports `huggingface_hub` inside
    its functions), and PIL only inside a function (`ImageFolderDataset`,
    `classify.eval_folder`)."""
    files = sorted((ROOT / "mnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    names = {f.name for f in files}
    assert {"decode_model.py", "flash_attention.py", "kvcache.py", "profile_decode.py",
            "chip_smoke.py", "batch_engine.py", "server.py", "trainer.py", "lora.py",
            "datasets.py", "compress.py", "awq_search.py", "omni_quant.py",
            "calibrate.py", "hqq.py", "smooth.py", "talker.py", "vocoder.py",
            "scheduler.py", "unet.py", "vae.py", "clip_text.py", "sd.py",
            "pipeline.py", "mmdit.py", "sana.py", "wan.py", "filter.py", "structural.py",
            "native.py", "onnx_frontend.py", "onnx_pb2.py", "torch_fx.py", "nn_ops.py",
            "nms.py", "vision.py", "classify.py", "benchit.py", "plugin.py", "protowire.py",
            "caffe_pb2.py", "caffe_frontend.py", "graphdef_pb2.py", "tf_frontend.py",
            "tflite_frontend.py", "download.py"} <= names
    bad = re.compile(r"^\s*(import\s+(jax|optax)\b|from\s+(jax|optax)\b)|\bmnn_tpu\.|"
                     r"^\s*(import|from)\s+mnn_tpu\b(?!_torch)|"
                     r"^\s*(import\s+google\b|from\s+google\b)|import_module\(['\"]google\b|"
                     r"^(import|from)\s+(PIL|tensorflow|flatbuffers|huggingface_hub)\b", re.M)
    for f in files:
        hits = [m.group(0) for m in bad.finditer(f.read_text())]
        assert not hits, f"{f.relative_to(ROOT)}: {hits}"


# --------------------------------------------------------------------------
# sampling filters and layer primitives
# --------------------------------------------------------------------------

FILTERS = [("top_k", 5), ("top_p", 0.8), ("min_p", 0.1), ("tfs", 0.9),
           ("typical", 0.7), ("temperature", 0.6), ("penalty", 1.3)]
ROPE_SCALING = [None, (8.0, 1.0, 4.0, 64), (4.0, 0.0, 0.0, -1)]


@pytest.fixture(scope="module")
def small_ref():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((3, 64)) * 3).astype(np.float32)
    recent = rng.integers(-1, 64, size=(3, 8)).astype(np.int32)
    jl = jnp.asarray(logits)
    state = jsamp.SamplerState(recent=jnp.asarray(recent),
                               pos=jnp.zeros((), jnp.int32))
    fns = dict(top_k=jsamp.apply_top_k, top_p=jsamp.apply_top_p,
               min_p=jsamp.apply_min_p, tfs=jsamp.apply_tfs,
               typical=jsamp.apply_typical, temperature=jsamp.apply_temperature,
               penalty=lambda x, v: jsamp.apply_penalty(x, state, v))
    filt = {name: np.asarray(fns[name](jl, val)) for name, val in FILTERS}
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    rope = [tuple(np.asarray(a) for a in jlayers.rope_cos_sin(
        jnp.asarray(pos), 64, 10000.0, scaling=sc)) for sc in ROPE_SCALING]
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=48).astype(np.float32)
    wg = rng.standard_normal((4, 96)).astype(np.float32)
    wu = rng.standard_normal((4, 96)).astype(np.float32)
    return dict(logits=logits, recent=recent, filt=filt, pos=pos, rope=rope,
                x=x, w=w, norm=np.asarray(jlayers.rms_norm(jnp.asarray(x),
                                                            jnp.asarray(w))),
                wg=wg, wu=wu, gu=np.asarray(jlayers.interleave_gate_up(wg, wu)))


@pytest.mark.parametrize("name,val", FILTERS)
def test_sampling_filter_matches_jax(small_ref, name, val):
    lt = torch.from_numpy(small_ref["logits"])
    state = sampler.SamplerState(recent=torch.from_numpy(small_ref["recent"]))
    fns = dict(top_k=sampler.apply_top_k, top_p=sampler.apply_top_p,
               min_p=sampler.apply_min_p, tfs=sampler.apply_tfs,
               typical=sampler.apply_typical, temperature=sampler.apply_temperature,
               penalty=lambda x, v: sampler.apply_penalty(x, state, v))
    got = fns[name](lt, val).numpy()
    want = small_ref["filt"][name]
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sample_draws_from_the_filtered_set(small_ref):
    lt = torch.from_numpy(small_ref["logits"])
    allowed = small_ref["filt"]["top_k"] > -1e29
    g = torch.Generator().manual_seed(0)
    state = sampler.make_state(3, window=8)
    for _ in range(20):
        tok, state = sampler.sample(lt, g, state, sampler="topK", top_k=5)
        assert tok.dtype == torch.int32
        assert allowed[np.arange(3), tok.numpy()].all()
    assert state.pos == 20
    greedy, _ = sampler.sample(lt, None, sampler="greedy")
    np.testing.assert_array_equal(greedy.numpy(), small_ref["logits"].argmax(-1))


@pytest.mark.parametrize("i", range(len(ROPE_SCALING)))
def test_rope_cos_sin_matches_jax(small_ref, i):
    cos, sin = layers.rope_cos_sin(torch.from_numpy(small_ref["pos"]), 64, 10000.0,
                                   scaling=ROPE_SCALING[i])
    want_cos, want_sin = small_ref["rope"][i]
    np.testing.assert_allclose(cos.numpy(), want_cos, atol=2e-3)
    np.testing.assert_allclose(sin.numpy(), want_sin, atol=2e-3)


def test_rms_norm_and_gate_up_layout_match_jax(small_ref):
    got = layers.rms_norm(torch.from_numpy(small_ref["x"]),
                          torch.from_numpy(small_ref["w"]))
    np.testing.assert_allclose(got.numpy(), small_ref["norm"], rtol=1e-5, atol=1e-6)
    gu = layers.interleave_gate_up(small_ref["wg"], small_ref["wu"])
    np.testing.assert_array_equal(gu, small_ref["gu"])
    gate, up = layers.split_gate_up(torch.from_numpy(gu))
    np.testing.assert_array_equal(gate.numpy(), small_ref["wg"])
    np.testing.assert_array_equal(up.numpy(), small_ref["wu"])


@pytest.mark.parametrize("n,chunk", [(17, 512), (300, 512), (600, 512), (45, 32)])
def test_prefill_buckets_match_jax(n, chunk):
    assert generate.prefill_buckets(n, chunk) == jgen.prefill_buckets(n, chunk)
