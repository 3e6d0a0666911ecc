"""Multimodal inputs of the port's decoder against the JAX package, on the
CPU: multimodal rope, `build_mrope_positions`, `forward(position_ids=,
inputs_embeds=, deepstack=)`, per-layer embeddings (PLE), the embeddings
prefill, and the PLE fields through `params_from_numpy` and a JAX
`save_checkpoint`.

The JAX side runs its plain XLA path (`interpret=None` on the CPU), as
`tests/test_ple_deepstack.py` and `tests/test_omni.py` run it, and is
computed once in a module-scoped fixture. Bounds:

* mrope cos/sin: within 1e-6 of JAX (f32 phases of positions below 64);
  with all three components equal, bit-equal to `rope_cos_sin`;
* `build_mrope_positions`: equal arrays;
* logits: rel-L2 5e-2 (`tests/test_decode_model.py:97`), the bound the
  port's other parity tests use, with the greedy token equal wherever the
  JAX top-2 margin exceeds the largest logit difference seen;
* a zero PLE projection: the plain forward's logits exactly;
* parameters: byte-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.convert import checkpoint as jckpt
from mnn_tpu.models import decoder as jdec
from mnn_tpu.models import layers as jlayers
from mnn_tpu.models import vision_encoder as jve
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime import generate as jgen
from mnn_tpu.runtime import kvcache as jkv
from mnn_tpu_torch.convert import checkpoint
from mnn_tpu_torch.models import decoder, layers, vision_encoder
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.runtime import generate, kvcache
from tests.test_torch_decoder import numpy_fields, rel

REL = 5e-2
SECTIONS = (4, 6, 6)                 # head_dim 32: 16 bands
IMG = -7                             # the image placeholder id
GRID = (4, 8)                        # (h, w) merge units of the image
MM_IDS = [5, 9, 2] + [IMG] * 32 + [11, 4, 8]
# the mrope forward's weights: at this scale and grid, sequential positions
# land 0.22 to 0.25 (rel-L2) from the mrope logits, far outside REL
MROPE_SCALE = 0.1
CAP = 64
# tests/test_ple_deepstack.py's shape (3 layers, a bf16 cache for PLE and
# deepstack); the same weights serve the multimodal rope and the embeddings
# prefill (int8 cache, int8 prefill rows) under a config with mrope_section
J_PLE = JModelConfig(
    name="ple-test", vocab_size=256, hidden_size=128, intermediate_size=256,
    num_layers=3, num_heads=4, num_kv_heads=2, head_dim=32, rope_theta=10000.0,
    attention_bias=False, tie_word_embeddings=True)
J_MROPE = dataclasses.replace(J_PLE, name="ple-test-mrope", mrope_section=SECTIONS)
PLE_DIM = 16
J_GEMMA = dataclasses.replace(J_PRESETS["gemma3-4b"], name="tiny-gemma3", vocab_size=256,
                              hidden_size=128, intermediate_size=256, num_layers=2,
                              head_dim=64)
EMB_RT = RuntimeConfig(max_seq_len=CAP * 2, prefill_chunk=32, kv_quant=True, kv_bits=8,
                       prefill_act_bits=8)
EMB_LEN = 45                         # a full 32-chunk, then 13 of a 32-bucket


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def with_ple(p, zero=False):
    """tests/test_ple_deepstack.py's table and projection (seeded keys)."""
    table = jax.random.normal(jax.random.PRNGKey(7), (256, 3, PLE_DIM), jnp.float32) * 0.05
    proj = jax.random.normal(jax.random.PRNGKey(8), (3, PLE_DIM, 128), jnp.float32) * 0.05
    if zero:
        proj = jnp.zeros_like(proj)
    return dataclasses.replace(p, layers=dataclasses.replace(p.layers, ple_proj=proj),
                               ple_table=table)


def jcache(cfg, quantized, cap=CAP):
    return jkv.create(cfg.num_layers, 1, cfg.num_kv_heads, cap, cfg.head_dim,
                      quantized=quantized, kv_bits=8)


def pcache(cfg, quantized, cap=CAP):
    return kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, cap, cfg.head_dim,
                          quantized=quantized, kv_bits=8)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(11)
    out = {}
    # mrope phases of random (t, h, w) positions
    pos3 = rng.integers(0, 64, (2, 5, 3)).astype(np.int32)
    out["pos3"] = pos3
    out["mrope"] = [np.asarray(a) for a in jlayers.rope_cos_sin_mrope(
        jnp.asarray(pos3), 32, 1e6, SECTIONS)]
    out["positions"] = {k: jve.build_mrope_positions(MM_IDS, IMG, GRID, start=k)
                        for k in (0, 3)}
    # the JAX package's packed random weights (its fast path), made once
    jp = jdec.init_random_params(J_PLE, jax.random.PRNGKey(0), scale=0.05, fast=True)
    pp = with_ple(jp)
    out["ple_params"] = numpy_fields(pp)
    out["ple_jax_params"] = pp
    out["mrope_params"] = numpy_fields(jp)
    jm = jdec.init_random_params(J_PLE, jax.random.PRNGKey(0), scale=MROPE_SCALE, fast=True)
    out["mrope_fwd_params"] = numpy_fields(jm)
    # multimodal rope: a prefill over spliced embeddings at mrope positions,
    # then a decode step at max(position) + 1 on all three components
    embeds = (rng.standard_normal((1, len(MM_IDS), 128)) * 0.05).astype(np.float32)
    out["embeds"] = embeds
    pos = out["positions"][0]
    cache = jcache(J_MROPE, True)
    zeros = jnp.zeros((1, len(MM_IDS)), jnp.int32)
    logits, cache = jdec.forward(jm, J_MROPE, zeros, cache,
                                 inputs_embeds=jnp.asarray(embeds, jnp.bfloat16),
                                 position_ids=jnp.asarray(pos))
    nxt = int(pos.max()) + 1
    step, _ = jdec.forward(jm, J_MROPE, jnp.asarray([[17]], jnp.int32), cache,
                           position_ids=jnp.full((1, 1, 3), nxt, jnp.int32))
    out["mrope_rows"] = [np32(logits), np32(step)]
    # the embeddings prefill with a padded last bucket (sequential positions)
    jrt = JRuntimeConfig(max_seq_len=CAP * 2, prefill_chunk=32, kv_quant=True, kv_bits=8,
                         prefill_act_bits=8)
    e45 = (rng.standard_normal((1, EMB_LEN, 128)) * 0.05).astype(np.float32)
    out["e45"] = e45
    logits, cache = jgen.run_prefill_embeds(jp, J_MROPE, jrt, jnp.asarray(e45, jnp.bfloat16),
                                            jcache(J_MROPE, True, CAP * 2))
    out["embeds_prefill"] = (np32(logits), int(cache.length[0]))
    # gemma's embedding scale multiplies inputs_embeds too
    gp = jdec.init_random_params(J_GEMMA, jax.random.PRNGKey(3), scale=0.05, fast=True)
    out["gemma_params"] = numpy_fields(gp)
    logits, _ = jdec.forward(gp, J_GEMMA, jnp.zeros((1, 12), jnp.int32),
                             jcache(J_GEMMA, False),
                             inputs_embeds=jnp.asarray(embeds[:, :12], jnp.bfloat16))
    out["gemma"] = np32(logits)
    # PLE and deepstack (2 levels, the image rows 3..6 only, as omni builds
    # them) in a 10-token prefill, then 2 decode steps under PLE
    toks = rng.integers(0, 256, (1, 10)).astype(np.int32)
    out["toks"] = toks
    ds = (rng.standard_normal((2, 1, 10, 128)) * 0.05).astype(np.float32)
    ds[:, :, :3] = 0
    ds[:, :, 7:] = 0
    out["ds"] = ds
    rows = []
    logits, cache = jdec.forward(pp, J_PLE, jnp.asarray(toks), jcache(J_PLE, False),
                                 deepstack=jnp.asarray(ds))
    rows.append(np32(logits))
    for tok in (42, 7):
        logits, cache = jdec.forward(pp, J_PLE, jnp.asarray([[tok]], jnp.int32), cache)
        rows.append(np32(logits))
    out["ple_rows"] = rows
    return out


def hold(got_rows, want_rows, label):
    """rel-L2 per row, and the token wherever the JAX margin is clear."""
    got_rows = [np.asarray(g, np.float32).reshape(-1) for g in got_rows]
    want_rows = [np.asarray(w, np.float32).reshape(-1) for w in want_rows]
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got_rows, want_rows))
    for s, (g, w) in enumerate(zip(got_rows, want_rows)):
        assert np.isfinite(g).all()
        assert rel(g, w) <= REL, f"{label} row {s}: rel-L2 {rel(g, w):.3g}"
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > diff:
            assert int(g.argmax()) == int(w.argmax()), f"{label} row {s}"


def test_mrope_cos_sin_matches_jax(ref):
    cos, sin = layers.rope_cos_sin_mrope(torch.from_numpy(ref["pos3"]), 32, 1e6, SECTIONS)
    np.testing.assert_allclose(cos.numpy(), ref["mrope"][0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), ref["mrope"][1], atol=1e-6, rtol=0)
    # text: all three components equal is plain rope, bit for bit
    p = torch.from_numpy(ref["pos3"][..., 0]).long()
    for got, want in zip(layers.rope_cos_sin_mrope(p[..., None].expand(2, 5, 3), 32, 1e6,
                                                   SECTIONS),
                         layers.rope_cos_sin(p, 32, 1e6)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="sum"):
        layers.rope_cos_sin_mrope(p[..., None].expand(2, 5, 3), 32, 1e6, (4, 4, 4))


@pytest.mark.parametrize("start", [0, 3])
def test_build_mrope_positions_matches_jax(ref, start):
    got = vision_encoder.build_mrope_positions(MM_IDS, IMG, GRID, start=start)
    np.testing.assert_array_equal(got, ref["positions"][start])
    assert got.dtype == np.int32 and got.shape == (1, len(MM_IDS), 3)
    with pytest.raises(ValueError):
        vision_encoder.build_mrope_positions(MM_IDS[:6], IMG, GRID)


def test_forward_position_ids_and_embeds_match_jax(ref):
    """The (kk) route at tiny size: spliced embeddings at mrope positions,
    then a decode step given position_ids (the fused decode-step kernel's
    plain version, its phases from the mrope cos/sin). A forward that
    dropped position_ids would fail `hold`: the same inputs at sequential
    positions sit 0.22 to 0.25 from the JAX mrope logits (rel-L2, both
    rows), where the port sits about 1.3e-2 from them."""
    cfg = port_config(J_MROPE)
    params = decoder.params_from_numpy(ref["mrope_fwd_params"], cfg, "cpu")
    pos = torch.from_numpy(ref["positions"][0])
    cache = pcache(cfg, True)
    logits, cache = decoder.forward(
        params, cfg, torch.zeros((1, len(MM_IDS)), dtype=torch.int64), cache,
        inputs_embeds=torch.from_numpy(ref["embeds"]).to(torch.bfloat16), position_ids=pos)
    nxt = int(pos.max()) + 1
    step, cache = decoder.forward(params, cfg, torch.tensor([[17]]), cache,
                                  position_ids=torch.full((1, 1, 3), nxt))
    assert int(cache.length[0]) == len(MM_IDS) + 1
    hold([logits.float(), step.float()], ref["mrope_rows"], "mrope")
    assert cfg.mrope_section == SECTIONS
    # the phases matter: sequential positions fail the bound on both rows
    seq, cache = decoder.forward(
        params, cfg, torch.zeros((1, len(MM_IDS)), dtype=torch.int64), pcache(cfg, True),
        inputs_embeds=torch.from_numpy(ref["embeds"]).to(torch.bfloat16))
    seq_step, _ = decoder.forward(params, cfg, torch.tensor([[17]]), cache)
    for g, w in zip((seq, seq_step), ref["mrope_rows"]):
        assert rel(g.float().numpy(), w) > 2 * REL


def test_inputs_embeds_take_gemma_scale(ref):
    cfg = port_config(J_GEMMA)
    params = decoder.params_from_numpy(ref["gemma_params"], cfg, "cpu")
    logits, _ = decoder.forward(
        params, cfg, torch.zeros((1, 12), dtype=torch.int64), pcache(cfg, False),
        inputs_embeds=torch.from_numpy(ref["embeds"][:, :12]).to(torch.bfloat16))
    hold([logits.float()], [ref["gemma"]], "gemma embeds")


def ple_port(ref, zero=False):
    cfg = port_config(J_PLE)
    params = decoder.params_from_numpy(ref["ple_params"], cfg, "cpu")
    if zero:
        params = dataclasses.replace(params, layers=dataclasses.replace(
            params.layers, ple_proj=torch.zeros_like(params.layers.ple_proj)))
    return cfg, params


def test_ple_and_deepstack_match_jax(ref):
    """PLE and deepstack in one prefill (the order within a layer: the MLP
    residual, PLE, then deepstack), then two PLE decode steps on the
    per-layer path."""
    cfg, params = ple_port(ref)
    assert params.ple_table.shape == (256, 3, PLE_DIM)
    rows = []
    logits, cache = decoder.forward(params, cfg, torch.from_numpy(ref["toks"]).long(),
                                    pcache(cfg, False), deepstack=torch.from_numpy(ref["ds"]))
    rows.append(logits.float())
    for tok in (42, 7):
        logits, cache = decoder.forward(params, cfg, torch.tensor([[tok]]), cache)
        rows.append(logits.float())
    hold(rows, ref["ple_rows"], "ple")
    with pytest.raises(ValueError, match="ple=True"):
        decoder.forward(params, cfg, torch.tensor([[3]]), cache, megakernel=True)


def test_zero_ple_projection_is_plain(ref):
    cfg, params = ple_port(ref, zero=True)
    toks = torch.from_numpy(ref["toks"]).long()
    got, _ = decoder.forward(params, cfg, toks, pcache(cfg, False))
    plain = dataclasses.replace(params, ple_table=None, layers=dataclasses.replace(
        params.layers, ple_proj=None))
    want, _ = decoder.forward(plain, cfg, toks, pcache(cfg, False))
    assert torch.equal(got, want)


def test_zero_deepstack_is_plain(ref):
    cfg, params = ple_port(ref)
    toks = torch.from_numpy(ref["toks"]).long()
    ds = torch.from_numpy(ref["ds"])
    logits, _ = decoder.forward(params, cfg, toks, pcache(cfg, False), deepstack=ds)
    plain, _ = decoder.forward(params, cfg, toks, pcache(cfg, False))
    zero, _ = decoder.forward(params, cfg, toks, pcache(cfg, False),
                              deepstack=torch.zeros_like(ds))
    assert torch.equal(zero, plain) and not torch.allclose(logits, plain, atol=1e-3)


def test_run_prefill_embeds_pads_the_last_bucket(ref):
    cfg = port_config(J_MROPE)
    params = decoder.params_from_numpy(ref["mrope_params"], cfg, "cpu")
    assert generate.prefill_buckets(EMB_LEN, 32) == [32, 32]
    e45 = torch.from_numpy(ref["e45"]).to(torch.bfloat16)
    logits, cache = generate.run_prefill_embeds(params, cfg, EMB_RT, e45,
                                                pcache(cfg, True, CAP * 2))
    want, length = ref["embeds_prefill"]
    assert int(cache.length[0]) == length == EMB_LEN
    hold([logits.float()], [want], "embeds prefill")
    # the embedding rows of token ids give the token prefill's logits
    ids = torch.arange(EMB_LEN)[None] % cfg.vocab_size
    tok_logits, _ = generate.run_prefill(params, cfg, EMB_RT, ids, pcache(cfg, True, CAP * 2))
    emb_logits, _ = generate.run_prefill_embeds(params, cfg, EMB_RT, params.embedding[ids],
                                                pcache(cfg, True, CAP * 2))
    assert torch.equal(tok_logits, emb_logits)


def test_ple_fields_cross_both_ways(ref, tmp_path):
    """params_from_numpy carries `ple_table` and `layers.ple_proj`; a JAX
    `save_checkpoint` writes `layers.ple_proj` (its flatten leaves the table
    out) and the port loads it byte-equal; the port's own writer keeps the
    table too."""
    arrays = ref["ple_params"]
    cfg, params = ple_port(ref)
    np.testing.assert_array_equal(params.ple_table.numpy(), arrays["ple_table"])
    np.testing.assert_array_equal(params.layers.ple_proj.numpy(), arrays["layers.ple_proj"])
    jckpt.save_checkpoint(str(tmp_path / "jax"), J_PLE, ref["ple_jax_params"],
                          JRuntimeConfig(quant_bits=4))
    got_cfg, got, _ = checkpoint.load_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert got_cfg == cfg and got.ple_table is None
    assert torch.equal(got.layers.ple_proj, params.layers.ple_proj)
    checkpoint.save_checkpoint(str(tmp_path / "port"), cfg, params)
    _, again, _ = checkpoint.load_checkpoint(str(tmp_path / "port"), device="cpu")
    assert torch.equal(again.ple_table, params.ple_table)
    assert torch.equal(again.layers.ple_proj, params.layers.ple_proj)
