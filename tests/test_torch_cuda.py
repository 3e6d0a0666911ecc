"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where there is no card. On a machine with an
NVIDIA Hopper card and nvcc, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use). Each case builds the kernels once, launches one on CUDA tensors,
and holds the result against the plain version on the same inputs, at odd
shapes the serving path does not reach: ragged N, a partial last row tile,
group sizes 1 to 8, windows and sinks. Tolerances as in the CPU tests
against JAX: rel-L2 1e-2 for the dequant matmuls, 2e-2 for flash prefill,
3e-2 for decode attention; quantized K/V rows at most one int8 level apart
(a rounding tie under another summation order). The whole-model decode
kernel is held to `decode_model.PARITY_BOUNDS` from the same state: logits
rel-L2 5e-2, x 2e-2, layer-0 rows one level and scales 8e-3, all layers'
dequantized rows 3e-2. The two mixture-of-experts kernels are held to rel-L2
2e-2 (the JAX tests' own bound, `tests/test_moe_decode.py`), the
dequantize-tile matmul to 1e-2; the fused expert decode kernel must also give
the same bits twice.
"""

import dataclasses

import pytest
import torch

from mnn_tpu_torch.kernels import (build, decode_model, decode_step, dequant_matmul,
                                   flash_attention, moe_decode, moe_prefill)
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.quant.quantize import QuantizedLinear
from mnn_tpu_torch.runtime import kvcache
from mnn_tpu_torch.runtime.llm import Llm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc for sm_90a")
    build.library()
    return torch.device("cuda")


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def rand_ql(g, dev, k, n, bits, act_bits, layers, with_bias):
    packed = torch.randint(-128, 128, (layers, k * bits // 8, n), dtype=torch.int8,
                           device=dev, generator=g)
    scale = (torch.rand((layers, k // 128, n), device=dev, generator=g) * 2e-3
             + 1e-3).to(torch.bfloat16)
    bias = (-(1 << (bits - 1)) * scale.float()).to(torch.bfloat16)
    ob = (torch.randn((layers, n), device=dev, generator=g) * 0.1
          if with_bias else None)
    return QuantizedLinear(packed=packed, scale=scale, bias=bias, out_bias=ob,
                           bits=bits, block_size=128, act_bits=act_bits)


# (bits, act_bits, M, K, N, out f32, out_bias)
GEMM = [(4, 16, 1, 256, 200, False, True), (4, 16, 5, 384, 1028, False, False),
        (8, 16, 1, 256, 132, True, False), (8, 16, 40, 256, 200, False, True),
        (4, 8, 1, 256, 200, False, True), (4, 8, 130, 384, 1028, False, False),
        (8, 8, 70, 256, 132, True, True)]


@pytest.mark.parametrize("bits,act_bits,m,k,n,f32,with_bias", GEMM)
def test_dequant_matmul_kernel(dev, bits, act_bits, m, k, n, f32, with_bias):
    g = torch.Generator(device=dev).manual_seed(m * n + bits)
    ql = rand_ql(g, dev, k, n, bits, act_bits, 3, with_bias)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    kern = dequant_matmul.KERNEL_A8 if act_bits == 8 else dequant_matmul.KERNEL_BF16
    before = kern.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=2, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(2), out_dtype)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 1e-2


# (H, Hkv, Tq, S, kv_len, q_offset, D, window, sink)
FLASH = [(2, 2, 16, 64, 40, 24, 64, 0, 0), (4, 2, 45, 128, 77, 32, 64, 0, 0),
         (14, 2, 100, 256, 228, 128, 64, 0, 0), (4, 2, 33, 96, 90, 57, 32, 16, 2),
         (2, 1, 20, 64, 20, 0, 128, 0, 0)]


@pytest.mark.parametrize("h,hkv,t,s,kv_len,q_off,d,window,sink", FLASH)
def test_flash_prefill_kernel(dev, h, hkv, t, s, kv_len, q_off, d, window, sink):
    g = torch.Generator(device=dev).manual_seed(h * t + s)
    mk = lambda *shape: torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = mk(2, h, t, d), mk(2, hkv, s, d), mk(2, hkv, s, d)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo,
                                          window=window, sink=sink)
    want = flash_attention.flash_attention_plain(q, k, v, kl, qo, True, None,
                                                 window, sink)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 2e-2


# (G, D, int8 cache, qk-norm, window, sink, lengths)
DECODE = [(7, 64, True, False, 0, 0, (0, 300)), (7, 64, True, True, 64, 4, (500, 37)),
          (3, 32, True, False, 0, 0, (1, 255)), (2, 128, False, False, 0, 0, (33, 256)),
          (8, 64, False, True, 0, 0, (100, 5))]


@pytest.mark.parametrize("grp,d,int8,qkn,window,sink,lengths", DECODE)
def test_decode_step_kernel(dev, grp, d, int8, qkn, window, sink, lengths):
    nl, b, hkv, s = 3, 2, 2, 512
    g = torch.Generator(device=dev).manual_seed(grp * d + len(lengths))
    kf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    vf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    if int8:
        (kc, ks), (vc, vs) = kvcache.quantize_kv(kf), kvcache.quantize_kv(vf)
    else:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    qkv = (torch.randn((b, hkv, grp + 2, d), device=dev, generator=g) * 2
           ).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, d // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    norms = ((torch.rand(d, device=dev, generator=g) + 0.5,
              torch.rand(d, device=dev, generator=g) + 0.5) if qkn else (None, None))
    before = decode_step.KERNEL.launches
    got = decode_step.fused_decode_attention(
        qkv, kc, vc, ks, vs, 1, lens, cos, sin, q_norm=norms[0], k_norm=norms[1],
        window=window, sink=sink)
    want = decode_step.fused_decode_attention_plain(
        qkv, kc, vc, ks, vs, 1, lens, cos, sin, norms[0], norms[1], 1e-6,
        d ** -0.5, window, sink, 0.0)
    torch.cuda.synchronize()
    assert decode_step.KERNEL.launches == before + 1
    assert got[0].shape == (b, hkv * grp, d) and torch.isfinite(got[0]).all()
    assert rel(got[0], want[0]) <= 3e-2
    for j in (1, 2):
        assert float((got[j] - want[j]).abs().max()) <= (1.0 if int8 else 0.0)
    if int8:
        for j in (3, 4):
            assert rel(got[j], want[j]) <= 1e-6


def test_cuda_tensors_never_take_the_plain_version(dev):
    """A shape the kernel does not take raises on the card; it does not
    fall back to the plain version."""
    q = torch.zeros((1, 2, 8, 48), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q.cpu(), q)


def rand_cache(g, dev, nl, b, hkv, s, d, bits):
    kf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    vf = torch.randn((nl, b, hkv, s, d), device=dev, generator=g)
    if bits == 16:
        return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    (kc, ks), (vc, vs) = kvcache.quantize_for(bits, kf), kvcache.quantize_for(bits, vf)
    return kc, vc, ks, vs


# (G, D, kv bits, window, sink, kv_len per sequence)
FLASH_DECODE = [(7, 64, 8, 0, 0, (1, 301)), (7, 64, 4, 0, 0, (49, 512)),
                (4, 128, 4, 64, 4, (500, 37)), (2, 128, 16, 0, 0, (33, 256)),
                (8, 64, 16, 16, 0, (100, 5)), (1, 128, 8, 0, 0, (0, 77))]


@pytest.mark.parametrize("grp,d,bits,window,sink,lengths", FLASH_DECODE)
def test_flash_decode_kernel(dev, grp, d, bits, window, sink, lengths):
    nl, b, hkv, s = 3, 2, 2, 512
    g = torch.Generator(device=dev).manual_seed(grp * d + bits)
    kc, vc, ks, vs = rand_cache(g, dev, nl, b, hkv, s, d, bits)
    q = (torch.randn((b, hkv * grp, d), device=dev, generator=g) * 2).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = flash_attention.KERNEL_DECODE.launches
    got = flash_attention.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs,
                                           layer_index=1, window=window, sink=sink)
    want = flash_attention.decode_attention_plain(q, kc, vc, lens, ks, vs, 1, None,
                                                  window, sink)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL_DECODE.launches == before + 1
    assert got.shape == (b, hkv * grp, d) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 3e-2


MK = ModelConfig(name="mk-test", vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=10000.0, attention_bias=True, tie_word_embeddings=True)
# (config changes, weight bits, kv bits, head bits, lengths)
DECODE_MODEL = [
    ({}, 4, 8, 4, (9,)), ({}, 4, 4, 4, (40,)), ({}, 4, 16, 0, (0,)),
    ({}, 8, 8, 8, (33, 5)), (dict(qk_norm=True, attention_bias=False), 4, 8, 4, (9, 70, 3)),
    (dict(sliding_window=6, attention_sink=2), 4, 4, 4, (20, 128, 1, 64, 7)),
    (dict(hidden_size=512, head_dim=128, intermediate_size=1024), 4, 4, 4, (50, 9)),
    (dict(hidden_size=896, num_heads=14, intermediate_size=4864, vocab_size=1024,
          num_layers=2), 4, 8, 4, (100,)),
    (dict(num_heads=16, hidden_size=1024), 8, 16, 4, (17,) * 8),
]


@pytest.mark.parametrize("changes,bits,kv_bits,head_bits,lengths", DECODE_MODEL)
def test_decode_model_kernel(dev, changes, bits, kv_bits, head_bits, lengths):
    cfg = dataclasses.replace(MK, **changes)
    b, s = len(lengths), 128
    gen = torch.Generator().manual_seed(bits + kv_bits + b)
    params = decoder.init_random_params(cfg, gen, quant_bits=bits, scale=0.05,
                                        lm_head_bits=head_bits, device=dev)
    lay = params.layers
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda t: torch.rand(t.shape, device=dev, generator=g) * 0.6 + 0.7
    lay = dataclasses.replace(lay, input_norm=rnd(lay.input_norm), post_norm=rnd(lay.post_norm))
    if cfg.attention_bias:
        lay = dataclasses.replace(lay, wqkv=dataclasses.replace(
            lay.wqkv, out_bias=torch.randn(lay.wqkv.out_bias.shape, device=dev, generator=g) * 0.1))
    if cfg.qk_norm:
        lay = dataclasses.replace(lay, q_norm=rnd(lay.q_norm), k_norm=rnd(lay.k_norm))
    kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, s,
                                cfg.head_dim, kv_bits)
    x = (torch.randn((b, cfg.hidden_size), device=dev, generator=g) * 0.05).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ang = torch.rand((b, cfg.head_dim // 2), device=dev, generator=g) * 6.28
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    head = params.lm_head if head_bits else None
    kw = dict(config=cfg, head=head, final_norm=rnd(params.final_norm))
    want = decode_model.fused_decode_model_plain(x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)
    before = decode_model.KERNEL.launches
    got = decode_model.fused_decode_model(x, lay, kc, vc, ks, vs, lens, cos, sin, **kw)
    again = decode_model.fused_decode_model(x, lay, kc, vc, ks, vs, lens, cos, sin,
                                            write_cache=True, **kw)
    torch.cuda.synchronize()
    assert decode_model.KERNEL.launches == before + 2
    assert len(got) == (7 if head_bits else 5)
    assert all(torch.isfinite(t).all() for t in got if t is not None)
    m = decode_model.parity_metrics(got, want, kv_bits)
    assert not decode_model.parity_failures(m), m
    # the same launch again gives the same bits, and wrote the rows in place
    for a, c in zip(got, again):
        assert a is None or torch.equal(a, c)
    pos = lens.long().clamp(0, s - 1)
    bi = torch.arange(b, device=dev)
    assert torch.equal(kc[:, bi, :, pos].float(), got[1][:, :, :, 0].transpose(0, 1))
    assert torch.equal(vc[:, bi, :, pos].float(), got[2][:, :, :, 0].transpose(0, 1))
    if kv_bits < 16:
        assert torch.equal(ks[:, bi, :, pos], got[3][:, :, :, 0].transpose(0, 1))


def test_tiny_slice_card_matches_cpu(dev):
    """The serving slice at a tiny size, from one seed on the card and
    through the plain versions on the CPU: every kernel of the per-layer
    path launches on the card (`tiny` has head_dim 32, which the whole-model
    kernel does not take) and none on the CPU, and the prefill logits and
    first token agree (the token where the CPU's top-2 margin exceeds the
    largest difference)."""
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                       sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                       max_new_tokens=6)
    ids = list(range(3, 48))
    runs = []
    for device in (dev, "cpu"):
        llm = Llm.synthetic("tiny", rt=rt, seed=1, device=device)
        build.reset_launches()
        toks = list(llm.stream(token_ids=ids))
        runs.append((toks, llm.last_prefill_logits.float().cpu(),
                     {k.name: k.launches for k in build.KERNELS}))
    (card_toks, card, card_n), (cpu_toks, cpu, cpu_n) = runs
    per_layer = ("mnn_dequant_matmul", "mnn_dequant_matmul_a8", "mnn_flash_prefill",
                 "mnn_decode_step")
    assert all(card_n[k] > 0 for k in per_layer) and not any(cpu_n.values())
    assert card_n["mnn_decode_model"] == 0
    assert len(card_toks) == len(cpu_toks) == rt.max_new_tokens
    assert torch.isfinite(card).all() and rel(card, cpu) <= 5e-2
    top2 = cpu[0].topk(2).values
    if float(top2[0] - top2[1]) > float((card - cpu).abs().max()):
        assert card_toks[0] == cpu_toks[0]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_megakernel_slice_card_matches_cpu(dev, kv_bits):
    """Greedy decode through the whole-model kernel at a small size (head_dim
    64), on the card and through the plain versions on the CPU: one
    `mnn_decode_model` launch per decode step and no `mnn_decode_step`
    launch, and from the same state the per-layer path's logits agree."""
    cfg = dataclasses.replace(MK, tie_word_embeddings=False)
    rt = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                       sampler="greedy", lm_head_bits=4, prefill_act_bits=8,
                       kv_bits=kv_bits, max_new_tokens=6)
    ids = list(range(3, 48))
    runs = []
    for device in (dev, "cpu"):
        gen = torch.Generator().manual_seed(1)
        params = decoder.init_random_params(cfg, gen, scale=0.05, lm_head_bits=4,
                                            device=device)
        llm = Llm(cfg, params, rt, device=device)
        assert llm.info()["decode_megakernel"] and llm.info()["decode_fused_head"]
        build.reset_launches()
        toks = list(llm.stream(token_ids=ids))
        runs.append((toks, {k.name: k.launches for k in build.KERNELS}, llm))
    (card_toks, card_n, llm), (cpu_toks, cpu_n, _) = runs
    assert card_n["mnn_decode_model"] == rt.max_new_tokens
    assert card_n["mnn_decode_step"] == 0 and not any(cpu_n.values())
    assert len(card_toks) == len(cpu_toks) == rt.max_new_tokens
    tok = torch.tensor([[card_toks[-1]]], device=dev)
    cache = llm.cache
    ref, _ = decoder.forward(llm.params, cfg, tok, _clone(cache), megakernel=False)
    (mk, mtok), _ = decoder.forward(llm.params, cfg, tok, _clone(cache),
                                    megakernel=True, return_token=True)
    torch.cuda.synchronize()
    assert rel(mk, ref) <= 5e-2
    assert int(mtok[0]) == int(decode_model.lowest_argmax(mk)[0])


def _clone(cache):
    cl = lambda t: None if t is None else t.clone()
    return dataclasses.replace(cache, k=cl(cache.k), v=cl(cache.v),
                               k_scale=cl(cache.k_scale), v_scale=cl(cache.v_scale))


# (bits, M, K, N, block, out f32, out_bias): ragged N, partial row slabs
DEQ = [(4, 512, 256, 384, 128, False, True), (4, 90, 384, 1028, 128, True, False),
       (8, 33, 256, 132, 64, False, True), (4, 7, 128, 200, 32, False, False)]


@pytest.mark.parametrize("bits,m,k,n,bs,f32,with_bias", DEQ)
def test_dequant_matmul_deq_kernel(dev, bits, m, k, n, bs, f32, with_bias, monkeypatch):
    g = torch.Generator(device=dev).manual_seed(m * n + bits)
    ql = rand_ql(g, dev, k, n, bits, 8, 3, with_bias)      # act_bits is ignored
    nb = k // bs
    ql = dataclasses.replace(
        ql, block_size=bs,
        scale=ql.scale[:, :1].expand(3, nb, n).contiguous(),
        bias=(torch.randn((3, nb, n), device=dev, generator=g) * 0.01).to(torch.bfloat16))
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    monkeypatch.setattr(dequant_matmul, "DEQ_MIN_M", m)
    before = dequant_matmul.KERNEL_DEQ.launches
    got = dequant_matmul.dequant_matmul(x, ql, layer_index=1, out_dtype=out_dtype)
    want = dequant_matmul.dequant_matmul_plain(x, ql.layer(1), out_dtype, deq=True)
    torch.cuda.synchronize()
    assert dequant_matmul.KERNEL_DEQ.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 1e-2


def rand_experts(g, dev, lead, k, n, bits, bs):
    """An expert stack [*lead, ...] with its own scale and bias per block."""
    packed = torch.randint(-128, 128, (*lead, k * bits // 8, n), dtype=torch.int8,
                           device=dev, generator=g)
    qmax = (1 << bits) - 1
    scale = ((torch.rand((*lead, k // bs, n), device=dev, generator=g) + 0.5)
             * 0.1 / qmax).to(torch.bfloat16)
    bias = (-(qmax / 2) * scale.float()
            + torch.randn((*lead, k // bs, n), device=dev, generator=g) * 2e-3
            ).to(torch.bfloat16)
    return QuantizedLinear(packed=packed, scale=scale, bias=bias, out_bias=None,
                           bits=bits, block_size=bs)


# (bits, E, C, H, mi, block of gate/up, block of down): both algebras per
# product, a partial last slab (C > 80), a ragged last tile of H
PREFILL_MOE = [(4, 3, 72, 256, 128, 128, 128), (4, 2, 144, 256, 192, 128, 64),
               (8, 2, 24, 128, 64, 64, 64), (4, 2, 100, 192, 64, 64, 32),
               (4, 2, 8, 256, 128, 128, 128)]


@pytest.mark.parametrize("bits,e,cap,h,mi,bs_h,bs_mi", PREFILL_MOE)
def test_moe_prefill_kernel(dev, bits, e, cap, h, mi, bs_h, bs_mi):
    g = torch.Generator(device=dev).manual_seed(e * cap + h)
    gu = rand_experts(g, dev, (e,), h, 2 * mi, bits, bs_h)
    dn = rand_experts(g, dev, (e,), mi, h, bits, bs_mi)
    xe = torch.randn((e, cap, h), device=dev, generator=g).to(torch.bfloat16)
    w_e = torch.rand((e, cap), device=dev, generator=g)
    xe[:, -3:] = 0                           # empty slots
    w_e[:, -3:] = 0
    assert moe_prefill.supports(gu, dn, h, cap)
    before = moe_prefill.KERNEL.launches
    got = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
    want = moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn)
    torch.cuda.synchronize()
    assert moe_prefill.KERNEL.launches == before + 1
    assert got.shape == (e, cap, h) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 2e-2
    assert (got[:, -3:] == 0).all()


def moe_cfg(h, e, k, mi, si):
    return ModelConfig(name="moe-test", vocab_size=256, hidden_size=h,
                       intermediate_size=256, num_layers=3, num_heads=2,
                       num_kv_heads=1, head_dim=64, num_experts=e,
                       num_experts_per_tok=k, moe_intermediate_size=mi,
                       shared_expert_intermediate_size=si)


# (bits, n, H, E, k, mi, si, with gate)
DECODE_MOE = [(4, 1, 256, 6, 2, 128, 256, True), (4, 3, 256, 6, 4, 192, 0, False),
              (8, 8, 128, 4, 2, 64, 128, False), (4, 5, 2048, 8, 4, 1408, 1024, True)]


@pytest.mark.parametrize("bits,n,h,e,k,mi,si,with_gate", DECODE_MOE)
def test_moe_decode_kernel(dev, bits, n, h, e, k, mi, si, with_gate):
    cfg = moe_cfg(h, e, k, mi, si)
    nl = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(n * h + e)
    bs_mi = 128 if mi % 128 == 0 else 64
    lay = decoder.LayerParams(
        wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
        wgu_e=rand_experts(g, dev, (nl, e), h, 2 * mi, bits, 128),
        wdown_e=rand_experts(g, dev, (nl, e), mi, h, bits, bs_mi),
        wgu_shared=rand_experts(g, dev, (nl,), h, 2 * si, bits, 128) if si else None,
        wdown_shared=rand_experts(g, dev, (nl,), si, h, bits, 128) if si else None)
    x = torch.randn((n, h), device=dev, generator=g) * 0.5
    sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k] for _ in range(n)])
    wsel = torch.rand((n, k), device=dev, generator=g)
    gate = torch.rand((n,), device=dev, generator=g) if with_gate else None
    assert moe_decode.supports(cfg, lay, n)
    before = moe_decode.KERNEL.launches
    got = moe_decode.moe_decode_mlp(x, lay, sel, wsel, 2, gate, config=cfg)
    again = moe_decode.moe_decode_mlp(x, lay, sel, wsel, 2, gate, config=cfg)
    want = moe_decode.moe_decode_mlp_plain(x, lay, sel, wsel, 2, gate, config=cfg)
    torch.cuda.synchronize()
    assert moe_decode.KERNEL.launches == before + 2
    assert got.shape == (n, h) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 2e-2
    assert torch.equal(got, again)           # the same bits from run to run
