"""Serving checkpoint / resume of the port's engine, on the CPU.

The port's own snapshots (`tests/test_engine_resume.py`'s cases): a resumed
engine continues every in-flight request exactly as an uninterrupted one
does, the waiting queue survives, a quantized cache round-trips, a mode
mismatch is refused. And a snapshot that the JAX engine wrote, with the JAX
package's keys (bf16 caches as their uint16 bits, a JAX PRNG key in place
of the port's generator state), resumes in the port and continues with the
JAX engine's greedy tokens, by the margin rule of
`tests/test_torch_batch_engine.py`. The JAX side runs once, in one
module-scoped fixture.
"""

import os
import time

import numpy as np
import pytest
import torch

from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.models.config import RuntimeConfig as JRuntimeConfig
from mnn_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, RuntimeConfig
from mnn_tpu_torch.runtime.batch_engine import BatchEngine, Status
from tests.test_torch_batch_engine import drain, held_to_jax
from tests.test_torch_decoder import jax_params, numpy_fields

CFG = PRESETS["tiny"]
PROMPTS = [[3, 7, 11, 2], [9, 1, 4], list(range(40, 61))]
RT = dict(max_batch=3, max_seq_len=64, prefill_chunk=16, decode_block=2,
          sampler="greedy", kv_quant=False, max_new_tokens=12)


def rt(**kw):
    return RuntimeConfig(**dict(RT, **kw))


def jax_snapshot(params, path, kv_quant):
    """The JAX engine: three requests, two steps, a snapshot, then the
    uninterrupted rest. Returns each request's out items (logprobs on: the
    margins) and how many tokens each had at the snapshot."""
    eng = JBatchEngine(J_PRESETS["tiny"], params,
                       JRuntimeConfig(**dict(RT, kv_quant=kv_quant)))
    reqs = [eng.submit(p, 12, logprobs=2) for p in PROMPTS]
    eng.step()
    eng.step()
    eng.snapshot(path)
    at_snapshot = [len(r.generated) for r in reqs]
    eng.run_until_idle()
    return [drain(r) for r in reqs], at_snapshot


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jp = jax_params(J_PRESETS["tiny"])
    d = tmp_path_factory.mktemp("jax_snapshots")
    out = dict(arrays=numpy_fields(jp))
    for kv, quant in (("bf16", False), ("int8", True)):
        path = str(d / f"{kv}.npz")
        out[kv] = (path,) + jax_snapshot(jp, path, quant)
    return out


@pytest.fixture(scope="module")
def params(ref):
    return decoder.params_from_numpy(ref["arrays"], CFG, "cpu")


def test_resume_matches_uninterrupted(params, tmp_path):
    ref_eng = BatchEngine(CFG, params, rt())
    ref_reqs = [ref_eng.submit(p, 12) for p in PROMPTS[:2]]
    ref_eng.run_until_idle()
    wants = [r.generated for r in ref_reqs]

    eng = BatchEngine(CFG, params, rt())
    reqs = [eng.submit(p, 12) for p in PROMPTS[:2]]
    eng.step()        # admits + first decode block
    eng.step()
    snap = str(tmp_path / "engine.npz")
    eng.snapshot(snap)
    assert all(0 < len(r.generated) < 12 for r in reqs)
    del eng

    eng2 = BatchEngine.resume(snap, CFG, params, rt())
    assert [r.rid for r in eng2.slots if r] == [r.rid for r in reqs if r.slot >= 0]
    eng2.run_until_idle()
    for rid, want in zip([r.rid for r in reqs], wants):
        assert eng2.requests[rid].generated == want
        assert eng2.requests[rid].status == Status.DONE
    assert next(eng2._rid) == 2


def test_waiting_queue_survives(params, tmp_path):
    kw = dict(max_batch=1, max_new_tokens=6)
    eng = BatchEngine(CFG, params, rt(**kw))
    a = eng.submit([1, 2, 3], 6)
    b = eng.submit([4, 5, 6], 6)   # no free slot: stays waiting
    eng.step()
    snap = str(tmp_path / "engine.npz")
    eng.snapshot(snap)
    eng2 = BatchEngine.resume(snap, CFG, params, rt(**kw))
    assert eng2.requests[b.rid].status == Status.WAITING
    eng2.run_until_idle()
    assert eng2.requests[a.rid].status == Status.DONE
    assert eng2.requests[b.rid].status == Status.DONE
    assert len(eng2.requests[b.rid].generated) == 6
    solo = BatchEngine(CFG, params, rt(**kw))
    assert eng2.requests[b.rid].generated == solo.generate([4, 5, 6], 6)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantized_cache_roundtrip(params, tmp_path, kv_bits):
    kw = dict(max_batch=2, kv_quant=True, kv_bits=kv_bits, max_new_tokens=8)
    eng = BatchEngine(CFG, params, rt(**kw))
    r = eng.submit([2, 4, 6, 8], 8)
    eng.step()
    snap = str(tmp_path / "q.npz")
    eng.snapshot(snap)
    eng.run_until_idle()
    want = eng.requests[r.rid].generated

    eng2 = BatchEngine.resume(snap, CFG, params, rt(**kw))
    assert eng2.cache.bits == kv_bits and eng2.cache.k.dtype == torch.int8
    with np.load(snap) as z:
        np.testing.assert_array_equal(eng2.cache.k_scale.numpy(), z["k_scale"])
        assert str(z["k_dtype"]) == "int8"
    eng2.run_until_idle()
    assert eng2.requests[r.rid].generated == want


def test_bf16_cache_crosses_as_uint16_bits(params, tmp_path):
    eng = BatchEngine(CFG, params, rt())
    eng.submit([5, 6, 7], 4)
    eng.step()
    snap = str(tmp_path / "b.npz")
    eng.snapshot(snap)
    with np.load(snap) as z:
        assert str(z["k_dtype"]) == "bfloat16" and z["k"].dtype == np.uint16
        assert "rng" not in z.files and "torch_generator" in z.files
    eng2 = BatchEngine.resume(snap, CFG, params, rt())
    assert torch.equal(eng2.cache.k.view(torch.int16), eng.cache.k.view(torch.int16))
    assert eng2.state.pos == eng.state.pos
    assert torch.equal(eng2.state.recent, eng.state.recent)


def test_sampled_resume_continues_the_generator(params, tmp_path):
    """With a sampler that draws, the generator's state crosses too: the
    resumed engine draws what the uninterrupted one drew."""
    kw = dict(sampler="mixed", temperature=0.9, seed=5)
    eng = BatchEngine(CFG, params, rt(**kw))
    r = eng.submit(PROMPTS[2], 12)
    eng.step()
    snap = str(tmp_path / "s.npz")
    eng.snapshot(snap)
    eng.run_until_idle()
    eng2 = BatchEngine.resume(snap, CFG, params, rt(**kw))
    eng2.run_until_idle()
    assert eng2.requests[r.rid].generated == r.generated


def test_extensionless_path_roundtrips(params, tmp_path):
    eng = BatchEngine(CFG, params, rt())
    eng.submit([1, 2], 4)
    eng.step()
    snap = str(tmp_path / "state")   # no extension, like --snapshot state
    eng.snapshot(snap)
    assert os.path.exists(snap) and not os.path.exists(snap + ".npz")
    BatchEngine.resume(snap, CFG, params, rt()).run_until_idle()


def test_mode_mismatch_rejected(params, tmp_path):
    eng = BatchEngine(CFG, params, rt())
    eng.submit([1, 2], 4)
    eng.step()
    snap = str(tmp_path / "m.npz")
    eng.snapshot(snap)
    with pytest.raises(ValueError, match="quantization mode mismatch"):
        BatchEngine.resume(snap, CFG, params, rt(kv_quant=True))
    with pytest.raises(ValueError, match="cache shape"):
        BatchEngine.resume(snap, CFG, params, rt(max_batch=2))


def test_logit_bias_and_deadline_survive(params, tmp_path):
    eng = BatchEngine(CFG, params, rt())
    r = eng.submit([1, 2, 3], 12, logit_bias=((99, 1000.0),), timeout_s=3600)
    eng.step()
    snap = str(tmp_path / "lb.npz")
    eng.snapshot(snap)
    eng2 = BatchEngine.resume(snap, CFG, params, rt())
    r2 = eng2.requests[r.rid]
    assert r2.logit_bias == ((99, 1000.0),)
    assert 3000 < r2.deadline - time.perf_counter() <= 3600
    eng2.run_until_idle()
    assert r2.generated == [99] * 12


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_jax_snapshot_resumes_in_the_port(ref, params, kv):
    """The JAX engine's file: its cache, lengths, last tokens, sampler ring
    and requests resume in the port, which continues with the JAX engine's
    tokens (the margin rule from the snapshot on)."""
    path, items, at_snapshot = ref[kv]
    eng = BatchEngine.resume(path, CFG, params, rt(kv_quant=kv == "int8"))
    assert eng.cache.bits == (8 if kv == "int8" else 16)
    with np.load(path) as z:
        assert "rng" in z.files and "torch_generator" not in z.files
        assert eng.cache.length.tolist() == z["length"].tolist()
        assert eng.last_tokens.tolist() == z["last_tokens"].tolist()
    eng.run_until_idle()
    compared = 0
    for rid, (want, n) in enumerate(zip(items, at_snapshot)):
        got = eng.requests[rid].generated
        assert eng.requests[rid].status == Status.DONE and len(got) == 12
        assert got[:n] == [t for t, _, _ in want[:n]]     # carried in the file
        compared += held_to_jax(want[n:], got[n:], f"{kv} request {rid}")
    assert compared >= 12
