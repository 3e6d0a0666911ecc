"""The port's perplexity evaluation against the JAX package's, on the CPU.

The same weights (the JAX `init_random_params`, crossed through
`params_from_numpy`) and the same tokens go through the JAX
`evaluate.sequence_nll` (Pallas in interpret mode) and the port's: `tiny`
with an int4 head and with its tied bf16 embedding as the head, and a tiny
mixture of experts, in chunks that leave a padded tail. The token counts
must be equal and the summed NLL within 1e-2 relative; `perplexity` is
exp(NLL / count) of the same numbers.
"""

import math

import jax
import numpy as np
import pytest

from mnn_tpu.models import decoder as jdec
from mnn_tpu.models.config import ModelConfig as JModelConfig
from mnn_tpu.models.config import PRESETS as J_PRESETS
from mnn_tpu.runtime import evaluate as jevaluate
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import ModelConfig
from mnn_tpu_torch.runtime import evaluate
from tests.test_torch_checkpoint import MOE
from tests.test_torch_decoder import numpy_fields

N_TOKENS = 45
# (config key, lm_head_bits, chunk): 45 tokens in chunks of 16 leave a
# 13-token last chunk (3 padded rows); of 32, a 13-token one (19 padded)
CASES = [("tiny", 4, 16), ("tiny", 0, 32), ("moe", 4, 16)]
BOUND = 1e-2


def case_id(case):
    return "-".join(map(str, case))


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for case in CASES:
        key, head_bits, chunk = case
        cfg = J_PRESETS["tiny"] if key == "tiny" else JModelConfig(**MOE)
        p = jdec.init_random_params(cfg, jax.random.PRNGKey(1), lm_head_bits=head_bits,
                                    scale=0.05)
        ids = np.random.default_rng(2).integers(0, cfg.vocab_size, N_TOKENS).tolist()
        nll, count = jevaluate.sequence_nll(p, cfg, ids, chunk=chunk, interpret=True)
        out[case] = dict(arrays=numpy_fields(p), ids=ids, nll=nll, count=count,
                         cfg=cfg)
    return out


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sequence_nll_matches_jax(jax_ref, case):
    ref = jax_ref[case]
    cfg = ModelConfig(**{f: getattr(ref["cfg"], f) for f in ref["cfg"].__dataclass_fields__})
    params = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    assert (params.lm_head is None) == (case[1] == 0)
    nll, count = evaluate.sequence_nll(params, cfg, ref["ids"], chunk=case[2])
    assert count == ref["count"] == N_TOKENS - 1
    gap = abs(nll - ref["nll"]) / abs(ref["nll"])
    assert gap < BOUND, (nll, ref["nll"], gap)
    ppl = evaluate.perplexity(params, cfg, ref["ids"], chunk=case[2])
    assert ppl == pytest.approx(math.exp(nll / count), rel=1e-6)
    # a wider chunk than the text: one padded chunk, the same sum
    nll1, count1 = evaluate.sequence_nll(params, cfg, ref["ids"], chunk=64)
    assert count1 == count and abs(nll1 - nll) / abs(nll) < BOUND


def test_sequence_nll_needs_two_tokens(jax_ref):
    ref = jax_ref[CASES[0]]
    cfg = ModelConfig(**{f: getattr(ref["cfg"], f) for f in ref["cfg"].__dataclass_fields__})
    params = decoder.params_from_numpy(ref["arrays"], cfg, "cpu")
    with pytest.raises(ValueError, match="at least 2"):
        evaluate.sequence_nll(params, cfg, [1])
