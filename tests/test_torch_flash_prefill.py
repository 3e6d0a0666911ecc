"""The port's causal flash prefill against the JAX package, at the edges of
the tensor-core kernel's design.

On the card these calls take `flash_prefill_kernel` (`csrc/flash_prefill.cu`,
bf16 tensor cores), which replaces
`mnn_tpu/kernels/flash_attention.py::_prefill_kernel`. On the CPU the port's
wrapper runs its plain version; the JAX side runs the Pallas kernel in
interpret mode, as the JAX package's own kernel tests do. The same numpy
inputs feed both, at batch 2 and at the shapes of the card cases in
`tests/test_torch_cuda.py`: head dims 32, 64 and 128; Tq off the 16- and
64-row tiles; kv_len inside a 64-position tile; T = 128 over 600 positions
at q_offset 512 (the second chunk of a 600-token prompt); a window and a sink
across tile edges; query groups 1, 7 and 8. Tolerance: rel-L2 2e-2, the JAX
attention tests' bound (`tests/test_attention.py`). The JAX side is computed
once for the module: XLA:CPU fails after a few hundred compilations in one
process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnn_tpu.kernels.flash_attention import flash_attention as j_flash
from mnn_tpu_torch.kernels import flash_attention

B = 2
# (name, H, Hkv, Tq, S, kv_len, q_offset, D, window, sink)
CASES = [
    ("g7-t37-kv-mid-tile", 7, 1, 37, 160, 101, 64, 64, 0, 0),
    ("d32-g1-t50", 8, 8, 50, 128, 128, 78, 32, 0, 0),
    ("qwen2-t128-kv600", 14, 2, 128, 1024, 600, 512, 64, 0, 0),
    ("moe-d128-t128-kv600", 16, 16, 128, 1024, 600, 512, 128, 0, 0),
    ("g8-window-sink", 8, 1, 90, 512, 300, 210, 64, 100, 70),
    ("d128-window-sink", 4, 4, 70, 256, 250, 180, 128, 64, 10),
    ("t1", 2, 2, 1, 64, 30, 29, 64, 0, 0),
    ("t200-g2", 4, 2, 200, 512, 450, 250, 64, 0, 0),
]


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> torch tensor; bf16 crosses through its bits."""
    a = np.array(np.asarray(a))                    # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def rel(got: torch.Tensor, want: np.ndarray) -> float:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.fixture(scope="module")
def cases():
    """Inputs, and every JAX result of this module computed once."""
    rng = np.random.default_rng(7)
    out = {}
    for name, h, hkv, t, s, kv_len, q_off, d, window, sink in CASES:
        q, k, v = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                   for shape in ((B, h, t, d), (B, hkv, s, d), (B, hkv, s, d)))
        want = j_flash(q, k, v, kv_len=jnp.int32(kv_len), q_offset=jnp.int32(q_off),
                       window=window, sink=sink, block_q=64, block_kv=64, interpret=True)
        out[name] = dict(q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
                         want=np.asarray(want))
    return out


@pytest.mark.parametrize("name,h,hkv,t,s,kv_len,q_off,d,window,sink", CASES)
def test_flash_prefill_matches_jax(cases, name, h, hkv, t, s, kv_len, q_off, d, window,
                                   sink):
    c = cases[name]
    q, k, v = (to_torch(c[n]) for n in "qkv")
    got = flash_attention.flash_attention(
        q, k, v, kv_len=torch.tensor(kv_len, dtype=torch.int32),
        q_offset=torch.tensor(q_off, dtype=torch.int32), window=window, sink=sink)
    assert got.shape == (B, h, t, d) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert rel(got, c["want"]) <= 2e-2
