"""Routed mixture-of-experts MLP of a decode step: every (token, expert)
pair of a layer and the shared expert in one kernel entry.

Replaces the TPU kernel `mnn_tpu/kernels/moe_decode.py::_kernel`. CUDA
source: `csrc/moe_decode.cu`.

For n <= 8 tokens (post-norm hidden states x [n, H]) and this layer's routing
(sel, wsel [n, k], from `models/decoder.py::_route`),

    y[r] = sum_k wsel[r, k] * expert_{sel[r, k]}(x[r]) + gate[r] * shared(x[r])

with expert(x) = down(act(gate_up(x))) over W4/W8 weights. Rounding points,
as the TPU kernel's: x rounded to bf16 (the row sums are taken over the
rounded x), part * s + rowsum * m per quant block in f32, the gate/up result
rounded to bf16, split by the 64-block interleave, bf16(bf16(g * sigmoid(g))
* u), the down product in f32, pair terms added in the order 0 .. k-1, then
the shared term times its gate (1 when there is a shared expert and no
gate). Output f32 [n, H].

What bounds it on the H100, and what the design does about it: bytes. A
token reads k of E experts and the shared expert once, 35 MB a layer at
qwen1.5-moe-a2.7b's widths, and does two operations per weight.

* The expert ids never leave the device: the kernel reads `sel` and
  computes its weight pointers into the flat [L * E] stacks itself, so a
  layer costs no host round trip and no expert is copied.
* The byte stream is spread over the card: both products are cut into
  (128-column tile, K range) items, one per block, a few hundred blocks a
  launch. The two products depend on each other, so the entry makes two
  launches on the caller's stream, with the activations parked in device
  memory in between.
* The same bits from run to run: K ranges meet in device memory and the
  last block to arrive (a counter per tile) adds them in a fixed order; no
  floating-point atomics.
"""

from __future__ import annotations

from typing import Optional

import torch

from mnn_tpu_torch.kernels.build import I, P, kernel
from mnn_tpu_torch.kernels.common import cdiv, check, use_kernel
from mnn_tpu_torch.kernels.dequant_matmul import deq_dot_plain
from mnn_tpu_torch.kernels.moe_prefill import _split_act
from mnn_tpu_torch.quant.quantize import QuantizedLinear

# int mnn_moe_decode(x, sel, wsel, gate, gu_p, gu_s, gu_b, dn_p, dn_s, dn_b,
#                    sgu_p, sgu_s, sgu_b, sdn_p, sdn_s, sdn_b, y,
#                    act_r, act_s, part_a, part_b, cnt_a, cnt_b,
#                    n, k, E, layer, H, mi, si, bits, bs_h, bs_mi, bs_sh, bs_sd,
#                    split_gu, split_dn, split_sdn, stream)
KERNEL = kernel("mnn_moe_decode", [P] * 23 + [I] * 15)

MAX_TOKENS = 8
TILE = 128          # columns of a kernel item
CHUNKS_PER_ITEM = 24   # 32-value K chunks a block takes: three per warp

_scratch: dict = {}


def supports(c, layers, n_tokens: int) -> bool:
    """Whether the fused kernel takes this config, these stacks and this
    many tokens: the JAX package's contract (W4/W8 and the same everywhere,
    bf16 rows, no output bias, quant blocks dividing K, the 64-block gate/up
    layout, at most 8 tokens) and the kernel's own limit, quant blocks that
    32-value K chunks tile."""
    if not c.is_moe or layers.wgu_e is None or layers.wdown_e is None:
        return False
    if n_tokens > MAX_TOKENS:
        return False
    ql = layers.wgu_e
    if ql.bits not in (4, 8) or ql.act_bits != 16 or ql.out_bias is not None:
        return False
    if layers.wdown_e.bits != ql.bits:
        return False
    if layers.wdown_e.act_bits != 16 or layers.wdown_e.out_bias is not None:
        return False
    h, mi = c.hidden_size, c.moe_intermediate_size
    blocks = [ql.block_size, layers.wdown_e.block_size]
    if h % ql.block_size or mi % layers.wdown_e.block_size:
        return False
    if mi % 64 or h % 128:
        return False
    si = c.shared_expert_intermediate_size
    if si:
        sq, sd = layers.wgu_shared, layers.wdown_shared
        if sq is None or sd is None or sq.bits != ql.bits or sd.bits != ql.bits:
            return False
        if sq.out_bias is not None or sd.out_bias is not None:
            return False
        if h % sq.block_size or si % sd.block_size or si % 64:
            return False
        blocks += [sq.block_size, sd.block_size]
    return all(bs % 32 == 0 for bs in blocks)


def _expert_dot(x: torch.Tensor, ql: QuantizedLinear, layer_index: int,
                ids: Optional[torch.Tensor]) -> torch.Tensor:
    """x [J, M, K] @ dequant of experts `ids` [J] of one layer (None: the
    layer's one shared matrix, J = 1) -> f32 [J, M, N], in the kernel's
    algebra: x rounded to bf16, part * s + rowsum * m per quant block. The
    experts are gathered by a device index: nothing crosses to the host."""
    pick = lambda t: t[layer_index][None] if ids is None else t[layer_index][ids]
    return deq_dot_plain(x, pick(ql.packed), pick(ql.scale), pick(ql.bias),
                         ql.bits, ql.block_size, True)


def moe_decode_mlp_plain(x: torch.Tensor, layers, sel: torch.Tensor,
                         wsel: torch.Tensor, layer_index: int,
                         gate: Optional[torch.Tensor], *, config) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same algebra, rounding points
    and order of the final sum."""
    c = config
    n, h = x.shape
    k = c.num_experts_per_tok
    xf = x.float()
    ids = sel.reshape(-1).long()
    rows = xf.repeat_interleave(k, dim=0)[:, None, :]            # [n*k, 1, H]
    act = _split_act(_expert_dot(rows, layers.wgu_e, layer_index, ids))
    term = _expert_dot(act, layers.wdown_e, layer_index, ids)
    term = term.reshape(n, k, h) * wsel.float()[:, :, None]
    y = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for kk in range(k):
        y = y + term[:, kk]
    if c.shared_expert_intermediate_size:
        act = _split_act(_expert_dot(xf[None], layers.wgu_shared, layer_index, None))
        sh = _expert_dot(act, layers.wdown_shared, layer_index, None)[0]
        y = y + (sh if gate is None else sh * gate.float()[:, None])
    return y


def _scratch_for(device, n_float: int, n_int: int):
    """Scratch that lives across calls: the counters must start at zero and
    every launch leaves them there."""
    key = (device, n_float, n_int)
    if key not in _scratch:
        _scratch[key] = (torch.empty((n_float,), dtype=torch.float32, device=device),
                         torch.zeros((n_int,), dtype=torch.int32, device=device))
    return _scratch[key]


def moe_decode_mlp(x: torch.Tensor, layers, sel: torch.Tensor,
                   wsel: torch.Tensor, layer_index: int,
                   gate: Optional[torch.Tensor], *, config) -> torch.Tensor:
    """y [n, H] f32 = sum_k wsel * expert_sel(x) + gate * shared(x).

    x [n, H] post-norm hidden states (n <= 8); layers: LayerParams whose
    expert stacks carry [L, E, ...]; sel [n, k] expert ids and wsel [n, k]
    f32 weights of layer `layer_index`; gate [n] f32 or None. The stacks are
    read in place, experts addressed as layer_index * E + sel."""
    c = config
    n, h = x.shape
    if not supports(c, layers, n):
        raise ValueError("moe_decode_mlp: unsupported config; ask supports() first")
    gu, dn = layers.wgu_e, layers.wdown_e
    if not use_kernel(x, sel, wsel, gate, gu.packed, dn.packed):
        return moe_decode_mlp_plain(x, layers, sel, wsel, layer_index, gate,
                                    config=c)
    k, e, mi = c.num_experts_per_tok, c.num_experts, c.moe_intermediate_size
    si = c.shared_expert_intermediate_size
    nl = gu.packed.shape[0]
    if not 0 <= layer_index < nl:
        raise ValueError(f"layer_index {layer_index} outside [0, {nl})")
    for ql, kd, nd in ((gu, h, 2 * mi), (dn, mi, h)):
        check(ql.packed, "packed", torch.int8, 4)
        check(ql.scale, "scale", torch.bfloat16, 4)
        check(ql.bias, "bias", torch.bfloat16, 4)
        if ql.packed.shape != (nl, e, kd * ql.bits // 8, nd) \
                or ql.scale.shape != (nl, e, kd // ql.block_size, nd) \
                or ql.bias.shape != ql.scale.shape:
            raise ValueError("expert stack shapes disagree with L, E, K, N")
    xf = x.float().contiguous()
    sel32 = sel.to(torch.int32).contiguous()
    wf = wsel.float().contiguous()
    if sel32.shape != (n, k) or wf.shape != (n, k):
        raise ValueError(f"sel/wsel: expected {(n, k)}")
    gf = None
    if gate is not None:
        if not si:
            raise ValueError("a gate without a shared expert")
        gf = gate.float().contiguous()
        check(gf, "gate", torch.float32, 1)
    nk = n * k
    split_gu = max(1, cdiv(h // 32, CHUNKS_PER_ITEM))
    split_dn = max(1, cdiv(mi // 32, CHUNKS_PER_ITEM))
    split_sdn = max(1, cdiv(si // 32, CHUNKS_PER_ITEM)) if si else 1
    tiles_r, tiles_s, tiles_h = 2 * mi // TILE, 2 * si // TILE, cdiv(h, TILE)
    sizes = [nk * mi, n * si,                                   # act_r, act_s
             (nk * tiles_r + tiles_s * n) * split_gu * TILE,    # part_a
             tiles_h * (nk * split_dn + (n * split_sdn if si else 0)) * TILE]
    counts = [nk * tiles_r + tiles_s, tiles_h]                  # cnt_a, cnt_b
    fbuf, ibuf = _scratch_for(x.device, sum(sizes), sum(counts))
    fptr = [fbuf.data_ptr() + 4 * sum(sizes[:i]) for i in range(4)]
    iptr = [ibuf.data_ptr(), ibuf.data_ptr() + 4 * counts[0]]
    shared = [None] * 6
    bs_sh = bs_sd = 0
    if si:
        sq, sd = layers.wgu_shared.layer(layer_index), layers.wdown_shared.layer(layer_index)
        for ql, kd, nd in ((sq, h, 2 * si), (sd, si, h)):
            check(ql.packed, "shared packed", torch.int8, 2)
            check(ql.scale, "shared scale", torch.bfloat16, 2)
            check(ql.bias, "shared bias", torch.bfloat16, 2)
            if ql.packed.shape != (kd * ql.bits // 8, nd) \
                    or ql.scale.shape != (kd // ql.block_size, nd) \
                    or ql.bias.shape != ql.scale.shape:
                raise ValueError("shared expert shapes disagree with K, N")
        shared = [t.data_ptr() for t in (sq.packed, sq.scale, sq.bias,
                                         sd.packed, sd.scale, sd.bias)]
        bs_sh, bs_sd = sq.block_size, sd.block_size
    y = torch.empty((n, h), dtype=torch.float32, device=x.device)
    KERNEL(xf.data_ptr(), sel32.data_ptr(), wf.data_ptr(),
           None if gf is None else gf.data_ptr(),
           gu.packed.data_ptr(), gu.scale.data_ptr(), gu.bias.data_ptr(),
           dn.packed.data_ptr(), dn.scale.data_ptr(), dn.bias.data_ptr(),
           *shared, y.data_ptr(), *fptr, *iptr,
           n, k, e, layer_index, h, mi, si, gu.bits, gu.block_size,
           dn.block_size, bs_sh, bs_sd, split_gu, split_dn, split_sdn)
    return y
