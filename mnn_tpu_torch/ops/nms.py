"""Non-maximum suppression on tensors, with no host read inside the loop.

Counterpart of the JAX package's `ops/nms.py`: greedy suppression in score
order, `max_outputs` slots, -1 in the slots past the kept count. JAX walks
the boxes with a `fori_loop` of n steps. Here the kept set is found as the
fixed point of one vectorized step over the score order,

    keep = alive & ~any_j<i (keep[j] & iou[j, i] > threshold),

which is the greedy answer: box i depends only on boxes before it, so after
t steps the first t boxes are settled, and the only fixed point is the
greedy set. Each step is one product over the [n, n] suppression matrix; the
loop reads one flag to the host every `CHECK_EVERY` steps to stop, never a
box. The chains of suppression in real detections are short, so it stops
after a few steps where the JAX loop takes n.

The IoU matrix is computed op by op as in the JAX package (no fused
multiply-add), so the card and the CPU compare the same f32 values with the
threshold.
"""

from __future__ import annotations

import torch

CHECK_EVERY = 4


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, 4], b [M, 4] in (x1, y1, x2, y2) -> IoU [N, M]."""
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) * torch.clamp(a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(b[:, 3] - b[:, 1], min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        score_threshold: float = 0.0, max_outputs: int = 100):
    """Greedy NMS. Returns (indices [max_outputs] int32, valid [max_outputs]
    bool) on the boxes' device. Indices are ordered by score; slots past the
    kept count hold -1."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes, boxes)[order][:, order]
    # later[j, i]: box j (earlier in score order) suppresses box i
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = ((iou > iou_threshold) & later).to(iou.dtype)
    alive = scores[order] > score_threshold
    keep = alive
    while True:
        for _ in range(CHECK_EVERY):
            prev = keep
            keep = alive & ~(keep.to(iou.dtype) @ suppress).bool()
        if torch.equal(keep, prev):        # one host read every CHECK_EVERY steps
            break
    pos = torch.cumsum(keep, 0) - 1
    slot = torch.where(keep & (pos < max_outputs), pos, torch.full_like(pos, max_outputs))
    out = torch.full((max_outputs + 1,), -1, dtype=torch.int32, device=boxes.device)
    out.scatter_(0, slot, order.to(torch.int32))
    out = out[:max_outputs]
    return out, out >= 0
