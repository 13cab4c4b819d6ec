"""Hungarian matching at training time (port of
`devis_tpu/models/matcher.py`).

Targets are padded to a fixed capacity with validity masks: image targets are
labels (B, N), boxes (B, N, 4), valid (B, N); clip targets are labels (N,),
boxes (N, T, 4), valid (N, T), per trajectory. The match comes back
target-aligned: ``src_idx[b, n]`` (``traj_idx[n]``) is the query (trajectory)
matched to target slot ``n``, arbitrary where the slot is invalid. The cost
matrix is built on the device without gradient; the assignment runs on the
host (`ops/hungarian.py`), once per image.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.hungarian import lsa
from ..util import box_ops

BIG_COST = 1e5


def run_lsa(cost: torch.Tensor, valid_cols: torch.Tensor) -> torch.Tensor:
    """cost (Q, N), valid_cols (N,) → the query matched to each target slot,
    (N,) int64. Non-finite costs and invalid target columns are neutralised
    with a constant BIG cost (their assignment is arbitrary and masked out
    downstream). Targets are the rows of the assignment: N <= Q."""
    cost = torch.nan_to_num(cost.float(), nan=BIG_COST, posinf=BIG_COST,
                            neginf=-BIG_COST)
    cost = torch.where(valid_cols[None, :], cost, cost.new_tensor(BIG_COST))
    return lsa(cost.t())


def focal_class_cost(out_prob: torch.Tensor, alpha: float = 0.25,
                     gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positive and negative focal classification costs."""
    neg = (1 - alpha) * (out_prob ** gamma) * (-torch.log(1 - out_prob + 1e-8))
    pos = alpha * ((1 - out_prob) ** gamma) * (-torch.log(out_prob + 1e-8))
    return pos, neg


@torch.no_grad()
def hungarian_match_image(pred_logits, pred_boxes, tgt_labels, tgt_boxes,
                          tgt_valid, cost_class: float = 2.0,
                          cost_bbox: float = 5.0, cost_giou: float = 2.0,
                          focal_loss: bool = True,
                          focal_alpha: float = 0.25) -> torch.Tensor:
    """Image-level matcher. pred_logits (B, Q, K), pred_boxes (B, Q, 4),
    tgt_labels (B, N), tgt_boxes (B, N, 4), tgt_valid (B, N). Costs in f32.
    Returns src_idx (B, N): the query matched to each target slot."""
    B, Q, K = pred_logits.shape
    logits = pred_logits.float()
    boxes = pred_boxes.float()
    tgt = tgt_boxes.float()
    at_label = tgt_labels.long().clamp(0, K - 1)[:, None, :].expand(B, Q, -1)
    if focal_loss:
        pos, neg = focal_class_cost(torch.sigmoid(logits), focal_alpha)
        cls = torch.gather(pos, 2, at_label) - torch.gather(neg, 2, at_label)
    else:
        cls = -torch.gather(torch.softmax(logits, dim=-1), 2, at_label)
    l1 = (boxes[:, :, None, :] - tgt[:, None, :, :]).abs().sum(-1)
    giou = -box_ops.multi_giou(box_ops.box_cxcywh_to_xyxy(boxes)[:, :, None, :],
                               box_ops.box_cxcywh_to_xyxy(tgt)[:, None, :, :])
    cost = cost_bbox * l1 + cost_class * cls + cost_giou * giou
    return torch.stack([run_lsa(cost[b], tgt_valid[b]) for b in range(B)])


@torch.no_grad()
def hungarian_match_clip(pred_logits, pred_boxes, tgt_labels, tgt_boxes,
                         tgt_valid, num_frames: int, cost_class: float = 2.0,
                         cost_bbox: float = 5.0, cost_giou: float = 2.0,
                         focal_alpha: float = 0.25,
                         use_l1_distance_sum: bool = False) -> torch.Tensor:
    """Clip-level trajectory matcher.

    pred_logits/pred_boxes: (1, T*Nq, .) frame-major (frame t's queries at
    t*Nq..(t+1)*Nq); tgt_labels (N,), tgt_boxes (N, T, 4), tgt_valid (N, T).
    Costs are averaged over frames per trajectory, in f32. Returns traj_idx
    (N,): the query trajectory matched to each target slot."""
    T = num_frames
    _, TQ, K = pred_logits.shape
    Nq = TQ // T
    logits = pred_logits[0].float().reshape(T, Nq, K)
    boxes = pred_boxes[0].float().reshape(T, Nq, 4)
    safe_labels = tgt_labels.long().clamp(0, K - 1)
    tgt_t = tgt_boxes.float().transpose(0, 1)              # (T, N, 4)

    pos, neg = focal_class_cost(torch.sigmoid(logits), focal_alpha)
    cls = (pos - neg)[:, :, safe_labels].mean(dim=0)       # (Nq, N)

    diff = (boxes[:, :, None, :] - tgt_t[:, None]).abs()   # (T, Nq, N, 4)
    l1 = diff.sum(-1).mean(0) if use_l1_distance_sum else diff.mean((0, -1))
    giou = -box_ops.multi_giou(
        box_ops.box_cxcywh_to_xyxy(boxes)[:, :, None, :],
        box_ops.box_cxcywh_to_xyxy(tgt_t)[:, None]).mean(dim=0)

    cost = cost_class * cls + cost_bbox * l1 + cost_giou * giou
    return run_lsa(cost, tgt_valid.any(dim=1))
