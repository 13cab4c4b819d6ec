"""Box utilities (port of `devis_tpu/util/box_ops.py`): cxcywh/xyxy
conversion, pairwise, elementwise and broadcasted IoU / generalized IoU on
xyxy boxes, boxes around masks, and greedy non-maximum suppression."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def multi_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """IoU and union of broadcastable (..., 4) xyxy boxes → (...)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union.clamp(min=1e-9), union


def multi_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of broadcastable (..., 4) xyxy boxes → (...). With
    equal shapes it is the elementwise GIoU."""
    iou, union = multi_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU between (N, 4) and (M, 4) xyxy boxes → (N, M) iou, union."""
    return multi_iou(boxes1[:, None], boxes2[None, :])


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU (https://giou.stanford.edu/) between (N, 4) and (M, 4)
    xyxy boxes → (N, M)."""
    return multi_giou(boxes1[:, None], boxes2[None, :])


def elementwise_generalized_box_iou(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU between equal-shaped (..., 4) xyxy boxes → (...)."""
    return multi_giou(boxes1, boxes2)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """xyxy boxes around binary masks (N, H, W) → (N, 4) f32, the far edges
    exclusive; an empty mask gives a zero box (reference box_ops.py:101-124)."""
    n, h, w = masks.shape
    m = masks > 0
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    big = 1e8
    x_min = torch.where(m, xs, big).amin(dim=(1, 2))
    x_max = torch.where(m, xs, -big).amax(dim=(1, 2))
    y_min = torch.where(m, ys, big).amin(dim=(1, 2))
    y_max = torch.where(m, ys, -big).amax(dim=(1, 2))
    boxes = torch.stack([x_min, y_min, x_max + 1, y_max + 1], dim=-1)
    return torch.where(m.flatten(1).any(1)[:, None], boxes, torch.zeros_like(boxes))


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy non-maximum suppression (reference box_ops.py:127): boxes
    (N, 4) xyxy, scores (N,) → a bool keep mask in the input's order. In
    descending score order (ties by the stable sort's order), a kept box
    suppresses every later box it overlaps by more than `iou_threshold`."""
    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True).indices
    iou = box_iou(boxes[order], boxes[order])[0]
    later = torch.arange(n, device=boxes.device)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep &= ~((iou[i] > iou_threshold) & (later > i) & keep[i])
    out = torch.empty_like(keep)
    out[order] = keep
    return out
