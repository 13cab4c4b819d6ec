"""Set-prediction losses of the image and clip models (port of
`devis_tpu/models/criterion.py`): focal classification, L1 + GIoU boxes,
focal + dice masks, in the padded, masked formulation: targets are padded to
capacity with validity masks and every loss is a masked reduction.

  * classification: sigmoid focal over the class logits; unmatched queries
    have all-zero targets; scaled by the number of queries.
  * clips: label loss on valid (trajectory, frame) pairs only; box and mask
    losses on ALL frames of matched trajectories.
  * images: every loss on the valid target slots of each image; the
    normaliser is the batch's count of valid targets, at least 1.
  * every loss is computed in f32, whatever the model's compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.interpolate import resize_bilinear_hw
from ..util import box_ops
from . import matcher as matcher_lib

AUX_LOSS_WEIGHTING_COEF = {5: 1 / 2, 4: 5 / 30, 3: 4 / 30, 2: 3 / 30,
                           1: 2 / 30, 0: 1 / 30}


def sigmoid_focal_loss(inputs, targets, num_boxes, alpha: float = 0.25,
                       gamma: float = 2.0, valid=None):
    """Focal loss with the `mean(1).sum() / num_boxes` reduction: the mean
    runs over axis 1 only. inputs/targets: (N, ...)."""
    prob = torch.sigmoid(inputs)
    ce = F.binary_cross_entropy_with_logits(inputs, targets, reduction="none")
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    loss = loss.mean(dim=1).reshape(loss.shape[0], -1).sum(dim=1)
    if valid is not None:
        loss = loss * valid
    return loss.sum() / num_boxes


def dice_loss(inputs, targets, num_boxes, valid=None):
    inputs = torch.sigmoid(inputs).reshape(inputs.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1)
    numerator = 2 * (inputs * targets).sum(dim=1)
    denominator = inputs.sum(dim=1) + targets.sum(dim=1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    if valid is not None:
        loss = loss * valid
    return loss.sum() / num_boxes


def reduce_num_boxes(counts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The normaliser shared by every clip of a batch: the mean target count
    over the clips, at least 1 (the JAX package's all-reduce over its clip
    axis)."""
    return torch.stack([c.float() for c in counts]).mean().clamp(min=1.0)


def image_losses(outputs: Dict, targets: Dict, src_idx: torch.Tensor,
                 num_boxes, focal_alpha: float = 0.25,
                 compute_masks: bool = False) -> Dict[str, torch.Tensor]:
    """Losses of one output level of the image model.

    targets: labels (B, N), boxes (B, N, 4), valid (B, N)
             [+ masks (B, N, H, W)].
    src_idx: (B, N) matched query per target slot.
    outputs['pred_masks'] when compute_masks: (B, N, h, w), slot-aligned."""
    logits = outputs["pred_logits"].float()              # (B, Q, K)
    B, Q, K = logits.shape
    labels = targets["labels"].long()
    valid = targets["valid"]
    N = labels.shape[1]

    # classification: matched queries of valid slots are foreground at the
    # slot's label; every other query has an all-zero target
    onehot = logits.new_zeros((B, Q, K))
    b_idx = torch.arange(B, device=logits.device)[:, None].expand(B, N)
    onehot[b_idx[valid], src_idx[valid], labels[valid]] = 1.0
    loss_ce = sigmoid_focal_loss(logits, onehot, num_boxes, alpha=focal_alpha) * Q

    gather_idx = src_idx[..., None]
    matched = torch.gather(logits, 1, gather_idx.expand(B, N, K))
    correct = (matched.argmax(-1) == labels) & valid
    class_error = 100.0 * (1.0 - correct.sum() / valid.sum().clamp(min=1))

    src_boxes = torch.gather(outputs["pred_boxes"].float(), 1,
                             gather_idx.expand(B, N, 4))
    tgt_boxes = targets["boxes"].float()
    vmask = valid.float()
    loss_bbox = ((src_boxes - tgt_boxes).abs().sum(-1) * vmask).sum() / num_boxes
    giou = box_ops.multi_giou(box_ops.box_cxcywh_to_xyxy(src_boxes),
                              box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1 - giou) * vmask).sum() / num_boxes

    losses = {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
              "loss_giou": loss_giou, "class_error": class_error}

    if compute_masks and "pred_masks" in outputs:
        tgt_masks = targets["masks"].float()
        up = resize_bilinear_hw(outputs["pred_masks"].float(), tgt_masks.shape[-2:])
        up = up.reshape(B * N, -1)
        tm = tgt_masks.reshape(B * N, -1)
        vm = vmask.reshape(B * N)
        losses["loss_mask"] = sigmoid_focal_loss(up, tm, num_boxes, valid=vm)
        losses["loss_dice"] = dice_loss(up, tm, num_boxes, valid=vm)
    return losses


def image_criterion(outputs: Dict, targets: Dict, matcher_cfg: Dict,
                    focal_alpha: float = 0.25,
                    mask_on: bool = False) -> Dict[str, torch.Tensor]:
    """The criterion over the final and auxiliary outputs of a batch of
    images. A level that carries 'indices' (set by the model when it is given
    targets) is not matched again."""
    num_boxes = targets["valid"].sum().float().clamp(min=1.0)

    def level(out, masks):
        idx = out.get("indices")
        if idx is None:
            idx = matcher_lib.hungarian_match_image(
                out["pred_logits"], out["pred_boxes"], targets["labels"],
                targets["boxes"], targets["valid"], **matcher_cfg)
        return image_losses(out, targets, idx, num_boxes, focal_alpha,
                            compute_masks=masks)

    losses = level(outputs, mask_on)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        l = level(aux, "pred_masks" in aux)
        l.pop("class_error", None)
        losses.update({f"{k}_{i}": v for k, v in l.items()})
    return losses


def clip_losses(outputs: Dict, targets: Dict, traj_idx: torch.Tensor,
                num_boxes, num_frames: int, focal_alpha: float = 0.25,
                compute_masks: bool = False) -> Dict[str, torch.Tensor]:
    """Losses of one output level of the clip model.

    targets: labels (N,), boxes (N, T, 4), valid (N, T), exists (N,)
             [+ masks (N, T, H, W)].
    traj_idx: (N,) matched query trajectory per target slot.
    outputs['pred_masks'] when compute_masks: (N, T, h, w), slot-aligned."""
    T = num_frames
    logits = outputs["pred_logits"].float()              # (1, T*Nq, K)
    _, TQ, K = logits.shape
    Nq = TQ // T
    labels = targets["labels"].long()
    N = labels.shape[0]
    exists = targets["exists"]
    live = targets["valid"] & exists[:, None]            # (N, T)

    # classification: valid (trajectory, frame) pairs are foreground; the
    # position of trajectory j at frame t is t*Nq + traj_idx[j]
    frame_pos = torch.arange(T, device=logits.device)[None, :] * Nq + traj_idx[:, None]
    onehot = logits.new_zeros((TQ, K))
    onehot[frame_pos[live], labels[:, None].expand(N, T)[live]] = 1.0
    loss_ce = sigmoid_focal_loss(logits, onehot[None], num_boxes,
                                 alpha=focal_alpha) * TQ

    matched = logits[0][frame_pos.clamp(0, TQ - 1)]      # (N, T, K)
    correct = (matched.argmax(-1) == labels[:, None]) & live
    class_error = 100.0 * (1.0 - correct.sum() / live.sum().clamp(min=1))

    # boxes: all frames of matched trajectories
    pred_boxes = outputs["pred_boxes"][0].float().reshape(T, Nq, 4)
    src_boxes = pred_boxes[:, traj_idx].transpose(0, 1)  # (N, T, 4)
    tgt_boxes = targets["boxes"].float()
    bmask = exists[:, None].float().expand(N, T)
    loss_bbox = ((src_boxes - tgt_boxes).abs().sum(-1) * bmask).sum() / num_boxes
    giou = box_ops.multi_giou(box_ops.box_cxcywh_to_xyxy(src_boxes),
                              box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1 - giou) * bmask).sum() / num_boxes

    losses = {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
              "loss_giou": loss_giou, "class_error": class_error}

    if compute_masks and "pred_masks" in outputs:
        tgt_masks = targets["masks"].float()
        up = resize_bilinear_hw(outputs["pred_masks"].float(), tgt_masks.shape[-2:])
        up = up.reshape(N * T, -1)
        tm = tgt_masks.reshape(N * T, -1)
        vm = bmask.reshape(N * T)
        losses["loss_mask"] = sigmoid_focal_loss(up, tm, num_boxes, valid=vm)
        losses["loss_dice"] = dice_loss(up, tm, num_boxes, valid=vm)
    return losses


def clip_criterion(outputs: Dict, targets: Dict, num_frames: int,
                   matcher_cfg: Dict, focal_alpha: float = 0.25,
                   num_boxes: Optional[torch.Tensor] = None,
                   mask_on: bool = False) -> Dict[str, torch.Tensor]:
    """The criterion over the final and auxiliary outputs of one clip.
    `num_boxes` is the batch's normaliser (`reduce_num_boxes`); alone, a
    clip counts its instances x T. A level that carries 'indices' (set by
    the model's training branch) is not matched again."""
    if num_boxes is None:
        num_boxes = reduce_num_boxes([targets["exists"].sum() * num_frames])

    def match(out):
        return matcher_lib.hungarian_match_clip(
            out["pred_logits"], out["pred_boxes"], targets["labels"],
            targets["boxes"], targets["valid"] & targets["exists"][:, None],
            num_frames, **matcher_cfg)

    def level(out, masks):
        idx = out["indices"] if "indices" in out else match(out)
        return clip_losses(out, targets, idx, num_boxes, num_frames,
                           focal_alpha, compute_masks=masks)

    losses = level(outputs, mask_on)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        l = level(aux, "pred_masks" in aux)
        l.pop("class_error", None)
        losses.update({f"{k}_{i}": v for k, v in l.items()})
    return losses


def build_weight_dict(cfg) -> Dict[str, float]:
    """Loss weights, with the auxiliary weighting ladder."""
    weight_dict = {"loss_ce": cfg.MODEL.LOSS.CLASS_COEF,
                   "loss_bbox": cfg.MODEL.LOSS.BBX_L1_COEF,
                   "loss_giou": cfg.MODEL.LOSS.BBX_GIOU_COEF}
    n_dec = cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    if cfg.MODEL.LOSS.AUX_LOSS:
        aux = {}
        if cfg.MODEL.LOSS.AUX_LOSS_WEIGHTING:
            for i in range(n_dec - 1):
                aux.update({f"{k}_{i}": v * AUX_LOSS_WEIGHTING_COEF[i]
                            for k, v in weight_dict.items()})
            top = AUX_LOSS_WEIGHTING_COEF[n_dec - 1]
            weight_dict = {k: v * top for k, v in weight_dict.items()}
        else:
            for i in range(n_dec - 1):
                aux.update({f"{k}_{i}": v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    if cfg.MODEL.MASK_ON:
        weight_dict["loss_mask"] = cfg.MODEL.LOSS.SEGM_MASK_COEF
        weight_dict["loss_dice"] = cfg.MODEL.LOSS.SEGM_DICE_COEF
        for i in cfg.MODEL.LOSS.MASK_AUX_LOSS:
            weight_dict[f"loss_mask_{i}"] = cfg.MODEL.LOSS.SEGM_MASK_COEF
            weight_dict[f"loss_dice_{i}"] = cfg.MODEL.LOSS.SEGM_DICE_COEF
    return weight_dict


def weighted_total(losses: Dict[str, torch.Tensor],
                   weight_dict: Dict[str, float]) -> torch.Tensor:
    return sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
