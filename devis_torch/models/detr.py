"""Deformable DETR with box refinement (port of `devis_tpu/models/detr.py`):
backbone, per-level input projections plus the extra stride-2 /64 level, the
deformable transformer and the per-layer class and box heads, for the T frames
of one clip (DeVIS) or a batch of B images (`transformer_kwargs` carries the
transformer's ``variant``), and the image model's top-k postprocessing."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import downsample_mask
from ..util import box_ops
from ..util.misc import inverse_sigmoid
from .layers import Conv2d, GroupNorm, Linear
from .transformer import DeformableTransformer


class MLP(nn.Module):
    """ReLU MLP; parameters `layers.{i}.weight/bias`."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers,
                 dtype=torch.float32):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b, dtype=dtype)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def class_bias_init(num_classes: int) -> np.ndarray:
    """Focal-loss prior bias."""
    return np.full((num_classes,), -math.log((1 - 0.01) / 0.01), np.float32)


def bbox_bias_init() -> np.ndarray:
    """wh logits start at -2."""
    return np.array([0.0, 0.0, -2.0, -2.0], dtype=np.float32)


class Backbone(nn.Module):
    """Holds the trunk as `body`, as the reference's backbone wrapper does."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body

    def forward(self, x):
        return self.body(x)


class DeformableDETR(nn.Module):
    def __init__(self, body: nn.Module, position_encoding: nn.Module,
                 num_classes: int, num_queries: int = 300,
                 num_feature_levels: int = 4, hidden_dim: int = 256,
                 aux_loss: bool = True, with_gradient: bool = False,
                 backbone_num_channels: Sequence[int] = (256, 512, 1024, 2048),
                 transformer_kwargs: dict = None, dtype=torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_feature_levels = num_feature_levels
        self.aux_loss = aux_loss
        self.with_gradient = with_gradient
        self.backbone_num_channels = tuple(backbone_num_channels)
        self.backbone = nn.ModuleList([Backbone(body), position_encoding])
        self.transformer = DeformableTransformer(
            d_model=hidden_dim, num_feature_levels=num_feature_levels,
            with_gradient=with_gradient, dtype=dtype,
            **(transformer_kwargs or {}))
        num_pred = self.transformer.num_decoder_layers
        if num_feature_levels > 1:
            in_ch = list(self.backbone_num_channels[1:])
            projs = [(c, 1, 1) for c in in_ch]
            projs += [(in_ch[-1] if i == 0 else hidden_dim, 3, 2)
                      for i in range(num_feature_levels - len(in_ch))]
        else:
            projs = [(self.backbone_num_channels[3], 1, 1)]
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hidden_dim, k, stride=s, padding=(k - 1) // 2,
                                 dtype=dtype),
                          GroupNorm(32, hidden_dim, dtype=dtype))
            for c, k, s in projs)
        self.query_embed = nn.Embedding(num_queries, hidden_dim * 2)
        self.class_embed = nn.ModuleList(
            Linear(hidden_dim, num_classes + 1, dtype=dtype)
            for _ in range(num_pred))
        self.bbox_embed = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 4, 3, dtype=dtype) for _ in range(num_pred))

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor):
        """images (T, H, W, 3) NHWC, the frames of a clip or a batch of
        images; pad_mask (T, H, W) bool, True on padding. Returns
        (out, intermediates) like the JAX module."""
        features = self.backbone[0](images.permute(0, 3, 1, 2))
        feature_masks = [downsample_mask(pad_mask, f.shape[-2:]) for f in features]
        pos = [self.backbone[1](m).to(features[0].dtype) for m in feature_masks]
        if self.num_feature_levels == 1:
            use = slice(-1, None)
        else:
            use = slice(1, None)
        use_feats, masks, pos_embeds = features[use], feature_masks[use], pos[use]
        srcs = [self.input_proj[l](f) for l, f in enumerate(use_feats)]
        masks, pos_embeds = list(masks), list(pos_embeds)
        for l in range(len(use_feats), self.num_feature_levels):
            base = use_feats[-1] if l == len(use_feats) else srcs[-1]
            src = self.input_proj[l](base)
            mask = downsample_mask(pad_mask, src.shape[-2:])
            srcs.append(src)
            masks.append(mask)
            pos_embeds.append(self.backbone[1](mask).to(src.dtype))

        t = self.transformer(srcs, masks, pos_embeds, self.query_embed.weight,
                             self.bbox_embed)
        hs = t["hs"]
        classes, coords = [], []
        for lvl in range(hs.shape[0]):
            classes.append(self.class_embed[lvl](hs[lvl]))
            if self.with_gradient:
                coords.append(t["inter_references"][lvl])
                continue
            ref = t["init_reference"] if lvl == 0 else t["inter_references"][lvl - 1]
            ref = inverse_sigmoid(ref)
            tmp = self.bbox_embed[lvl](hs[lvl])
            if ref.shape[-1] == 4:
                tmp = tmp + ref
            else:
                tmp = torch.cat([tmp[..., :2] + ref, tmp[..., 2:]], dim=-1)
            coords.append(torch.sigmoid(tmp))
        out = {"pred_logits": classes[-1], "pred_boxes": coords[-1]}
        if self.aux_loss:
            out["aux_outputs"] = [{"pred_logits": c, "pred_boxes": b}
                                  for c, b in zip(classes[:-1], coords[:-1])]
        intermediates = dict(backbone_feats=features, feature_masks=feature_masks,
                             memories=t["memories"], hs=hs, srcs=srcs, masks=masks,
                             init_reference=t["init_reference"],
                             inter_references=t["inter_references"],
                             valid_ratios=t["valid_ratios"],
                             spatial_shapes=t["spatial_shapes"])
        return out, intermediates


def top_k_process(output_prob: torch.Tensor, boxes: torch.Tensor, num_out: int):
    """Top-k over the flattened query x class axis. output_prob (B, Q, K);
    boxes (B, Q, 4) → scores, labels, boxes (B, k, 4), query_idx."""
    B, Q, K = output_prob.shape
    scores, top_idx = torch.topk(output_prob.reshape(B, Q * K), min(num_out, Q * K),
                                 dim=1)
    query_idx = torch.div(top_idx, K, rounding_mode="floor")
    labels = top_idx % K
    boxes = torch.gather(boxes, 1, query_idx[..., None].expand(-1, -1, 4))
    return scores, labels, boxes, query_idx


def process_boxes(boxes: torch.Tensor, target_sizes: torch.Tensor) -> torch.Tensor:
    """cxcywh in [0, 1] → absolute xyxy; target_sizes (B, 2) as (h, w)."""
    boxes = box_ops.box_cxcywh_to_xyxy(boxes)
    img_h, img_w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return boxes * scale[:, None, :]


def postprocess_detections(outputs: dict, target_sizes: torch.Tensor,
                           num_out: int, focal_loss: bool = True) -> dict:
    """The detection postprocessor: top-k scores, labels, absolute boxes."""
    logits = outputs["pred_logits"].float()
    prob = torch.sigmoid(logits) if focal_loss \
        else torch.softmax(logits, dim=-1)[..., :-1]
    scores, labels, boxes, query_idx = top_k_process(
        prob, outputs["pred_boxes"].float(), num_out)
    return {"scores": scores, "labels": labels,
            "boxes": process_boxes(boxes, target_sizes),
            "query_top_k_indexes": query_idx}
