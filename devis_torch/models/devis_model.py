"""DeVIS clip model (port of `devis_tpu/models/devis_model.py`).

Clip forward on T frames. At eval: top-k trajectory selection and masks for a
static trajectory set, all Nq trajectories when Nq <= num_out, else the
top-num_out set with duplicates. In training (``targets`` given and
``train=True``): the final level and each level of `mask_aux_loss` are
matched to the targets on detached costs, and masks are computed for the
matched trajectories only; the criterion reads `indices` and `pred_masks`
from those levels.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from . import matcher as matcher_lib
from .detr import DeformableDETR
from .segmentation import (MaskHeadConv, MultiScaleMHAttentionMap,
                           attention_and_head_features, mask_head_feat_dims)


class DeVIS(nn.Module):
    """Batch axis = T frames; queries = T * Nq per-frame queries."""

    def __init__(self, detr: DeformableDETR, num_frames: int = 6,
                 mask_head_used_features: Sequence = (
                     ("/32", "encoded"), ("/16", "encoded"), ("/8", "encoded"),
                     ("/4", "backbone")),
                 att_maps_used_res: Sequence[str] = ("/32", "/16", "/8"),
                 mask_aux_loss: Sequence[int] = (2,),
                 matcher_cfg: Optional[dict] = None,
                 num_out: int = 20, dtype=torch.float32):
        super().__init__()
        self.def_detr = detr
        self.num_frames = num_frames
        self.mask_head_used_features = tuple(map(tuple, mask_head_used_features))
        self.att_maps_used_res = tuple(att_maps_used_res)
        self.mask_aux_loss = tuple(mask_aux_loss)
        self.matcher_cfg = dict(matcher_cfg or {})
        self.num_out = num_out
        hidden = detr.hidden_dim
        nheads = 8
        self.bbox_attention = MultiScaleMHAttentionMap(
            hidden, nheads, len(self.att_maps_used_res), dtype=dtype)
        fpn_dims = mask_head_feat_dims(self.mask_head_used_features,
                                       detr.backbone_num_channels, hidden)
        self.mask_head = MaskHeadConv(hidden, fpn_dims, nheads,
                                      len(self.att_maps_used_res), dtype=dtype)

    def _masks_for_trajectories(self, traj_embeddings, mem_att, mask_att, feats):
        """traj_embeddings (T, N, C) → (N, T, h, w) mask logits."""
        T, N, _ = traj_embeddings.shape
        bbox_masks = self.bbox_attention(traj_embeddings, mem_att, mask_att)
        bbox_masks = [b.transpose(0, 1).reshape((N * T,) + b.shape[2:])
                      for b in bbox_masks]
        m = self.mask_head(feats, bbox_masks, expand=N)   # (N*T, 1, h, w)
        return m[:, 0].reshape(N, T, m.shape[2], m.shape[3])

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor,
                clip_length: Optional[int] = None, targets: Optional[dict] = None,
                train: bool = False):
        """images (T, H, W, 3); pad_mask (T, H, W); clip_length: number of
        real frames. Returns (out, results) like the JAX module's eval path,
        or, with ``targets`` and ``train=True``, `out` alone with `indices`
        and `pred_masks` on the levels that carry a mask loss."""
        T = self.num_frames
        out, inter = self.def_detr(images, pad_mask)
        mem_att, mask_att, feats = attention_and_head_features(
            inter, self.att_maps_used_res, self.mask_head_used_features)
        hs = inter["hs"]                                  # (n_layers, 1, T*Nq, C)
        Nq = hs.shape[2] // T

        if targets is not None and train:
            live = targets["valid"] & targets["exists"][:, None]
            for lvl in (-1,) + self.mask_aux_loss:
                level_out = out if lvl == -1 else out["aux_outputs"][lvl]
                traj_idx = matcher_lib.hungarian_match_clip(
                    level_out["pred_logits"], level_out["pred_boxes"],
                    targets["labels"], targets["boxes"], live, T,
                    **self.matcher_cfg)
                level_out["indices"] = traj_idx
                emb = hs[lvl][0].reshape(T, Nq, -1)[:, traj_idx]   # (T, N, C)
                level_out["pred_masks"] = self._masks_for_trajectories(
                    emb, mem_att, mask_att, feats)
            return out

        logits = torch.sigmoid(out["pred_logits"][0].float()).reshape(T, Nq, -1)
        K = logits.shape[-1]
        clip_length = T if clip_length is None else int(clip_length)
        frame_ok = (torch.arange(T, device=logits.device) < clip_length).float()
        traj_probs = ((logits * frame_ok[:, None, None]).sum(0)
                      / max(clip_length, 1)).reshape(-1)
        num_out = min(self.num_out, traj_probs.shape[0])
        _, top_idx = torch.topk(traj_probs, num_out)
        query_idx = torch.div(top_idx, K, rounding_mode="floor")
        labels = top_idx % K
        scores = logits[:, query_idx, labels]             # (T, num_out)

        boxes = out["pred_boxes"][0].reshape(T, Nq, 4)
        top_boxes = boxes[:, query_idx]
        hs_t = hs[-1][0].reshape(T, Nq, -1)
        if Nq <= num_out:
            emb, mask_gather = hs_t, query_idx
        else:
            emb = hs_t[:, query_idx]
            mask_gather = torch.arange(num_out, device=hs_t.device)
        masks = self._masks_for_trajectories(emb, mem_att, mask_att, feats)
        results = {"scores": scores, "labels": labels, "boxes": top_boxes,
                   "center_points": top_boxes[..., :2], "masks": masks,
                   "mask_gather": mask_gather, "query_top_k_indexes": query_idx,
                   "spatial_shapes": inter["spatial_shapes"]}
        return out, results
