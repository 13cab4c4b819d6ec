"""DeVIS clip model, eval path (port of `devis_tpu/models/devis_model.py`).

Clip forward on T frames, then top-k trajectory selection and masks for a
static trajectory set: all Nq trajectories when Nq <= num_out, else the
top-num_out set with duplicates. The training branch and the matcher belong
to the training slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .detr import DeformableDETR
from .segmentation import (MaskHeadConv, MultiScaleMHAttentionMap, RES_TO_IDX,
                           mask_head_feat_dims, select_mask_head_features)


class DeVIS(nn.Module):
    """Batch axis = T frames; queries = T * Nq per-frame queries."""

    def __init__(self, detr: DeformableDETR, num_frames: int = 6,
                 mask_head_used_features: Sequence = (
                     ("/32", "encoded"), ("/16", "encoded"), ("/8", "encoded"),
                     ("/4", "backbone")),
                 att_maps_used_res: Sequence[str] = ("/32", "/16", "/8"),
                 num_out: int = 20, dtype=torch.float32):
        super().__init__()
        self.def_detr = detr
        self.num_frames = num_frames
        self.mask_head_used_features = tuple(map(tuple, mask_head_used_features))
        self.att_maps_used_res = tuple(att_maps_used_res)
        self.num_out = num_out
        hidden = detr.hidden_dim
        nheads = 8
        self.bbox_attention = MultiScaleMHAttentionMap(
            hidden, nheads, len(self.att_maps_used_res), dtype=dtype)
        fpn_dims = mask_head_feat_dims(self.mask_head_used_features,
                                       detr.backbone_num_channels, hidden)
        self.mask_head = MaskHeadConv(hidden, fpn_dims, nheads,
                                      len(self.att_maps_used_res), dtype=dtype)

    def _select_features(self, inter):
        memories, masks = inter["memories"], inter["masks"]
        if len(memories) != 1:
            mem_att = [memories[RES_TO_IDX[r]] for r in self.att_maps_used_res]
            mask_att = [masks[RES_TO_IDX[r]] for r in self.att_maps_used_res]
        else:
            mem_att, mask_att = [memories[0]], [masks[0]]
        feats = select_mask_head_features(
            inter["backbone_feats"], inter["srcs"],
            [m.permute(0, 3, 1, 2) for m in memories],
            self.mask_head_used_features)
        return mem_att, mask_att, feats

    def _masks_for_trajectories(self, traj_embeddings, mem_att, mask_att, feats):
        """traj_embeddings (T, N, C) → (N, T, h, w) mask logits."""
        T, N, _ = traj_embeddings.shape
        bbox_masks = self.bbox_attention(traj_embeddings, mem_att, mask_att)
        bbox_masks = [b.transpose(0, 1).reshape((N * T,) + b.shape[2:])
                      for b in bbox_masks]
        m = self.mask_head(feats, bbox_masks, expand=N)   # (N*T, 1, h, w)
        return m[:, 0].reshape(N, T, m.shape[2], m.shape[3])

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor,
                clip_length: Optional[int] = None):
        """images (T, H, W, 3); pad_mask (T, H, W); clip_length: number of
        real frames. Returns (out, results) like the JAX module's eval path."""
        T = self.num_frames
        out, inter = self.def_detr(images, pad_mask)
        mem_att, mask_att, feats = self._select_features(inter)
        hs = inter["hs"]                                  # (n_layers, 1, T*Nq, C)
        Nq = hs.shape[2] // T

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
