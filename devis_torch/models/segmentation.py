"""Mask head and the image instance-segmentation model (port of the
channel-first path of `devis_tpu/models/segmentation.py`).

  * `ModulatedDeformableConv`: a DCNv2 layer run as one K4 launch.
  * `plain_conv`: the 3x3 convolution that takes its place where the config
    turns the deformable convs off (`USE_MDC: False`); cuDNN runs it.
  * `MultiScaleMHAttentionMap`: per-level attention maps between query
    embeddings and encoder memories, softmaxed jointly over heads x space.
  * `MaskHeadConv`: the FPN-style spine, channel-first; the features are
    expanded instance-major (``"tile"``, sample n*T + t, DeVIS) or image-major
    (``"repeat"``, sample b*N + n, the image model).
  * `DeformableDETRSegm`: Deformable DETR plus the mask head on a batch of
    images: at eval the masks of the top-k (query, class) pairs, in training
    the masks of the matched queries on each level that carries a mask loss.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import modulated_deform_conv2d
from ..ops.interpolate import resize_nearest_hw
from . import matcher as matcher_lib
from .detr import DeformableDETR, top_k_process
from .layers import Conv2d, GroupNorm, Linear

# srcs/memories are ordered [/8, /16, /32, /64]; backbone features
# [/4, /8, /16, /32].
RES_TO_IDX = {"/64": 3, "/32": 2, "/16": 1, "/8": 0}
BACKBONE_RES_TO_IDX = {"/32": 3, "/16": 2, "/8": 1, "/4": 0}


def _hwio(w: torch.Tensor, dtype) -> torch.Tensor:
    """OIHW conv weight → the kernel's HWIO layout, in `dtype`."""
    return w.permute(2, 3, 1, 0).to(dtype)


class ModulatedDeformableConv(nn.Module):
    """DCNv2 layer: offset and modulator field convs plus the deformable conv,
    with the reference's parameter names (`offset_conv`, `modulator_conv`,
    `regular_conv`). Channel-first in and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 padding: int = 1, dtype=torch.float32):
        super().__init__()
        K = kernel
        self.padding = padding
        self.compute_dtype = dtype
        self.offset_conv = nn.Conv2d(in_channels, 2 * K * K, K, padding=padding)
        self.modulator_conv = nn.Conv2d(in_channels, K * K, K, padding=padding)
        self.regular_conv = nn.Conv2d(in_channels, out_channels, K,
                                      padding=padding)

    def forward(self, x):
        dt = self.compute_dtype
        return modulated_deform_conv2d(
            x, _hwio(self.offset_conv.weight, dt), self.offset_conv.bias.to(dt),
            _hwio(self.modulator_conv.weight, dt), self.modulator_conv.bias.to(dt),
            _hwio(self.regular_conv.weight, x.dtype),
            self.regular_conv.bias.to(x.dtype), self.padding)


def plain_conv(in_channels: int, out_channels: int, dtype=torch.float32) -> Conv2d:
    """The mask head's 3x3 conv without deformation (padding 1); its weight
    and bias keep the layer's own names (`lay1.weight`, as the reference's
    plain `nn.Conv2d`)."""
    return Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)


class MultiScaleMHAttentionMap(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, num_levels: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.num_levels = num_levels
        for i in range(num_levels):
            sfx = "" if i == 0 else f"_{i}"
            setattr(self, f"q_linear{sfx}", Linear(hidden_dim, hidden_dim, dtype=dtype))
            setattr(self, f"k_linear{sfx}", Linear(hidden_dim, hidden_dim, dtype=dtype))

    def forward(self, q, memories, masks=None) -> List[torch.Tensor]:
        """q (B, N, C); memories per level (B, H, W, C); masks (B, H, W) True
        on padding → per level (B, N, heads, H, W)."""
        out = []
        Dh = self.hidden_dim // self.num_heads
        for i, mem in enumerate(memories):
            sfx = "" if i == 0 else f"_{i}"
            q_l = getattr(self, f"q_linear{sfx}")(q)
            k_l = getattr(self, f"k_linear{sfx}")(mem)
            B, N, _ = q_l.shape
            H, W = mem.shape[1], mem.shape[2]
            qh = q_l.reshape(B, N, self.num_heads, Dh)
            kh = k_l.reshape(B, H, W, self.num_heads, Dh)
            logits = torch.einsum("bnhc,bxyhc->bnhxy", qh * Dh ** -0.5, kh)
            if masks is not None:
                logits = logits.masked_fill(masks[i][:, None, None], float("-inf"))
            att = torch.softmax(logits.reshape(B, N, -1).float(), dim=-1)
            out.append(att.to(logits.dtype).reshape(B, N, self.num_heads, H, W))
        return out


def mask_head_feat_dims(mask_head_used_features, backbone_num_channels,
                        hidden_dim) -> List[int]:
    """Channel count of each selected finer feature."""
    ch = {"/64": hidden_dim, "/32": backbone_num_channels[3],
          "/16": backbone_num_channels[2], "/8": backbone_num_channels[1],
          "/4": backbone_num_channels[0]}
    return [ch[res] if kind == "backbone" else hidden_dim
            for res, kind in mask_head_used_features[1:]]


def select_mask_head_features(backbone_feats, srcs, memories,
                              mask_head_used_features):
    """Feature sources of the mask head; every input is channel-first."""
    used = []
    for res, kind in mask_head_used_features:
        if kind == "backbone":
            used.append(srcs[RES_TO_IDX[res]] if res == "/64"
                        else backbone_feats[BACKBONE_RES_TO_IDX[res]])
        elif kind == "compressed_backbone":
            used.append(backbone_feats[BACKBONE_RES_TO_IDX[res]] if res == "/4"
                        else srcs[RES_TO_IDX[res]])
        elif kind == "encoded":
            if len(memories) == 1:
                used.append(memories[0])
            elif res == "/4":
                used.append(backbone_feats[BACKBONE_RES_TO_IDX[res]])
            else:
                used.append(memories[RES_TO_IDX[res]])
        else:
            raise ValueError(f"unknown mask-head feature type {kind}")
    return used


def attention_and_head_features(inter, att_maps_used_res, mask_head_used_features):
    """From a DETR's intermediates: the memories and masks the attention maps
    are taken on, and the channel-first feature maps of the mask head."""
    memories, masks = inter["memories"], inter["masks"]
    if len(memories) != 1:
        mem_att = [memories[RES_TO_IDX[r]] for r in att_maps_used_res]
        mask_att = [masks[RES_TO_IDX[r]] for r in att_maps_used_res]
    else:
        mem_att, mask_att = [memories[0]], [masks[0]]
    feats = select_mask_head_features(
        inter["backbone_feats"], inter["srcs"],
        [m.permute(0, 3, 1, 2) for m in memories], mask_head_used_features)
    return mem_att, mask_att, feats


class MaskHeadConv(nn.Module):
    """FPN-style mask head, channel-first, with DCNv2 convs or, where
    `use_deformable_conv` is off, plain 3x3 convs. `features[0]` is the
    coarsest map; attention maps join at the first `num_att_levels` scales.
    Features are expanded to (expand*B, ...): ``"tile"`` repeats the batch
    as a whole (sample n*B + b), ``"repeat"`` each image in turn (sample
    b*expand + n). Without `out_layer` the head returns its last feature
    map (the 3-d conv head of the DeVIS ablations takes it)."""

    def __init__(self, dim: int, fpn_dims: Sequence[int], nheads: int,
                 num_att_levels: int, dtype=torch.float32,
                 expand_mode: str = "tile", use_deformable_conv: bool = True,
                 out_layer: bool = True):
        super().__init__()
        if expand_mode not in ("tile", "repeat"):
            raise ValueError(f"unknown expand_mode {expand_mode!r}")
        self.expand_mode = expand_mode
        self.num_att_levels = num_att_levels
        self.compute_dtype = dtype
        conv = ModulatedDeformableConv if use_deformable_conv else plain_conv
        n_fpn = len(fpn_dims)
        out_dims = [dim // (2 ** e) for e in range(n_fpn + 3)]
        c0 = dim + nheads
        self.lay1 = conv(c0, c0, dtype=dtype)
        self.gn1 = GroupNorm(8, c0, dtype=dtype)
        self.lay2 = conv(c0, out_dims[1], dtype=dtype)
        self.gn2 = GroupNorm(8, out_dims[1], dtype=dtype)
        for lvl, fdim in enumerate(fpn_dims):
            c_in = out_dims[lvl + 1]
            self.add_module(f"adapter{lvl + 1}",
                            Conv2d(fdim, c_in, 1, dtype=dtype))
            if num_att_levels > 1 and lvl + 1 < num_att_levels:
                c_in += nheads
            self.add_module(f"lay{lvl + 3}", conv(c_in, out_dims[lvl + 2], dtype=dtype))
            self.add_module(f"gn{lvl + 3}", GroupNorm(8, out_dims[lvl + 2],
                                                      dtype=dtype))
        self.out_lay = conv(out_dims[n_fpn + 1], 1, dtype=dtype) if out_layer else None

    def forward(self, features: List[torch.Tensor],
                bbox_masks: List[torch.Tensor], expand: int) -> torch.Tensor:
        """features: channel-first (B, C, H, W) maps, coarsest first;
        bbox_masks: per level (expand*B, heads, H, W) → (expand*B, 1, h, w)."""
        dt = self.compute_dtype

        def tile(t):
            if self.expand_mode == "tile":
                return t.to(dt).repeat(expand, 1, 1, 1)
            return t.to(dt).repeat_interleave(expand, dim=0)

        x = torch.cat([tile(features[0]), bbox_masks[0].to(dt)], dim=1)
        x = F.relu(self.gn1(self.lay1(x)))
        x = F.relu(self.gn2(self.lay2(x)))
        for lvl, feat in enumerate(features[1:]):
            fpn = tile(getattr(self, f"adapter{lvl + 1}")(feat))
            x = fpn + resize_nearest_hw(x, fpn.shape[-2:])
            if self.num_att_levels > 1 and lvl + 1 < len(bbox_masks):
                x = torch.cat([x, bbox_masks[lvl + 1].to(dt)], dim=1)
            x = getattr(self, f"lay{lvl + 3}")(x)
            x = F.relu(getattr(self, f"gn{lvl + 3}")(x))
        return x if self.out_lay is None else self.out_lay(x)


class DeformableDETRSegm(nn.Module):
    """Image instance-segmentation model. Batch axis = B images."""

    def __init__(self, detr: DeformableDETR,
                 mask_head_used_features: Sequence = (
                     ("/32", "encoded"), ("/16", "encoded"), ("/8", "encoded"),
                     ("/4", "backbone")),
                 att_maps_used_res: Sequence[str] = ("/32", "/16", "/8"),
                 mask_aux_loss: Sequence[int] = (2,),
                 matcher_cfg: Optional[dict] = None, num_out: int = 100,
                 focal_loss: bool = True, use_deformable_conv: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.def_detr = detr
        self.mask_head_used_features = tuple(map(tuple, mask_head_used_features))
        self.att_maps_used_res = tuple(att_maps_used_res)
        self.mask_aux_loss = tuple(mask_aux_loss)
        self.matcher_cfg = dict(matcher_cfg or {})
        self.num_out = num_out
        self.focal_loss = focal_loss
        hidden = detr.hidden_dim
        nheads = 8
        self.bbox_attention = MultiScaleMHAttentionMap(
            hidden, nheads, len(self.att_maps_used_res), dtype=dtype)
        fpn_dims = mask_head_feat_dims(self.mask_head_used_features,
                                       detr.backbone_num_channels, hidden)
        self.mask_head = MaskHeadConv(hidden, fpn_dims, nheads,
                                      len(self.att_maps_used_res), dtype=dtype,
                                      expand_mode="repeat",
                                      use_deformable_conv=use_deformable_conv)

    def _masks_for_embeddings(self, embeddings, mem_att, mask_att, feats):
        """embeddings (B, N, C) → (B, N, h, w) mask logits."""
        B, N, _ = embeddings.shape
        bbox_masks = self.bbox_attention(embeddings, mem_att, mask_att)
        bbox_masks = [b.reshape((B * N,) + b.shape[2:]) for b in bbox_masks]
        m = self.mask_head(feats, bbox_masks, expand=N)    # (B*N, 1, h, w)
        return m[:, 0].reshape(B, N, m.shape[2], m.shape[3])

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor,
                targets: Optional[dict] = None, train: bool = False):
        """images (B, H, W, 3); pad_mask (B, H, W). With ``targets`` (labels
        (B, N), boxes (B, N, 4), valid (B, N)) the final level and each level
        of `mask_aux_loss` get `indices` and slot-aligned `pred_masks`;
        unless ``train``, `out["top_k"]` holds the scores, labels, boxes,
        query indices and masks of the top `num_out` (query, class) pairs."""
        out, inter = self.def_detr(images, pad_mask)
        mem_att, mask_att, feats = attention_and_head_features(
            inter, self.att_maps_used_res, self.mask_head_used_features)
        hs = inter["hs"]                                   # (n_layers, B, Nq, C)

        def gather(level_hs, idx):
            return torch.gather(level_hs, 1,
                                idx[..., None].expand(-1, -1, level_hs.shape[-1]))

        if targets is not None:
            for lvl in (-1,) + self.mask_aux_loss:
                level_out = out if lvl == -1 else out["aux_outputs"][lvl]
                src_idx = matcher_lib.hungarian_match_image(
                    level_out["pred_logits"], level_out["pred_boxes"],
                    targets["labels"], targets["boxes"], targets["valid"],
                    **self.matcher_cfg)
                level_out["indices"] = src_idx
                level_out["pred_masks"] = self._masks_for_embeddings(
                    gather(hs[lvl], src_idx), mem_att, mask_att, feats)

        if not train:
            logits = out["pred_logits"].float()
            prob = torch.sigmoid(logits) if self.focal_loss \
                else torch.softmax(logits, dim=-1)[..., :-1]
            scores, labels, boxes, query_idx = top_k_process(
                prob, out["pred_boxes"], self.num_out)
            masks = self._masks_for_embeddings(gather(hs[-1], query_idx),
                                               mem_att, mask_att, feats)
            out["top_k"] = {"scores": scores, "labels": labels, "boxes": boxes,
                            "query_top_k_indexes": query_idx, "masks": masks}
        return out
