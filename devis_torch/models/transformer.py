"""Deformable transformer (port of `devis_tpu/models/transformer.py`), its
three variants: ``"devis"``, temporal deformable attention in the encoder and
the decoder over the T frames of one clip; ``"devis_ablation"``, the same
clip without temporal connections: the encoder attends frame by frame (the
T frames as a batch) and the decoder's queries of frame t attend frame t's
memory alone; and ``"image"``, single-frame attention over a batch of B
images with batched queries and per-image valid ratios. The reference
points are refined layer by layer by the DETR's box heads
(`WITH_BBX_REFINE`), by its reference-point heads
(`WITH_REF_POINT_REFINE`), or not at all. Dropout sits where the JAX package
puts it (after each attention, inside and after each FFN). With
``remat_layers`` each encoder and decoder layer keeps only its inputs for
the backward pass and runs again there (`layers.recompute`). Outside
``"devis"`` the reference points are 2-d up to the first box refinement and
4-d after it, so decoder layer 0 and the encoder take the projection-fused
attention and the later decoder layers the q-major one."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..util.misc import inverse_sigmoid
from .attention import (MSDeformAttn, MultiHeadAttention,
                        TemporalMSDeformAttnDecoder, TemporalMSDeformAttnEncoder)
from .layers import Dropout, LayerNorm, Linear, recompute


def get_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (w_ratio, h_ratio) of the unpadded area → (B, L, 2)."""
    ratios = []
    for m in masks:
        H, W = m.shape[1], m.shape[2]
        valid_h = (~m[:, :, 0]).sum(1).float()
        valid_w = (~m[:, 0, :]).sum(1).float()
        ratios.append(torch.stack([valid_w / W, valid_h / H], dim=-1))
    return torch.stack(ratios, dim=1)


def encoder_reference_points(spatial_shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """Normalized pixel-centre grid of every level → (B, S, L, 2)."""
    refs = []
    dev = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry, rx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                                indexing="ij")
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], dim=-1))
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None] * valid_ratios[:, None]


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, dropout, n_levels, n_heads, n_frames,
                 t_window, connect_all, n_points, n_temporal_points, dtype,
                 variant="devis"):
        super().__init__()
        self.dropout = Dropout(dropout)
        if variant == "devis":
            self.self_attn = TemporalMSDeformAttnEncoder(
                n_frames, d_model, n_levels, t_window, n_heads, n_points,
                n_temporal_points, dtype=dtype, connect_all=connect_all)
        else:
            self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                          dtype=dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask):
        drop = self.dropout
        src = self.norm1(src + drop(self.self_attn(src + pos, reference_points, src,
                                                   spatial_shapes, padding_mask)))
        y = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(y))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, dropout, n_levels, n_heads, n_frames,
                 instance_aware, n_points, n_temporal_points, dtype,
                 variant="devis"):
        super().__init__()
        self.per_frame = variant == "devis_ablation"
        self.dropout = Dropout(dropout)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout, dtype=dtype)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        if variant == "devis":
            self.cross_attn = TemporalMSDeformAttnDecoder(
                n_frames, d_model, n_levels, n_frames - 1, n_heads, n_points,
                n_temporal_points, dtype=dtype, instance_aware=instance_aware)
        else:
            self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                           dtype=dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                padding_mask):
        drop = self.dropout
        q = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(q, q, tgt)))
        query = tgt + query_pos
        if self.per_frame:
            # the queries of frame t, (1, T*Lq, C) → (T, Lq, C), attend frame t
            T = src.shape[0]
            query = query.reshape(T, -1, query.shape[-1])
            reference_points = reference_points.reshape(
                (T, query.shape[1]) + reference_points.shape[-2:])
        tgt2 = self.cross_attn(query, reference_points, src, spatial_shapes, padding_mask)
        tgt = self.norm1(tgt + drop(tgt2.reshape(tgt.shape)))
        y = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(y))


class _Stack(nn.Module):
    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableTransformer(nn.Module):
    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, dropout=0.1,
                 num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 num_frames=6, enc_connect_all=True,
                 enc_temporal_window=2, enc_n_temporal_points=4,
                 dec_n_temporal_points=4, instance_aware=True,
                 with_gradient=False, variant="devis", remat_layers=False,
                 dtype=torch.float32):
        super().__init__()
        if variant not in ("devis", "devis_ablation", "image"):
            raise ValueError(f"unknown transformer variant {variant!r}")
        self.variant = variant
        self.d_model = d_model
        self.with_gradient = with_gradient
        self.remat_layers = remat_layers
        self.compute_dtype = dtype
        self.num_decoder_layers = num_decoder_layers
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        self.reference_points = Linear(d_model, 2, dtype=dtype)
        enc_t_window = num_frames - 1 if enc_connect_all else enc_temporal_window
        self.encoder = _Stack([
            EncoderLayer(d_model, dim_feedforward, dropout, num_feature_levels,
                         n_heads, num_frames, enc_t_window, enc_connect_all,
                         enc_n_points, enc_n_temporal_points, dtype, variant)
            for _ in range(num_encoder_layers)])
        self.decoder = _Stack([
            DecoderLayer(d_model, dim_feedforward, dropout, num_feature_levels,
                         n_heads, num_frames, instance_aware, dec_n_points,
                         dec_n_temporal_points, dtype, variant)
            for _ in range(num_decoder_layers)])

    def _refine(self, lid, output, reference_points, bbox_embed, ref_point_embed):
        """Layer `lid`'s refined references: by its box head (gradients pass
        through the boxes only with `with_gradient`), then by its
        reference-point head; unchanged where neither is given."""
        if bbox_embed is not None:
            tmp = bbox_embed[lid](output)
            if reference_points.shape[-1] == 4:
                new_ref = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
            else:
                xy = tmp[..., :2] + inverse_sigmoid(reference_points)
                new_ref = torch.sigmoid(torch.cat([xy, tmp[..., 2:]], dim=-1))
            reference_points = new_ref if self.with_gradient else new_ref.detach()
        if ref_point_embed is not None:
            tmp = ref_point_embed[lid](output)
            reference_points = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
        return reference_points

    def forward(self, srcs, masks, pos_embeds, query_embed, bbox_embed=None,
                ref_point_embed=None):
        """srcs: NCHW per level; masks (T, h, w) bool; pos_embeds
        (T, h, w, C); query_embed (num_queries, 2C); bbox_embed and
        ref_point_embed: the DETR's per-layer box and reference-point heads
        that refine the references, or None. The leading axis is the T
        frames of one clip (``"devis"``, ``"devis_ablation"``) or B images
        (``"image"``)."""
        spatial_shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        dt = self.compute_dtype
        T = srcs[0].shape[0]
        C = self.d_model
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], dim=1)
        mask_flat = torch.cat([m.reshape(T, -1) for m in masks], dim=1)
        pos_flat = torch.cat([(p.reshape(T, -1, C) + self.level_embed[l]).to(dt)
                              for l, p in enumerate(pos_embeds)], dim=1)
        valid_ratios = get_valid_ratios(masks)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = src_flat.to(dt)
        call = recompute if self.remat_layers else (lambda layer, *a: layer(*a))
        for layer in self.encoder.layers:
            memory = call(layer, memory, pos_flat, enc_ref, spatial_shapes, mask_flat)

        query_pos, tgt = torch.split(query_embed.to(dt), C, dim=1)
        if self.variant == "image":
            query_pos = query_pos[None].expand(T, -1, -1)
            tgt = tgt[None].expand(T, -1, -1)
            dec_valid_ratios = valid_ratios
        else:
            query_pos, tgt = query_pos[None], tgt[None]
            dec_valid_ratios = valid_ratios[0:1]          # the first frame's
        reference_points = torch.sigmoid(self.reference_points(query_pos))
        init_reference = reference_points

        hs, refs = [], []
        output = tgt
        for lid, layer in enumerate(self.decoder.layers):
            vr = dec_valid_ratios
            if reference_points.shape[-1] == 4:
                vr = torch.cat([vr, vr], dim=-1)
            ref_input = reference_points[:, :, None] * vr[:, None]
            output = call(layer, output, query_pos, ref_input, memory, spatial_shapes,
                          mask_flat)
            reference_points = self._refine(lid, output, reference_points,
                                            bbox_embed, ref_point_embed)
            hs.append(output)
            refs.append(reference_points)

        memories = []
        offset = 0
        for h, w in spatial_shapes:
            memories.append(memory[:, offset:offset + h * w].reshape(T, h, w, C))
            offset += h * w
        return dict(hs=torch.stack(hs), memories=memories,
                    init_reference=init_reference,
                    inter_references=torch.stack(refs),
                    valid_ratios=valid_ratios, spatial_shapes=spatial_shapes)
