"""Temporal deformable attention and query self-attention (port of
`devis_tpu/models/attention.py`).

  * `TemporalMSDeformAttnEncoder`: per-frame current attention plus temporal
    attention over the other frames, one K1 launch per layer: the offset and
    logit projections go to the kernel raw, and the location math and the
    joint softmax run inside it.
  * `TemporalMSDeformAttnDecoder`: instance-aware temporal attention; the
    locations and the joint softmax are built here and sampled by K3.
  * `MultiHeadAttention`: the decoder's query self-attention, with the packed
    `in_proj_*` parameters of `torch.nn.MultiheadAttention`.

Frames ride the batch axis. Temporal levels are frame-major: (W, L).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.ms_deform_attn import (make_temporal_shapes, normalize_shapes,
                                  temporal_frame_rule, temporal_frame_table)
from ..ops.ms_deform_attn_cuda import msda_temporal, msda_temporal_proj
from .layers import Linear


def _directional_grid(n_heads: int) -> np.ndarray:
    """Unit L∞-normalized direction per head."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    return grid / np.abs(grid).max(axis=-1, keepdims=True)


def sampling_offsets_bias_init(n_heads: int, n_levels: int,
                               n_points: int) -> np.ndarray:
    """Bias layout (M, L, P, 2): head direction scaled by point index + 1."""
    grid = np.tile(_directional_grid(n_heads)[:, None, None, :],
                   (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def temporal_sampling_offsets_bias_init(n_heads: int, n_levels: int,
                                        t_window: int, n_points: int) -> np.ndarray:
    grid = np.tile(_directional_grid(n_heads)[:, None, None, None, :],
                   (1, n_levels, t_window, n_points, 1))
    for i in range(n_points):
        grid[:, :, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def compute_sampling_locations(reference_points: torch.Tensor,
                               offsets: torch.Tensor, spatial_shapes,
                               n_points: int) -> torch.Tensor:
    """reference_points (B, Q, L, 2|4); offsets (B, Q, M, L, P, 2).
    2-d: loc = ref + off / (W_l, H_l); 4-d: loc = ref_xy + off / P * ref_wh / 2."""
    if reference_points.shape[-1] == 2:
        norm = torch.tensor([[w, h] for h, w in spatial_shapes],
                            dtype=torch.float32, device=offsets.device)
        return (reference_points[:, :, None, :, None, :]
                + offsets / norm[None, None, None, :, None, :])
    if reference_points.shape[-1] == 4:
        ref = reference_points[:, :, None, :, None, :]
        return ref[..., :2] + offsets / n_points * ref[..., 2:] * 0.5
    raise ValueError("reference points last dim must be 2 or 4, got "
                     f"{reference_points.shape[-1]}")


class TemporalMSDeformAttnBase(nn.Module):
    """Projections shared by the encoder and decoder temporal attention."""

    def __init__(self, n_frames: int = 6, d_model: int = 256, n_levels: int = 4,
                 t_window: int = 2, n_heads: int = 8, n_curr_points: int = 4,
                 n_temporal_points: int = 4, dtype=torch.float32):
        super().__init__()
        if n_curr_points != n_temporal_points:
            raise NotImplementedError(
                "current and temporal point counts must match (the fused "
                "level stack of K1/K3); unequal counts are a ROADMAP item")
        self.n_frames, self.d_model, self.n_levels = n_frames, d_model, n_levels
        self.t_window, self.n_heads = t_window, n_heads
        self.n_points = n_curr_points
        M, L, W, P = n_heads, n_levels, t_window, n_curr_points
        self.value_proj = Linear(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Linear(d_model, M * L * P * 2, dtype=dtype)
        self.temporal_sampling_offsets = Linear(d_model, M * L * W * P * 2,
                                                dtype=dtype)
        self.attention_weights = Linear(d_model, M * L * P, dtype=dtype)
        self.temporal_attention_weights = Linear(d_model, M * L * W * P,
                                                 dtype=dtype)
        self.output_proj = Linear(d_model, d_model, dtype=dtype)

    @torch.no_grad()
    def reset_offsets(self):
        """The reference init: zero offset and logit weights, directional
        offset biases, zero logit biases."""
        M, L, W, P = self.n_heads, self.n_levels, self.t_window, self.n_points
        for lin in (self.sampling_offsets, self.temporal_sampling_offsets,
                    self.attention_weights, self.temporal_attention_weights):
            lin.weight.zero_()
            lin.bias.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            sampling_offsets_bias_init(M, L, P)))
        self.temporal_sampling_offsets.bias.copy_(torch.from_numpy(
            temporal_sampling_offsets_bias_init(M, L, W, P)))

    def _value(self, input_flatten, padding_mask):
        T, S = input_flatten.shape[:2]
        value = self.value_proj(input_flatten)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        return value.reshape(T, S, self.n_heads, self.d_model // self.n_heads)


class TemporalMSDeformAttnEncoder(TemporalMSDeformAttnBase):
    """Encoder temporal attention: the temporal reference of every tap is the
    query's level-0 reference point."""

    def __init__(self, *args, connect_all: bool = True, **kw):
        super().__init__(*args, **kw)
        self.connect_all = connect_all

    def forward(self, query, reference_points, input_flatten, spatial_shapes,
                padding_mask=None):
        """query (T, Q, C); reference_points (T, Q, L, 2); input_flatten
        (T, S, C); padding_mask (T, S) True on padding → (T, Q, C)."""
        if reference_points.shape[-1] != 2:
            raise ValueError("encoder reference points must be 2-d")
        rule = temporal_frame_rule(self.n_frames, self.t_window,
                                   self.connect_all)
        value = self._value(input_flatten, padding_mask).contiguous()
        out = msda_temporal_proj(
            value, normalize_shapes(spatial_shapes),
            reference_points.float().contiguous(),
            self.sampling_offsets(query).contiguous(),
            self.temporal_sampling_offsets(query).contiguous(),
            self.attention_weights(query).contiguous(),
            self.temporal_attention_weights(query).contiguous(), rule)
        return self.output_proj(out)


class TemporalMSDeformAttnDecoder(TemporalMSDeformAttnBase):
    """Decoder temporal attention with instance-aware temporal references:
    query i of frame t samples frame f around query i's reference in f."""

    def __init__(self, *args, instance_aware: bool = True, **kw):
        super().__init__(*args, **kw)
        self.instance_aware = instance_aware

    def forward(self, query, reference_points, input_flatten, spatial_shapes,
                padding_mask=None):
        """query (1, T*Lq, C); reference_points (1, T*Lq, L, 2|4) →
        (1, T*Lq, C)."""
        T = self.n_frames
        W = T - 1
        M, L, P = self.n_heads, self.n_levels, self.n_points
        spatial_shapes = normalize_shapes(spatial_shapes)
        C = query.shape[-1]
        Lq = query.shape[1] // T
        query = query.reshape(T, Lq, C)
        ref = reference_points.reshape((T, Lq) + reference_points.shape[-2:])
        value = self._value(input_flatten, padding_mask).contiguous()

        c_off = self.sampling_offsets(query).reshape(T, Lq, M, L, P, 2)
        t_off = self.temporal_sampling_offsets(query).reshape(T, Lq, M, W * L, P, 2)
        logits = torch.cat([
            self.attention_weights(query).reshape(T, Lq, M, L * P),
            self.temporal_attention_weights(query).reshape(T, Lq, M, W * L * P)],
            dim=-1)
        att = torch.softmax(logits.float(), dim=-1).reshape(T, Lq, M, (1 + W) * L, P)

        loc_c = compute_sampling_locations(ref, c_off, spatial_shapes, P)
        t_shapes = make_temporal_shapes(spatial_shapes, W)
        rdim = ref.shape[-1]
        if self.instance_aware:
            table = torch.as_tensor(temporal_frame_table(("all",), T),
                                    device=ref.device)
            t_ref = ref[table].permute(0, 2, 1, 3, 4).reshape(T, Lq, W * L, rdim)
        else:
            t_ref = ref.repeat(1, 1, W, 1)
        loc_t = compute_sampling_locations(t_ref, t_off, t_shapes, P)
        loc = torch.cat([loc_c, loc_t], dim=3).float().contiguous()
        out = msda_temporal(value, spatial_shapes, loc, att.contiguous(), ("all",))
        return self.output_proj(out).reshape(1, T * Lq, C)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with `torch.nn.MultiheadAttention`'s parameters
    (`in_proj_weight` (3C, C), `in_proj_bias`, `out_proj`)."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def forward(self, q, k, v):
        B, Lq, C = q.shape
        Dh = C // self.n_heads
        dt = self.compute_dtype
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)

        def heads(x, i):
            y = F.linear(x.to(dt), w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return y.reshape(B, -1, self.n_heads, Dh).transpose(1, 2)

        qp, kp, vp = heads(q, 0), heads(k, 1), heads(v, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", qp, kp) / math.sqrt(Dh)
        att = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.einsum("bhqk,bhkd->bhqd", att, vp)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))
