"""Multi-scale deformable attention: plain PyTorch version and helpers.

The port of `devis_tpu/ops/ms_deform_attn.py`. Semantics:
  * ``value``               (B, S, M, D): flattened multi-scale features in M
                            heads, S = sum_l H_l * W_l.
  * ``spatial_shapes``      tuple ((H_0, W_0), ...) of Python ints.
  * ``sampling_locations``  (B, Q, M, L, P, 2): (x, y) in [0, 1] of each
                            level's full extent.
  * ``attention_weights``   (B, Q, M, L, P).
  * returns                 (B, Q, M*D) in the value's dtype.

Bilinear sampling at ``p = loc * size - 0.5`` with zero padding, i.e.
``F.grid_sample(align_corners=False, padding_mode='zeros')``. The sum runs
level by level: one gather over every level at once would hold
B*M*Q*L*P*4*D floats (about 12 GB for the temporal encoder at full width).

The temporal attention of DeVIS reads, for frame t, the current frame's L
levels and the same L levels of W other frames. `temporal_frame_table`
names those frames; `ms_deform_attn_temporal_plain` gathers one frame slot
at a time, so no (1+W)-times stacked value copy exists.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Shapes = Tuple[Tuple[int, int], ...]


def normalize_shapes(spatial_shapes) -> Shapes:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def level_start_index(spatial_shapes: Shapes) -> Tuple[int, ...]:
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return tuple(starts)


def make_temporal_shapes(spatial_shapes: Shapes, n_temporal_frames: int) -> Shapes:
    """Level-stacked geometry of the W temporal frames (frame-major)."""
    return tuple(spatial_shapes) * n_temporal_frames


def temporal_frame_rule(n_frames: int, t_window: int, connect_all: bool):
    """``("all",)`` connects every other frame; ``("window", offsets)`` the
    frames t+o for o in [-W/2, W/2] without 0, reflected at the clip edges."""
    if connect_all:
        return ("all",)
    rel = tuple(o for o in range(-t_window // 2, t_window // 2 + 1) if o != 0)
    return ("window", rel)


def rule_window(rule, n_frames: int) -> int:
    return (n_frames - 1) if rule[0] == "all" else len(rule[1])


def temporal_frame_table(rule, n_frames: int) -> np.ndarray:
    """(T, W) absolute source frame of temporal slot j of frame t."""
    T = n_frames
    rows = []
    for t in range(T):
        if rule[0] == "all":
            rows.append([f for f in range(T) if f != t])
        else:
            rows.append([t - o if (t + o < 0 or t + o > T - 1) else t + o
                         for o in rule[1]])
    return np.asarray(rows, np.int64).reshape(T, rule_window(rule, T))


def sample_level(v_l: torch.Tensor, loc: torch.Tensor, att: torch.Tensor,
                 h: int, w: int) -> torch.Tensor:
    """Bilinear-sample one level and weight the taps.

    v_l: (B, M, H*W, D); loc: (B, Q, M, P, 2) f32; att: (B, Q, M, P).
    Returns (B, M, Q, D) float32."""
    B, M, _, D = v_l.shape
    _, Q, _, P, _ = loc.shape
    x = loc[..., 0].float() * w - 0.5                      # (B, Q, M, P)
    y = loc[..., 1].float() * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    att = att.float()
    idxs, wts = [], []
    for oy, ox, tw in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                       (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
        yi, xi = y0i + oy, x0i + ox
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).float()
        idxs.append(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        wts.append(tw * valid * att)
    # (B, Q, M, P, 4) -> (B, M, Q*P*4)
    idx = torch.stack(idxs, -1).permute(0, 2, 1, 3, 4).reshape(B, M, Q * P * 4)
    wt = torch.stack(wts, -1).permute(0, 2, 1, 3, 4).reshape(B, M, Q * P * 4)
    g = torch.gather(v_l, 2, idx[..., None].expand(B, M, Q * P * 4, D))
    return (g.float() * wt[..., None]).reshape(B, M, Q, P * 4, D).sum(3)


def _ms_deform_attn_f32(value, spatial_shapes: Shapes, loc, att) -> torch.Tensor:
    """Level-by-level sum → (B, MG, Q, D) float32. loc and att may carry G
    heads a value head (MG = G * M, head mg reading value head mg // G): the
    value heads are repeated G times."""
    B, S, M, D = value.shape
    Q, MG = loc.shape[1], loc.shape[2]
    assert loc.shape[3] == len(spatial_shapes)
    assert S == sum(h * w for h, w in spatial_shapes)
    assert MG % M == 0, (MG, M)
    value_hm = value.permute(0, 2, 1, 3)                   # (B, M, S, D)
    if MG != M:
        value_hm = value_hm.repeat_interleave(MG // M, dim=1)
    starts = level_start_index(spatial_shapes)
    out = value.new_zeros((B, MG, Q, D), dtype=torch.float32)
    for lvl, (h, w) in enumerate(spatial_shapes):
        out += sample_level(value_hm[:, :, starts[lvl]:starts[lvl] + h * w],
                            loc[:, :, :, lvl], att[:, :, :, lvl], h, w)
    return out


def _heads_last(out: torch.Tensor, dtype) -> torch.Tensor:
    B, M, Q, D = out.shape
    return out.permute(0, 2, 1, 3).reshape(B, Q, M * D).to(dtype)


def ms_deform_attn(value: torch.Tensor, spatial_shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain multi-scale deformable attention (see module docstring)."""
    out = _ms_deform_attn_f32(value, normalize_shapes(spatial_shapes),
                              sampling_locations, attention_weights)
    return _heads_last(out, value.dtype)


def ms_deform_attn_temporal_plain(value: torch.Tensor, spatial_shapes,
                                  loc: torch.Tensor, att: torch.Tensor,
                                  rule) -> torch.Tensor:
    """Temporal attention over per-frame values.

    value (T, S, M, D), one copy per frame; loc (T, Q, M, Lf, P, 2) and att
    (T, Q, M, Lf, P) over the fused level stack in frame-major order: the
    current frame's L levels, then L levels for each of the W temporal
    frames that `rule` names. Returns (T, Q, M*D)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    L = len(spatial_shapes)
    table = torch.as_tensor(temporal_frame_table(rule, value.shape[0]),
                            device=value.device)
    n_slots = 1 + table.shape[1]
    assert loc.shape[3] == n_slots * L, (loc.shape, n_slots, L)
    out = 0
    for j in range(n_slots):
        v = value if j == 0 else value[table[:, j - 1]]
        lv = slice(j * L, (j + 1) * L)
        out = out + _ms_deform_attn_f32(v, spatial_shapes, loc[:, :, :, lv],
                                        att[:, :, :, lv])
    return _heads_last(out, value.dtype)
