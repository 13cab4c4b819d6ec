"""Positional encodings (port of `devis_tpu/models/position_encoding.py`).

They take the padding mask (B, H, W) and return (B, H, W, C) f32, the JAX
package's layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn


def sine_position_encoding(mask: torch.Tensor, num_pos_feats: int,
                           temperature: float = 10000.0,
                           normalize: bool = True, scale=None) -> torch.Tensor:
    """2-d sine encoding; mask True on padding → (B, H, W, 2*num_pos_feats)."""
    if scale is None:
        scale = 2 * math.pi
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        -1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        -1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)


class PositionEmbeddingSine(nn.Module):
    """2-d sine encoding of the image model; no parameters."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.num_pos_feats = num_pos_feats

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        return sine_position_encoding(mask, self.num_pos_feats)


class PositionEmbeddingSineWithLearnableTemporal(nn.Module):
    """2-d sine plus a learned embedding per frame; the batch axis is frames."""

    def __init__(self, hidden_dim: int = 256, num_frames: int = 6):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_frames = num_frames
        self.temporal_embed = nn.Parameter(torch.zeros(num_frames, hidden_dim))

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        if mask.shape[0] != self.num_frames:
            raise ValueError(f"expected {self.num_frames} frames, got {mask.shape[0]}")
        pos = sine_position_encoding(mask, self.hidden_dim // 2)
        return pos + self.temporal_embed[:, None, None, :]


class PositionEmbeddingSpatialTemporalSine(nn.Module):
    """VisTR's (t, y, x) sine encoding over the T frames of a clip (the batch
    axis), `num_pos_feats` channels each, zero-padded by 4 channels: 256 at
    the 84 a hidden width of 252 gives."""

    def __init__(self, num_pos_feats: int = 84, num_frames: int = 6,
                 temperature: float = 10000.0):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.num_frames = num_frames
        self.temperature = temperature

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        """mask (T, H, W) True on padding → (T, H, W, 3 * num_pos_feats + 4)."""
        scale = 2 * math.pi
        not_mask = (~mask).float()[None]                  # (1, T, H, W)
        eps = 1e-6
        embeds = []
        for axis in (1, 2, 3):
            e = not_mask.cumsum(axis)
            last = e.narrow(axis, e.shape[axis] - 1, 1)
            embeds.append(e / (last + eps) * scale)
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32, device=mask.device)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / self.num_pos_feats)

        def enc(e):
            p = e[..., None] / dim_t
            return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2)

        pos = torch.cat([enc(e) for e in embeds], dim=-1)
        pad = torch.zeros(pos.shape[:-1] + (4,), dtype=pos.dtype, device=pos.device)
        return torch.cat([pos, pad], dim=-1)[0]
