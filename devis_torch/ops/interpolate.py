"""Nearest resize with torch's "nearest" rule, src = floor(dst * in / out).

The port of the nearest half of `devis_tpu/ops/interpolate.py`, as an index
gather (the JAX package phrases it as matmuls because the TPU lacks a fast
gather).
"""
from __future__ import annotations

from typing import Tuple

import torch


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    src = torch.floor(torch.arange(out_size, dtype=torch.float64, device=device)
                      * (in_size / out_size)).long()
    return src.clamp(0, in_size - 1)


def resize_nearest_hw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two axes (..., H, W)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == tuple(size):
        return x
    iy = _nearest_index(h_in, size[0], x.device)
    ix = _nearest_index(w_in, size[1], x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def downsample_mask(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Padding mask (N, H, W) bool → (N, h, w), as the reference's
    `F.interpolate(mask.float(), size).bool()`."""
    return resize_nearest_hw(mask, size)
