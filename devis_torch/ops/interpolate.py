"""Image resizing with torch's rules (port of `devis_tpu/ops/interpolate.py`).

  * nearest: src = floor(dst * in / out), as an index gather (the JAX package
    phrases it as matmuls because the TPU lacks a fast gather);
  * bilinear with half-pixel centres and clamped edges
    (``align_corners=False``), as two small products with constant
    interpolation matrices, out = A_h . X . A_w^T, like the JAX package: the
    matrices are built in float64 and rounded to f32, so the two agree to f32
    rounding, and the products differentiate.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
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


@functools.lru_cache(maxsize=256)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) half-pixel lerp weights; read-only, shared by all callers."""
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (coords - lo).astype(np.float32)
    mat = np.zeros((out_size, in_size), np.float32)
    mat[np.arange(out_size), lo] += 1.0 - w_hi
    mat[np.arange(out_size), hi] += w_hi
    mat.setflags(write=False)
    return mat


def resize_bilinear_hw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes (..., H, W), align_corners=False,
    computed in f32 and returned in x's dtype."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == tuple(size):
        return x
    a_h = torch.tensor(_bilinear_matrix(h_in, size[0]), device=x.device)
    a_w = torch.tensor(_bilinear_matrix(w_in, size[1]), device=x.device)
    y = torch.matmul(a_h, x.float())                       # (..., h, W)
    return torch.matmul(y, a_w.t()).to(x.dtype)            # (..., h, w)
