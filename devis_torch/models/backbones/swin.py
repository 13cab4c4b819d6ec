"""Swin Transformer backbone (port of `devis_tpu/models/backbones/swin.py`):
4×4 patch embed, shifted-window attention with relative position bias,
patch-merging downsample, a LayerNorm'd output at each of the strides
[4, 8, 16, 32]. Variants in `SWIN_CONFIGS`.

NCHW in and out, as the port's ResNet; NHWC inside for the windows.
Parameter names are the reference torch Swin's (`patch_embed.proj`,
`layers.{i}.blocks.{j}.attn.qkv`, `layers.{i}.downsample.reduction`,
`norm{i}`), and each block's `relative_position_index` is a persistent
buffer, so a reference state dict loads strictly.

The semantics are the JAX package's: each stage is padded with zeros to
window multiples once, every block of the stage runs on the padded map, the
stage output is cropped back, and a stage whose padded map is no larger
than one window does not shift.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, DropPath, LayerNorm, Linear, recompute

LN_EPS = 1e-6                  # flax's LayerNorm default


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nH·nW, w, w, C); H, W divisible by w."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)


def window_reverse(wins: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def relative_position_index(w: int) -> np.ndarray:
    """(w², w²) index into the (2w-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # (2, w², w²)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """Additive −100 mask between regions the cyclic shift brought
    together. Returns (nW, w², w²) f32."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias. q is scaled before the product;
    the logits are f32 (bf16 operands, f32 accumulation, as the JAX einsum's
    ``preferred_element_type``), bias and mask are added in f32, the softmax
    is f32 and cast to the compute dtype."""

    def __init__(self, dim: int, num_heads: int, window: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)).long())

    def forward(self, x: torch.Tensor, mask: torch.Tensor = None) -> torch.Tensor:
        """x (nW, N, C) with N = window²; mask (n_mask, N, N) f32 or None."""
        nW, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x).reshape(nW, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                    # (nW, h, N, hd)
        # the scale is rounded to q's dtype first, as JAX rounds a Python
        # scalar to the array's dtype
        scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
        attn = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nm = mask.shape[0]
            attn = (attn.reshape(nW // nm, nm, h, N, N) + mask[None, :, None]).reshape(nW, h, N, N)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nW, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))                # exact (erf) GELU


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self._masks = {}                 # (H, W, device) → the shift mask on it

    def shift_mask(self, H: int, W: int, device) -> torch.Tensor:
        key = (H, W, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_attn_mask(H, W, self.window, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, shifted: bool = True) -> torch.Tensor:
        """x (B, H, W, C), H and W multiples of the window; `shifted` False
        runs a shifted block without its shift."""
        B, H, W, C = x.shape
        w, s = self.window, self.shift if shifted else 0
        shortcut = x
        x = self.norm1(x)
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = self.shift_mask(H, W, x.device)
        wins = self.attn(window_partition(x, w).reshape(-1, w * w, C), mask)
        x = window_reverse(wins.reshape(-1, w, w, C), w, B, H, W)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + self.drop_path(x)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2× downsample: the 2×2 neighbourhood concatenated (x[0::2, 0::2],
    x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]), LayerNorm, linear
    4C → 2C; an odd side is padded with zeros first."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, out_dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, 4, stride=4, dtype=dtype)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS, out_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW image → NHWC tokens."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, blocks: List[SwinBlock], downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32), each
    LayerNorm'd, NCHW in the compute dtype. Block i of the n in all stages
    drops its branches with probability linspace(0, drop_path_rate, n)[i]
    in training; `use_checkpoint` recomputes each block in the backward
    pass (`layers.recompute`)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 mlp_ratio: float = 4.0,
                 num_channels: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.2, use_checkpoint: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.window = window
        self.use_checkpoint = use_checkpoint
        self.compute_dtype = dtype
        self.num_channels = tuple(num_channels)
        self.patch_embed = PatchEmbed(embed_dim, dtype=dtype)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        stages, blk_id, dim = [], 0, embed_dim
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = []
            for blk in range(depth):
                blocks.append(SwinBlock(dim, heads, window, 0 if blk % 2 == 0 else window // 2,
                                        mlp_ratio, float(dpr[blk_id]), dtype=dtype))
                blk_id += 1
            last = stage == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, dtype=dtype)))
            self.add_module(f"norm{stage}", LayerNorm(dim, eps=LN_EPS, out_dtype=dtype))
            dim *= 2
        self.layers = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        w = self.window
        x = self.patch_embed(x.to(self.compute_dtype))
        outs = []
        for i, stage in enumerate(self.layers):
            B, H, W, C = x.shape
            Hp, Wp = -(-H // w) * w, -(-W // w) * w
            xp = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
            shifted = min(Hp, Wp) > w     # no shift where a side is one window
            for blk in stage.blocks:
                xp = recompute(blk, xp, shifted) if self.use_checkpoint else blk(xp, shifted)
            x = xp[:, :H, :W]
            outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def _cfg(embed, depths, heads, window, drop_path_rate):
    return dict(embed_dim=embed, depths=depths, num_heads=heads, window=window,
                num_channels=tuple(embed * 2 ** i for i in range(4)),
                drop_path_rate=drop_path_rate)


# drop_path rates from the reference registry
SWIN_CONFIGS = {
    "swin_t_p4w7": _cfg(96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.2),
    "swin_s_p4w7": _cfg(96, (2, 2, 18, 2), (3, 6, 12, 24), 7, 0.2),
    "swin_b_p4w7": _cfg(128, (2, 2, 18, 2), (4, 8, 16, 32), 7, 0.3),
    "swin_l_p4w7": _cfg(192, (2, 2, 18, 2), (6, 12, 24, 48), 7, 0.3),
    "swin_l_p4w12": _cfg(192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 0.3),
}
