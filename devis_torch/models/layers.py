"""Dense layers with the JAX package's dtype policy.

Parameters are stored in f32. A layer built with ``dtype=torch.bfloat16``
casts its input and parameters to bf16 and returns bf16, as a flax layer with
``dtype=bfloat16`` does. Layer and group norms compute their statistics in
f32; `LayerNorm` returns f32 (flax's LayerNorm promotes to its f32 scale),
`GroupNorm` returns its compute dtype. `Dropout` draws its mask from an
explicit `torch.Generator` on the input's device.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """NCHW convolution computed in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, self.dilation)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm on channel-first (B, C, ...) input with f32 statistics and
    the fast variance E[x²] − E[x]², returning ``dtype``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        B, C = x.shape[:2]
        xf = x.float().reshape(B, self.num_groups, -1)
        mean = xf.mean(dim=2, keepdim=True)
        var = (xf * xf).mean(dim=2, keepdim=True) - mean * mean
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, C) + (1,) * (x.dim() - 2)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.compute_dtype)


class Dropout(nn.Module):
    """Inverted dropout, active in training mode. The keep mask comes from
    `generator` (on the input's device), which the train step hands to
    every layer from its caller, so a run is reproducible from that
    generator's seed; with none it comes from torch's global generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=self.generator) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Give every `Dropout` of `model` the generator it draws from."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
