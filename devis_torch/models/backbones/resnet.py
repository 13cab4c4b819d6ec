"""ResNet-50/101 with frozen batch norm (port of
`devis_tpu/models/backbones/resnet.py`), NCHW.

Parameter names follow the torchvision state dict (`conv1`, `bn1`,
`layer{i}.{j}.conv{k}`, `downsample.{0,1}`). The stem is the plain 7×7/s2
convolution; the JAX package's space-to-depth stem is a TPU reformulation of
the same map.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d

BLOCK_COUNTS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
NUM_CHANNELS = (256, 512, 1024, 2048)


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with fixed statistics and affine (buffers), eps 1e-5."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + 1e-5)
        scale = (self.weight * inv).to(x.dtype)
        bias = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * scale[None, :, None, None] + bias[None, :, None, None]


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, width: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, width, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, width * 4, 1, stride=stride, bias=False,
                       dtype=dtype),
                FrozenBatchNorm2d(width * 4))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class ResNet(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32) NCHW."""

    def __init__(self, name_variant: str = "resnet50", dilation: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        dil = 1
        for stage, (n_blocks, width) in enumerate(
                zip(BLOCK_COUNTS[name_variant], (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            if stage == 3 and dilation:
                dil, stride = 2, 1
            blocks = []
            for blk in range(n_blocks):
                blocks.append(Bottleneck(inplanes, width,
                                         stride=stride if blk == 0 else 1,
                                         dilation=dil, downsample=blk == 0,
                                         dtype=dtype))
                inplanes = width * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x.to(self.compute_dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        return outs
