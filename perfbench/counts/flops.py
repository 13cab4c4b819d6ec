"""Model FLOPs of one training step, as `step_mfu.train` counts them.

The matrix products and convolutions of the plain reference's forward and
backward, counted by `torch.utils.flop_counter.FlopCounterMode` on the meta
device (no memory, no time) for one item at its content size (the image
before padding to the canvas): the whole model, the mask head on the
configuration's instance slots at the final level and at each mask-loss
level; plus the deformable taps that the counter cannot see
(`msda.step_gather_flops`). The losses, the matching and the optimizer are
left out (negligible); nothing recomputed is counted.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from counts import msda                          # noqa: E402
from reference import model as M                 # noqa: E402


def _item_matmul_flops(arch: Dict, hw: Tuple[int, int]) -> int:
    h, w = hw
    T = arch["num_frames"]
    dev = torch.device("meta")
    model = M.SegmModel(arch)                    # parameters stay on meta
    model.train()
    images = torch.zeros((T, h, w, 3), device=dev, requires_grad=False)
    pad = torch.zeros((T, h, w), dtype=torch.bool, device=dev)
    n = arch["slots"]
    counter = FlopCounterMode(display=False)
    with M.counting(_shape_only), counter:
        levels, head = model(images, pad)
        hs = head["hs"]
        total = sum(lv["pred_logits"].sum() + lv["pred_boxes"].sum() for lv in levels)
        for lv in [len(levels) - 1] + list(arch["mask_aux_loss"]):
            emb = hs[lv][0].reshape(T, -1, hs.shape[-1])[:, :n]
            total = total + model.masks(emb, head).sum()
        total.backward()
    return counter.get_total_flops()


def _shape_only(v, grid):
    """The sampler's output shape, joined to both inputs' gradients, without
    the sampler's own many small operations (its taps are counted
    analytically)."""
    out = v.new_zeros(v.shape[:2] + grid.shape[1:3])
    return out + (v.sum() + grid.sum()) * 0


class StepFlops:
    """FLOPs of a step by the content sizes of its items, each size counted
    once a process."""

    def __init__(self, arch: Dict):
        self.arch = arch
        self._by_size: Dict[Tuple[int, int], float] = {}

    def item(self, hw: Tuple[int, int]) -> float:
        hw = (int(hw[0]), int(hw[1]))
        if hw not in self._by_size:
            self._by_size[hw] = (_item_matmul_flops(self.arch, hw)
                                 + msda.step_gather_flops(self.arch, [hw]))
        return self._by_size[hw]

    def step(self, sizes) -> float:
        return sum(self.item(hw) for hw in sizes)
