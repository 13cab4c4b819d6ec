"""Seeded synthetic training clips in the batch layout of the train step (the
layout `collate_clip` of the JAX package produces): bright rectangles that
drift over a noisy background, with their labels, boxes and masks."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def synthetic_clip_batch(seed: int, num_frames: int, canvas: Tuple[int, int],
                         valid_hw: Tuple[int, int], n_instances: int,
                         max_instances: int, num_classes: int, batch: int = 1,
                         mask_stride: int = 4) -> Dict:
    """`batch` clips of `num_frames` frames of `valid_hw` pixels on a
    `canvas`, each with `n_instances` moving rectangles in `max_instances`
    target slots.

    Returns numpy arrays: images (B, T, H, W, 3) f32, normalized; pad_mask
    (B, T, H, W) bool, True on padding; targets: labels (B, N) int32, boxes
    (B, N, T, 4) cxcywh normalized to the unpadded frame (0.5 in empty
    slots), valid (B, N, T), exists (B, N), masks (B, N, T, H/s, W/s) f32."""
    rs = np.random.RandomState(seed)
    B, T, N = batch, num_frames, max_instances
    H, W = canvas
    h, w = valid_hw
    if n_instances > N or h > H or w > W:
        raise ValueError("instances must fit the slots and frames the canvas")
    hm, wm = H // mask_stride, W // mask_stride
    images = np.zeros((B, T, H, W, 3), np.float32)
    pad_mask = np.ones((B, T, H, W), bool)
    pad_mask[:, :, :h, :w] = False
    labels = np.zeros((B, N), np.int32)
    boxes = np.full((B, N, T, 4), 0.5, np.float32)
    valid = np.zeros((B, N, T), bool)
    exists = np.zeros((B, N), bool)
    masks = np.zeros((B, N, T, hm, wm), np.float32)
    for b in range(B):
        frames = rs.rand(T, h, w, 3).astype(np.float32) * 0.3
        for i in range(n_instances):
            bh = rs.randint(h // 6, h // 2)
            bw = rs.randint(w // 6, w // 2)
            y0, x0 = rs.randint(0, h - bh), rs.randint(0, w - bw)
            vy, vx = rs.randint(-4, 5), rs.randint(-4, 5)
            colour = rs.rand(3).astype(np.float32)
            labels[b, i] = rs.randint(0, num_classes)
            exists[b, i] = True
            for t in range(T):
                y = int(np.clip(y0 + vy * t, 0, h - bh))
                x = int(np.clip(x0 + vx * t, 0, w - bw))
                frames[t, y:y + bh, x:x + bw] = colour
                boxes[b, i, t] = ((x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h)
                valid[b, i, t] = True
                s = mask_stride
                masks[b, i, t, y // s:-(-(y + bh) // s), x // s:-(-(x + bw) // s)] = 1.0
        images[b, :, :h, :w] = (frames - IMAGENET_MEAN) / IMAGENET_STD
    return {"images": images, "pad_mask": pad_mask,
            "targets": {"labels": labels, "boxes": boxes, "valid": valid,
                        "exists": exists, "masks": masks}}
