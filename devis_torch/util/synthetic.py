"""Seeded synthetic data in the layouts of the JAX package's collate functions
and datasets: training clips (`collate_clip`) with bright rectangles that
drift over a noisy background and their labels, boxes and masks; training
image batches (`collate_images`) of the same kind; and an image dataset for
the COCO evaluation loop (`image`, `image_id`, `orig_size`)."""
from __future__ import annotations

from typing import Dict, List, Tuple

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


def _rectangle(rs, h: int, w: int):
    """A random rectangle (y, x, bh, bw) inside an (h, w) image."""
    bh = rs.randint(h // 6, h // 2)
    bw = rs.randint(w // 6, w // 2)
    return rs.randint(0, h - bh), rs.randint(0, w - bw), bh, bw


def synthetic_image_batch(seed: int, canvas: Tuple[int, int],
                          valid_hw: Tuple[int, int], n_instances: int,
                          max_instances: int, num_classes: int, batch: int = 1,
                          mask_stride: int = 4) -> Dict:
    """`batch` images of `valid_hw` pixels on a `canvas`, each with
    `n_instances` rectangles in `max_instances` target slots.

    Returns numpy arrays: images (B, H, W, 3) f32, normalized; pad_mask
    (B, H, W) bool, True on padding; targets: labels (B, N) int32, boxes
    (B, N, 4) cxcywh normalized to the unpadded image (0.5 in empty slots),
    valid (B, N), masks (B, N, H/s, W/s) f32."""
    rs = np.random.RandomState(seed)
    B, N = batch, max_instances
    H, W = canvas
    h, w = valid_hw
    if n_instances > N or h > H or w > W:
        raise ValueError("instances must fit the slots and images the canvas")
    s = mask_stride
    images = np.zeros((B, H, W, 3), np.float32)
    pad_mask = np.ones((B, H, W), bool)
    pad_mask[:, :h, :w] = False
    labels = np.zeros((B, N), np.int32)
    boxes = np.full((B, N, 4), 0.5, np.float32)
    valid = np.zeros((B, N), bool)
    masks = np.zeros((B, N, H // s, W // s), np.float32)
    for b in range(B):
        image = rs.rand(h, w, 3).astype(np.float32) * 0.3
        for i in range(n_instances):
            y, x, bh, bw = _rectangle(rs, h, w)
            image[y:y + bh, x:x + bw] = rs.rand(3).astype(np.float32)
            labels[b, i] = rs.randint(0, num_classes)
            boxes[b, i] = ((x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h)
            valid[b, i] = True
            masks[b, i, y // s:-(-(y + bh) // s), x // s:-(-(x + bw) // s)] = 1.0
        images[b, :h, :w] = (image - IMAGENET_MEAN) / IMAGENET_STD
    return {"images": images, "pad_mask": pad_mask,
            "targets": {"labels": labels, "boxes": boxes, "valid": valid,
                        "masks": masks}}


class SyntheticImageDataset:
    """`n` seeded images for the COCO evaluation loop: item i is
    {"image": (h, w, 3) f32 normalized, "image_id": i + 1, "orig_size":
    (oh, ow)} with rectangles over noise; `sizes` gives each image's (h, w)
    after the eval resize and `orig_sizes` its size before it."""

    def __init__(self, seed: int, sizes: List[Tuple[int, int]],
                 orig_sizes: List[Tuple[int, int]] = None, n_rectangles: int = 4):
        self.seed = seed
        self.sizes = [tuple(s) for s in sizes]
        self.orig_sizes = [tuple(s) for s in (orig_sizes or sizes)]
        self.n_rectangles = n_rectangles

    def __len__(self) -> int:
        return len(self.sizes)

    def eval_hw(self, idx: int) -> Tuple[int, int]:
        return self.sizes[idx]

    def __getitem__(self, idx: int) -> Dict:
        rs = np.random.RandomState(self.seed + 7919 * idx)
        h, w = self.sizes[idx]
        image = rs.rand(h, w, 3).astype(np.float32) * 0.3
        for _ in range(self.n_rectangles):
            y, x, bh, bw = _rectangle(rs, h, w)
            image[y:y + bh, x:x + bw] = rs.rand(3).astype(np.float32)
        return {"image": (image - IMAGENET_MEAN) / IMAGENET_STD,
                "image_id": idx + 1, "orig_size": self.orig_sizes[idx]}
