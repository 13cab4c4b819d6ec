"""The general generator of training traffic: a traffic file's parameters
and a seed give an in-memory dataset of clips in the format the port's
datasets hand to `TrainLoader` (normalised float32 content at its
transformed size, instance masks, boxes, labels).

Every seed meets the same sizes and instance counts, in another order: the
file's `block`, shuffled once by the seed, is laid out again and again in
the order the loader consumes the dataset (`assign`). Set-up draws the content of the
first `pool_blocks` blocks (`fill`, each item from its own generator,
seeded by (seed, index)); every later item repeats the item one or more
blocks before it, which has the same size and count. So the window's
loader thread only collates, as a deployment's does after decoding.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    with open(os.path.join(HERE, name + ".json")) as f:
        return json.load(f)


def resized(hw: Sequence[int], size: int, max_size: int) -> Tuple[int, int]:
    """Shorter side to `size`, longer side at most `max_size` (the
    reference's rule, ints truncated)."""
    h, w = hw
    lo, hi = float(min(h, w)), float(max(h, w))
    if hi / lo * size > max_size:
        size = int(round(max_size * lo / hi))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    return (int(size * h / w), size) if w < h else (size, int(size * w / h))


class Dataset:
    """`len(ds)` items; `assign` sets each one's size and instance count
    and which earlier item it repeats; `fill` draws the content."""

    def __init__(self, p: Dict, seed: int):
        self.p, self.seed = p, int(seed)
        self.spec: Dict[int, Tuple[Tuple[int, int], int]] = {}
        self.source: Dict[int, int] = {}
        self.items: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return self.p["dataset_items"]

    def _block(self, rng) -> List:
        """One block of (size, instance count) specs in consumption order."""
        p, blk = self.p, self.p["block"]
        sc, n = rng.permutation(blk["scales"]), rng.permutation(blk["instances"])
        return [(resized(p["source_hw"], int(s), p["max_size"]), int(k)) for s, k in zip(sc, n)]

    def assign(self, batches: List[Sequence[int]]) -> None:
        """Sizes, counts and repeats by consumption order: `batches` are the
        dataset indices of each batch in the order the loader takes them."""
        order = [int(i) for b in batches for i in b]
        taken = set(order)
        order += [i for i in range(len(self)) if i not in taken]
        block = self._block(np.random.default_rng([self.seed, 1]))
        pool = self.p["pool_blocks"] * len(block)
        for j, i in enumerate(order):
            self.spec[i] = block[j % len(block)]
            back = 0 if j < pool else -(-(j - pool + 1) // len(block)) * len(block)
            self.source[i] = order[j - back]

    def fill(self) -> None:
        """Draws the content of every item that later items repeat."""
        for i in sorted(set(self.source.values())):
            self.items[i] = self._draw(i)

    def _draw(self, i: int) -> Dict:
        (h, w), n = self.spec[i]
        rng = np.random.default_rng([self.seed, 2, i])
        return _scene(rng, self.p["frames"], h, w, n, self.p["absent_share"], self.p["classes"])

    def __getitem__(self, i: int) -> Dict:
        src = self.source[int(i)]
        if src not in self.items:
            self.items[src] = self._draw(src)
        return self.items[src]


def _scene(rng, T: int, h: int, w: int, n: int, absent: float, classes: int) -> Dict:
    """T frames of n moving ellipses over a drifting gradient with a little
    noise (a small tile repeated), normalised like the port's transforms' output (about zero mean,
    unit spread); later instances occlude earlier ones. Each ellipse is
    drawn inside its own bounding box."""
    base = rng.normal(0, 0.6, (3,)).astype(np.float32)
    gy, gx = rng.normal(0, 0.5, (2, 3)).astype(np.float32)
    centre = rng.uniform(0.2, 0.8, (n, 2)) * (w, h)
    speed = rng.uniform(-0.03, 0.03, (n, 2)) * (w, h)
    radii = rng.uniform(0.05, 0.3, (n, 2)) * (w, h)
    colour = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    present = rng.random((n, T)) >= absent
    present[np.arange(n), rng.integers(0, T, n)] = True      # in one frame at least
    ramp = (np.linspace(-1, 1, h, dtype=np.float32)[:, None, None] * gy
            + np.linspace(-1, 1, w, dtype=np.float32)[None, :, None] * gx + base)
    images = np.empty((T, h, w, 3), np.float32)
    label = np.zeros((T, h, w), np.int16)             # 1 + the instance on top, 0 none
    drawn = {}                                        # (k, t) → the ellipse's box
    for t in range(T):
        images[t] = ramp + np.float32(0.1 * t)
        for k in range(n):
            if not present[k, t]:
                continue
            (cx, cy), (rx, ry) = centre[k] + speed[k] * t, radii[k]
            y0, y1 = max(int(cy - ry), 0), min(int(cy + ry) + 1, h)
            x0, x1 = max(int(cx - rx), 0), min(int(cx + rx) + 1, w)
            if y0 >= y1 or x0 >= x1:
                continue
            yy = np.arange(y0, y1, dtype=np.float32)[:, None]
            xx = np.arange(x0, x1, dtype=np.float32)[None, :]
            inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
            np.copyto(label[t, y0:y1, x0:x1], k + 1, where=inside)
            np.copyto(images[t, y0:y1, x0:x1], colour[k], where=inside[..., None])
            drawn[k, t] = (y0, y1, x0, x1)
        tile = 0.1 * rng.standard_normal((97, 89, 3), dtype=np.float32)
        images[t] += np.tile(tile, (-(-h // 97), -(-w // 89), 1))[:h, :w]
    masks = np.zeros((n, T, h, w), np.uint8)
    boxes = np.zeros((n, T, 4), np.float32)
    area = np.zeros((n, T), np.int64)
    for (k, t), (y0, y1, x0, x1) in drawn.items():
        m = label[t, y0:y1, x0:x1] == k + 1
        ys, xs = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
        if len(ys):
            masks[k, t, y0:y1, x0:x1] = m
            area[k, t] = m.sum()
            bx0, bx1, by0, by1 = x0 + xs[0], x0 + xs[-1] + 1, y0 + ys[0], y0 + ys[-1] + 1
            boxes[k, t] = [(bx0 + bx1) / 2 / w, (by0 + by1) / 2 / h,
                           (bx1 - bx0) / w, (by1 - by0) / h]
    return {"images": images, "labels": rng.integers(0, classes, n).astype(np.int32),
            "boxes": boxes, "masks": masks, "valid": area > 2, "exists": np.ones(n, bool)}
