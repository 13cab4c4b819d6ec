"""Dataset dispatch and static-shape collation (port of
`devis_tpu/datasets/__init__.py`).

`build_dataset` follows the reference (`src/datasets/__init__.py:28-46`).
The collate functions turn ragged host samples into padded arrays of fixed
capacity (canvas-bucketed images, capped instance slots with validity
masks), the batches `engine.make_train_step` takes as they come; masks are
resized to the canvas's /4 grid by OpenCV's INTER_NEAREST rule. `TrainLoader`
shuffles with `np.random.RandomState(seed + epoch)` as the JAX loader does,
and one thread builds the next batches while the step runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import local_batch_size, shard_items
from ..util import trace
from .transforms import resize_nearest_numpy


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_canvas(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w), else (h, w) rounded up to 64."""
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return round_up(h, 64), round_up(w, 64)


def make_buckets(scales: Sequence[int], max_size: int) -> List[Tuple[int, int]]:
    """Two orientation buckets covering the multi-scale training range."""
    s = round_up(max(scales), 64)
    m = round_up(max_size, 64)
    return [(s, m), (m, s)] if m != s else [(s, s)]


def _small_masks(masks: np.ndarray, h: int, w: int, mask_stride: int) -> np.ndarray:
    """(..., h, w) masks to float32 at (round(h / stride), round(w / stride))."""
    mh, mw = max(round(h / mask_stride), 1), max(round(w / mask_stride), 1)
    lead = masks.shape[:-2]
    flat = np.asarray(masks, np.float32).reshape((-1, h, w)).transpose(1, 2, 0)
    small = resize_nearest_numpy(flat, (mh, mw)).transpose(2, 0, 1)
    return small.reshape(lead + (mh, mw))


def collate_images(samples: List[Dict], canvas: Tuple[int, int],
                   max_instances: int, mask_stride: int = 4) -> Dict:
    """Image samples → images (B, H, W, 3), pad_mask (B, H, W), sizes (B, 2)
    and targets {labels, boxes (normalized to the unpadded image), valid}
    padded to `max_instances` slots, masks at canvas / mask_stride."""
    B = len(samples)
    H, W = canvas
    N = max_instances
    images = np.zeros((B, H, W, 3), np.float32)
    pad_mask = np.ones((B, H, W), bool)
    labels = np.zeros((B, N), np.int32)
    boxes = np.full((B, N, 4), 0.5, np.float32)
    valid = np.zeros((B, N), bool)
    masks = np.zeros((B, N, H // mask_stride, W // mask_stride), np.float32)
    sizes = np.zeros((B, 2), np.int32)
    for b, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[b, :h, :w] = s["image"]
        pad_mask[b, :h, :w] = False
        sizes[b] = (h, w)
        n = min(len(s["labels"]), N)
        if n:
            labels[b, :n] = s["labels"][:n]
            boxes[b, :n] = s["boxes"][:n]
            valid[b, :n] = s["valid"][:n]
            if "masks" in s and len(s["masks"]):
                small = _small_masks(s["masks"][:n], h, w, mask_stride)
                masks[b, :n, :small.shape[1], :small.shape[2]] = small
    return {"images": images, "pad_mask": pad_mask, "sizes": sizes,
            "targets": {"labels": labels, "boxes": boxes, "valid": valid,
                        "masks": masks}}


def collate_clip(sample: Dict, canvas: Tuple[int, int], max_instances: int,
                 mask_stride: int = 4) -> Dict:
    """One clip sample → images (T, H, W, 3), pad_mask (T, H, W), sizes (2,)
    and targets {labels (N,), boxes (N, T, 4), valid (N, T), exists (N,),
    masks (N, T, H / stride, W / stride)} padded to `max_instances`."""
    T = sample["images"].shape[0]
    H, W = canvas
    N = max_instances
    h, w = sample["images"].shape[1:3]
    images = np.zeros((T, H, W, 3), np.float32)
    pad_mask = np.ones((T, H, W), bool)
    images[:, :h, :w] = sample["images"]
    pad_mask[:, :h, :w] = False
    labels = np.zeros((N,), np.int32)
    boxes = np.full((N, T, 4), 0.5, np.float32)
    valid = np.zeros((N, T), bool)
    exists = np.zeros((N,), bool)
    masks = np.zeros((N, T, H // mask_stride, W // mask_stride), np.float32)
    n = min(len(sample["labels"]), N)
    if n:
        labels[:n] = sample["labels"][:n]
        boxes[:n] = sample["boxes"][:n]
        valid[:n] = sample["valid"][:n]
        exists[:n] = sample["exists"][:n]
        small = _small_masks(sample["masks"][:n], h, w, mask_stride)
        masks[:n, :, :small.shape[2], :small.shape[3]] = small
    return {"images": images, "pad_mask": pad_mask, "sizes": np.asarray([h, w]),
            "targets": {"labels": labels, "boxes": boxes, "valid": valid,
                        "exists": exists, "masks": masks}}


def _stack(items: List[Dict]) -> Dict:
    return {k: _stack([it[k] for it in items]) if isinstance(items[0][k], dict)
            else np.stack([it[k] for it in items]) for k in items[0]}


class TrainLoader:
    """Padded training batches, epoch by epoch (the reference's DataLoader
    with its sampler, `main.py:142-158`). The order of an epoch is
    `np.random.RandomState(seed + epoch)`'s shuffle; the last partial batch
    is dropped unless `drop_last` is false. One thread builds up to
    `prefetch` batches ahead of the consumer (each in the span
    `loader.batch`); an error there is raised in the consumer. Clip
    batches (`vis`) stack `collate_clip` of each sample.
    `max_batches` cuts every epoch to its first batches (smoke runs): the
    batches after them are never built, so a dataset's augmentation draws
    for exactly the batches that were taken. With `world` > 1 the batch is
    global: every rank draws all of its samples, in the same order from the
    same seed, picks the canvas over all of them, and collates its share,
    items rank, rank + world, ... (`parallel.shard_items`)."""

    def __init__(self, dataset, batch_size: int, vis: bool,
                 buckets: Sequence[Tuple[int, int]], max_instances: int = 25,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, max_batches: Optional[int] = None,
                 rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.vis = vis
        self.buckets = list(buckets)
        self.max_instances = max_instances
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.max_batches = max_batches
        self.rank, self.world = rank, world
        local_batch_size(batch_size, world)           # the world divides the batch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        n = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return n if self.max_batches is None else min(n, self.max_batches)

    def batch_indices(self) -> List[np.ndarray]:
        """The dataset indices of each batch of the current epoch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        batches = [order[i:i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches[:self.max_batches]

    def make_batch(self, idxs) -> Dict:
        samples = [self.dataset[int(i)] for i in idxs]
        key = "images" if self.vis else "image"
        hw = [s[key].shape[-3:-1] for s in samples]
        canvas = pick_canvas(max(h for h, _ in hw), max(w for _, w in hw), self.buckets)
        samples = shard_items(samples, self.rank, self.world)
        if self.vis:
            return _stack([collate_clip(s, canvas, self.max_instances) for s in samples])
        return collate_images(samples, canvas, self.max_instances)

    def __iter__(self):
        batches = self.batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    with trace.span("loader.batch"):
                        batch = self.make_batch(b)
                    if not put(("batch", batch)):
                        return
            except Exception as e:  # noqa: BLE001 - re-raised in the consumer
                put(("error", e))
                return
            put(("done", done))

        thread = threading.Thread(target=worker, daemon=True, name="TrainLoader")
        thread.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "error":
                    raise item
                if kind == "done":
                    return
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)


def build_dataset(image_set: str, cfg):
    """(dataset, num_classes) of `cfg` for image_set 'TRAIN' or 'VAL'
    (reference datasets/__init__.py:28-46)."""
    if cfg.DATASETS.TYPE == "vis":
        from .vis import build_vis
        return build_vis(image_set, cfg)
    if cfg.DATASETS.TYPE == "coco_panoptic":
        from .coco_panoptic import build_coco_panoptic
        return build_coco_panoptic(image_set, cfg)
    from .coco import build_coco
    return build_coco(image_set, cfg)
