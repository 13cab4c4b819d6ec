"""COCO instance segmentation without pycocotools or OpenCV (port of
`devis_tpu/datasets/coco.py`; reference `src/datasets/coco.py`).

The annotation json is parsed here; images are decoded by `image_io`;
polygon segmentations are filled by OpenCV's rule in host C
(`csrc/poly.c`, `polygons_to_mask`; `polygons_to_mask_plain` is its Python
version), RLE ones decoded by the port's codec. Images without an
annotation are dropped, crowd annotations are skipped in the targets, labels
are shifted by -1 (reference coco.py:105), training samples go through the
multi-scale `ClipTransform` and validation samples through the fixed
resize.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..evaluation import _native
from ..evaluation import rle as rle_lib
from .image_io import read_image
from .transforms import (ClipTransform, get_size_with_aspect_ratio, normalize_sample,
                         resize_sample)


def _polygon_points(segmentation) -> List[np.ndarray]:
    """Float polygons rounded half to even to int (x, y) points, as the
    JAX package rounds them for cv2."""
    return [np.round(np.asarray(poly, np.float64).reshape(-1, 2)).astype(np.int64)
            for poly in segmentation]


def polygons_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygons, or RLE with string or list counts) →
    binary (h, w) uint8 mask."""
    if isinstance(segmentation, dict):
        return rle_lib.decode(segmentation)
    mask = np.zeros((h, w), np.uint8)
    _native.fill_poly(mask, _polygon_points(segmentation))
    return mask


# ---------------------------------------------------------------------------
# The plain version of the polygon fill (`csrc/poly.c` repeats it step by step)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, x0: int, y0: int, x1: int, y1: int) -> bool:
    return not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h)


def _line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's 8-connected LineIterator, left to right, clipped."""
    h, w = mask.shape
    if _outside(w, h, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        mask[y, x] = 1
        neg = err < 0
        err += -2 * dy + (2 * dx if neg else 0)
        if vert:
            y, x = y + sy, x + (sx if neg else 0)
        else:
            x, y = x + sx, y + (sy if neg else 0)


def _tdiv(a: int, b: int) -> int:
    """Integer division truncated toward zero, as in C."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def polygons_to_mask_plain(segmentation: Sequence, h: int, w: int) -> np.ndarray:
    """The Python version of the polygon fill of `polygons_to_mask` (the
    algorithm is described in `csrc/poly.c`)."""
    mask = np.zeros((h, w), np.uint8)
    edges = []                                          # [y0, y1, x, dx]
    for pts in _polygon_points(segmentation):
        pts = [(int(x), int(y)) for x, y in pts]
        if not pts:
            continue
        p0x, p0y = pts[-1][0] << _XY_SHIFT, pts[-1][1]
        for x, y in pts:
            p1x, p1y = x << _XY_SHIFT, y
            c0x, c0y, c1x, c1y = p0x, p0y, p1x, p1y
            t0x, t1x = (p0x + (_XY_ONE >> 1)) >> _XY_SHIFT, (p1x + (_XY_ONE >> 1)) >> _XY_SHIFT
            t0y, t1y = p0y, p1y
            _line8(mask, t0x, t0y, t1x, t1y)
            if _outside(w, h, t0x, t0y, t1x, t1y):
                _, t0x, t0y, t1x, t1y = _clip_line(w, h, t0x, t0y, t1x, t1y)
                if t0y != t1y:
                    c0y, c1y = t0y, t1y
                c0x, c1x = t0x << _XY_SHIFT, t1x << _XY_SHIFT
            if p0y != p1y:
                dx = _tdiv(c1x - c0x, c1y - c0y)
                if p0y < p1y:
                    edges.append([p0y, p1y, c0x + (p0y - c0y) * dx, dx])
                else:
                    edges.append([p1y, p0y, c1x + (p1y - c1y) * dx, dx])
            p0x, p0y = p1x, p1y
    _fill_edges_plain(mask, edges)
    return mask


def _fill_edges_plain(mask: np.ndarray, edges: List[List[int]]) -> None:
    h, w = mask.shape
    if len(edges) < 2:
        return
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    xs = [e[2] for e in edges] + ends
    y_max = max(e[1] for e in edges)
    if y_max < 0 or min(e[0] for e in edges) >= h or max(xs) < 0 \
            or min(xs) >= (w << _XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    total, i, active = len(edges), 0, []
    for y in range(edges[0][0], min(y_max, h)):
        k, draw, prev, nxt = 0, False, None, []
        while k < len(active) or (i < total and edges[i][0] == y):
            if k < len(active) and active[k][1] == y:      # the edge ends
                k += 1
                continue
            if k < len(active) and (i >= total or edges[i][0] > y
                                    or active[k][2] < edges[i][2]):
                cur, k = active[k], k + 1
            elif i < total and edges[i][0] == y:
                cur, i = edges[i], i + 1
            else:
                break
            nxt.append(cur)
            if draw:
                if y >= 0:
                    left, right = (cur, prev) if prev[2] > cur[2] else (prev, cur)
                    x1 = (left[2] + _XY_ONE - 1) >> _XY_SHIFT
                    x2 = right[2] >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1
                prev[2] += prev[3]
                cur[2] += cur[3]
            draw = not draw
            prev = cur
        nxt.extend(active[k:])
        for _ in range(len(nxt)):                           # bubble sort by x
            swapped = False
            for j in range(len(nxt) - 1):
                if nxt[j][2] > nxt[j + 1][2]:
                    nxt[j], nxt[j + 1] = nxt[j + 1], nxt[j]
                    swapped = True
            if not swapped:
                break
        active = nxt


# ---------------------------------------------------------------------------
# The dataset
# ---------------------------------------------------------------------------

class CocoDetection:
    """Image dataset over a COCO json; drops images without annotations
    (reference coco.py:17-52). A training set draws its augmentation from
    `rng`."""

    def __init__(self, img_folder: str, ann_file: str, train: bool,
                 scales=None, max_size: int = 1333, min_size_test: int = 800,
                 max_size_test: int = 1333, rng: Optional[random.Random] = None):
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.img_folder = img_folder
        self.train = train
        self.imgs = {im["id"]: im for im in self.coco["images"]}
        self.anns_by_img: Dict[int, List] = {}
        for ann in self.coco["annotations"]:
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.ids = [i for i in sorted(self.imgs) if self.anns_by_img.get(i)]
        scales = scales or [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]
        if train:
            if rng is None:
                raise ValueError("a training CocoDetection needs its random.Random")
            self.transform = ClipTransform(
                scales=scales, rng=rng, max_size=max_size,
                scales_before_crop=[400, 500, 600], crop_size=(384, 600),
                create_bbx_from_mask=False)
        else:
            self.min_size_test, self.max_size_test = min_size_test, max_size_test

    def __len__(self):
        return len(self.ids)

    def eval_hw(self, idx: int) -> Tuple[int, int]:
        """Post-resize (h, w) of val image `idx` from the json, without
        decoding it (lets the eval loop group images by canvas)."""
        if self.train:
            raise ValueError("eval_hw is for a validation set")
        info = self.imgs[self.ids[idx]]
        return get_size_with_aspect_ratio((info["height"], info["width"]),
                                          self.min_size_test, self.max_size_test)

    def gt_dict(self) -> Dict:
        """The full COCO annotation dict (for the evaluator)."""
        return self.coco

    def _load_image(self, info) -> np.ndarray:
        return read_image(os.path.join(self.img_folder, info["file_name"])).astype(np.float32)

    def get_sample(self, idx: int) -> Dict:
        """Raw sample: the image and its instance targets at the original
        resolution."""
        img_id = self.ids[idx]
        info = self.imgs[img_id]
        image = self._load_image(info)
        h, w = image.shape[:2]
        boxes, labels, masks = [], [], []
        for ann in self.anns_by_img[img_id]:
            if ann.get("iscrowd", 0):
                continue
            x, y, bw, bh = ann["bbox"]
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + bw, w), min(y + bh, h)
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(ann["category_id"] - 1)
            masks.append(polygons_to_mask(ann.get("segmentation", []), h, w))
        return {"image": image,
                "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                "labels": np.asarray(labels, np.int32),
                "masks": np.stack(masks) if masks else np.zeros((0, h, w), np.uint8),
                "valid": np.ones(len(boxes), bool),
                "image_id": img_id, "orig_size": (h, w)}

    def __getitem__(self, idx: int) -> Dict:
        sample = self.get_sample(idx)
        if self.train:
            out = self.transform([sample])[0]
        else:
            size = get_size_with_aspect_ratio(sample["image"].shape[:2], self.min_size_test,
                                              self.max_size_test)
            out = normalize_sample(resize_sample(sample, size))
        out["image_id"] = sample["image_id"]
        out["orig_size"] = sample["orig_size"]
        return out


COCO_PATHS = {
    "train": ("COCO/train2017", "COCO/annotations/instances_train2017.json", 91),
    "val": ("COCO/val2017", "COCO/annotations/instances_val2017.json", 91),
}


def build_coco(image_set: str, cfg):
    """(dataset, num_classes) of the COCO split `cfg` names for image_set
    'TRAIN' or 'VAL'; a split named 'synthetic*' gives the synthetic set."""
    split = cfg.DATASETS.TRAIN_DATASET if image_set == "TRAIN" else cfg.DATASETS.VAL_DATASET
    train = image_set == "TRAIN"
    if split.startswith("synthetic"):
        from .synthetic import SyntheticCocoDataset
        return SyntheticCocoDataset(train=train), 91
    img_dir, ann, num_classes = COCO_PATHS[split]
    root = cfg.DATASETS.DATA_PATH
    sf = cfg.INPUT.SCALE_FACTOR_TRAIN
    scales = [int(sf * s) for s in [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]]
    ds = CocoDetection(os.path.join(root, img_dir), os.path.join(root, ann), train=train,
                       scales=scales, max_size=int(sf * 1333),
                       min_size_test=cfg.INPUT.MIN_SIZE_TEST,
                       max_size_test=cfg.INPUT.MAX_SIZE_TEST,
                       rng=random.Random(cfg.SEED) if train else None)
    return ds, num_classes
