"""COCO-panoptic dataset (port of `devis_tpu/datasets/coco_panoptic.py`;
reference `CocoPanoptic`, `src/datasets/coco_panoptic.py:14`).

Panoptic PNGs encode segment ids as R + G·256 + B·256²; each segment becomes
one instance with its mask and label, `iscrowd` carried through. Segment
PNGs are decoded by the port's own `decode_png`, images by `read_image`
(a `.png` file name in the json is read as its `.jpg`, as the reference
does).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .image_io import read_image
from .transforms import get_size_with_aspect_ratio, normalize_sample, resize_sample


def png_to_segment_ids(png_rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB → (H, W) int32 segment-id map."""
    p = png_rgb.astype(np.int32)
    return p[..., 0] + 256 * p[..., 1] + 256 * 256 * p[..., 2]


class CocoPanoptic:
    def __init__(self, img_folder: str, ann_folder: str, ann_file: str,
                 train: bool = False, min_size_test: int = 800,
                 max_size_test: int = 1333):
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.img_folder = img_folder
        self.ann_folder = ann_folder
        self.train = train
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test
        self.anns = self.coco["annotations"]
        self.imgs = {im["id"]: im for im in self.coco["images"]}

    def __len__(self):
        return len(self.anns)

    def gt_dict(self) -> Dict:
        return self.coco

    def _segment_ids(self, ann) -> np.ndarray:
        return png_to_segment_ids(read_image(os.path.join(self.ann_folder, ann["file_name"])))

    def gt_segmentation(self, idx: int):
        """(segment-id map (H, W) int32, segments_info list) for PQ eval."""
        ann = self.anns[idx]
        return self._segment_ids(ann), ann["segments_info"]

    def __getitem__(self, idx: int) -> Dict:
        ann = self.anns[idx]
        info = self.imgs[ann["image_id"]]
        img = read_image(os.path.join(self.img_folder, info["file_name"].replace(
            ".png", ".jpg"))).astype(np.float32)
        ids = self._segment_ids(ann)
        masks, labels, iscrowd = [], [], []
        for seg in ann["segments_info"]:
            masks.append((ids == seg["id"]).astype(np.uint8))
            labels.append(seg["category_id"] - 1)
            iscrowd.append(seg.get("iscrowd", 0))
        h, w = img.shape[:2]
        masks = np.stack(masks) if masks else np.zeros((0, h, w), np.uint8)
        boxes = np.zeros((len(masks), 4), np.float32)
        for i, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        sample = {"image": img, "boxes": boxes,
                  "labels": np.asarray(labels, np.int32),
                  "masks": masks,
                  "valid": masks.reshape(len(masks), -1).sum(-1) > 2}
        oh, ow = get_size_with_aspect_ratio(img.shape[:2], self.min_size_test,
                                            self.max_size_test)
        out = normalize_sample(resize_sample(sample, (oh, ow)))
        out["image_id"] = ann["image_id"]
        out["orig_size"] = (h, w)
        out["iscrowd"] = np.asarray(iscrowd, np.int32)
        return out


def build_coco_panoptic(image_set: str, cfg):
    """(dataset, 250) of `DATASETS.TYPE: coco_panoptic` for image_set 'TRAIN'
    or 'VAL'. The reference's layout (`src/datasets/coco_panoptic.py:79-99`):
    images under `<DATA_PATH>/COCO/{train,val}2017`, panoptic annotations
    under `<DATA_PATH>/coco_panoptic/panoptic_{split}2017[.json]`. 250 is the
    panoptic category-id space (DETR's convention; the ids run to 200)."""
    split = "train" if image_set == "TRAIN" else "val"
    root = cfg.DATASETS.DATA_PATH
    ann_root = os.path.join(root, "coco_panoptic")
    ds = CocoPanoptic(
        img_folder=os.path.join(root, "COCO", f"{split}2017"),
        ann_folder=os.path.join(ann_root, f"panoptic_{split}2017"),
        ann_file=os.path.join(ann_root, "annotations", f"panoptic_{split}2017.json"),
        train=image_set == "TRAIN",
        min_size_test=cfg.INPUT.MIN_SIZE_TEST,
        max_size_test=cfg.INPUT.MAX_SIZE_TEST)
    return ds, 250
