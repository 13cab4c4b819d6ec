"""Seeded dataset trees on disk, in the layouts `build_coco` and `build_vis`
read (`DATASETS.DATA_PATH`), written as PNG so that neither Pillow nor a YAML
library is needed to read them back. The tests and `chip_smoke.py` run the
CLI (`devis_torch.main`) on them.

COCO (`write_coco_tree`): `COCO/{train2017,val2017}/*.png` and
`COCO/annotations/instances_{train,val}2017.json`. Each image holds seeded
rectangles and ellipses; an instance is annotated as a polygon (its
outline's corners), an RLE with string counts, or an RLE with list counts,
in turn, and one instance an image is a crowd (iscrowd 1, RLE). The last
training image has no annotation (the dataset drops it).

YouTube-VIS 2019 (`write_vis_tree`): `Youtube_VIS-2019/{train,valid}/
JPEGImages/<video>/<frame>.png` with `train/train.json` and
`valid/valid.json`, RLE segmentations and `null` where an instance has left
the frame (each video's last instance is absent from its first frames).
YouTube-VIS 2021 (`version="2021"`): the same under `Youtube_VIS-2021/`, with
`{train,valid}/instances.json` (`datasets/vis.py`'s `yt_vis_*_21`); its
validation videos can be given names (the visualization config's
`TEST.VIZ.VIDEO_NAMES`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..datasets.image_io import encode_png
from ..evaluation import rle as rle_lib

COCO_CATEGORIES = (1, 3, 18, 44, 62, 90)        # ids from the 91-slot COCO table
VIS_CATEGORIES = tuple(range(1, 41))


def _shape(rs: np.random.RandomState, h: int, w: int):
    """(kind, y0, x0, y1, x1) of a seeded rectangle or ellipse."""
    bh, bw = rs.randint(h // 8, h // 3), rs.randint(w // 8, w // 3)
    y0, x0 = rs.randint(0, h - bh), rs.randint(0, w - bw)
    return int(rs.randint(0, 2)), y0, x0, y0 + bh, x0 + bw


def _mask_of(kind: int, y0: int, x0: int, y1: int, x1: int, h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    if kind == 0:
        m[y0:y1, x0:x1] = 1
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx, ry, rx = (y0 + y1) / 2, (x0 + x1) / 2, (y1 - y0) / 2, (x1 - x0) / 2
        m[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 1
    return m


def _background(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    base = rs.randint(0, 255, 3)
    img = np.stack([(xx * 255 // max(w - 1, 1) + base[0]) % 256,
                    (yy * 255 // max(h - 1, 1) + base[1]) % 256,
                    np.full((h, w), base[2])], -1)
    return (img + rs.randint(0, 12, (h, w, 3))).clip(0, 255).astype(np.uint8)


def _bbox(m: np.ndarray) -> List[float]:
    ys, xs = np.nonzero(m)
    return [float(xs.min()), float(ys.min()), float(xs.max() + 1 - xs.min()),
            float(ys.max() + 1 - ys.min())]


def _write_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type=1, level=1))


def _coco_split(root: str, split: str, sizes: Sequence[Tuple[int, int]], n: int,
                rs: np.random.RandomState, empty_last: bool) -> None:
    images, annotations = [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = _background(rs, h, w)
        image_id = 1000 + i
        images.append({"id": image_id, "file_name": f"{image_id:012d}.png",
                       "height": h, "width": w})
        n_obj = 0 if (empty_last and i == n - 1) else 4
        for k in range(n_obj):
            kind, y0, x0, y1, x1 = _shape(rs, h, w)
            m = _mask_of(kind, y0, x0, y1, x1, h, w)
            img[m > 0] = rs.randint(0, 255, 3)
            crowd = int(k == n_obj - 1)
            if k % 3 == 0 and not crowd:       # the outline's corners (rectangle or box)
                seg = [[float(x0), float(y0), float(x1 - 1), float(y0),
                        float(x1 - 1), float(y1 - 1), float(x0), float(y1 - 1)]]
            elif k % 3 == 1 and not crowd:
                counts = rle_lib.counts_of(rle_lib.encode(m > 0))
                seg = {"size": [h, w], "counts": [int(c) for c in counts]}
            else:
                seg = rle_lib.encode(m > 0)
            annotations.append({"id": len(annotations) + 1, "image_id": image_id,
                                "category_id": int(COCO_CATEGORIES[rs.randint(
                                    len(COCO_CATEGORIES))]),
                                "bbox": _bbox(m), "area": float(m.sum()), "iscrowd": crowd,
                                "segmentation": seg})
        _write_png(os.path.join(root, "COCO", f"{split}2017", images[-1]["file_name"]), img)
    ann_dir = os.path.join(root, "COCO", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    with open(os.path.join(ann_dir, f"instances_{split}2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"cat{c}"} for c in COCO_CATEGORIES]}, f)


def write_coco_tree(root: str, seed: int = 0, n_train: int = 4, n_val: int = 4,
                    sizes: Sequence[Tuple[int, int]] = ((480, 640), (640, 480))) -> str:
    """Writes the COCO tree under `root`; returns `root`."""
    rs = np.random.RandomState(seed)
    _coco_split(root, "train", sizes, n_train, rs, empty_last=True)
    _coco_split(root, "val", sizes, n_val, rs, empty_last=False)
    return root


def _vis_split(root: str, folder: str, split: str, json_name: str, n_videos: int,
               n_frames: int, size: Tuple[int, int], rs: np.random.RandomState, first_id: int,
               video_names: Optional[Sequence[str]] = None) -> None:
    h, w = size
    base = os.path.join(root, folder, split)
    videos, annotations = [], []
    for v in range(n_videos):
        vid = first_id + v
        name = video_names[v] if video_names else f"{vid:010x}"
        n_inst = 3
        tracks = []
        for k in range(n_inst):
            kind, y0, x0, y1, x1 = _shape(rs, h, w)
            tracks.append((kind, y0, x0, y1 - y0, x1 - x0, rs.randint(-6, 7), rs.randint(-4, 5),
                           rs.randint(0, 255, 3), int(VIS_CATEGORIES[rs.randint(40)])))
        segs: List[List] = [[] for _ in range(n_inst)]
        boxes: List[List] = [[] for _ in range(n_inst)]
        areas: List[List] = [[] for _ in range(n_inst)]
        names = []
        for t in range(n_frames):
            img = _background(rs, h, w)
            for k, (kind, y0, x0, bh, bw, vy, vx, colour, _) in enumerate(tracks):
                yy, xx = int(np.clip(y0 + vy * t, 0, h - bh)), int(np.clip(x0 + vx * t, 0, w - bw))
                m = _mask_of(kind, yy, xx, yy + bh, xx + bw, h, w)
                present = not (k == n_inst - 1 and t < 2) and m.any()
                if present:
                    img[m > 0] = colour
                segs[k].append(rle_lib.encode(m > 0) if present else None)
                boxes[k].append(_bbox(m) if present else None)
                areas[k].append(float(m.sum()) if present else None)
            names.append(f"{name}/{t:05d}.png")
            _write_png(os.path.join(base, "JPEGImages", names[-1]), img)
        videos.append({"id": vid, "height": h, "width": w, "length": n_frames,
                       "file_names": names})
        for k, track in enumerate(tracks):
            annotations.append({"id": len(annotations) + 1, "video_id": vid,
                                "category_id": track[-1], "segmentations": segs[k],
                                "bboxes": boxes[k], "areas": areas[k], "iscrowd": 0})
    with open(os.path.join(base, json_name), "w") as f:
        json.dump({"videos": videos, "annotations": annotations,
                   "categories": [{"id": c, "name": f"cat{c}"} for c in VIS_CATEGORIES]}, f)


VIS_TREES = {"2019": ("Youtube_VIS-2019", "train.json", "valid.json"),
             "2021": ("Youtube_VIS-2021", "instances.json", "instances.json")}


def write_vis_tree(root: str, seed: int = 0, n_train: int = 2, n_val: int = 2,
                   n_frames: int = 12, size: Tuple[int, int] = (360, 640),
                   version: str = "2019", val_names: Optional[Sequence[str]] = None) -> str:
    """Writes the YouTube-VIS tree of `version` (2019 or 2021, `VIS_TREES`)
    under `root`; the validation videos take `val_names` (one a video) where
    given, else their id in hex. Returns `root`."""
    folder, train_json, val_json = VIS_TREES[version]
    if val_names is not None and len(val_names) != n_val:
        raise ValueError(f"{len(val_names)} names for {n_val} validation videos")
    rs = np.random.RandomState(seed)
    _vis_split(root, folder, "train", train_json, n_train, n_frames, size, rs, 1)
    _vis_split(root, folder, "valid", val_json, n_val, n_frames, size, rs, 1 + n_train,
               val_names)
    return root


def tree_summary(root: str) -> Dict[str, int]:
    """Files and bytes under `root`."""
    n, size = 0, 0
    for d, _, files in os.walk(root):
        for f in files:
            n += 1
            size += os.path.getsize(os.path.join(d, f))
    return {"files": n, "bytes": size}
