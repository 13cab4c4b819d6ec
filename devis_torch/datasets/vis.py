"""YouTube-VIS / OVIS video datasets (port of `devis_tpu/datasets/vis.py`;
reference `src/datasets/vis.py`).

`VISTrainDataset` samples a clip at every valid start frame (or at every
frame, with reflection padding for short videos, reference L38-76) and
returns per-trajectory targets padded by the collate to a fixed capacity:
labels (N,) 0-based, boxes (N, T, 4), valid (N, T), exists (N,), masks
(N, T, H, W). `VISValDataset` parses each validation video into overlapping
clips (`VideoClips`: stride T - overlap, short videos reflected, the last
clip anchored to the video's end with `last_real_idx`, reference L163-211).
Frames are decoded by `image_io`.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from .coco import polygons_to_mask
from .image_io import read_image
from .transforms import ClipTransform, ValTransform


class VISTrainDataset:
    """Clips of T frames with their trajectories' targets; the augmentation
    draws from `rng`."""

    def __init__(self, ann_file: str, img_folder: str, num_frames: int, rng: random.Random,
                 sample_each_frame: bool = False, scales=None, max_size: int = 768,
                 scale_factor: float = 1.0, create_bbx_from_mask: bool = True):
        with open(ann_file) as f:
            self.db = json.load(f)
        self.img_folder = img_folder
        self.num_frames = num_frames
        self.videos = {v["id"]: v for v in self.db["videos"]}
        self.anns_by_vid: Dict[int, List] = {}
        for ann in self.db["annotations"]:
            if not ann.get("iscrowd", 0):
                self.anns_by_vid.setdefault(ann["video_id"], []).append(ann)
        self.cat_ids = sorted(c["id"] for c in self.db["categories"])
        # clip start table (reference vis.py:38-53)
        self.samples: List[Tuple[int, int]] = []
        for vid_id, v in self.videos.items():
            length = v["length"]
            if sample_each_frame:
                self.samples.extend((vid_id, f) for f in range(length))
            elif length < num_frames:
                self.samples.append((vid_id, 0))
            else:
                self.samples.extend((vid_id, f) for f in range(length - num_frames + 1))
        scales = scales or [288, 320, 352, 392, 416, 448, 480, 512]
        self.transform = ClipTransform(
            scales=[int(scale_factor * s) for s in scales], rng=rng,
            max_size=int(scale_factor * max_size),
            scales_before_crop=[int(scale_factor * s) for s in (400, 500, 600)],
            crop_size=(int(scale_factor * 384), int(scale_factor * 600)),
            create_bbx_from_mask=create_bbx_from_mask)

    def __len__(self):
        return len(self.samples)

    def frame_indices(self, vid_id: int, frame_id: int) -> List[int]:
        """Frame indices of the clip starting at `frame_id`, reflected as
        the reference pads short videos (vis.py:62-76)."""
        length = self.videos[vid_id]["length"]
        idxs = list(range(frame_id, length))
        if len(idxs) >= self.num_frames:
            return idxs[:self.num_frames]
        fwd = list(range(length))
        while len(idxs) < self.num_frames:
            idxs.extend(fwd[::-1][1:])
            idxs.extend(fwd[1:])
        return idxs[:self.num_frames]

    def __getitem__(self, idx: int) -> Dict:
        vid_id, frame_id = self.samples[idx]
        video = self.videos[vid_id]
        anns = self.anns_by_vid.get(vid_id, [])
        frames = []
        for fi in self.frame_indices(vid_id, frame_id):
            img = read_image(os.path.join(self.img_folder,
                                          video["file_names"][fi])).astype(np.float32)
            h, w = img.shape[:2]
            boxes, masks, valid = [], [], []
            for ann in anns:
                bbox, segm = ann["bboxes"][fi], ann["segmentations"][fi]
                ok = bbox is not None and segm is not None
                if ok:
                    x, y, bw, bh = bbox
                    boxes.append([max(x, 0), max(y, 0), min(x + bw, w), min(y + bh, h)])
                    masks.append(polygons_to_mask(segm, h, w))
                else:
                    boxes.append([0, 0, 0, 0])
                    masks.append(np.zeros((h, w), np.uint8))
                valid.append(ok)
            frames.append({"image": img,
                           "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                           "masks": np.stack(masks) if masks else np.zeros((0, h, w), np.uint8),
                           "valid": np.asarray(valid, bool)})
        frames = self.transform(frames)
        T, N = self.num_frames, len(anns)
        h, w = frames[0]["image"].shape[:2]
        out = {
            "images": np.stack([f["image"] for f in frames]),
            "labels": np.asarray([a["category_id"] - 1 for a in anns], np.int32),
            "boxes": np.stack([f["boxes"] for f in frames], axis=1) if N
            else np.zeros((0, T, 4), np.float32),
            "masks": np.stack([f["masks"] for f in frames], axis=1) if N
            else np.zeros((0, T, h, w), np.uint8),
            "valid": np.stack([f["valid"] for f in frames], axis=1) if N
            else np.zeros((0, T), bool),
            "exists": np.ones(N, bool),
            "video_id": vid_id,
        }
        if N:       # 2 pixels or fewer leave a frame invalid (vis_transforms.py:197-242)
            out["valid"] = out["valid"] & (out["masks"].reshape(N, T, -1).sum(-1) > 2)
        return out


class VideoClips:
    """A validation video parsed into overlapping clips (reference
    `VideoClip`, vis.py:103-129). Clip `i` is the list of frame names
    `video_clips[i]`; the last clip is anchored to the end of the video, and
    `last_real_idx` is the first of its frames that no earlier clip covered;
    `real_video_length` is set for a video shorter than a clip (its clip
    repeats frames)."""

    def __init__(self, video_id: int, images_folder: str, file_names: List[str],
                 original_size: Tuple[int, int], clips: List[List[str]],
                 last_real_idx: int, real_video_length: Optional[int],
                 transform: ValTransform, cat_names: Dict[int, str]):
        self.video_id = video_id
        self.images_folder = images_folder
        self.file_names = file_names
        self.original_size = original_size
        self.video_clips = clips
        self.last_real_idx = last_real_idx
        self.real_video_length = real_video_length
        self.final_video_length = len(file_names)
        self.transform = transform
        self.cat_names = cat_names

    def __len__(self):
        return len(self.video_clips)

    @property
    def video_name(self) -> str:
        """YouTube-VIS folder name of the video (file names are
        '<hash>/00000.jpg'; reference viz_utils.py:154)."""
        first = self.file_names[0]
        return first.split("/")[0] if "/" in first else str(self.video_id)

    def read_frame(self, t: int) -> np.ndarray:
        """Frame `t` of the video at its original size, RGB uint8."""
        return read_image(os.path.join(self.images_folder, self.file_names[t]))

    def load_clip(self, idx: int) -> np.ndarray:
        """(T, h, w, 3) uint8 frames of clip `idx`, resized by the transform."""
        return np.stack([self.transform(read_image(os.path.join(self.images_folder, name)))
                         for name in self.video_clips[idx]])


class VISValDataset:
    """Validation videos of a YouTube-VIS json, each parsed into clips."""

    def __init__(self, ann_file: str, images_folder: str, max_clip_length: int,
                 stride: int, min_size: int = 360, max_size: int = 640):
        with open(ann_file) as f:
            self.annotations = json.load(f)
        self.max_clip_length = max_clip_length
        self.overlap_window = max_clip_length - stride
        self.has_gt = bool(self.annotations.get("annotations"))
        self.cat_names = {c["id"]: c["name"] for c in self.annotations["categories"]}
        self.cat_names[0] = "Bkg"
        transform = ValTransform(min_size, max_size)
        self.videos = [self._parse_video(v, images_folder, transform)
                       for v in self.annotations["videos"]]

    def _parse_video(self, video, images_folder, transform) -> VideoClips:
        T = self.max_clip_length
        names = video["file_names"]
        length = video["length"]
        clips: List[List[str]] = []
        last_real_idx = 0
        real_video_length = None
        if length < T:
            padded = list(names)
            j = 1
            while len(padded) < T:
                padded.extend(names[::-1][1:] if j % 2 else names[1:])
                j += 1
            clips.append(padded[:T])
            real_video_length = length
        elif length == T:
            clips.append(names[:T])
        else:
            clips.append(names[:T])
            start = T - self.overlap_window
            end = start + T
            while end < length:
                clips.append(names[start:end])
                start = end - self.overlap_window
                end = start + T
            last_real_idx = start - (len(names) - 1 - T) - 1
            clips.append(names[-T:])
        return VideoClips(video["id"], images_folder, names, (video["height"], video["width"]),
                          clips, last_real_idx, real_video_length, transform, self.cat_names)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int) -> VideoClips:
        return self.videos[idx]

    def get_total_num_frames(self) -> int:
        return sum(v["length"] for v in self.annotations["videos"])


VIS_PATHS = {
    "yt_vis_train_19": ("Youtube_VIS-2019/train/JPEGImages",
                        "Youtube_VIS-2019/train/train.json", 40),
    "yt_vis_val_19": ("Youtube_VIS-2019/valid/JPEGImages",
                      "Youtube_VIS-2019/valid/valid.json", 40),
    "yt_vis_train_21": ("Youtube_VIS-2021/train/JPEGImages",
                        "Youtube_VIS-2021/train/instances.json", 40),
    "yt_vis_train_21_wo_2975_2359": (
        "Youtube_VIS-2021/train/JPEGImages",
        "Youtube_VIS-2021/train/instances_wo_2975_2359.json", 40),
    "yt_vis_val_21": ("Youtube_VIS-2021/valid/JPEGImages",
                      "Youtube_VIS-2021/valid/instances.json", 40),
    "yt_vis_val_long": ("Youtube_VIS-long/valid/JPEGImages",
                        "Youtube_VIS-long/valid/instances.json", 40),
    "ovis_train": ("OVIS/train", "OVIS/annotations_train.json", 25),
    "ovis_val": ("OVIS/valid", "OVIS/annotations_valid.json", 25),
    "mini_train": ("Youtube_VIS/train/JPEGImages", "Youtube_VIS/train/mini_train.json", 40),
    "mini_val": ("Youtube_VIS/valid/JPEGImages", "Youtube_VIS/valid/mini_valid.json", 40),
}


class ConcatDataset:
    """The datasets one after another (reference datasets/__init__.py:43)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._lens = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx: int):
        for d, n in zip(self.datasets, self._lens):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)


def build_vis(image_set: str, cfg):
    """(dataset, num_classes) of the video split `cfg` names for image_set
    'TRAIN' or 'VAL'; a split named 'synthetic*' gives the synthetic set."""
    split = cfg.DATASETS.TRAIN_DATASET if image_set == "TRAIN" else cfg.DATASETS.VAL_DATASET
    T = cfg.MODEL.DEVIS.NUM_FRAMES
    if split.startswith("synthetic"):
        from .synthetic import SyntheticVISDataset, SyntheticVISValDataset
        if image_set == "TRAIN":
            return SyntheticVISDataset(num_frames=T), 40
        return SyntheticVISValDataset(num_frames=T, stride=cfg.TEST.CLIP_TRACKING.STRIDE,
                                      min_size=cfg.INPUT.MIN_SIZE_TEST,
                                      max_size=cfg.INPUT.MAX_SIZE_TEST), 40
    img_dir, ann, num_classes = VIS_PATHS[split]
    root = cfg.DATASETS.DATA_PATH
    if image_set != "TRAIN":
        return VISValDataset(os.path.join(root, ann), os.path.join(root, img_dir),
                             max_clip_length=T, stride=cfg.TEST.CLIP_TRACKING.STRIDE,
                             min_size=cfg.INPUT.MIN_SIZE_TEST,
                             max_size=cfg.INPUT.MAX_SIZE_TEST), num_classes
    if cfg.DATASETS.DEVIS.COCO_JOINT_TRAINING:
        raise NotImplementedError("COCO_JOINT_TRAINING (coco_joint_vis) is ROADMAP.md "
                                  "queue A item 3 of the port")
    return VISTrainDataset(os.path.join(root, ann), os.path.join(root, img_dir),
                           num_frames=T, rng=random.Random(cfg.SEED),
                           sample_each_frame=cfg.INPUT.DEVIS.SAMPLE_EACH_FRAME,
                           scale_factor=cfg.INPUT.SCALE_FACTOR_TRAIN,
                           create_bbx_from_mask=cfg.INPUT.DEVIS.CREATE_BBX_FROM_MASK
                           ), num_classes
