"""COCO→pseudo-video joint training (port of
`devis_tpu/datasets/coco_joint_vis.py`).

Behavioral equivalent of the reference's `CocoJointVIS`
(`src/datasets/coco_joint_vis.py:36-130`) + `ImageToSeqAugmenter`
(`src/datasets/image_to_seq_augmenter.py:14-90`): a still COCO image becomes a
T-frame clip by applying an independent random perspective/affine warp (+
brightness jitter and occasional motion blur) per frame, shuffling the frames,
recomputing boxes from the warped masks, remapping COCO→YouTube-VIS category
ids, and capping at 25 instances. The JAX package draws the augmentation
with cv2; the port repeats those five OpenCV functions in numpy
(`datasets/warp.py`). Every draw comes from the dataset's one
`random.Random`, in the JAX package's order (the augmenter's and the frame
shuffle's); `ClipTransform` has its own generator, seeded alike. The same
seed gives the JAX package's clips.

Category id maps are data taken from the reference
(`src/datasets/coco_joint_vis.py:23-31`).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from .coco import CocoDetection
from .transforms import ClipTransform, boxes_from_masks
from .warp import (filter2d, get_perspective_transform, get_rotation_matrix_2d,
                   warp_perspective_linear, warp_perspective_nearest)

COCO_TO_YT19_CATEGORY_MAP = {
    1: 1, 2: 21, 3: 6, 4: 21, 5: 28, 7: 17, 8: 29, 9: 34, 17: 14, 18: 8,
    19: 18, 21: 15, 22: 32, 23: 20, 24: 30, 25: 22, 36: 33, 41: 5, 42: 27,
    43: 40,
}
COCO_TO_YT21_CATEGORY_MAP = {
    1: 26, 2: 23, 3: 5, 4: 23, 5: 1, 7: 36, 8: 37, 9: 4, 16: 3, 17: 6,
    18: 9, 19: 19, 21: 7, 22: 12, 23: 2, 24: 40, 25: 18, 36: 31, 41: 29,
    42: 33, 43: 34, 74: 24,
}
MAX_NUM_INSTANCES = 25


class ImageToSeqAugmenter:
    """Random per-frame warp (perspective + affine) with photometric jitter,
    mirroring the reference augmenter's parameter ranges."""

    def __init__(self, rng: random.Random, perspective_magnitude: float = 0.08,
                 rotation_range=(-20, 20), translate_range=(-0.1, 0.1),
                 brightness_range=(-40, 40), motion_blur_prob: float = 0.25,
                 motion_blur_kernel_sizes=(9, 11)):
        self.rng = rng
        self.perspective_magnitude = perspective_magnitude
        self.rotation_range = rotation_range
        self.translate_range = translate_range
        self.brightness_range = brightness_range
        self.motion_blur_prob = motion_blur_prob
        self.motion_blur_kernel_sizes = motion_blur_kernel_sizes

    def _warp_matrix(self, h: int, w: int) -> np.ndarray:
        r = self.rng
        # perspective: jitter the 4 corners by ±magnitude of the image size
        m = self.perspective_magnitude
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = src + np.float32([[r.uniform(-m, m) * w, r.uniform(-m, m) * h]
                                for _ in range(4)])
        persp = get_perspective_transform(src, dst)
        # affine: rotation about the center + translation
        ang = r.uniform(*self.rotation_range)
        tx = r.uniform(*self.translate_range) * w
        ty = r.uniform(*self.translate_range) * h
        aff = get_rotation_matrix_2d((w / 2, h / 2), ang, 1.0)
        aff[0, 2] += tx
        aff[1, 2] += ty
        aff3 = np.vstack([aff, [0, 0, 1]]).astype(np.float32)
        return aff3 @ persp

    def __call__(self, image: np.ndarray, masks: np.ndarray):
        """image (H, W, 3) float32 [0..255]; masks (N, H, W) → warped pair."""
        h, w = image.shape[:2]
        mat = self._warp_matrix(h, w)
        img = warp_perspective_linear(image, mat, (w, h))
        warped_masks = np.stack([
            warp_perspective_nearest(m.astype(np.uint8), mat, (w, h))
            for m in masks]) if len(masks) else masks
        r = self.rng
        img = np.clip(img + r.uniform(*self.brightness_range), 0, 255)
        if r.random() < self.motion_blur_prob:
            k = r.choice(self.motion_blur_kernel_sizes)
            kernel = np.zeros((k, k), np.float32)
            ang = r.uniform(0, 180)
            c = (k - 1) / 2
            dx, dy = np.cos(np.deg2rad(ang)), np.sin(np.deg2rad(ang))
            for i in np.linspace(-c, c, k):
                kernel[int(round(c + i * dy)), int(round(c + i * dx))] = 1
            img = filter2d(img, kernel / kernel.sum())
        return img.astype(np.float32), warped_masks


class CocoJointVIS:
    """Pseudo-video clips from COCO stills, in the VIS train-sample layout
    ({images (T,H,W,3), labels (N,), boxes (N,T,4), masks, valid, exists})."""

    def __init__(self, img_folder: str, ann_file: str, num_frames: int,
                 category_map: Dict[int, int], scales=None,
                 max_size: int = 768, seed: int = 0,
                 scale_factor: float = 1.0):
        self.base = CocoDetection(img_folder, ann_file, train=False)
        self.num_frames = num_frames
        self.category_map = category_map
        self.rng = random.Random(seed)
        self.augmenter = ImageToSeqAugmenter(self.rng)
        scales = scales or [int(scale_factor * s)
                            for s in (288, 320, 352, 392, 416, 448, 480, 512)]
        self.transform = ClipTransform(scales=scales, rng=random.Random(seed),
                                       max_size=int(scale_factor * max_size),
                                       create_bbx_from_mask=True)
        # keep images whose (mapped) annotations fit the instance cap
        self.ids = []
        for i in range(len(self.base)):
            anns = self.base.anns_by_img.get(self.base.ids[i], [])
            mapped = [a for a in anns
                      if a["category_id"] in category_map
                      and not a.get("iscrowd", 0)]
            if 0 < len(mapped) <= MAX_NUM_INSTANCES:
                self.ids.append(i)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        sample = self.base.get_sample(self.ids[idx])
        # remap categories; drop instances outside the map
        keep = [i for i, lab in enumerate(sample["labels"])
                if int(lab) + 1 in self.category_map]
        labels = np.asarray([self.category_map[int(sample["labels"][i]) + 1] - 1
                             for i in keep], np.int32)
        masks = sample["masks"][keep]
        image = sample["image"]
        T = self.num_frames
        frames = [image]
        frame_masks = [masks]
        for _ in range(T - 1):
            img_t, m_t = self.augmenter(image, masks)
            frames.append(img_t)
            frame_masks.append(m_t)
        order = list(range(T))
        self.rng.shuffle(order)                     # reference L101
        frames = [frames[t] for t in order]
        frame_masks = [frame_masks[t] for t in order]

        clip = [{"image": frames[t],
                 "masks": frame_masks[t],
                 "labels": labels,
                 "boxes": boxes_from_masks(frame_masks[t]),   # abs xyxy
                 "valid": frame_masks[t].reshape(len(labels), -1).sum(-1) > 2}
                for t in range(T)]
        clip = self.transform(clip)
        h, w = clip[0]["image"].shape[:2]
        N = len(labels)
        images = np.stack([c["image"] for c in clip])
        boxes = np.stack([c["boxes"] for c in clip], axis=1) \
            if N else np.zeros((0, T, 4), np.float32)
        masks_out = np.stack([c["masks"] for c in clip], axis=1) \
            if N else np.zeros((0, T, h, w), np.uint8)
        valid = np.stack([c["valid"] for c in clip], axis=1) \
            if N else np.zeros((0, T), bool)
        return {"images": images, "labels": labels, "boxes": boxes,
                "masks": masks_out, "valid": valid,
                "exists": np.ones(N, bool), "video_id": -1}


