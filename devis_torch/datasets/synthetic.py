"""Synthetic datasets with exact ground truth (port of
`devis_tpu/datasets/synthetic.py`): moving rectangles and ellipses of seeded
colours, sizes and speeds. `SyntheticVISDataset` and `SyntheticCocoDataset`
are training sets (clips and still images with their targets);
`SyntheticVISValDataset` parses the videos into overlapping clips like a
YouTube-VIS validation video, with an in-memory YouTube-VIS GT dict for
TrackMAP. They back the `synthetic` splits of `build_vis` and `build_coco`;
nothing is downloaded.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..evaluation import rle as rle_lib
from .transforms import ValTransform, normalize_sample
from .vis import VideoClips


def _draw_instance(img, mask, kind, x, y, size, color):
    """Draws one shape into `img` and, unless it is None, into `mask`."""
    h, w = img.shape[:2]
    if kind == 0:
        y0, y1 = max(y, 0), min(y + size, h)
        x0, x1 = max(x, 0), min(x + size, w)
        if y1 > y0 and x1 > x0:
            img[y0:y1, x0:x1] = color
            if mask is not None:
                mask[y0:y1, x0:x1] = 1
    else:
        # only the ellipse's bounding window is rasterized
        a, b = size / 2 + 1e-6, size / 3 + 1e-6
        y0, y1 = max(int(np.floor(y - b)), 0), min(int(np.ceil(y + b)) + 1, h)
        x0, x1 = max(int(np.floor(x - a)), 0), min(int(np.ceil(x + a)) + 1, w)
        if y1 <= y0 or x1 <= x0:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]
        e = ((xx - x) / a) ** 2 + ((yy - y) / b) ** 2 <= 1
        img[y0:y1, x0:x1][e] = color
        if mask is not None:
            mask[y0:y1, x0:x1][e] = 1


class SyntheticVideo:
    """Deterministic video of `n_inst` moving shapes. Each frame is drawn
    once and kept, as a stand-in for a decoded frame: a second pass over the
    video pays for the frame resize, not the drawing."""

    def __init__(self, video_id: int, n_frames: int = 12, size=(180, 320),
                 n_inst: int = 3, seed: int = 0):
        self._frames: Dict[int, np.ndarray] = {}
        self.video_id = video_id
        self.n_frames = n_frames
        self.size = size
        rng = np.random.RandomState(seed + video_id)
        self.insts = []
        h, w = size
        for i in range(n_inst):
            self.insts.append(dict(
                kind=int(rng.randint(0, 2)),
                cat=int(rng.randint(1, 6)),
                x0=int(rng.randint(0, w // 2)), y0=int(rng.randint(0, h // 2)),
                vx=int(rng.randint(-4, 5)), vy=int(rng.randint(-3, 4)),
                sz=int(rng.randint(h // 6, h // 3)),
                color=rng.randint(64, 255, size=3).astype(np.float32)))

    def render(self, t: int):
        h, w = self.size
        img = np.full((h, w, 3), 30.0, np.float32)
        masks = []
        for inst in self.insts:
            m = np.zeros((h, w), np.uint8)
            _draw_instance(img, m, inst["kind"], inst["x0"] + t * inst["vx"],
                           inst["y0"] + t * inst["vy"], inst["sz"], inst["color"])
            masks.append(m)
        return img, masks

    def frame(self, t: int) -> np.ndarray:
        """The image of `render(t)`, drawn without the instance masks."""
        if t in self._frames:
            return self._frames[t]
        h, w = self.size
        img = np.full((h, w, 3), 30.0, np.float32)
        for inst in self.insts:
            _draw_instance(img, None, inst["kind"], inst["x0"] + t * inst["vx"],
                           inst["y0"] + t * inst["vy"], inst["sz"], inst["color"])
        self._frames[t] = img
        return img

    def gt_annotations(self) -> List[Dict]:
        """One YouTube-VIS annotation per instance; each frame is rendered
        once for all instances."""
        segs = [[] for _ in self.insts]
        areas = [[] for _ in self.insts]
        for t in range(self.n_frames):
            for i, m in enumerate(self.render(t)[1]):
                a = int(m.sum())
                segs[i].append(rle_lib.encode(m > 0) if a else None)
                areas[i].append(a if a else None)
        return [{"video_id": self.video_id, "category_id": inst["cat"],
                 "segmentations": segs[i], "areas": areas[i], "iscrowd": 0,
                 "id": self.video_id * 100 + i}
                for i, inst in enumerate(self.insts)]


class _SyntheticVideoClips(VideoClips):
    def __init__(self, video: SyntheticVideo, clips_idx: List[List[int]],
                 last_real_idx: int, real_video_length, transform):
        self.synthetic_video = video
        self.clips_idx = clips_idx
        super().__init__(video.video_id, "", [f"{t}.jpg" for t in
                                             range(video.n_frames)],
                         video.size, [[f"{t}.jpg" for t in c] for c in clips_idx],
                         last_real_idx, real_video_length, transform,
                         {i: f"cat{i}" for i in range(6)})

    def load_clip(self, idx: int) -> np.ndarray:
        frames = []
        for t in self.clips_idx[idx]:
            frames.append(self.transform(self.synthetic_video.frame(t)))
        return np.stack(frames)

    def read_frame(self, t: int) -> np.ndarray:
        """Frame `t` at its original size (float32 RGB, as drawn)."""
        return self.synthetic_video.frame(t)


class SyntheticVISDataset:
    """Training clips over synthetic videos: every start frame of every
    video, normalized frames, per-trajectory targets with boxes from the
    masks (cxcywh normalized)."""

    def __init__(self, num_frames: int = 6, n_videos: int = 4,
                 video_len: int = 12, size=(180, 320), seed: int = 0):
        self.num_frames = num_frames
        self.videos = [SyntheticVideo(i + 1, video_len, size, seed=seed)
                       for i in range(n_videos)]
        self.samples = [(v, s) for v in range(n_videos)
                        for s in range(video_len - num_frames + 1)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        vi, start = self.samples[idx]
        video = self.videos[vi]
        T = self.num_frames
        imgs, all_masks = [], []
        for t in range(start, start + T):
            img, masks = video.render(t)
            imgs.append(normalize_sample({"image": img})["image"])
            all_masks.append(masks)
        N = len(video.insts)
        h, w = video.size
        masks = np.stack([np.stack([all_masks[t][n] for t in range(T)])
                          for n in range(N)])                  # (N, T, H, W)
        boxes = np.zeros((N, T, 4), np.float32)
        for n in range(N):
            for t in range(T):
                ys, xs = np.nonzero(masks[n, t])
                if len(ys):
                    x0, x1 = xs.min(), xs.max() + 1
                    y0, y1 = ys.min(), ys.max() + 1
                    boxes[n, t] = [(x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                                   (x1 - x0) / w, (y1 - y0) / h]
        return {"images": np.stack(imgs),
                "labels": np.asarray([i["cat"] - 1 for i in video.insts], np.int32),
                "boxes": boxes, "masks": masks,
                "valid": masks.reshape(N, T, -1).sum(-1) > 2,
                "exists": np.ones(N, bool), "video_id": video.video_id}


class SyntheticVISValDataset:
    """Val-style dataset with in-memory YouTube-VIS GT for TrackMAP."""

    def __init__(self, num_frames: int = 6, stride: int = 4, n_videos: int = 3,
                 video_len: int = 12, size=(180, 320), min_size: int = 360,
                 max_size: int = 640, seed: int = 0, sizes=None,
                 n_inst: int = 3):
        """`sizes`: optional per-video (h, w) list cycled over the videos —
        mixed orientations exercise several eval canvas buckets; `n_inst`
        instances per video sizes the stitching problem."""
        self.max_clip_length = num_frames
        self.overlap_window = num_frames - stride
        self.has_gt = True
        transform = ValTransform(min_size, max_size)
        sizes = list(sizes) if sizes else [size]
        self.synthetic_videos = [
            SyntheticVideo(i + 1, video_len, sizes[i % len(sizes)],
                           n_inst=n_inst, seed=seed)
            for i in range(n_videos)]
        self.videos = []
        for v in self.synthetic_videos:
            idxs = list(range(v.n_frames))
            T = num_frames
            clips, last_real_idx, real_len = [], 0, None
            if v.n_frames <= T:
                clips.append((idxs + idxs[::-1][1:] * 3)[:T])
                real_len = v.n_frames
            else:
                clips.append(idxs[:T])
                start, end = stride, stride + T
                while end < v.n_frames:
                    clips.append(idxs[start:end])
                    start = end - self.overlap_window
                    end = start + T
                last_clip_start = v.n_frames - 1 - T
                last_real_idx = start - last_clip_start - 1
                clips.append(idxs[-T:])
            self.videos.append(_SyntheticVideoClips(v, clips, last_real_idx,
                                                    real_len, transform))
        self.cat_names = {i: f"cat{i}" for i in range(6)}

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx):
        return self.videos[idx]

    def get_total_num_frames(self):
        return sum(v.synthetic_video.n_frames for v in self.videos)

    def gt_dict(self) -> Dict:
        videos, annotations = [], []
        for v in self.synthetic_videos:
            h, w = v.size
            videos.append({"id": v.video_id, "height": h, "width": w,
                           "length": v.n_frames,
                           "file_names": [f"{v.video_id}/{t}.jpg"
                                          for t in range(v.n_frames)]})
            annotations.extend(v.gt_annotations())
        categories = [{"id": i, "name": f"cat{i}"} for i in range(1, 6)]
        return {"videos": videos, "annotations": annotations,
                "categories": categories}


class SyntheticCocoDataset:
    """Still synthetic scenes as a COCO-style image dataset, with its COCO
    GT dict for the evaluator; images come at their final size."""

    def __init__(self, train: bool = True, n_images: int = 8, size=(200, 280),
                 seed: int = 0):
        self.train = train
        self.size = size
        self.scenes = [SyntheticVideo(i + 1, 1, size, seed=seed) for i in range(n_images)]

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx: int) -> Dict:
        v = self.scenes[idx]
        img, masks = v.render(0)
        h, w = self.size
        boxes = np.zeros((len(masks), 4), np.float32)
        for n, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes[n] = [(xs.min() + xs.max() + 1) / 2 / w,
                            (ys.min() + ys.max() + 1) / 2 / h,
                            (xs.max() + 1 - xs.min()) / w,
                            (ys.max() + 1 - ys.min()) / h]
        return {"image": normalize_sample({"image": img})["image"],
                "labels": np.asarray([i["cat"] - 1 for i in v.insts], np.int32),
                "boxes": boxes, "masks": np.stack(masks),
                "valid": np.asarray([m.sum() > 2 for m in masks]),
                "image_id": idx, "orig_size": self.size}

    def eval_hw(self, idx: int):
        return self.size

    def gt_dict(self) -> Dict:
        h, w = self.size
        images, annotations = [], []
        aid = 0
        for idx, v in enumerate(self.scenes):
            images.append({"id": idx, "height": h, "width": w})
            for inst, m in zip(v.insts, v.render(0)[1]):
                ys, xs = np.nonzero(m)
                if not len(ys):
                    continue
                aid += 1
                annotations.append({
                    "id": aid, "image_id": idx, "category_id": inst["cat"],
                    "bbox": [float(xs.min()), float(ys.min()),
                             float(xs.max() + 1 - xs.min()), float(ys.max() + 1 - ys.min())],
                    "area": int(m.sum()), "iscrowd": 0,
                    "segmentation": rle_lib.encode(m > 0)})
        return {"images": images, "annotations": annotations,
                "categories": [{"id": c, "name": f"cat{c}"} for c in range(1, 6)]}
