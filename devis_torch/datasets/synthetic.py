"""Synthetic validation videos with exact ground truth (port of the
evaluation half of `devis_tpu/datasets/synthetic.py`): moving rectangles and
ellipses of seeded colours, sizes and speeds, parsed into overlapping clips
like a YouTube-VIS validation video, with an in-memory YouTube-VIS GT dict
for TrackMAP. The tracker's tests and the e2e phase of `chip_smoke.py` run
on them; nothing is downloaded.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..evaluation import rle as rle_lib
from .transforms import ValTransform
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
