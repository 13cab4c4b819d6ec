"""A validation video parsed into overlapping clips (port of `VideoClips`,
`devis_tpu/datasets/vis.py`; reference `VideoClip`, vis.py:103-129): what
`VISInferFn.prepare`, the tracker and `inference_vis` read of a video."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .transforms import ValTransform


class VideoClips:
    """Clip `i` is the list of frame names `video_clips[i]`; the last clip is
    anchored to the end of the video, and `last_real_idx` is the first of
    its frames that no earlier clip covered; `real_video_length` is set for
    a video shorter than a clip (its clip repeats frames)."""

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

    def read_frame(self, name: str) -> np.ndarray:
        raise NotImplementedError(
            "decoding frame files needs the port's cv2-free decode path "
            "(ROADMAP.md queue A item 3); subclasses that make their frames "
            "override load_clip")

    def load_clip(self, idx: int) -> np.ndarray:
        """(T, h, w, 3) uint8 frames of clip `idx`, resized by the transform."""
        return np.stack([self.transform(self.read_frame(name))
                         for name in self.video_clips[idx]])
