"""Per-instance track of the near-online clip tracker (port of
`devis_tpu/tracking/track.py`; reference `Track`, `src/models/tracker.py:13-216`):
per-frame scores, masks, categories, boxes and centroids with validity flags;
on an overlap frame the higher-scoring detection stays; a mask that leaves
the stitching window is run-length encoded (reference L129-138).

A mask entry is an RLE dict, a full-resolution probability map, or a
`SmallMask`: the model's logits at stride 4 and the video's size. Soft-IoU
stitching reads its probabilities at stride 4; the full-resolution RLE
(bilinear resize of the logits, threshold at logit > 0, i.e. p > 0.5;
reference devis_segmentation.py:119-133 and tracker.py:239-260) is made only
for frames that survive into a track, on a background pool where the tracker
passes one (a `concurrent.futures.Future` stands in until then).
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datasets.transforms import resize_linear_f32
from ..evaluation import rle as rle_lib

ATTRS = ("scores", "masks", "categories", "boxes", "centroid_points")


class SmallMask:
    """Deferred full-resolution mask (see module docstring). `logits` is an
    (hv, wv) array, or a CPU tensor (`VISInferFn.fetch` returns float8
    e4m3 logits, whose upcast to float32 is exact)."""
    __slots__ = ("logits", "tgt_size", "_probs")

    def __init__(self, logits, tgt_size):
        self.logits = logits          # (hv, wv) at the model's stride
        self.tgt_size = tgt_size      # (H, W) of the video
        self._probs = None

    def logits_f32(self) -> np.ndarray:
        x = self.logits
        if isinstance(x, torch.Tensor):
            return x.float().numpy()
        return np.asarray(x, np.float32)

    @property
    def probs(self) -> np.ndarray:
        """Sigmoid probabilities at stride 4 (soft-IoU input)."""
        if self._probs is None:
            self._probs = 1.0 / (1.0 + np.exp(-self.logits_f32()))
        return self._probs

    def to_rle(self) -> Dict:
        """Full-resolution RLE: the logits resized bilinearly to the video's
        size as OpenCV's INTER_LINEAR does (bit-exact), thresholded at
        logit > 0."""
        return rle_lib.encode(resize_linear_f32(self.logits_f32(), tuple(self.tgt_size)) > 0)


def encode_mask(mask) -> Dict:
    """Any mask form → RLE dict (reference L219-223 thresholds probs at 0.5)."""
    if isinstance(mask, dict):
        return mask
    if isinstance(mask, Future):
        return mask.result()
    if isinstance(mask, SmallMask):
        return mask.to_rle()
    return rle_lib.encode(np.asarray(mask) > 0.5)


def mask_probs(mask) -> np.ndarray:
    """Probability-map view of a mask entry (soft-IoU input)."""
    if isinstance(mask, SmallMask):
        return mask.probs
    return np.asarray(mask, np.float32)


class Track:
    def __init__(self, track_id: int, track_length: int, start_idx: int = 0):
        self._id = track_id
        self.length = track_length
        self.start_idx = start_idx
        self.scores: List[Optional[float]] = [None] * track_length
        self.masks: List = [None] * track_length
        self.categories: List[Optional[int]] = [None] * track_length
        self.boxes: List = [None] * track_length
        self.centroid_points: List = [None] * track_length
        self.valid_frames: List[bool] = [True] * track_length
        self.mask_id: Optional[int] = None
        self.last_t = 0
        # (video track id, clip track id) of every stitch: the track
        # renders' matches.txt (reference tracker.py:27,105)
        self.matching_ids_record: List = []

    def __len__(self):
        return self.length

    def get_id(self) -> int:
        return self._id

    def valid(self, min_detections: int = 1) -> bool:
        return sum(self.valid_frames) >= min_detections

    def update(self, scores, categories, boxes, masks, centroid_points, mask_id):
        """Fill a clip track from model outputs (reference L38-44)."""
        self.scores = [float(s) for s in scores]
        self.categories = [int(c) for c in categories]
        self.boxes = [np.asarray(b) for b in boxes]
        self.centroid_points = [np.asarray(c) for c in centroid_points]
        self.mask_id = mask_id
        self.masks = list(masks)

    # -- accessors over the stitching windows (reference L65-84) ------------
    def get_last_t_result(self, t: int, attr: str):
        return getattr(self, attr)[self.last_t + t]

    def get_last_results(self, t_window: int, attr: str):
        return getattr(self, attr)[self.last_t - t_window:self.last_t]

    def get_first_t_result(self, t: int, attr: str):
        return getattr(self, attr)[self.start_idx + t]

    def get_first_results(self, t_window: int, attr: str):
        return getattr(self, attr)[self.start_idx:self.start_idx + t_window]

    def get_results_to_append(self, t: int, attr: str):
        return getattr(self, attr)[self.start_idx + t:]

    def get_mask_id(self):
        return self.mask_id

    # -- lifecycle ----------------------------------------------------------
    def init_video_track(self, num_t: int, clip_track: "Track"):
        for attr in ATTRS:
            getattr(self, attr)[:num_t] = getattr(clip_track, attr)
        self.mask_id = clip_track.mask_id

    def add_video_track(self, t_window: int, clip_track: "Track"):
        """Start a fresh video track mid-video (reference L86-96)."""
        start_idx = self.last_t - t_window - clip_track.start_idx
        for i in range(start_idx):
            self.valid_frames[i] = False
        for attr in ATTRS:
            results = getattr(clip_track, attr)
            getattr(self, attr)[start_idx:start_idx + len(results)] = results
        self.mask_id = clip_track.mask_id

    def kill_track(self):
        for i in range(self.last_t, self.length):
            self.valid_frames[i] = False
        self.encode_all_masks()

    def append_track(self, clip_track: "Track", t_window: int):
        """Stitch a matched clip track: overlap frames keep the
        higher-scoring detection, then the new frames are appended
        (reference L103-124)."""
        self.matching_ids_record.append((self._id, clip_track.get_id()))
        overlap_positions = range(
            self.last_t - t_window - clip_track.start_idx, self.last_t)
        for other_pos, self_pos in enumerate(overlap_positions):
            other_score = clip_track.scores[other_pos] or 0
            self_score = self.scores[self_pos] or 0
            if other_score > self_score:
                for attr in ATTRS:
                    getattr(self, attr)[self_pos] = getattr(clip_track, attr)[other_pos]
        for attr in ATTRS:
            results = clip_track.get_results_to_append(t_window, attr)
            getattr(self, attr)[self.last_t:self.last_t + len(results)] = results
        self.mask_id = clip_track.mask_id

    def update_stride(self, stride: int):
        self.last_t += stride

    def update_stride_and_encode_masks(self, stride: int, overlap_window: int,
                                       encoder=None):
        """Advance the clock; RLE-encode masks leaving the overlap window
        (reference L129-138). With an `encoder` executor the full-res
        resize+RLE runs on background threads (a Future stands in)."""
        for idx in range(self.last_t - overlap_window,
                         self.last_t - overlap_window + stride):
            if 0 <= idx < len(self.masks):
                m = self.masks[idx]
                if m is None:
                    self.valid_frames[idx] = False
                elif not isinstance(m, (dict, Future)):
                    self.masks[idx] = (encoder.submit(encode_mask, m)
                                       if encoder is not None
                                       else encode_mask(m))
        self.last_t += stride

    def encode_all_masks(self):
        for t in range(self.length):
            if self.masks[t] is not None:
                self.masks[t] = encode_mask(self.masks[t])

    # -- final results (reference L140-195) ---------------------------------
    def filter_frame_detections(self, min_detection_score: float):
        for idx, score in enumerate(self.scores):
            if score is not None and score < min_detection_score:
                self.valid_frames[idx] = False

    def _valid_scores(self):
        return [s for v, s in zip(self.valid_frames, self.scores) if v and s is not None]

    def compute_final_score(self, policy: str) -> float:
        scores = self._valid_scores()
        if not scores:
            return 0.0
        if policy == "mean":
            return float(np.mean(scores))
        if policy == "median":
            return float(np.median(scores))
        raise ValueError(f"unknown score policy {policy}")

    def mean_score(self) -> float:
        """Mean of the valid frames' scores (reference L59-63; the per-clip
        renders' folder names)."""
        return self.compute_final_score("mean")

    def compute_final_category(self, policy: str) -> int:
        if policy == "most_common":
            cats = np.array([c for v, c in zip(self.valid_frames, self.categories)
                             if v and c is not None])
            return int(np.argmax(np.bincount(cats)))
        if policy == "score_weighting":
            acc: Dict[int, float] = {}
            for v, s, c in zip(self.valid_frames, self.scores, self.categories):
                if v and c is not None:
                    acc[c] = acc.get(c, 0.0) + (s or 0.0)
            return max(acc.items(), key=lambda kv: kv[1])[0]
        raise ValueError(f"unknown category policy {policy}")

    def get_formatted_result(self, video_id, category_policy: str,
                             score_policy: str) -> Dict:
        segmentations = [m if v else None
                         for v, m in zip(self.valid_frames, self.masks)]
        return {"video_id": int(video_id),
                "score": self.compute_final_score(score_policy),
                "category_id": int(self.compute_final_category(category_policy)),
                "segmentations": segmentations}
