"""Near-online multi-cue clip tracker (port of
`devis_tpu/tracking/tracker.py`; reference `Tracker`,
`src/models/tracker.py:226-462`): each video's overlapping clips go through
the model; the first clip seeds the video's tracks; every later clip is
stitched on by the Hungarian inference matcher (over all tracks, or per
category with kill and spawn); masks that leave the overlap window are run-
length encoded; the final tracks are filtered by score and detections and
formatted for YouTube-VIS's results.json.

The device step (`infer_fn`) returns fixed shapes: scores, labels, boxes and
centres of the top-k trajectories, and mask logits at stride 4. The host
keeps masks at stride 4 as `SmallMask`s: soft-IoU stitching reads their
probabilities, and the full-resolution resize and RLE run on a background
pool, only for frames that survive into a track. Loading, dispatch, fetch
and stitching overlap as pipeline stages (`ClipPipeline`).

`TEST.VIZ` renders tracks (`util/visualization.py`): each clip's tracks
after the score filters (`SAVE_CLIP_VIZ`), and the final tracks of a video,
merged on its frames (`SAVE_MERGED_TRACKS`) or a folder a track, under
`OUT_VIZ_PATH`.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np

from .inference_matcher import HungarianInferenceMatcher
from .pipeline import ClipPipeline
from .track import SmallMask, Track


def process_boxes_host(boxes_cxcywh: np.ndarray, tgt_size) -> np.ndarray:
    """Normalized cxcywh → absolute xyxy clamped to the image
    (reference devis_segmentation.py:119-127)."""
    h, w = tgt_size
    cx, cy, bw, bh = np.moveaxis(boxes_cxcywh, -1, 0)
    out = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=-1)
    out = out * np.asarray([w, h, w, h], dtype=out.dtype)
    out[..., 0::2] = np.clip(out[..., 0::2], 0, w)
    out[..., 1::2] = np.clip(out[..., 1::2], 0, h)
    return out


class Tracker:
    def __init__(self, infer_fn: Callable, hungarian_matcher: HungarianInferenceMatcher,
                 tracker_cfg: Dict, num_frames: int, overlap_window: int,
                 visualization_cfg: Optional[Dict] = None):
        """infer_fn(clip) → dict of numpy arrays with keys
        scores (T, K), labels (K,), boxes (T, K, 4) normalized cxcywh,
        center_points (T, K, 2), mask_logits (Nm, T, h, w) at model stride,
        mask_gather (K,) row of mask_logits per detection, plus
        valid_hw = (h_valid, w_valid) of the un-padded region of mask_logits."""
        self.infer_fn = infer_fn
        self.matcher = hungarian_matcher
        self.cfg = SimpleNamespace(**tracker_cfg)
        self.num_frames = num_frames
        self.overlap_window = overlap_window
        # TEST.VIZ (reference models/__init__.py:96-100)
        self.viz = SimpleNamespace(**{
            **dict(out_viz_path="", save_clip_viz=False, merge_tracks=False),
            **(visualization_cfg or {})})
        # cumulative timed-path split (result-wait vs stitch) for benchmarks
        self.wait_time = 0.0
        self.stitch_time = 0.0
        # A pipeline shared across videos (`inference_vis` enqueues every
        # video up front); when unset, __call__ makes one for its video.
        self.pipeline: Optional[ClipPipeline] = None
        # lazy persistent RLE encode pool (threads spawn on first use)
        self._encode_pool = None

    def _encoder(self):
        if self._encode_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._encode_pool = ThreadPoolExecutor(max_workers=2)
        return self._encode_pool

    # -- mask post-processing (reference L239-260) --------------------------
    def _process_masks(self, tgt_size, logits, valid_hw) -> List:
        """logits: (T, h, w) model-stride mask logits for one trajectory.

        Soft-IoU mode returns `SmallMask` wrappers (zero host work here):
        the stitcher reads /4 probs and the full-res resize+RLE happens
        lazily, only for frames that survive into a track. Binary-RLE mode
        needs exact full-res RLEs at match time, so it materializes them
        immediately (reference semantics: resize logits, threshold at 0)."""
        T = logits.shape[0]
        hv, wv = valid_hw
        out = []
        for t in range(T):
            m = SmallMask(logits[t, :hv, :wv], tgt_size)
            if self.matcher.use_binary_mask_iou:
                out.append(m.to_rle())
            else:
                out.append(m)
        return out

    def __call__(self, video, all_times: Optional[List] = None):
        real_len = video.real_video_length
        clip_length = (self.num_frames if real_len is None
                       or real_len >= self.num_frames else real_len)
        video_tracks = None
        times = []

        track_counter = 0
        cats_dict: Dict[int, List[int]] = {}
        num_clips = len(video)

        # Loading, dispatch, fetch and stitching overlap (ClipPipeline): clip
        # i + 2 loads on a loader thread, clip i + 1 is uploaded and enqueued
        # on the dispatch thread, clip i's outputs are fetched on the fetch
        # thread, and this thread stitches clip i - 1 meanwhile; full-
        # resolution RLEs are made on the encode pool. The reference runs
        # these serially (tracker.py:296-462).
        pipe = self.pipeline
        owns_pipe = pipe is None
        if owns_pipe:
            pipe = ClipPipeline(self.infer_fn)
            pipe.add_video(video)

        for clip_idx in range(num_clips):
            t0 = time.time()
            results = pipe.next()
            times.append(time.time() - t0)
            self.wait_time += times[-1]

            scores = results["scores"][:clip_length]
            labels = results["labels"] + 1                 # category ids 1-based
            boxes = process_boxes_host(results["boxes"][:clip_length],
                                       video.original_size)
            centers = results["center_points"][:clip_length]
            mask_logits = results["mask_logits"]
            mask_gather = results["mask_gather"]
            K = scores.shape[1]

            is_last = clip_idx == num_clips - 1
            start_idx = video.last_real_idx if is_last else 0
            clip_tracks = [Track(i, clip_length, start_idx) for i in range(K)]
            clip_cats: Dict[int, List[int]] = {}

            processed: Dict[int, List] = {}
            for i, track in enumerate(clip_tracks):
                mid = int(mask_gather[i])
                if mid not in processed:
                    processed[mid] = self._process_masks(
                        video.original_size, mask_logits[mid][:clip_length],
                        results["valid_hw"])
                cat = int(labels[i])
                clip_cats.setdefault(cat, []).append(i)
                track.update(scores[:, i], [cat] * clip_length, boxes[:, i],
                             processed[mid], centers[:, i], mid)

            if self.viz.save_clip_viz and self.viz.out_viz_path:
                self.visualize_clip_results(video, clip_tracks, clip_idx, clip_length)

            t1 = time.time()
            if video_tracks is None:
                # First clip seeds the video tracks (reference L350-363).
                track_counter += K - 1
                video_tracks = [Track(i, video.final_video_length, start_idx)
                                for i in range(K)]
                for new_track in clip_tracks:
                    cat = new_track.categories[0]
                    cats_dict.setdefault(cat, []).append(new_track.get_id())
                    video_tracks[new_track.get_id()].init_video_track(
                        clip_length, new_track)
                for tr in video_tracks:
                    tr.update_stride(clip_length)
            elif not self.cfg.per_class_matching:
                ids1, ids2 = self.matcher(video_tracks, clip_tracks)
                for p1, p2 in zip(ids1, ids2):
                    video_tracks[p1].append_track(clip_tracks[p2],
                                                  self.overlap_window)
                for tr in video_tracks:
                    tr.update_stride_and_encode_masks(
                        clip_length - self.overlap_window, self.overlap_window,
                        encoder=self._encoder())
            else:
                self._per_class_stitch(video, video_tracks, clip_tracks,
                                       cats_dict, clip_cats,
                                       lambda: track_counter)
                track_counter = self._track_counter
                stride = clip_length - self.overlap_window
                for tr in video_tracks:
                    tr.update_stride_and_encode_masks(stride, self.overlap_window,
                                                      encoder=self._encoder())
            times.append(time.time() - t1)
            self.stitch_time += times[-1]

        if owns_pipe:
            pipe.close()
        if all_times is not None:
            all_times.append(sum(times))

        # -- final filtering (reference L434-448) ---------------------------
        if self.cfg.track_min_detection_score != 0:
            for tr in video_tracks:
                tr.filter_frame_detections(self.cfg.track_min_detection_score)
        video_tracks = [tr for tr in video_tracks
                        if tr.valid(self.cfg.track_min_detections)]
        if self.cfg.track_min_score != 0:
            video_tracks = [
                tr for tr in video_tracks
                if tr.compute_final_score(self.cfg.final_score_policy)
                > self.cfg.track_min_score]
        for tr in video_tracks:
            tr.encode_all_masks()

        if self.viz.out_viz_path:
            # reference tracker.py:450-458: merged overlays, or a folder a
            # track (with matches.txt), per video
            from ..util.visualization import (visualize_results_merged,
                                              visualize_tracks_independently)
            render = (visualize_results_merged if self.viz.merge_tracks
                      else visualize_tracks_independently)
            render(video, video_tracks, self.cfg.final_class_policy,
                   self.cfg.final_score_policy, self.viz.out_viz_path,
                   class_names=getattr(video, "cat_names", None))

        return [tr.get_formatted_result(video.video_id,
                                        self.cfg.final_class_policy,
                                        self.cfg.final_score_policy)
                for tr in video_tracks]

    def visualize_clip_results(self, video, clip_tracks, clip_idx: int, clip_length: int):
        """Each clip's surviving tracks, a folder a track (reference
        tracker.py:262-279): copy, apply the score filters, encode the
        masks, draw."""
        import copy

        from ..util.visualization import visualize_clips_after_processing
        shows = copy.deepcopy(clip_tracks)
        if self.cfg.track_min_detection_score != 0:
            for tr in shows:
                tr.filter_frame_detections(self.cfg.track_min_detection_score)
        shows = [tr for tr in shows if tr.valid(min_detections=1)]
        if self.cfg.track_min_score != 0:
            shows = [tr for tr in shows if tr.mean_score() > self.cfg.track_min_score]
        for tr in shows:
            tr.encode_all_masks()
        visualize_clips_after_processing(
            clip_idx, video, video.video_clips[clip_idx][:clip_length], shows,
            out_path=self.viz.out_viz_path, class_names=getattr(video, "cat_names", None))

    # -- per-class stitching with kill/spawn (reference L376-427) -----------
    def _per_class_stitch(self, video, video_tracks, clip_tracks, cats_dict,
                          clip_cats, counter_fn):
        self._track_counter = counter_fn()

        def add_new(cat, ids):
            for cid in ids:
                self._track_counter += 1
                t = Track(self._track_counter, video.final_video_length, 0)
                t.update_stride(video_tracks[0].last_t)
                t.add_video_track(self.overlap_window, clip_tracks[cid])
                video_tracks.append(t)
                cats_dict.setdefault(cat, []).append(t.get_id())

        for cat in set(list(cats_dict.keys()) + list(clip_cats.keys())):
            vids = cats_dict.get(cat, [])
            clips = clip_cats.get(cat, [])
            if not clips:
                for vid in vids:
                    video_tracks[vid].kill_track()
                del cats_dict[cat]
            elif not vids:
                add_new(cat, clips)
            else:
                v_tracks = [video_tracks[i] for i in vids]
                c_tracks = [clip_tracks[i] for i in clips]
                m1, m2 = self.matcher(v_tracks, c_tracks)
                matched_v = [vids[i] for i in m1]
                matched_c = [clips[i] for i in m2]
                for p1, p2 in zip(matched_v, matched_c):
                    video_tracks[p1].append_track(clip_tracks[p2],
                                                  self.overlap_window)
                for vid in set(vids) - set(matched_v):
                    video_tracks[vid].kill_track()
                    cats_dict[cat].remove(vid)
                add_new(cat, sorted(set(clips) - set(matched_c)))
