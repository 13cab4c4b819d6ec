"""Clip-stitching Hungarian matcher on the host (port of
`devis_tpu/tracking/inference_matcher.py`; reference
`HungarianInferenceMatcher`, `src/models/matcher.py:229-394`): over the
overlap window, cost = −mask IoU·w (volumetric soft IoU by default; binary
RLE IoU or the per-frame average as options) − class equality·w
+ |score difference|·w + centre distance·w, solved exactly by the port's
assignment (`ops/hungarian.py`) in place of scipy's.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..evaluation import rle as rle_lib
from ..ops.hungarian import lsa_numpy
from .track import mask_probs


class HungarianInferenceMatcher:
    def __init__(self, overlap_window: int = 2, cost_class: float = 2,
                 cost_mask_iou: float = 6, score_cost: float = 2,
                 center_distance_cost: float = 0,
                 use_frame_average_iou: bool = False,
                 use_binary_mask_iou: bool = False):
        self.overlap_w = overlap_window
        self.class_cost = cost_class
        self.mask_iou_cost = cost_mask_iou
        self.score_cost = score_cost
        self.center_distance_cost = center_distance_cost
        self.use_frame_average_iou = use_frame_average_iou
        self.use_binary_mask_iou = use_binary_mask_iou

    # -- individual cost terms (reference L241-307) -------------------------
    def compute_class_cost(self, tracks1: List, tracks2: List) -> np.ndarray:
        per_t = []
        for t in range(self.overlap_w):
            c1 = [tr.get_last_t_result(-self.overlap_w + t, "categories")
                  for tr in tracks1]
            c2 = [tr.get_first_t_result(t, "categories") for tr in tracks2]
            per_t.append(np.asarray(
                [[float(a == b) for b in c2] for a in c1], dtype=np.float32))
        return np.stack(per_t).mean(0)

    def compute_score_cost(self, tracks1: List, tracks2: List) -> np.ndarray:
        per_t = []
        for t in range(self.overlap_w):
            s1 = [tr.get_last_t_result(-self.overlap_w + t, "scores") or 0.0
                  for tr in tracks1]
            s2 = [tr.get_first_t_result(t, "scores") or 0.0 for tr in tracks2]
            per_t.append(np.abs(np.asarray(s1)[:, None] - np.asarray(s2)[None, :]))
        return np.stack(per_t).mean(0).astype(np.float32)

    def compute_center_distance_cost(self, tracks1: List, tracks2: List) -> np.ndarray:
        per_t = []
        for t in range(self.overlap_w):
            p1 = [np.asarray(tr.get_last_t_result(-self.overlap_w + t,
                                                  "centroid_points"))
                  for tr in tracks1]
            p2 = [np.asarray(tr.get_first_t_result(t, "centroid_points"))
                  for tr in tracks2]
            m = np.zeros((len(p1), len(p2)), np.float32)
            for i, a in enumerate(p1):
                for j, b in enumerate(p2):
                    m[i, j] = float(np.abs(a - b).mean())
            per_t.append(m)
        return np.stack(per_t).mean(0)

    @staticmethod
    def _binary_track_iou(masks1, masks2) -> float:
        """Volumetric RLE IoU over aligned frame lists (reference L323-338)."""
        inter = union = 0.0
        for d, g in zip(masks1, masks2):
            if d is not None and g is not None:
                inter += rle_lib.area(rle_lib.merge([d, g], intersect=True))
                union += rle_lib.area(rle_lib.merge([d, g], intersect=False))
            elif g is not None:
                union += rle_lib.area(g)
            elif d is not None:
                union += rle_lib.area(d)
        return inter / union if union > 0 else 0.0

    @staticmethod
    def _soft_track_iou(masks1, masks2) -> float:
        m1 = np.stack([mask_probs(m) for m in masks1])
        m2 = np.stack([mask_probs(m) for m in masks2])
        return rle_lib.soft_iou(m1, m2)

    def compute_volumetric_iou_cost(self, tracks1: List, tracks2: List) -> np.ndarray:
        ious = np.zeros((len(tracks1), len(tracks2)))
        m1 = [tr.get_last_results(self.overlap_w, "masks") for tr in tracks1]
        m2 = [tr.get_first_results(self.overlap_w, "masks") for tr in tracks2]
        if not self.use_binary_mask_iou:
            batched = self._soft_track_iou_batch(m1, m2)
            if batched is not None:
                return batched
        id1 = [tr.get_mask_id() for tr in tracks1]
        id2 = [tr.get_mask_id() for tr in tracks2]
        fn = self._binary_track_iou if self.use_binary_mask_iou else self._soft_track_iou
        cache = {}
        for i in range(len(tracks1)):
            for j in range(len(tracks2)):
                key = (id1[i], id2[j])
                if key not in cache or id1[i] is None or id2[j] is None:
                    cache[key] = fn(m1[i], m2[j])
                ious[i, j] = cache[key]
        return ious

    @staticmethod
    def _soft_track_iou_batch(m1: List, m2: List):
        """All-pairs volumetric soft IoU in one matrix product: each track's
        overlap-window probability masks (at stride 4 for `SmallMask`
        entries) flattened to a vector f; inter[i, j] = f1_i·f2_j and union
        = Σf1_i + Σf2_j − inter (the arithmetic of `soft_iou`). None when a
        mask is not a probability array of one shape (an RLE already):
        callers then take the pairwise route."""
        try:
            F1 = np.stack([np.concatenate(
                [mask_probs(m).ravel() for m in ms]) for ms in m1])
            F2 = np.stack([np.concatenate(
                [mask_probs(m).ravel() for m in ms]) for ms in m2])
        except (ValueError, TypeError):
            return None
        if F1.shape[1] != F2.shape[1]:
            return None
        inter = F1 @ F2.T
        union = F1.sum(1)[:, None] + F2.sum(1)[None, :] - inter
        return (inter / np.maximum(union, 1e-6)).astype(np.float64)

    def compute_frame_average_iou_cost(self, tracks1: List, tracks2: List) -> np.ndarray:
        per_t = []
        for t in range(self.overlap_w):
            a = [tr.get_last_t_result(-self.overlap_w + t, "masks") for tr in tracks1]
            b = [tr.get_first_t_result(t, "masks") for tr in tracks2]
            if self.use_binary_mask_iou:
                m = rle_lib.iou(a, b)
            else:
                m = np.zeros((len(a), len(b)))
                for i in range(len(a)):
                    for j in range(len(b)):
                        m[i, j] = rle_lib.soft_iou(mask_probs(a[i]),
                                                   mask_probs(b[j]))
            per_t.append(m)
        return np.stack(per_t).mean(0)

    def __call__(self, tracks1: List, tracks2: List):
        if self.use_frame_average_iou:
            iou = self.compute_frame_average_iou_cost(tracks1, tracks2)
        else:
            iou = self.compute_volumetric_iou_cost(tracks1, tracks2)
        cost = -iou * self.mask_iou_cost
        if self.class_cost:
            cost = cost - self.compute_class_cost(tracks1, tracks2) * self.class_cost
        if self.score_cost:
            cost = cost + self.compute_score_cost(tracks1, tracks2) * self.score_cost
        if self.center_distance_cost:
            cost = cost + self.compute_center_distance_cost(
                tracks1, tracks2) * self.center_distance_cost
        return linear_sum_assignment(cost)


def linear_sum_assignment(cost: np.ndarray):
    """(row_ind, col_ind) of a minimum-cost assignment, as scipy returns
    them: rows ascending, min(n_rows, n_cols) pairs. `lsa_numpy` takes
    n_rows <= n_cols, so a cost with more rows (more video tracks than clip
    tracks) is solved transposed and mapped back. Where several assignments
    tie, the one chosen may differ from scipy's."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    if n <= m:
        return np.arange(n), lsa_numpy(cost)
    rows = lsa_numpy(cost.T)
    order = np.argsort(rows)
    return rows[order], np.arange(m)[order]


def build_inference_matcher(cfg) -> HungarianInferenceMatcher:
    """The clip-stitch matcher of `cfg.TEST.CLIP_TRACKING` (reference
    `build_inference_matcher`)."""
    ct = cfg.TEST.CLIP_TRACKING
    return HungarianInferenceMatcher(
        cost_mask_iou=ct.MASK_COST, cost_class=ct.CLASS_COST, score_cost=ct.SCORE_COST,
        center_distance_cost=ct.CENTER_COST,
        overlap_window=cfg.MODEL.DEVIS.NUM_FRAMES - ct.STRIDE,
        use_binary_mask_iou=ct.USE_BINARY_MASK_IOU,
        use_frame_average_iou=ct.USE_FRAME_AVERAGE_IOU)
