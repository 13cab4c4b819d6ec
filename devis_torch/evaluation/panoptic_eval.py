"""Panoptic Quality (PQ) evaluation (port of
`devis_tpu/evaluation/panoptic_eval.py`; reference `PanopticEvaluator`,
`src/datasets/panoptic_eval.py:12`, backed by the panopticapi
`pq_compute`). Standard PQ: segments match when
IoU > 0.5; PQ = Σ IoU(TP) / (|TP| + |FP|/2 + |FN|/2), reported overall and
split by things/stuff.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _segment_areas(ids: np.ndarray):
    uniq, counts = np.unique(ids, return_counts=True)
    return dict(zip(uniq.tolist(), counts.tolist()))


def pq_compute_single(gt_ids: np.ndarray, gt_segments: Sequence[Dict],
                      pred_ids: np.ndarray, pred_segments: Sequence[Dict],
                      void_id: int = 0):
    """Per-image stats {cat: [iou_sum, tp, fp, fn]} (panopticapi semantics:
    crowd GT segments are excluded from matching; unmatched predictions
    mostly covered by void/crowd don't count as FP)."""
    gt_info = {s["id"]: s for s in gt_segments}
    pred_info = {s["id"]: s for s in pred_segments}
    gt_areas = _segment_areas(gt_ids)
    pred_areas = _segment_areas(pred_ids)

    # intersections via combined key
    comb = gt_ids.astype(np.int64) * (1 << 32) + pred_ids.astype(np.int64)
    uniq, counts = np.unique(comb, return_counts=True)
    inter = {(int(k >> 32), int(k & 0xFFFFFFFF)): int(c)
             for k, c in zip(uniq, counts)}

    stats: Dict[int, List[float]] = {}

    def stat(cat):
        return stats.setdefault(cat, [0.0, 0, 0, 0])

    matched_gt, matched_pred = set(), set()
    for (gid, pid), i in inter.items():
        if gid not in gt_info or pid not in pred_info:
            continue
        g, p = gt_info[gid], pred_info[pid]
        if g.get("iscrowd", 0) or g["category_id"] != p["category_id"]:
            continue
        union = (gt_areas[gid] + pred_areas[pid] - i
                 - inter.get((void_id, pid), 0))
        iou = i / union if union > 0 else 0.0
        if iou > 0.5:
            s = stat(g["category_id"])
            s[0] += iou
            s[1] += 1
            matched_gt.add(gid)
            matched_pred.add(pid)

    crowd_by_cat = {}
    for gid, g in gt_info.items():
        if g.get("iscrowd", 0):
            crowd_by_cat[g["category_id"]] = gid
            continue
        if gid not in matched_gt:
            stat(g["category_id"])[3] += 1                       # FN
    for pid, p in pred_info.items():
        if pid in matched_pred:
            continue
        # ignore predictions mostly covered by void + same-class crowd
        ignore = inter.get((void_id, pid), 0)
        crowd_gid = crowd_by_cat.get(p["category_id"])
        if crowd_gid is not None:
            ignore += inter.get((crowd_gid, pid), 0)
        if ignore / max(pred_areas.get(pid, 1), 1) > 0.5:
            continue
        stat(p["category_id"])[2] += 1                           # FP
    return stats


class PanopticEvaluator:
    """Accumulates per-image PQ stats and summarizes PQ/SQ/RQ."""

    def __init__(self, categories: Sequence[Dict]):
        self.things = {c["id"] for c in categories if c.get("isthing", 1)}
        self.stats: Dict[int, List[float]] = {}

    def update(self, gt_ids, gt_segments, pred_ids, pred_segments):
        for cat, (iou, tp, fp, fn) in pq_compute_single(
                gt_ids, gt_segments, pred_ids, pred_segments).items():
            s = self.stats.setdefault(cat, [0.0, 0, 0, 0])
            s[0] += iou
            s[1] += tp
            s[2] += fp
            s[3] += fn

    def summarize(self) -> Dict[str, float]:
        def agg(cats):
            pq = sq = rq = n = 0
            for c in cats:
                iou, tp, fp, fn = self.stats.get(c, [0.0, 0, 0, 0])
                if tp + fp + fn == 0:
                    continue
                n += 1
                pq += iou / (tp + 0.5 * fp + 0.5 * fn)
                sq += iou / tp if tp else 0.0
                rq += tp / (tp + 0.5 * fp + 0.5 * fn)
            return {k: 100 * v / max(n, 1) for k, v in
                    (("PQ", pq), ("SQ", sq), ("RQ", rq))}
        all_cats = set(self.stats)
        out = agg(all_cats)
        th = agg(all_cats & self.things)
        st = agg(all_cats - self.things)
        out.update({"PQ_th": th["PQ"], "PQ_st": st["PQ"]})
        return out
