"""TrackMAP for YouTube-VIS (port of `devis_tpu/evaluation/track_map.py`).

The slice of TrackEval the reference evaluates with (`src/engine.py:265-313`):
`trackeval.datasets.YouTubeVIS` with `trackeval.metrics.TrackMAP` at the
YouTube-VIS settings (area ranges [0-128², 128²-256², 256²-1e5²], no time
ranges, at most 100 detections, IoU thresholds 0.5:0.05:0.95, 101 recall
points): greedy matching per threshold with ignore handling, accumulation per
class, the summary averaged over classes; volumetric mask-track IoU on the
RLE counts, a gt track's area the mean over its frames, crowd tracks ignored.

Inputs live in memory: the YouTube-VIS GT dict (videos, annotations,
categories) and the tracker's predictions ({video_id, score, category_id,
segmentations}).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import rle as rle_lib

IOU_THRESHOLDS = np.arange(0.5, 0.96, 0.05)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = [[0.0, 128.0 ** 2], [128.0 ** 2, 256.0 ** 2],
               [256.0 ** 2, 1e5 ** 2]]
AREA_RANGE_LABELS = ["area_s", "area_m", "area_l"]
MAX_DETECTIONS = 100
EPS = np.finfo("float").eps


def _track_from_segmentations(segs: Sequence[Optional[Dict]]) -> Dict[int, Dict]:
    return {t: s for t, s in enumerate(segs) if s}


def _track_area(track: Dict[int, Dict]) -> float:
    areas = [rle_lib.area(s) for s in track.values()]
    return float(np.mean(areas)) if areas else 0.0


def mask_track_iou(dt_track: Dict[int, Dict], gt_track: Dict[int, Dict]) -> float:
    """Volumetric track IoU (trackeval track_map.py:401-431), on the RLE
    counts: per frame the intersection, union = area(d) + area(g) − inter."""
    inter = union = 0.0
    for t in set(dt_track) | set(gt_track):
        d, g = dt_track.get(t), gt_track.get(t)
        if d and g:
            i = rle_lib.intersection(d, g)
            inter += i
            union += rle_lib.area(d) + rle_lib.area(g) - i
        elif g:
            union += rle_lib.area(g)
        elif d:
            union += rle_lib.area(d)
    return inter / union if union > 0 else 0.0


def _ignore_masks(num: int, areas: Optional[List[float]],
                  iscrowd: Optional[List[int]], is_gt: bool) -> List[np.ndarray]:
    """Track ignore masks: [all] + one per area range (track_map.py:312-347)."""
    masks = [np.zeros(num)]
    for lo, hi in AREA_RANGES:
        masks.append(np.array(
            [0 if lo - EPS <= a <= hi + EPS else 1 for a in (areas or [])]
            if areas is not None else [0] * num, dtype=float))
    if is_gt and iscrowd is not None and any(iscrowd):
        masks = [np.logical_or(m, iscrowd).astype(float) for m in masks]
    return masks


NUM_IG_MASKS = 1 + len(AREA_RANGES)
LABELS = ["all"] + AREA_RANGE_LABELS


def _eval_sequence(gt_tracks, gt_areas, gt_iscrowd, dt_tracks, dt_scores):
    """Greedy matching for one (video, class) (track_map.py:62-169).
    dt_tracks must already be sorted by descending score."""
    num_gt, num_dt = len(gt_tracks), len(dt_tracks)
    if num_gt == 0 and num_dt == 0:
        return [None] * NUM_IG_MASKS

    gt_ig_masks = _ignore_masks(num_gt, gt_areas, gt_iscrowd, True)
    dt_areas = [_track_area(t) for t in dt_tracks]
    dt_ig_masks = _ignore_masks(num_dt, dt_areas, None, False)

    ious = np.zeros((num_dt, num_gt))
    for i in range(num_dt):
        for j in range(num_gt):
            ious[i, j] = mask_track_iou(dt_tracks[i], gt_tracks[j])

    num_thrs = len(IOU_THRESHOLDS)
    res = []
    for mask_idx in range(NUM_IG_MASKS):
        gt_ig_mask = gt_ig_masks[mask_idx]
        order = np.argsort(gt_ig_mask, kind="mergesort")   # ignores last
        ious_sorted = ious[:, order] if num_dt else ious
        gt_ig = gt_ig_mask[order]

        gt_m = np.full((num_thrs, num_gt), -1.0)
        dt_m = np.full((num_thrs, num_dt), -1.0)
        dt_ig = np.zeros((num_thrs, num_dt))

        for ti, thr in enumerate(IOU_THRESHOLDS):
            for di in range(num_dt):
                best_iou = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(num_gt):
                    if gt_m[ti, gi] > 0:
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious_sorted[di, gi] < best_iou - EPS:
                        continue
                    best_iou = ious_sorted[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dt_m[ti, di] = 1           # matched (id value unused downstream)
                gt_m[ti, m] = di + 1       # >0 marks taken (mirrors reference)

        dt_ig_mask = np.tile(dt_ig_masks[mask_idx][None], (num_thrs, 1))
        dt_ig = np.logical_or(dt_ig, np.logical_and(dt_m == -1, dt_ig_mask))
        res.append({"dt_matches": dt_m, "dt_scores": np.asarray(dt_scores),
                    "gt_ignore": gt_ig, "dt_ignore": dt_ig})
    return res


def _combine_sequences(seq_results: List) -> Dict[str, np.ndarray]:
    """Precision/recall accumulation across videos (track_map.py:171-278)."""
    num_thrs = len(IOU_THRESHOLDS)
    num_rec = len(RECALL_THRESHOLDS)
    precision = -np.ones((num_thrs, num_rec, NUM_IG_MASKS))
    recall = -np.ones((num_thrs, NUM_IG_MASKS))

    for ig in range(NUM_IG_MASKS):
        rs = [r[ig] for r in seq_results if r[ig] is not None]
        if not rs:
            continue
        md = MAX_DETECTIONS
        dt_scores = np.concatenate([r["dt_scores"][:md] for r in rs])
        order = np.argsort(-dt_scores, kind="mergesort")
        dt_m = np.concatenate([r["dt_matches"][:, :md] for r in rs], axis=1)[:, order]
        dt_ig = np.concatenate([r["dt_ignore"][:, :md] for r in rs], axis=1)[:, order]
        gt_ig = np.concatenate([r["gt_ignore"] for r in rs])
        num_gt = int(np.count_nonzero(gt_ig == 0))
        if num_gt == 0:
            continue

        tps = np.logical_and(dt_m != -1, ~dt_ig.astype(bool))
        fps = np.logical_and(dt_m == -1, ~dt_ig.astype(bool))
        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)

        for ti in range(num_thrs):
            tp, fp = tp_sum[ti], fp_sum[ti]
            if len(tp):
                rc = tp / num_gt
                recall[ti, ig] = rc[-1]
                pr = (tp / (fp + tp + np.spacing(1))).tolist()
                for i in range(len(pr) - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                idx = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
                pr_at = np.zeros(num_rec)
                for k, pi in enumerate(idx):
                    if pi < len(pr):
                        pr_at[k] = pr[pi]
                precision[ti, :, ig] = pr_at
            else:
                recall[ti, ig] = 0

    out = {}
    for li, lbl in enumerate(LABELS):
        ap = np.zeros(num_thrs)
        for ti in range(num_thrs):
            p = precision[ti, :, li]
            ap[ti] = np.mean(p[p > -1]) if (p > -1).any() else -1
        out[f"AP_{lbl}"] = ap
        out[f"AR_{lbl}"] = recall[:, li]
    return out


def evaluate_vis(gt: Dict, predictions: List[Dict]) -> Dict[str, float]:
    """Full YouTube-VIS TrackMAP evaluation.

    gt: YouTube-VIS annotation dict (videos/annotations/categories).
    predictions: tracker output records {video_id, score, category_id,
    segmentations}. Returns the summary the reference reports
    (engine.py:310-313) plus the per-threshold arrays."""
    video_ids = [v["id"] for v in gt["videos"]]
    class_ids = sorted({c["id"] for c in gt["categories"]})

    gt_by_vc: Dict = {}
    for ann in gt.get("annotations", []):
        track = _track_from_segmentations(ann["segmentations"])
        areas = [a for a in (ann.get("areas") or []) if a]
        area = float(np.mean(areas)) if areas else _track_area(track)
        gt_by_vc.setdefault((ann["video_id"], ann["category_id"]), []).append(
            dict(track=track, area=area, iscrowd=int(ann.get("iscrowd", 0))))

    dt_by_vc: Dict = {}
    for p in predictions:
        track = _track_from_segmentations(p["segmentations"])
        dt_by_vc.setdefault((p["video_id"], p["category_id"]), []).append(
            dict(track=track, score=float(p["score"])))

    per_class = {}
    for cls in class_ids:
        seq_results = []
        any_data = False
        for vid in video_ids:
            gts = gt_by_vc.get((vid, cls), [])
            dts = sorted(dt_by_vc.get((vid, cls), []),
                         key=lambda d: -d["score"])
            if not gts and not dts:
                seq_results.append([None] * NUM_IG_MASKS)
                continue
            any_data = True
            seq_results.append(_eval_sequence(
                [g["track"] for g in gts], [g["area"] for g in gts],
                [g["iscrowd"] for g in gts],
                [d["track"] for d in dts], [d["score"] for d in dts]))
        if any_data:
            per_class[cls] = _combine_sequences(seq_results)

    # class-averaged over classes with data (track_map.py:280-297)
    summary = {}
    for lbl in LABELS:
        for pre in ("AP", "AR"):
            field = f"{pre}_{lbl}"
            stack = np.stack([per_class[c][field] for c in per_class]) \
                if per_class else -np.ones((1, len(IOU_THRESHOLDS)))
            avg = np.zeros(len(IOU_THRESHOLDS))
            for ti in range(len(IOU_THRESHOLDS)):
                vals = stack[:, ti]
                avg[ti] = np.mean(vals[vals > -1]) if (vals > -1).any() else -1
            summary[field] = avg

    ap_all, ar_all = summary["AP_all"], summary["AR_all"]
    valid = ap_all > -1
    result = {
        "AP": 100 * float(np.mean(ap_all[valid])) if valid.any() else 0.0,
        "AP50": 100 * float(ap_all[0]) if ap_all[0] > -1 else 0.0,
        "AP75": 100 * float(ap_all[5]) if ap_all[5] > -1 else 0.0,
        "AR": 100 * float(np.mean(ar_all[ar_all > -1])) if (ar_all > -1).any() else 0.0,
    }
    result["per_threshold"] = summary
    result["per_class"] = per_class
    return result
