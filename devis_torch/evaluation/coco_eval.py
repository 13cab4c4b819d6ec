"""COCO-style detection and segmentation mAP (port of
`devis_tpu/evaluation/coco_eval.py`; reference `src/datasets/coco_eval.py:21-90`,
which uses pycocotools' `COCOeval`). Matching and accumulation transcribe
COCOeval in numpy (greedy per-threshold matching with crowd re-match, ignore
propagation, 101-point interpolated precision); mask IoU runs on the port's
RLE codec (`evaluation/rle.py`). No pycocotools.

GT is the standard COCO annotation dict; predictions are
{image_id, category_id, score, bbox [x,y,w,h]} and/or {... segmentation RLE}.
For `segm`, a GT polygon is filled at its image's size by the dataset's
rule (`datasets.coco.polygons_to_mask`, OpenCV's fill; pycocotools has its
own rasterizer, and the JAX evaluator takes RLE GT only).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import rle as rle_lib

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": [0.0, 1e5 ** 2],
    "small": [0.0, 32.0 ** 2],
    "medium": [32.0 ** 2, 96.0 ** 2],
    "large": [96.0 ** 2, 1e5 ** 2],
}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                 iscrowd: Sequence[int]) -> np.ndarray:
    """(D,4) x (G,4) [x,y,w,h] → (D,G); crowd gt uses dt-area denominator
    (pycocotools maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0], dt[:, 1]
    dx1, dy1 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx1[:, None], gx1[None]) -
                 np.maximum(dx0[:, None], gx0[None]), 0, None)
    ih = np.clip(np.minimum(dy1[:, None], gy1[None]) -
                 np.maximum(dy0[:, None], gy0[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(np.asarray(iscrowd, bool)[None], d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_img(gts: List[Dict], dts: List[Dict], area_rng, max_det: int,
                  iou_type: str):
    """COCOeval.evaluateImg for one (image, category, area range)."""
    if not gts and not dts:
        return None
    # gt order: non-ignored first (COCOeval sorts by _ignore)
    for g in gts:
        g["_ignore"] = int(g.get("iscrowd", 0)) or not (
            area_rng[0] <= g["area"] <= area_rng[1])
    gt_order = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
    gts = [gts[i] for i in gt_order]
    dts = sorted(dts, key=lambda d: -d["score"])[:max_det]

    iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
    if iou_type == "bbox":
        ious = box_iou_xywh(np.asarray([d["bbox"] for d in dts], np.float64
                                       ).reshape(len(dts), 4),
                            np.asarray([g["bbox"] for g in gts], np.float64
                                       ).reshape(len(gts), 4), iscrowd)
    else:
        ious = rle_lib.iou([d["segmentation"] for d in dts],
                           [g["segmentation"] for g in gts], iscrowd)

    T, G, D = len(IOU_THRESHOLDS), len(gts), len(dts)
    gtm = np.zeros((T, G))
    dtm = np.zeros((T, D))
    gt_ig = np.asarray([g["_ignore"] for g in gts], float)
    dt_ig = np.zeros((T, D))
    for ti, thr in enumerate(IOU_THRESHOLDS):
        for di in range(D):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(G):
                # gt already matched, and not a crowd → cannot reuse
                if gtm[ti, gi] > 0 and not iscrowd[gi]:
                    continue
                # best match so far is a real gt; remaining are ignored → stop
                if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[ti, di] = gt_ig[m]
            dtm[ti, di] = 1
            gtm[ti, m] = di + 1
    # unmatched dts outside the area range are ignored
    a = np.asarray([not (area_rng[0] <= (d["area"] if "area" in d else
                                         d["bbox"][2] * d["bbox"][3])
                         <= area_rng[1]) for d in dts], float)
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.tile(a, (T, 1))))
    return {"dt_matches": dtm, "dt_ignore": dt_ig, "gt_ignore": gt_ig,
            "dt_scores": np.asarray([d["score"] for d in dts])}


def _accumulate(per_img: List, max_det: int):
    """→ (precision (T,R), recall (T,)) for one (category, area, maxDet)."""
    T, R = len(IOU_THRESHOLDS), len(RECALL_THRESHOLDS)
    rs = [r for r in per_img if r is not None]
    if not rs:
        return None, None
    scores = np.concatenate([r["dt_scores"][:max_det] for r in rs])
    order = np.argsort(-scores, kind="mergesort")
    dtm = np.concatenate([r["dt_matches"][:, :max_det] for r in rs], 1)[:, order]
    dt_ig = np.concatenate([r["dt_ignore"][:, :max_det] for r in rs], 1)[:, order]
    gt_ig = np.concatenate([r["gt_ignore"] for r in rs])
    num_gt = int(np.count_nonzero(gt_ig == 0))
    if num_gt == 0:
        return None, None
    tps = np.logical_and(dtm, ~dt_ig.astype(bool))
    fps = np.logical_and(~dtm.astype(bool), ~dt_ig.astype(bool))
    tp_sum = np.cumsum(tps, 1).astype(float)
    fp_sum = np.cumsum(fps, 1).astype(float)
    precision = -np.ones((T, R))
    recall = -np.ones(T)
    for ti in range(T):
        tp, fp = tp_sum[ti], fp_sum[ti]
        if len(tp) == 0:
            recall[ti] = 0
            precision[ti] = 0
            continue
        rc = tp / num_gt
        pr = (tp / (fp + tp + np.spacing(1))).tolist()
        recall[ti] = rc[-1]
        for i in range(len(pr) - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        idx = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
        pr_at = np.zeros(R)
        for k, pi in enumerate(idx):
            if pi < len(pr):
                pr_at[k] = pr[pi]
        precision[ti] = pr_at
    return precision, recall


def evaluate_coco(gt: Dict, predictions: List[Dict],
                  iou_type: str = "bbox") -> Dict[str, float]:
    """Full COCOeval: returns the 12-number COCO summary
    (AP, AP50, AP75, APs/m/l, AR@1/10/100, ARs/m/l) in percent."""
    img_ids = [im["id"] for im in gt["images"]]
    cat_ids = sorted({c["id"] for c in gt["categories"]})

    sizes = {im["id"]: (im["height"], im["width"]) for im in gt["images"]}
    gt_by: Dict = {}
    for ann in gt.get("annotations", []):
        g = dict(ann)
        if "area" not in g:
            g["area"] = float(g["bbox"][2] * g["bbox"][3])
        if iou_type == "segm" and isinstance(g.get("segmentation"), list):
            from ..datasets.coco import polygons_to_mask
            g["segmentation"] = rle_lib.encode(
                polygons_to_mask(g["segmentation"], *sizes[g["image_id"]]))
        gt_by.setdefault((ann["image_id"], ann["category_id"]), []).append(g)
    dt_by: Dict = {}
    for p in predictions:
        d = dict(p)
        if iou_type == "segm" and "area" not in d:
            d["area"] = float(rle_lib.area(d["segmentation"]))
        dt_by.setdefault((p["image_id"], p["category_id"]), []).append(d)

    T, R = len(IOU_THRESHOLDS), len(RECALL_THRESHOLDS)
    A, M, K = len(AREA_RANGES), len(MAX_DETS), len(cat_ids)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))
    max_det_all = max(MAX_DETS)
    for ki, cat in enumerate(cat_ids):
        for ai, (aname, arng) in enumerate(AREA_RANGES.items()):
            per_img = [
                _evaluate_img([dict(g) for g in gt_by.get((i, cat), [])],
                              dt_by.get((i, cat), []), arng, max_det_all,
                              iou_type)
                for i in img_ids]
            for mi, md in enumerate(MAX_DETS):
                p, r = _accumulate(per_img, md)
                if p is not None:
                    precision[:, :, ki, ai, mi] = p
                    recall[:, ki, ai, mi] = r

    def _summ(ap: bool, iou: Optional[float] = None, area: str = "all",
              max_det: int = 100) -> float:
        ai = list(AREA_RANGES).index(area)
        mi = MAX_DETS.index(max_det)
        s = precision[..., ai, mi] if ap else recall[..., ai, mi]
        if iou is not None:
            s = s[np.isclose(IOU_THRESHOLDS, iou)]
        s = s[s > -1]
        return 100 * float(np.mean(s)) if s.size else -1.0

    return {
        "AP": _summ(True), "AP50": _summ(True, 0.5), "AP75": _summ(True, 0.75),
        "APs": _summ(True, area="small"), "APm": _summ(True, area="medium"),
        "APl": _summ(True, area="large"),
        "AR@1": _summ(False, max_det=1), "AR@10": _summ(False, max_det=10),
        "AR@100": _summ(False), "ARs": _summ(False, area="small"),
        "ARm": _summ(False, area="medium"), "ARl": _summ(False, area="large"),
    }


class CocoEvaluator:
    """Streaming wrapper mirroring the reference `CocoEvaluator`
    (`src/datasets/coco_eval.py:21-90`): `update()` per batch with
    {image_id: {"scores", "labels", "boxes" xyxy [, "masks"]}} results,
    then `summarize()`."""

    def __init__(self, gt: Dict, iou_types: Sequence[str] = ("bbox",)):
        self.gt = gt
        self.iou_types = tuple(iou_types)
        self.predictions: List[Dict] = []

    def update(self, results: Dict[int, Dict]):
        for image_id, out in results.items():
            boxes = np.asarray(out["boxes"], np.float64).reshape(-1, 4)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            for i in range(len(boxes)):
                rec = {"image_id": int(image_id),
                       "category_id": int(out["labels"][i]),
                       "score": float(out["scores"][i]),
                       "bbox": xywh[i].tolist()}
                if "masks" in out:
                    m = out["masks"][i]
                    rec["segmentation"] = (m if isinstance(m, dict)
                                           else rle_lib.encode(np.asarray(m)))
                self.predictions.append(rec)

    def summarize(self) -> Dict[str, Dict[str, float]]:
        return {t: evaluate_coco(self.gt, self.predictions, t)
                for t in self.iou_types}
