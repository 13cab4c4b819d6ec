"""Inference entry points (port of `devis_tpu/inference.py`): video in, tracks
out (`build_tracker`, `inference_vis`), the device step of the clip-stitching
tracker (`VISInferFn`, `make_eval_buckets`) and the COCO evaluation loop of
the image model (`evaluate_coco`, into the port's `CocoEvaluator` unless
the caller passes an evaluator, with the val losses on request).

`VISInferFn` keeps the JAX package's three stages: `prepare` (host: load and
pad one clip to a static canvas), `dispatch` (upload and enqueue the forward;
returns without waiting for the GPU) and `fetch` (wait, copy back and adapt
the outputs to the tracker's dict). Mask logits leave the device as
float8_e4m3fn, 1 byte a pixel: its resolution is finest around logit 0,
where the tracker's threshold decides.

`evaluate_coco` keeps the JAX function's three stages too: `_prep` (a loader
thread pads a chunk of images to a static canvas), `_fwd` (the forward, then
on the device the bilinear upsampling of the /4 mask logits to the canvas,
the threshold at logit 0 and the bit-packing, 8 columns a byte), and
`_postprocess` (host: absolute boxes, unpacked, cropped and nearest-resized
masks). Chunk j+1's forward is enqueued before chunk j is fetched.
"""
from __future__ import annotations

import json
import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .datasets import pick_canvas, round_up
from .datasets.transforms import get_size_with_aspect_ratio, resize_nearest_numpy
from .evaluation.track_map import evaluate_vis
from .models.detr import top_k_process
from .ops.interpolate import resize_bilinear_hw
from .util.misc import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_eval_buckets(min_size: int, max_size: int,
                      multiple: int = 64) -> List[Tuple[int, int]]:
    """Static eval canvases: shorter side `min_size`, longer `max_size`, both
    orientations, rounded up to `multiple`."""
    s, m = round_up(min_size, multiple), round_up(max_size, multiple)
    return [(s, m), (m, s), (s, s)]


class VISInferFn:
    """Tracker-facing `infer_fn(video, clip_idx)` over a DeVIS model.

    fetch returns scores (T, K), labels (K,), boxes (T, K, 4) cxcywh
    normalized to the unpadded image, center_points (T, K, 2), mask_logits
    (Nm, T, h, w) float8_e4m3fn on the CPU, mask_gather (K,) and valid_hw."""

    def __init__(self, model, num_frames: int, buckets: List[Tuple[int, int]],
                 mask_stride: int = 4, device=None):
        self.device = resolve_device(device)
        params = next(model.parameters())
        if params.device.type != self.device.type:
            raise ValueError(f"model lies on {params.device}, not {self.device}")
        self.model = model
        self.num_frames = num_frames
        self.buckets = buckets
        self.mask_stride = mask_stride
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)

    def prepare(self, video, clip_idx: int):
        """Host stage: load and canvas-pad one clip."""
        frames = video.load_clip(clip_idx)               # (T, h, w, 3)
        T, h, w = frames.shape[:3]
        if T != self.num_frames:
            raise ValueError(f"clip has {T} frames, expected {self.num_frames}")
        Hc, Wc = pick_canvas(h, w, self.buckets)
        images = np.zeros((T, Hc, Wc, 3), frames.dtype)
        images[:, :h, :w] = frames
        real_len = video.real_video_length
        clip_length = T if real_len is None or real_len >= T else real_len
        return images, (h, w), clip_length

    @torch.inference_mode()
    def dispatch(self, prepared):
        """Upload and run the forward; the GPU works on after this returns."""
        images, (h, w), clip_length = prepared
        x = torch.from_numpy(images).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self._mean) / self._std
        T, Hc, Wc = x.shape[:3]
        ys = torch.arange(Hc, device=self.device)[:, None] >= h
        xs = torch.arange(Wc, device=self.device)[None, :] >= w
        pad = (ys | xs)[None].expand(T, Hc, Wc)
        _, res = self.model(x, pad, clip_length=clip_length)
        masks = res["masks"].to(torch.float8_e4m3fn)
        small = {k: res[k] for k in ("scores", "labels", "boxes", "mask_gather")}
        # recorded on this thread's current stream, the one the forward ran on
        done = torch.cuda.Event() if self.device.type == "cuda" else None
        if done is not None:
            done.record()
        return masks, small, done, (h, w)

    def fetch(self, dispatched) -> Dict[str, np.ndarray]:
        """Wait for the forward and adapt its outputs to the tracker's dict."""
        masks, small, done, (h, w) = dispatched
        if done is not None:
            done.synchronize()
        boxes = small["boxes"].float().cpu().numpy()
        st = self.mask_stride
        return {"scores": small["scores"].float().cpu().numpy(),
                "labels": small["labels"].cpu().numpy().astype(np.int32),
                "boxes": boxes, "center_points": boxes[..., :2],
                "mask_logits": masks.cpu(),
                "mask_gather": small["mask_gather"].cpu().numpy().astype(np.int32),
                "valid_hw": (max(1, round(h / st)), max(1, round(w / st)))}

    def run(self, prepared) -> Dict[str, np.ndarray]:
        return self.fetch(self.dispatch(prepared))

    def __call__(self, video, clip_idx: int) -> Dict[str, np.ndarray]:
        return self.run(self.prepare(video, clip_idx))


def build_tracker(cfg, model, device=None):
    """The clip-stitching tracker over `model` (reference `build_tracker`,
    `src/models/__init__.py:84-108`). Runs on the GPU unless ``device`` says
    otherwise; the model must lie there."""
    from .tracking.inference_matcher import build_inference_matcher
    from .tracking.tracker import Tracker

    ct = cfg.TEST.CLIP_TRACKING
    T = cfg.MODEL.DEVIS.NUM_FRAMES
    overlap = T - ct.STRIDE
    infer_fn = VISInferFn(model, T, make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST,
                                                      cfg.INPUT.MAX_SIZE_TEST),
                          device=device)
    matcher = build_inference_matcher(cfg)
    tracker_cfg = dict(
        per_class_matching=ct.PER_CLASS_MATCHING,
        track_min_detection_score=ct.MIN_FRAME_SCORE,
        track_min_score=ct.MIN_TRACK_SCORE,
        track_min_detections=ct.MIN_DETECTIONS,
        final_class_policy=ct.FINAL_CLASS_POLICY,
        final_score_policy=ct.FINAL_SCORE_POLICY)
    visualization_cfg = dict(
        out_viz_path=cfg.TEST.VIZ.OUT_VIZ_PATH,
        save_clip_viz=cfg.TEST.VIZ.SAVE_CLIP_VIZ,
        merge_tracks=cfg.TEST.VIZ.SAVE_MERGED_TRACKS)
    return Tracker(infer_fn, matcher, tracker_cfg, T, overlap,
                   visualization_cfg=visualization_cfg)


def inference_vis(tracker, dataset, output_dir: Optional[str] = None,
                  verbose: bool = True,
                  selected_videos: Optional[List[str]] = None) -> Dict:
    """Tracks every video of `dataset` (reference engine.py:206-262).
    Returns {"results": [...], "fps": frames / (wait + stitch) seconds of the
    tracker} and, where the dataset has ground truth, "eval": its TrackMAP.
    `selected_videos` keeps only the named videos. Writes results.json and
    results.zip to `output_dir` when given.

    Videos run grouped by their evaluation canvas, through one pipeline that
    spans the pass (`ClipPipeline`). In a process group each rank tracks
    videos rank, rank + world, ... (padded, so a rank may repeat a video) and
    the records are gathered, each video's from the first rank that has it
    (`devis_tpu/inference.py:231-232,293-294`); every rank returns them all
    and rank 0 writes the files. `fps` is then the frames of the dataset over
    the slowest rank's seconds."""
    from .parallel import (accumulate_results, all_gather_objects, is_distributed,
                           is_main_process, padded_shard)
    from .tracking.pipeline import ClipPipeline

    buckets = getattr(tracker.infer_fn, "buckets", None)

    def canvas_of(video):
        tr = getattr(video, "transform", None)
        size = getattr(video, "original_size", None)
        if tr is None or size is None or not buckets:
            return (0, 0)
        return pick_canvas(*get_size_with_aspect_ratio(size, tr.min_size, tr.max_size),
                           buckets)

    # same-canvas videos back to back (the order changes no video's tracks)
    videos = sorted((dataset[i] for i in padded_shard(len(dataset))), key=canvas_of)
    if selected_videos:
        videos = [v for v in videos if getattr(v, "video_name", None) in selected_videos]

    pipeline = ClipPipeline(tracker.infer_fn)
    for video in videos:
        pipeline.add_video(video)
    tracker.pipeline = pipeline
    results: List[Dict] = []
    times: List[float] = []
    try:
        for j, video in enumerate(videos):
            t0 = time.time()
            results.extend(tracker(video, all_times=times))
            if verbose:
                print(f"video {j + 1}/{len(videos)} ({time.time() - t0:.2f}s)", flush=True)
    finally:
        tracker.pipeline = None
        pipeline.close()

    seconds = sum(times)
    if is_distributed():
        results = accumulate_results(all_gather_objects(results))
        seconds = max(all_gather_objects(seconds))
    fps = dataset.get_total_num_frames() / max(seconds, 1e-9)
    out = {"results": results, "fps": fps}
    if getattr(dataset, "has_gt", False):
        gt = dataset.gt_dict() if hasattr(dataset, "gt_dict") else dataset.annotations
        out["eval"] = evaluate_vis(gt, results)
        if verbose:
            e = out["eval"]
            print(f"TrackMAP: AP {e['AP']:.1f} AP50 {e['AP50']:.1f} AP75 {e['AP75']:.1f} "
                  f"AR {e['AR']:.1f} | {fps:.1f} FPS")
    if output_dir and is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        res_path = os.path.join(output_dir, "results.json")
        with open(res_path, "w") as f:
            json.dump(results, f)
        with zipfile.ZipFile(os.path.join(output_dir, "results.zip"), "w",
                             zipfile.ZIP_DEFLATED) as z:
            z.write(res_path, "results.json")
    return out


# ---------------------------------------------------------------------------
# COCO evaluation loop
# ---------------------------------------------------------------------------

def pack_mask_bits(logits: torch.Tensor, canvas: Tuple[int, int]) -> torch.Tensor:
    """Mask logits (B, K, h, w) → flat uint8 of B*K*Hc*(Wc/8) bytes: bilinear
    upsampling to the canvas (align_corners=False), threshold at logit > 0,
    8 columns a byte with the first column in the highest bit, so that
    `np.unpackbits` reads it back."""
    Hc, Wc = canvas
    if Wc % 8:
        raise ValueError(f"canvas width {Wc} is not a multiple of 8")
    B, K = logits.shape[:2]
    up = resize_bilinear_hw(logits.float(), (Hc, Wc))
    bits = (up > 0).reshape(B, K, Hc, Wc // 8, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=logits.device)
    return (bits * weights).sum(-1).to(torch.uint8).reshape(-1)


def merge_rank_predictions(rank_lists: List[List[Dict]]) -> List[Dict]:
    """Merges per-rank COCO prediction lists, keeping one copy of each
    image's predictions: the first rank's that has it (a padded sampler
    puts tail images on several ranks; the reference de-duplicates in
    `accumulate_results`, misc.py:129-139)."""
    merged: List[Dict] = []
    seen: set = set()
    for rank_preds in rank_lists:
        keep = {p["image_id"] for p in rank_preds} - seen
        merged.extend(p for p in rank_preds if p["image_id"] in keep)
        seen |= keep
    return merged


def evaluate_coco(model, dataset, cfg, evaluator=None, device=None,
                  verbose: bool = True, log_losses: bool = False):
    """Evaluation loop of the image model over a COCO-style dataset
    (reference engine.py:98-203).

    `dataset[i]` gives {"image" (h, w, 3) f32, "image_id", "orig_size"};
    images are padded to static canvases (`make_eval_buckets`) and run
    `TEST.EVAL_BATCH_SIZE` to a forward where the dataset has `eval_hw` (the
    tail chunk repeats its first image). Every image's {"scores", "labels"
    (+1, back to COCO ids), "boxes" absolute xyxy clipped to the original
    size, "masks" bool at the original size} goes to
    `evaluator.update({image_id: result})`; returns `evaluator.summarize()`.
    Without an evaluator the port's `CocoEvaluator` over `dataset.gt_dict()`
    is used (bbox, and segm with MASK_ON). With `log_losses` the criterion
    also runs on each val image's targets (a second forward, given the
    targets) and the averaged losses are returned under "losses" (reference
    engine.py:98-150). In a process group each rank evaluates images rank,
    rank + world, ... (padded) and the predictions, one copy an image, and
    the loss sums are gathered before the summary, which every rank returns
    (`devis_tpu/inference.py:404-405,528-532`). Runs on the GPU unless
    ``device`` says otherwise."""
    from .parallel import all_gather_objects, is_distributed, padded_shard
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model lies on {next(model.parameters()).device}, not {device}")
    buckets = make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    mask_on = bool(cfg.MODEL.MASK_ON)
    if evaluator is None:
        from .evaluation.coco_eval import CocoEvaluator
        evaluator = CocoEvaluator(dataset.gt_dict(),
                                  ("bbox", "segm") if mask_on else ("bbox",))
    model.eval()

    @torch.inference_mode()
    def _fwd(images: np.ndarray, pad_mask: np.ndarray) -> Dict[str, torch.Tensor]:
        x = torch.from_numpy(images).to(device, non_blocking=True)
        pad = torch.from_numpy(pad_mask).to(device, non_blocking=True)
        if mask_on:
            tk = dict(model(x, pad, train=False)["top_k"])
            tk["masks_packed"] = pack_mask_bits(tk.pop("masks"), images.shape[1:3])
            return tk
        out, _ = model(x, pad)
        prob = torch.sigmoid(out["pred_logits"].float()) if cfg.MODEL.LOSS.FOCAL_LOSS \
            else torch.softmax(out["pred_logits"].float(), dim=-1)[..., :-1]
        scores, labels, boxes, _ = top_k_process(prob, out["pred_boxes"],
                                                 cfg.TEST.NUM_OUT)
        return {"scores": scores, "labels": labels, "boxes": boxes}

    loss_sums: Dict[str, float] = {}
    loss_count = 0

    @torch.inference_mode()
    def _losses(sample, canvas) -> None:
        nonlocal loss_count
        from .datasets import collate_images
        from .models import matcher_cfg_from
        from .models.criterion import image_criterion
        # the slots cannot outnumber the queries
        batch = collate_images([sample], canvas, max_instances=min(
            cfg.TPU.MAX_INSTANCES, cfg.MODEL.NUM_QUERIES))
        x = torch.from_numpy(batch["images"]).to(device)
        pad = torch.from_numpy(batch["pad_mask"]).to(device)
        targets = {k: torch.from_numpy(v).to(device) for k, v in batch["targets"].items()}
        out = model(x, pad, targets=targets, train=False) if mask_on else model(x, pad)[0]
        losses = image_criterion(out, targets, matcher_cfg_from(cfg, clip=False),
                                 cfg.MODEL.LOSS.FOCAL_ALPHA, mask_on=mask_on)
        for k, v in losses.items():
            loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
        loss_count += 1

    indices = padded_shard(len(dataset))
    B = max(1, int(cfg.TEST.EVAL_BATCH_SIZE))
    if B > 1 and hasattr(dataset, "eval_hw"):
        groups: Dict[Tuple[int, int], List[int]] = {}
        for idx in indices:
            groups.setdefault(pick_canvas(*dataset.eval_hw(idx), buckets), []).append(idx)
        chunks = [grp[k:k + B] for grp in groups.values()
                  for k in range(0, len(grp), B)]
    else:
        B = 1
        chunks = [[idx] for idx in indices]

    def _prep(chunk):
        """Host stage: load and canvas-pad one chunk (loader thread)."""
        samples = [dataset[idx] for idx in chunk]
        hws = [s["image"].shape[:2] for s in samples]
        Hc, Wc = pick_canvas(max(h for h, _ in hws), max(w for _, w in hws), buckets)
        images = np.zeros((B, Hc, Wc, 3), np.float32)
        pad_mask = np.ones((B, Hc, Wc), bool)
        for b, (s, (h, w)) in enumerate(zip(samples, hws)):
            images[b, :h, :w] = s["image"]
            pad_mask[b, :h, :w] = False
        for b in range(len(samples), B):                   # tail padding
            images[b] = images[0]
            pad_mask[b] = pad_mask[0]
        return samples, images, pad_mask, hws, (Hc, Wc)

    def _postprocess(samples, out_dev, hws, canvas):
        """Host stage: fetch and convert one chunk's predictions."""
        Hc, Wc = canvas
        tk = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
              for k, v in out_dev.items()}
        for b, (sample, (h, w)) in enumerate(zip(samples, hws)):
            oh, ow = sample["orig_size"]
            bx = tk["boxes"][b]
            cx, cy = bx[:, 0] * ow, bx[:, 1] * oh
            bw, bh = bx[:, 2] * ow, bx[:, 3] * oh
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh)
            res = {"scores": tk["scores"][b], "labels": tk["labels"][b] + 1,
                   "boxes": boxes}
            if "masks_packed" in tk:
                Bf, K = tk["scores"].shape                 # the tail padding included
                pk = tk["masks_packed"].reshape(Bf, K, Hc, Wc // 8)
                res["masks"] = [
                    resize_nearest_numpy(np.unpackbits(pk[b, k], axis=-1)[:h, :w],
                                         (oh, ow)) > 0 for k in range(K)]
            evaluator.update({int(sample["image_id"]): res})

    loader = ThreadPoolExecutor(max_workers=1)
    preps: Dict[int, object] = {}

    def ensure_prep(k):
        if k not in preps and k < len(chunks):
            preps[k] = loader.submit(_prep, chunks[k])

    try:
        ensure_prep(0)
        ensure_prep(1)
        pending = None
        done = 0
        for j in range(len(chunks)):
            samples, images, pad_mask, hws, canvas = preps.pop(j).result()
            ensure_prep(j + 2)
            out_dev = _fwd(images, pad_mask)
            if log_losses:
                for sample in samples:
                    if len(sample.get("labels", ())):
                        _losses(sample, canvas)
            if pending is not None:
                _postprocess(*pending)
            pending = (samples, out_dev, hws, canvas)
            done += len(samples)
            if verbose and (j + 1) % 50 == 0:
                print(f"eval {done}/{len(indices)}", flush=True)
        if pending is not None:
            _postprocess(*pending)
    finally:
        loader.shutdown(wait=True)
    if is_distributed():
        evaluator.predictions = merge_rank_predictions(
            all_gather_objects(evaluator.predictions))
        if log_losses:
            gathered = all_gather_objects((loss_sums, loss_count))
            loss_count = sum(c for _, c in gathered)
            loss_sums = {}
            for sums, _ in gathered:
                for k, v in sums.items():
                    loss_sums[k] = loss_sums.get(k, 0.0) + v
    summary = evaluator.summarize()
    if log_losses and loss_sums:
        summary["losses"] = {k: v / loss_count for k, v in loss_sums.items()}
        if verbose:
            print("val losses:", {k: round(v, 4) for k, v in sorted(summary["losses"].items())
                                  if not k[-1].isdigit()})
    return summary


def paint_panoptic(top_k: Dict[str, np.ndarray], canvas: Tuple[int, int],
                   hw: Tuple[int, int], gt_hw: Tuple[int, int],
                   score_threshold: float = 0.5, min_pixels: int = 4):
    """One image's panoptic prediction from its fetched `top_k` (scores
    (K,), labels (K,), masks (K, h', w') logits; numpy), the mask-wise rule
    of `devis_tpu/inference.py:577-600`: in descending score order each mask
    at or above `score_threshold` is upsampled to the `canvas` (bilinear f32,
    cv2's INTER_LINEAR rule), thresholded at logit 0, cropped to the image's
    `hw`, nearest-resized to the ground truth's `gt_hw` (INTER_NEAREST rule)
    and painted where no higher-scoring mask painted, unless fewer than
    `min_pixels` pixels are left. Returns (segment-id map (oh, ow) int32, 0
    void; segments [{"id", "category_id"}])."""
    from .datasets.transforms import resize_linear_f32
    Hc, Wc = canvas
    h, w = hw
    oh, ow = gt_hw
    pred_ids = np.zeros((oh, ow), np.int32)
    segments: List[Dict] = []
    if "masks" not in top_k:
        return pred_ids, segments
    scores = top_k["scores"]
    next_id = 1
    for j in np.argsort(-scores):
        if scores[j] < score_threshold:
            continue
        up = resize_linear_f32(np.asarray(top_k["masks"][j], np.float32), (Hc, Wc))
        binm = (up > 0)[:h, :w]
        full = resize_nearest_numpy(binm.astype(np.uint8), (oh, ow)) > 0
        paint = full & (pred_ids == 0)
        if paint.sum() < min_pixels:
            continue
        pred_ids[paint] = next_id
        segments.append({"id": next_id, "category_id": int(top_k["labels"][j]) + 1})
        next_id += 1
    return pred_ids, segments


def evaluate_panoptic(model, dataset, cfg, score_threshold: float = 0.5,
                      min_pixels: int = 4, device=None, verbose: bool = True) -> Dict:
    """Panoptic-quality evaluation of the image model for `DATASETS.TYPE:
    coco_panoptic` (port of `devis_tpu/inference.py:550-611`; reference
    engine.py:115-176). Each image is padded alone to its canvas
    (`make_eval_buckets`), its top-k masks painted by `paint_panoptic` and
    scored against `dataset.gt_segmentation` by the port's
    `PanopticEvaluator`. Returns PQ, SQ, RQ, PQ_th and PQ_st (in percent)
    and `segments`, the count of segments painted over the dataset. Runs on
    the GPU unless ``device`` says otherwise."""
    from .evaluation.panoptic_eval import PanopticEvaluator
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model lies on {next(model.parameters()).device}, not {device}")
    buckets = make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    evaluator = PanopticEvaluator(dataset.gt_dict().get("categories", []))
    model.eval()
    n_segments = 0
    for idx in range(len(dataset)):
        sample = dataset[idx]
        img = sample["image"]
        h, w = img.shape[:2]
        Hc, Wc = pick_canvas(h, w, buckets)
        images = np.zeros((1, Hc, Wc, 3), np.float32)
        pad_mask = np.ones((1, Hc, Wc), bool)
        images[0, :h, :w] = img
        pad_mask[0, :h, :w] = False
        with torch.inference_mode():
            out = model(torch.from_numpy(images).to(device),
                        torch.from_numpy(pad_mask).to(device), train=False)
        tk = {k: (v.float() if v.is_floating_point() else v)[0].cpu().numpy()
              for k, v in out["top_k"].items()} if isinstance(out, dict) else {}
        gt_ids, gt_segments = dataset.gt_segmentation(idx)
        pred_ids, segments = paint_panoptic(tk, (Hc, Wc), (h, w), gt_ids.shape,
                                            score_threshold, min_pixels)
        n_segments += len(segments)
        evaluator.update(gt_ids, gt_segments, pred_ids, segments)
        if verbose and (idx + 1) % 50 == 0:
            print(f"panoptic eval {idx + 1}/{len(dataset)}", flush=True)
    summary = evaluator.summarize()
    if verbose:
        print("PQ {PQ:.1f} SQ {SQ:.1f} RQ {RQ:.1f} "
              "PQ_th {PQ_th:.1f} PQ_st {PQ_st:.1f}".format(**summary))
    summary["segments"] = n_segments
    return summary
