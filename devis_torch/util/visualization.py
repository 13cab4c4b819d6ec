"""Result visualization: track overlays, decoder sampling maps, dataset
renders (port of `devis_tpu/util/visualization.py`).

Counterpart of the reference's `src/util/viz_utils.py:153-353` (per-clip and
merged track overlays) and `src/util/att_maps_viz.py:208-818` (the decoder's
sampling points), drawn with OpenCV. cv2 is imported here only, inside the
functions that draw or write, so that the rest of the port runs where it is
missing. Masks decode through the port's RLE codec (`evaluation/rle.py`) and
`tracking/track.py`'s `encode_mask`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..evaluation import rle as rle_lib

_COLORS = np.array(
    [[244, 67, 54], [33, 150, 243], [76, 175, 80], [255, 193, 7],
     [156, 39, 176], [0, 188, 212], [255, 87, 34], [63, 81, 181],
     [139, 195, 74], [233, 30, 99], [0, 150, 136], [121, 85, 72]],
    np.float32)


def _cv2():
    import cv2
    return cv2


def color_for(track_id: int) -> np.ndarray:
    return _COLORS[track_id % len(_COLORS)]


def create_color_map(N: int = 256, normalized: bool = False) -> np.ndarray:
    """PASCAL-VOC style bit-reversal color map (reference
    viz_utils.py:132-150): color i spreads the low bits of i across the RGB
    channels' high bits, giving well-separated track colors."""
    cmap = np.zeros((N, 3), np.float32 if normalized else np.uint8)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap / 255.0 if normalized else cmap


def _as_binary_mask(mask) -> Optional[np.ndarray]:
    """Any track mask entry (RLE dict, probabilities, SmallMask, Future) →
    (H, W) bool, or None."""
    if mask is None:
        return None
    from ..tracking.track import encode_mask
    if not isinstance(mask, dict):
        mask = encode_mask(mask)
    return rle_lib.decode(mask).astype(bool)


def _most_left_coordinate(mask: np.ndarray):
    """Topmost-in-leftmost-column text anchor for a label where no box is
    drawn (reference viz_utils.py:12-20)."""
    cols = np.where(mask.any(axis=0))[0]
    if len(cols):
        rows = np.where(mask[:, cols[0]])[0]
        if len(rows):
            return int(cols[0]), int(rows[-1])
    return 0, 0


def draw_instance(img: np.ndarray, instance: Dict, cmap: np.ndarray,
                  class_names: Optional[Dict[int, str]] = None,
                  mask_alpha: float = 0.7, draw_box: bool = True,
                  font_size: float = 0.45) -> np.ndarray:
    """Overlay one instance (mask blend, label, optional box) on a uint8
    frame in place. `instance` keys: mask (any track-mask form), score,
    category_id, instance_id, optionally bbox (xyxy absolute)."""
    cv2 = _cv2()
    mask = _as_binary_mask(instance.get("mask"))
    if mask is None:
        return img
    color = cmap[1:][instance["instance_id"] % (len(cmap) - 1)].astype(np.float32)
    img[mask] = ((1.0 - mask_alpha) * img[mask].astype(np.float32)
                 + mask_alpha * color).astype(img.dtype)
    cat = int(instance.get("category_id", 0))
    name = (class_names or {}).get(cat, f"class {cat}")
    label = f"{name}|{instance.get('score', 0.0):.02f}"
    bbox = instance.get("bbox")
    if bbox is not None and draw_box:
        x0, y0, x1, y1 = np.asarray(bbox).astype(np.int32)[:4]
        cv2.rectangle(img, (int(x0), int(y0)), (int(x1), int(y1)), (255, 0, 0), 2)
        tx, ty = int(x0), int(y0)
    else:
        tx, ty = _most_left_coordinate(mask)
    cv2.putText(img, label, (tx, max(ty, 12)), cv2.FONT_HERSHEY_SIMPLEX,
                font_size, (255, 255, 255), 1, cv2.LINE_AA)
    return img


def _video_frame_reader(video):
    """Callable (file_name) → RGB uint8 frame through the video's
    `read_frame` (disk for YouTube-VIS videos, drawn for synthetic ones)."""
    index = {name: t for t, name in enumerate(video.file_names)}
    return lambda name: video.read_frame(index[name])


def _video_name(video) -> str:
    name = getattr(video, "video_name", None)
    if name:
        return name
    first = video.file_names[0]
    return first.split("/")[0] if "/" in first else str(video.video_id)


def write_rgb(path: str, img: np.ndarray):
    """Writes an RGB uint8 image (the format from the path's extension)."""
    cv2 = _cv2()
    cv2.imwrite(path, cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_RGB2BGR))


def visualize_clips_after_processing(clip_idx: int, video, frame_names, tracks,
                                     out_path: str, class_names=None) -> None:
    """Per-clip, per-track overlays under
    `{out}/{video}/clip_results/window_{i}/{score}_track_{id}_id_{mask_id}/`
    (reference viz_utils.py:153-184)."""
    cmap = create_color_map()
    read = _video_frame_reader(video)
    out_folder = os.path.join(out_path, _video_name(video), "clip_results",
                              f"window_{clip_idx}")
    for track in tracks:
        score_str = f"{track.mean_score() * 100:.2f}".replace(".", "").zfill(4)
        folder = os.path.join(out_folder,
                              f"{score_str}_track_{track.get_id()}_id_{track.mask_id}")
        os.makedirs(folder, exist_ok=True)
        for t, name in enumerate(frame_names):
            frame = read(name).astype(np.uint8).copy()
            if t < len(track.masks) and track.masks[t] is not None:
                draw_instance(frame, {
                    "mask": track.masks[t], "score": track.scores[t] or 0.0,
                    "category_id": track.categories[t], "bbox": track.boxes[t],
                    "instance_id": track.get_id()}, cmap, class_names)
            write_rgb(os.path.join(folder, os.path.basename(name)), frame)


def visualize_tracks_independently(video, video_tracks, final_class_policy: str,
                                   final_score_policy: str, out_path: str,
                                   class_names=None) -> None:
    """One folder per final track under `{out}/{video}/tracks_results/`, with
    every frame of the video overlaid by that track alone and a
    `matches.txt` of the clip-stitch matching record (reference
    viz_utils.py:187-241)."""
    cmap = create_color_map()
    read = _video_frame_reader(video)
    out_folder = os.path.join(out_path, _video_name(video), "tracks_results")
    for track in video_tracks:
        final_score = track.compute_final_score(final_score_policy)
        final_cat = track.compute_final_category(final_class_policy)
        score_str = f"{final_score * 100:.2f}".replace(".", "").zfill(4)
        folder = os.path.join(out_folder, f"{score_str}_track_{track.get_id()}")
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "matches.txt"), "w") as f:
            for idx, match in enumerate(track.matching_ids_record):
                f.write(f"Window_{idx} track_{match[0]} / "
                        f"Window_{idx + 1} track_{match[1]}\n")
        for t, name in enumerate(video.file_names):
            frame = read(name).astype(np.uint8).copy()
            if track.valid_frames[t] and track.masks[t] is not None:
                draw_instance(frame, {
                    "mask": track.masks[t], "score": final_score,
                    "category_id": final_cat, "bbox": track.boxes[t],
                    "instance_id": track.get_id()}, cmap, class_names)
            write_rgb(os.path.join(folder, os.path.basename(name)), frame)


def visualize_results_merged(video, video_tracks, final_class_policy: str,
                             final_score_policy: str, out_path: str,
                             class_names=None) -> None:
    """Every final track overlaid on each frame, under `{out}/{video}/`
    (reference viz_utils.py:244-350: masks and category labels, no boxes)."""
    cmap = create_color_map(N=15)
    read = _video_frame_reader(video)
    out_folder = os.path.join(out_path, _video_name(video))
    os.makedirs(out_folder, exist_ok=True)
    for t, name in enumerate(video.file_names):
        frame = read(name).astype(np.uint8).copy()
        for track in video_tracks:
            if not track.valid_frames[t] or track.masks[t] is None:
                continue
            draw_instance(frame, {
                "mask": track.masks[t],
                "score": track.compute_final_score(final_score_policy),
                "category_id": track.compute_final_category(final_class_policy),
                "instance_id": track.get_id()}, cmap, class_names,
                mask_alpha=0.55, draw_box=False, font_size=0.6)
        write_rgb(os.path.join(out_folder, os.path.basename(name)), frame)


def overlay_tracks_on_frame(frame: np.ndarray, results: List[Dict], t: int,
                            cat_names: Optional[Dict[int, str]] = None,
                            alpha: float = 0.45,
                            score_threshold: float = 0.0) -> np.ndarray:
    """Every track's mask and label on frame `t` of a video. frame: (H, W, 3)
    uint8 RGB; results: the tracker's records ({video_id, score,
    category_id, segmentations})."""
    cv2 = _cv2()
    out = frame.astype(np.float32).copy()
    boxes = []
    for tid, rec in enumerate(results):
        if rec.get("score", 1.0) < score_threshold:
            continue
        seg = rec["segmentations"][t] if t < len(rec["segmentations"]) else None
        if not seg:
            continue
        mask = rle_lib.decode(seg).astype(bool)
        color = color_for(tid)
        out[mask] = (1 - alpha) * out[mask] + alpha * color
        ys, xs = np.nonzero(mask)
        if len(ys):
            name = (cat_names or {}).get(rec.get("category_id", 0),
                                         str(rec.get("category_id", "?")))
            label = f"{tid}:{name} {rec.get('score', 0):.2f}"
            boxes.append((int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()),
                          color, label))
    out = np.ascontiguousarray(np.clip(out, 0, 255).astype(np.uint8))
    for x0, y0, x1, y1, color, label in boxes:
        cv2.rectangle(out, (x0, y0), (x1, y1), color.tolist(), 1)
        cv2.putText(out, label, (x0, max(y0 - 3, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                    color.tolist(), 1, cv2.LINE_AA)
    return out


def save_video_visualization(video, results: List[Dict], out_dir: str,
                             cat_names: Optional[Dict[int, str]] = None,
                             score_threshold: float = 0.1) -> List[str]:
    """Every frame of a `VideoClips` video with its final tracks (the
    reference's merged tracks mode); a frame cv2 cannot read is skipped.
    Returns the paths written."""
    cv2 = _cv2()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, name in enumerate(video.file_names):
        img = cv2.imread(os.path.join(video.images_folder, name))
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        vis = overlay_tracks_on_frame(img, results, t, cat_names,
                                      score_threshold=score_threshold)
        path = os.path.join(out_dir, f"{video.video_id}_{t:04d}.jpg")
        cv2.imwrite(path, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
        paths.append(path)
    return paths


def render_sampling_points(frame: np.ndarray, sampling_locations: np.ndarray,
                           attention_weights: np.ndarray, query_idx: int,
                           frame_idx: int, level_colors: bool = True,
                           level: Optional[int] = None) -> np.ndarray:
    """One query's deformable sampling points over a frame (reference
    att_maps_viz.py: a color a level, radius by weight).
    sampling_locations: (T, Lq, M, L, P, 2) normalized; attention_weights:
    (T, Lq, M, L, P). With `level` set only that level's points are drawn
    (the reference's per-level mode); None draws every level."""
    cv2 = _cv2()
    out = np.ascontiguousarray(np.clip(frame, 0, 255).astype(np.uint8))
    h, w = frame.shape[:2]
    loc = np.asarray(sampling_locations)[frame_idx, query_idx]   # (M, L, P, 2)
    att = np.asarray(attention_weights)[frame_idx, query_idx]    # (M, L, P)
    M, L, P, _ = loc.shape
    amax = max(att.max(), 1e-6)
    for m in range(M):
        for lvl in range(L):
            if level is not None and lvl != level:
                continue
            color = _COLORS[(lvl if level_colors else m) % len(_COLORS)]
            for p in range(P):
                x = int(np.clip(loc[m, lvl, p, 0], 0, 1) * (w - 1))
                y = int(np.clip(loc[m, lvl, p, 1], 0, 1) * (h - 1))
                r = max(1, int(round(4 * att[m, lvl, p] / amax)))
                cv2.circle(out, (x, y), r, color.tolist(), -1)
    return out


def decoder_attention(records: Sequence[Dict], layer: int = -1):
    """The current frame's sampling locations (T, Lq, M, L, P, 2) and
    attention weights (T, Lq, M, L, P) of one decoder layer, as numpy f32,
    from `models.attention.capture_sampling`'s records (one a decoder layer,
    in call order). Takes the place of the JAX package's
    `extract_decoder_attention` over a flax `intermediates` tree."""
    rec = records[layer]
    return (rec["loc_c"].float().cpu().numpy(), rec["att_c"].float().cpu().numpy())


def visualize_dataset_sample(sample: Dict, out_dir: str, idx: int = 0,
                             mean=(0.485, 0.456, 0.406),
                             std=(0.229, 0.224, 0.225)) -> List[str]:
    """An augmented train clip with its ground truth (reference
    visualize_dataset.py): the images un-normalized, GT masks and boxes
    drawn."""
    cv2 = _cv2()
    os.makedirs(out_dir, exist_ok=True)
    images = sample["images"]                          # (T, H, W, 3) normalized
    T = images.shape[0]
    h, w = images.shape[1:3]
    paths = []
    for t in range(T):
        img = (images[t] * np.asarray(std) + np.asarray(mean)) * 255.0
        img = np.clip(img, 0, 255).astype(np.float32)
        for n in range(len(sample["labels"])):
            if not sample["valid"][n, t]:
                continue
            color = color_for(n)
            mask = sample["masks"][n, t].astype(bool)
            img[mask] = 0.55 * img[mask] + 0.45 * color
        img = np.ascontiguousarray(img.astype(np.uint8))
        for n in range(len(sample["labels"])):
            if not sample["valid"][n, t]:
                continue
            color = color_for(n)
            cx, cy, bw, bh = sample["boxes"][n, t]
            x0, y0 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
            x1, y1 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
            cv2.rectangle(img, (x0, y0), (x1, y1), color.tolist(), 1)
            cv2.putText(img, str(int(sample["labels"][n])), (x0, max(y0 - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color.tolist(), 1)
        path = os.path.join(out_dir, f"sample{idx}_t{t}.jpg")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(path)
    return paths
