"""VIS clip inference: the device step of the clip-stitching tracker (port of
`VISInferFn` and `make_eval_buckets` of `devis_tpu/inference.py`).

`VISInferFn` keeps the JAX package's three stages: `prepare` (host: load and
pad one clip to a static canvas), `dispatch` (upload and enqueue the forward;
returns without waiting for the GPU) and `fetch` (wait, copy back and adapt
the outputs to the tracker's dict). Mask logits leave the device as
float8_e4m3fn, 1 byte a pixel: its resolution is finest around logit 0,
where the tracker's threshold decides.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .util.misc import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_canvas(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w)."""
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return round_up(h, 64), round_up(w, 64)


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
