"""Evaluation-time frame transforms (the slice of
`devis_tpu/datasets/transforms.py` that clip inference reads), and bilinear
resizes that give OpenCV's `cv2.resize(..., INTER_LINEAR)` results without
OpenCV.

OpenCV takes two routes for INTER_LINEAR, and each resize here repeats one:

- float32 (`resize_linear_f32`; the tracker's mask logits, the synthetic
  corpus's float frames): OpenCV hands a source of at least 2 x 2 pixels to
  Intel IPP, which places output pixel d at source coordinate
  (d + 0.5) * (in / out) - 0.5 in float64, clamps it into the source, keeps
  the fraction f as float32 and interpolates a + (b - a) * f with one
  rounding (a fused multiply-add), along x and then along y. Repeated in that
  order (in C, `csrc/resize.c`, which leaves the GIL to the tracker's other
  threads; `resize_linear_f32_plain` is its numpy version), the result is
  bit-exact on 2-d sources of 2 x 2 pixels or more (the tests scan 60 size
  pairs); on 3-channel sources some columns differ in the last bit.
- uint8 (`resize_linear_u8`, video frames): fixed point. The coordinate is
  float32 (d + 0.5) * (1 / (out / in)) - 0.5 (the scale is the reciprocal
  of out / in, as for INTER_NEAREST), the two weights are rounded to 11
  fractional bits, the rows are summed exactly in integers, and the columns
  are combined by OpenCV's SIMD rounding: each row sum is shifted right by 4,
  multiplied by its weight keeping the high 16 bits, and the two halves are
  added and rounded by 2 bits. OpenCV's scalar tail rounds the exact sum
  once instead, so pixels it handles (the last few of a row, how many
  depends on the CPU's vector width) can differ by one grey level; no pixel
  differs by more.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..evaluation import _native


def get_size_with_aspect_ratio(image_size: Tuple[int, int], size: int,
                               max_size: Optional[int] = None) -> Tuple[int, int]:
    """Shorter side to `size`, longer side at most `max_size`
    (reference coco_transforms.py:109-130)."""
    h, w = image_size
    if max_size is not None:
        min_original = float(min(h, w))
        max_original = float(max(h, w))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def _clamped(s: np.ndarray, f: np.ndarray, src: int):
    """Source index pairs and fractions, clamped into [0, src - 1]."""
    lo, hi = s < 0, s >= src - 1
    s = np.where(lo, 0, np.where(hi, src - 1, s))
    f = np.where(lo | hi, np.float32(0), f).astype(np.float32)
    return s, np.minimum(s + 1, src - 1), f


def _taps_f32(src: int, dst: int):
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(pos)
    return _clamped(s.astype(np.int64), (pos - s).astype(np.float32), src)


def _lerp_f32(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """a + (b - a) * f in float32 with one rounding after the multiply-add:
    the float32 product is exact in float64."""
    d = (b - a).astype(np.float64)
    d *= f
    d += a
    return d.astype(np.float32)


def resize_linear_f32_plain(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The numpy version of `resize_linear_f32`: the same arithmetic in the
    same order (the x pass, then the y pass on float32 rows)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    oh, ow = size
    tail = (1,) * (img.ndim - 2)
    x0, x1, fx = _taps_f32(w, ow)
    y0, y1, fy = _taps_f32(h, oh)
    rows = _lerp_f32(img[:, x0], img[:, x1], fx.reshape((1, ow) + tail))
    return _lerp_f32(rows[y0], rows[y1], fy.reshape((oh, 1) + tail))


def resize_linear_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a float32
    (H, W) or (H, W, C) array to `size` = (h, w) (module docstring), in C
    (`csrc/resize.c`)."""
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    oh, ow = size
    out = np.empty((oh, ow) + img.shape[2:], np.float32)
    if _native.lib().resize_linear_f32(img.ctypes.data_as(_native.F32_P), h, w,
                                       img.shape[2] if img.ndim == 3 else 1, oh, ow,
                                       out.ctypes.data_as(_native.F32_P)) != 0:
        raise MemoryError("resize_linear_f32")
    return out


def _taps_u8(src: int, dst: int):
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(pos)
    s, s1, f = _clamped(s.astype(np.int64), (pos - s).astype(np.float32), src)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return s, s1, w0, w1


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a uint8
    (H, W) or (H, W, C) array to `size` = (h, w), within one grey level of
    OpenCV (module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    oh, ow = size
    tail = (1,) * (img.ndim - 2)
    x0, x1, a0, a1 = _taps_u8(w, ow)
    y0, y1, b0, b1 = _taps_u8(h, oh)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0.reshape((1, ow) + tail) + src[:, x1] * a1.reshape((1, ow) + tail)
    top = ((rows[y0] >> 4) * b0.reshape((oh, 1) + tail)) >> 16
    bottom = ((rows[y1] >> 4) * b1.reshape((oh, 1) + tail)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


class ValTransform:
    """The evaluation resize (shorter side `min_size`, longer at most
    `max_size`), returning raw uint8 frames: the network input is normalized
    on the device (`devis_torch.inference.VISInferFn`). A float frame is
    resized in float32 and then truncated to uint8, as the JAX package's
    `ValTransform(normalize=False)` does with OpenCV."""

    normalize = False

    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, image: np.ndarray) -> np.ndarray:
        size = get_size_with_aspect_ratio(image.shape[:2], self.min_size, self.max_size)
        if size == image.shape[:2]:          # OpenCV copies at the same size
            return np.ascontiguousarray(image, np.uint8)
        if image.dtype == np.uint8:
            return resize_linear_u8(image, size)
        return np.ascontiguousarray(resize_linear_f32(image, size), np.uint8)
