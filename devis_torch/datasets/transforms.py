"""Image and clip transforms (port of `devis_tpu/datasets/transforms.py`),
and the resizes and colour conversions they need, which give OpenCV's
results without OpenCV.

The training half (`resize_sample`, `hflip_sample`, `crop_sample`,
`photometric_distort`, `random_erasing_sample`, `normalize_sample`,
`ClipTransform`, `boxes_from_masks`) takes its randomness from a caller's
`random.Random` and draws it in the JAX package's order, so one seed gives
the JAX package's sample. Images are resized by `resize_linear_f32`, masks by
`resize_nearest_numpy` (OpenCV's INTER_NEAREST index rule), and the float
HSV conversions of the photometric distortion repeat OpenCV's
`cvtColor(COLOR_RGB2HSV / COLOR_HSV2RGB)` on float32 in numpy (S and V to
the bit, H within a few ulp of 360).

A sample is a dict: image (H, W, 3) float32 RGB in [0, 255], boxes (N, 4)
absolute xyxy (normalized cxcywh after `normalize_sample`), labels (N,),
masks (N, H, W) uint8, valid (N,).

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

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..evaluation import _native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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


def resize_nearest_numpy(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of an (h, w, ...) array to `size` = (oh, ow) by the
    index rule of OpenCV's INTER_NEAREST: source = min(floor(dst * (1 / (out
    / in))), in - 1), the scale taken as the f64 reciprocal of out / in as
    OpenCV takes it (`in / out` differs from it in the last bit at some
    sizes, and then picks the neighbouring source row where dst * scale is
    near an integer)."""
    h, w = mask.shape[:2]
    oh, ow = size
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return mask[ys][:, xs]            # rows, then columns: two takes, no 2-d index


# ---------------------------------------------------------------------------
# Training transforms
# ---------------------------------------------------------------------------

def resize_sample(sample: Dict, size: Tuple[int, int]) -> Dict:
    """Image (bilinear, float32) and masks (nearest) to `size` = (h, w);
    boxes scaled."""
    h, w = sample["image"].shape[:2]
    oh, ow = size
    out = dict(sample, image=resize_linear_f32(sample["image"], (oh, ow)))
    if "boxes" in sample and len(sample["boxes"]):
        scale = np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
        out["boxes"] = sample["boxes"] * scale
    if "masks" in sample and len(sample["masks"]):
        masks = np.asarray(sample["masks"]).astype(np.uint8)
        out["masks"] = np.ascontiguousarray(
            resize_nearest_numpy(masks.transpose(1, 2, 0), (oh, ow)).transpose(2, 0, 1))
    return out


def hflip_sample(sample: Dict) -> Dict:
    w = sample["image"].shape[1]
    out = dict(sample, image=sample["image"][:, ::-1].copy())
    if "boxes" in sample and len(sample["boxes"]):
        b = sample["boxes"].copy()
        b[:, [0, 2]] = w - b[:, [2, 0]]
        out["boxes"] = b
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = sample["masks"][:, :, ::-1].copy()
    return out


def crop_sample(sample: Dict, region: Tuple[int, int, int, int]) -> Dict:
    """region = (y0, x0, h, w). Boxes clamped; instances the crop empties
    are invalidated (reference coco_transforms.py:22-76)."""
    y0, x0, h, w = region
    out = dict(sample, image=sample["image"][y0:y0 + h, x0:x0 + w].copy())
    if "boxes" in sample and len(sample["boxes"]):
        b = sample["boxes"] - np.array([x0, y0, x0, y0], np.float32)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, w)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, h)
        out["boxes"] = b
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = sample["masks"][:, y0:y0 + h, x0:x0 + w].copy()
    if "valid" in sample and "masks" in out and len(out.get("masks", [])):
        keep = out["masks"].reshape(len(out["masks"]), -1).sum(1) > 0
        out["valid"] = np.logical_and(sample["valid"], keep)
    return out


_F32_EPS = float(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) of float32 RGB: H in [0, 360),
    S and V in [0, 1] for inputs in [0, 1]."""
    img = np.asarray(img, np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + np.float32(_F32_EPS))
    scale = (60.0 / (diff.astype(np.float64) + _F32_EPS)).astype(np.float32)
    h = np.where(v == r, (g - b) * scale,
                 np.where(v == g, (b - r) * scale + np.float32(120),
                          (r - g) * scale + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], -1).astype(np.float32)


# OpenCV's table of (b, g, r) sources by sector of the hue circle
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) of float32 HSV with H in degrees."""
    hsv = np.asarray(hsv, np.float32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.mod(h * np.float32(6.0 / 360.0), np.float32(6))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0), h)
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    src = _HSV_SECTORS[sector]
    bgr = np.take_along_axis(tab, src, -1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


# channel permutations for lighting noise (reference coco_transforms.py:336-347)
_LIGHTING_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                   (2, 1, 0))


def photometric_distort(image: np.ndarray, rng: random.Random,
                        brightness_delta: float = 0.0,
                        contrast: Tuple[float, float] = (0.5, 1.3),
                        contrast_post: Tuple[float, float] = (0.5, 1.5),
                        saturation: Tuple[float, float] = (0.7, 1.3),
                        hue_delta: float = 8.0,
                        lighting_noise: bool = True) -> np.ndarray:
    """The reference's `VISPhotometricDistort` (`vis_transforms.py:348-376`):
    optional brightness shift, random contrast either before or after the
    HSV chain (one coin flip; the pre-HSV contrast uses the recipe's bound,
    the post-HSV one the default 1.5), saturation scale and hue rotation in
    float HSV, and lighting noise, a random channel permutation."""
    img = image.astype(np.float32)
    if brightness_delta and rng.random() < 0.5:
        img += rng.uniform(-brightness_delta, brightness_delta)
    contrast_first = rng.random() < 0.5
    if contrast_first and rng.random() < 0.5:
        img *= rng.uniform(contrast[0], contrast[1])
    hsv = rgb_to_hsv(np.clip(img, 0, 255) / 255.0)
    if rng.random() < 0.5:
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation), 0, 1)
    if rng.random() < 0.5:
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) % 360
    img = hsv_to_rgb(hsv) * 255.0
    if not contrast_first and rng.random() < 0.5:
        img *= rng.uniform(*contrast_post)
    if lighting_noise and rng.random() < 0.5:
        perm = _LIGHTING_PERMS[rng.randrange(len(_LIGHTING_PERMS))]
        img = img[:, :, perm]
    return np.clip(img, 0, 255)


def random_erasing_sample(sample: Dict, rng: random.Random, p: float = 0.5,
                          scale: Tuple[float, float] = (0.02, 0.33),
                          ratio: Tuple[float, float] = (0.3, 3.3),
                          value: float = 0.0,
                          drop_overlap: float = 0.7) -> Dict:
    """RandomErasing (reference coco_transforms.py:569-608): erase a random
    rectangle and invalidate instances whose box it covers by more than
    `drop_overlap` of their area."""
    if rng.random() >= p:
        return sample
    img = sample["image"]
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh = int(round(np.sqrt(target_area * aspect)))
        ew = int(round(np.sqrt(target_area / aspect)))
        if eh < h and ew < w:
            y0 = rng.randint(0, h - eh)
            x0 = rng.randint(0, w - ew)
            break
    else:
        return sample
    out_img = img.copy()
    out_img[y0:y0 + eh, x0:x0 + ew] = value
    out = dict(sample, image=out_img)
    if "boxes" in sample and len(sample["boxes"]):
        b = sample["boxes"]
        ix = (np.minimum(b[:, 2], x0 + ew) - np.maximum(b[:, 0], x0)).clip(min=0)
        iy = (np.minimum(b[:, 3], y0 + eh) - np.maximum(b[:, 1], y0)).clip(min=0)
        box_area = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).clip(min=1e-9)
        if "valid" in sample:
            out["valid"] = np.logical_and(sample["valid"], ix * iy <= drop_overlap * box_area)
    return out


def normalize_sample(sample: Dict) -> Dict:
    """/255 and ImageNet normalisation; boxes to cxcywh normalized by the
    image size (reference coco_transforms.py:640+)."""
    image = sample["image"].astype(np.float32) / 255.0
    image = (image - IMAGENET_MEAN) / IMAGENET_STD
    out = dict(sample, image=image)
    h, w = image.shape[:2]
    if "boxes" in sample and len(sample["boxes"]):
        b = sample["boxes"].astype(np.float32)
        cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                           b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
        cxcywh /= np.array([w, h, w, h], np.float32)
        out["boxes"] = cxcywh
    return out


def boxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """xyxy boxes of the masks' pixels (reference vis_transforms.py:197-242);
    an empty mask gives zeros."""
    out = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return out


class ClipTransform:
    """Random multi-scale resize, horizontal flip, optional crop and
    photometric distortion, one draw for every frame of a clip (reference
    `VISTransformsApplier`, vis_transforms.py:428), then normalisation.
    `rng` supplies every draw, in the JAX package's order."""

    def __init__(self, scales: Sequence[int], rng: random.Random, max_size: int = 768,
                 flip_prob: float = 0.5,
                 scales_before_crop: Sequence[int] = (400, 500, 600),
                 crop_size: Optional[Tuple[int, int]] = (384, 600),
                 crop_prob: float = 0.5, photometric: bool = True,
                 create_bbx_from_mask: bool = True):
        self.scales = list(scales)
        self.rng = rng
        self.max_size = max_size
        self.flip_prob = flip_prob
        self.scales_before_crop = list(scales_before_crop)
        self.crop_size = crop_size
        self.crop_prob = crop_prob
        self.photometric = photometric
        self.create_bbx_from_mask = create_bbx_from_mask

    def __call__(self, frames: List[Dict]) -> List[Dict]:
        rng = self.rng
        do_flip = rng.random() < self.flip_prob
        do_crop = self.crop_size is not None and rng.random() < self.crop_prob
        scale = rng.choice(self.scales)
        if do_flip:
            frames = [hflip_sample(f) for f in frames]
        if do_crop:
            pre = rng.choice(self.scales_before_crop)
            frames = [resize_sample(f, get_size_with_aspect_ratio(f["image"].shape[:2], pre))
                      for f in frames]
            h, w = frames[0]["image"].shape[:2]
            ch = rng.randint(self.crop_size[0], min(h, self.crop_size[1]))
            cw = rng.randint(self.crop_size[0], min(w, self.crop_size[1]))
            ch, cw = min(ch, h), min(cw, w)
            y0 = rng.randint(0, h - ch)
            x0 = rng.randint(0, w - cw)
            frames = [crop_sample(f, (y0, x0, ch, cw)) for f in frames]
        frames = [resize_sample(f, get_size_with_aspect_ratio(f["image"].shape[:2], scale,
                                                              self.max_size))
                  for f in frames]
        if self.photometric:
            # one draw seeds every frame's distortion (the clip stays consistent)
            seed = rng.random()
            for f in frames:
                f["image"] = photometric_distort(f["image"], random.Random(seed))
        out = []
        for f in frames:
            if self.create_bbx_from_mask and len(f.get("masks", [])):
                f = dict(f, boxes=boxes_from_masks(f["masks"]))
            out.append(normalize_sample(f))
        return out
