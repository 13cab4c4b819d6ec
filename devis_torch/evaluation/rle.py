"""COCO-compatible run-length-encoded masks (port of
`devis_tpu/evaluation/rle.py`).

An RLE is ``{"size": [h, w], "counts": str}``, as pycocotools writes it:
runs over the mask flattened in Fortran (column-major) order, starting with
the zeros, in pycocotools' character encoding (`rleToString`). Every public
function runs on the C codec of `csrc/rle.c` (`_native`); the numpy
functions ending in `_plain` compute the same things and are what the tests
hold the codec against.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import _native


def encode(mask: np.ndarray) -> Dict:
    """Binary mask (H, W) → RLE with string counts."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=bool).ravel(order="F")
    if flat.size == 0:
        return {"size": [h, w], "counts": ""}
    return {"size": [h, w],
            "counts": _native.counts_to_string(_native.encode_counts(flat.view(np.uint8)))}


def decode(rle: Dict) -> np.ndarray:
    """RLE → binary mask (H, W) uint8."""
    h, w = rle["size"]
    return _native.decode_counts(counts_of(rle), h * w).reshape((h, w), order="F")


def area(rle: Dict) -> int:
    return _native.area(counts_of(rle))


def intersection(a: Dict, b: Dict) -> int:
    """Foreground overlap of two RLEs, on the counts (no decode)."""
    return _native.intersection(counts_of(a), counts_of(b))


def iou(dt: Sequence[Dict], gt: Sequence[Dict],
        iscrowd: Sequence[bool] | None = None) -> np.ndarray:
    """Pairwise mask IoU, (len(dt), len(gt)) float64; a crowd gt divides by
    the detection's area (pycocotools)."""
    if iscrowd is None:
        iscrowd = [False] * len(gt)
    if not len(dt) or not len(gt):
        return np.zeros((len(dt), len(gt)))
    return _native.iou_matrix([counts_of(d) for d in dt], [counts_of(g) for g in gt],
                              [bool(c) for c in iscrowd])


def compute_iou_matrix(masks1: Sequence[Dict], masks2: Sequence[Dict],
                       is_encoded: bool = True) -> np.ndarray:
    """RLE IoU matrix, (len(masks1), len(masks2)) float64 (reference
    util/mask_ops.py:5-33). `is_encoded` is the reference's flag: the
    masks are RLEs either way."""
    return iou(list(masks1), list(masks2))


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    """Union (or intersection) of RLE masks."""
    if not rles:
        raise ValueError("merge of an empty list")
    acc = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        acc = acc & m if intersect else acc | m
    return encode(acc)


def counts_of(rle: Dict) -> np.ndarray:
    """The run counts of an RLE, int64, whatever form its counts take."""
    c = rle["counts"]
    if isinstance(c, bytes):
        c = c.decode("ascii")
    if isinstance(c, str):
        return _native.string_to_counts(c) if c else np.zeros(0, np.int64)
    return np.asarray(c, np.int64)


def soft_iou(probs1: np.ndarray, probs2: np.ndarray) -> float:
    """Soft IoU of probability masks (the reference's matcher.py:310-321)."""
    inter = float((probs1 * probs2).sum())
    union = float((probs1 + probs2 - probs1 * probs2).sum())
    return inter / max(union, 1e-6)


# ---------------------------------------------------------------------------
# Plain versions: numpy, the same results as the codec
# ---------------------------------------------------------------------------

def encode_counts_plain(flat: np.ndarray) -> List[int]:
    """Flat F-order 0/1 mask → run counts starting with the zeros."""
    flat = np.asarray(flat, bool)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + counts if flat[0] else counts


def encode_plain(mask: np.ndarray) -> Dict:
    h, w = mask.shape
    flat = np.asarray(mask, bool).ravel(order="F")
    if flat.size == 0:
        return {"size": [h, w], "counts": ""}
    return {"size": [h, w], "counts": counts_to_string_plain(encode_counts_plain(flat))}


def decode_plain(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=np.uint8)
    pos, val = 0, 0
    for c in counts_plain(rle):
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def area_plain(rle: Dict) -> int:
    return int(sum(counts_plain(rle)[1::2]))


def _intervals(counts: Sequence[int]) -> np.ndarray:
    """The [start, end) runs of ones in flat F order, (n, 2)."""
    counts = np.asarray(counts, dtype=np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.stack([starts[1::2], ends[1::2]], axis=1)


def intersection_plain(a: Dict, b: Dict) -> int:
    iv_a, iv_b = _intervals(counts_plain(a)), _intervals(counts_plain(b))
    i = j = total = 0
    while i < len(iv_a) and j < len(iv_b):
        lo = max(iv_a[i, 0], iv_b[j, 0])
        hi = min(iv_a[i, 1], iv_b[j, 1])
        total += max(0, hi - lo)
        if iv_a[i, 1] < iv_b[j, 1]:
            i += 1
        else:
            j += 1
    return int(total)


def iou_plain(dt: Sequence[Dict], gt: Sequence[Dict],
              iscrowd: Sequence[bool] | None = None) -> np.ndarray:
    if iscrowd is None:
        iscrowd = [False] * len(gt)
    out = np.zeros((len(dt), len(gt)))
    for i, d in enumerate(dt):
        for j, g in enumerate(gt):
            inter = intersection_plain(d, g)
            union = area_plain(d) if iscrowd[j] else area_plain(d) + area_plain(g) - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def counts_to_string_plain(counts: Sequence[int]) -> str:
    """pycocotools' `rleToString`: 5 bits a character with a continuation bit,
    each count from the third on stored as its difference to the count two
    before it."""
    chars = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            chars.append(chr((ch | 0x20 if more else ch) + 48))
    return "".join(chars)


def string_to_counts_plain(s: str) -> List[int]:
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = k = 0
        more = True
        while more:
            ch = ord(s[p]) - 48
            x |= (ch & 0x1F) << (5 * k)
            more = bool(ch & 0x20)
            p += 1
            k += 1
            if not more and (ch & 0x10):
                x |= -1 << (5 * k)
        counts.append(x + (counts[-2] if len(counts) > 2 else 0))
    return counts


def counts_plain(rle: Dict) -> List[int]:
    c = rle["counts"]
    if isinstance(c, bytes):
        c = c.decode("ascii")
    return string_to_counts_plain(c) if isinstance(c, str) else [int(v) for v in c]
