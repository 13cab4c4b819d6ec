"""ctypes bindings of the port's host C code: the RLE codec
(`devis_torch/csrc/rle.c`), OpenCV's float bilinear resize
(`devis_torch/csrc/resize.c`), OpenCV's polygon fill (`csrc/poly.c`) and
PNG's scanline unfiltering (`csrc/png.c`).

The sources are built with ``cc -O2 -fPIC -shared`` into
`devis_torch/_build/libhost.so` at first use (and again when a source is
newer). A failed build raises: the numpy functions in `rle.py`,
`datasets/{transforms,coco,image_io}.py` are the plain versions the tests hold this library
against, not a fallback. ctypes releases the GIL for each call.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Sequence

import numpy as np

from ..ops import _build

SOURCES = [os.path.join(_build.SRC_DIR, f) for f in ("rle.c", "resize.c", "poly.c", "png.c")]
LIB_PATH = os.path.join(_build.BUILD_DIR, "libhost.so")

_lib = None
_lock = threading.Lock()
_LONG_P = ctypes.POINTER(ctypes.c_long)
U8_P = ctypes.POINTER(ctypes.c_uint8)
_CHAR_P = ctypes.POINTER(ctypes.c_char)
F32_P = ctypes.POINTER(ctypes.c_float)


def _compile() -> None:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) found to build the host library")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    out = subprocess.run([cc, "-O2", "-fPIC", "-shared", "-o", tmp, *SOURCES, "-lm"],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"building the host library failed:\n{out.stderr}")
    os.replace(tmp, LIB_PATH)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < max(
                    os.path.getmtime(src) for src in SOURCES):
                _compile()
            L = ctypes.CDLL(LIB_PATH)
            L.rle_encode.restype = ctypes.c_long
            L.rle_encode.argtypes = [U8_P, ctypes.c_long, _LONG_P, ctypes.c_long]
            L.rle_decode.restype = ctypes.c_long
            L.rle_decode.argtypes = [_LONG_P, ctypes.c_long, U8_P, ctypes.c_long]
            L.rle_area.restype = ctypes.c_long
            L.rle_area.argtypes = [_LONG_P, ctypes.c_long]
            L.rle_intersection.restype = ctypes.c_long
            L.rle_intersection.argtypes = [_LONG_P, ctypes.c_long, _LONG_P, ctypes.c_long]
            L.rle_iou_matrix.restype = None
            L.rle_iou_matrix.argtypes = [_LONG_P, _LONG_P, _LONG_P, ctypes.c_long,
                                         _LONG_P, _LONG_P, _LONG_P, ctypes.c_long,
                                         U8_P, ctypes.POINTER(ctypes.c_double)]
            L.rle_counts_to_string.restype = ctypes.c_long
            L.rle_counts_to_string.argtypes = [_LONG_P, ctypes.c_long, _CHAR_P,
                                               ctypes.c_long]
            L.rle_string_to_counts.restype = ctypes.c_long
            L.rle_string_to_counts.argtypes = [_CHAR_P, ctypes.c_long, _LONG_P,
                                               ctypes.c_long]
            L.resize_linear_f32.restype = ctypes.c_long
            L.resize_linear_f32.argtypes = [F32_P] + [ctypes.c_long] * 5 + [F32_P]
            L.fill_poly.restype = ctypes.c_long
            L.fill_poly.argtypes = [U8_P, ctypes.c_long, ctypes.c_long, _LONG_P, _LONG_P,
                                    ctypes.c_long]
            L.png_unfilter.restype = ctypes.c_long
            L.png_unfilter.argtypes = [U8_P, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                                       U8_P]
            _lib = L
    return _lib


def _ptr_long(a: np.ndarray):
    return a.ctypes.data_as(_LONG_P)


def _ptr_u8(a: np.ndarray):
    return a.ctypes.data_as(U8_P)


def _longs(counts) -> np.ndarray:
    return np.ascontiguousarray(counts, dtype=np.int64)


def encode_counts(mask_f: np.ndarray) -> np.ndarray:
    """Flat F-order 0/1 mask → int64 run counts."""
    mask_f = np.ascontiguousarray(mask_f, dtype=np.uint8)
    out = np.empty(mask_f.size + 2, dtype=np.int64)
    n = lib().rle_encode(_ptr_u8(mask_f), mask_f.size, _ptr_long(out), out.size)
    if n < 0:
        raise RuntimeError("rle_encode: count buffer too small")
    return out[:n]


def decode_counts(counts, n: int) -> np.ndarray:
    """Run counts → flat F-order uint8 mask of `n` elements."""
    counts = _longs(counts)
    out = np.empty(n, dtype=np.uint8)
    if lib().rle_decode(_ptr_long(counts), len(counts), _ptr_u8(out), n) != 0:
        raise ValueError(f"RLE counts cover more than {n} pixels")
    return out


def area(counts) -> int:
    counts = _longs(counts)
    return int(lib().rle_area(_ptr_long(counts), len(counts)))


def intersection(ca, cb) -> int:
    ca, cb = _longs(ca), _longs(cb)
    return int(lib().rle_intersection(_ptr_long(ca), len(ca), _ptr_long(cb), len(cb)))


def _pack(lst: List[np.ndarray]):
    lens = np.asarray([len(c) for c in lst], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    cat = np.concatenate(lst).astype(np.int64) if lst else np.zeros(0, np.int64)
    return np.ascontiguousarray(cat), offs, lens


def iou_matrix(dt_counts: Sequence, gt_counts: Sequence,
               iscrowd: Sequence[bool]) -> np.ndarray:
    """(len(dt), len(gt)) float64 IoU; a crowd gt divides by the dt area."""
    dc, do, dl = _pack([_longs(c) for c in dt_counts])
    gc, go, gl = _pack([_longs(c) for c in gt_counts])
    crowd = np.asarray(iscrowd, np.uint8).reshape(-1)
    out = np.zeros((len(dt_counts), len(gt_counts)), np.float64)
    lib().rle_iou_matrix(_ptr_long(dc), _ptr_long(do), _ptr_long(dl), len(dt_counts),
                         _ptr_long(gc), _ptr_long(go), _ptr_long(gl), len(gt_counts),
                         _ptr_u8(crowd), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def counts_to_string(counts) -> str:
    """int64 counts → pycocotools' character string."""
    counts = _longs(counts)
    buf = ctypes.create_string_buffer(13 * max(1, len(counts)))
    n = lib().rle_counts_to_string(_ptr_long(counts), len(counts), buf, len(buf))
    if n < 0:
        raise RuntimeError("rle_counts_to_string: buffer too small")
    return buf.raw[:n].decode("ascii")


def string_to_counts(s: str) -> np.ndarray:
    """pycocotools' character string → int64 counts."""
    raw = s.encode("ascii")
    out = np.empty(max(1, len(raw)), dtype=np.int64)
    n = lib().rle_string_to_counts(ctypes.cast(ctypes.c_char_p(raw), _CHAR_P), len(raw),
                                   _ptr_long(out), out.size)
    if n < 0:
        raise ValueError(f"malformed RLE string {s[:40]!r}")
    return out[:n]



def fill_poly(mask: np.ndarray, polygons: Sequence[np.ndarray]) -> None:
    """Fills int (n, 2) (x, y) polygons into the C-contiguous uint8 (h, w)
    `mask` with 1, as cv2.fillPoly(mask, polygons, 1) does."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags.c_contiguous:
        raise ValueError("fill_poly takes a C-contiguous uint8 (h, w) mask")
    counts = np.asarray([len(p) for p in polygons], np.int64)
    xy = (np.concatenate([np.asarray(p, np.int64).reshape(-1, 2) for p in polygons])
          if len(polygons) else np.zeros((0, 2), np.int64))
    xy = np.ascontiguousarray(xy)
    if lib().fill_poly(_ptr_u8(mask), mask.shape[0], mask.shape[1], _ptr_long(xy),
                       _ptr_long(counts), len(counts)) != 0:
        raise MemoryError("fill_poly")


def png_unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undoes the PNG scanline filters of `raw` (height rows of a filter
    byte and row_bytes bytes) into a (height, row_bytes) uint8 array; raises
    ValueError, naming the row, on a filter type outside 0-4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    bad = lib().png_unfilter(_ptr_u8(raw), height, row_bytes, bpp, _ptr_u8(out))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type "
                         f"{raw.reshape(-1)[(bad - 1) * (row_bytes + 1)]}")
    return out
