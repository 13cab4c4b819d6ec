"""The five OpenCV functions COCO joint training's augmenter uses
(`devis_tpu/datasets/coco_joint_vis.py:61-101`), in numpy, with OpenCV's
arithmetic so that the port's pseudo-clips are the JAX package's:

- `get_perspective_transform`: the 8 x 8 system of `cv::getPerspectiveTransform`
  (the products src * dst taken in f32, as OpenCV takes them from its
  Point2f, the rest in f64), solved by Gaussian elimination with partial
  pivoting; `get_rotation_matrix_2d`: `cv::getRotationMatrix2D` (the centre
  a Point2f). Both f64, to 1e-12 of OpenCV's.
- `warp_perspective_linear`: `cv::warpPerspective` INTER_LINEAR of an f32
  image with BORDER_CONSTANT 0, as OpenCV 5 computes it (its SIMD warp
  kernels; OpenCV 4's fixed-point path, the source coordinate rounded to
  1/32 of a pixel and the weights read from a table, gives other pixels, up
  to 3 grey levels apart on these images): the matrix inverted by the
  cofactor rule of `cv::invert` (3 x 3) and rounded to f32, each source
  coordinate in f32 (a row's terms, then one fused multiply-add with x, then
  the division by w), the fractions a = x - floor(x), b likewise, and the
  lerps p00 + a (p01 - p00), then the rows' by b, each one fused
  multiply-add; a corner outside the image reads 0. Equal to the bit on
  image widths that are multiples of 16; OpenCV's scalar tail for the last
  columns of other widths rounds differently (a few 1e-3 grey levels).
- `warp_perspective_nearest`: the same coordinates with INTER_NEAREST on
  uint8 masks, rounded to the nearest (to even at .5).
- `filter2d`: `cv::filter2D` (correlation, anchor at the kernel's centre,
  BORDER_REFLECT_101) of an f32 image, summed in f64 and rounded to f32.
  OpenCV filters kernels of 50 taps or more through a DFT, so its last bits
  differ from a direct sum (`tests/test_torch_coco_joint_vis.py` states the
  tolerance).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(3, 3) f64 homography taking the four `src` points to `dst` (f32
    (4, 2) each), as `cv::getPerspectiveTransform` (DECOMP_LU) gives it."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        sx, sy = src[i]
        dx, dy = dst[i]
        a[i, 0] = a[i + 4, 3] = sx
        a[i, 1] = a[i + 4, 4] = sy
        a[i, 2] = a[i + 4, 5] = 1.0
        a[i, 6] = -(sx * dx)                       # f32 products, as OpenCV's
        a[i, 7] = -(sy * dx)
        a[i + 4, 6] = -(sx * dy)
        a[i + 4, 7] = -(sy * dy)
        b[i], b[i + 4] = dx, dy
    x = _solve_lu(a, b)
    return np.append(x, 1.0).reshape(3, 3)


def _solve_lu(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's `LUImpl` then back substitution: partial pivoting by the
    largest |a[j, i]|, rows swapped, eliminated below the pivot."""
    a, b = a.copy(), b.copy()
    n = len(b)
    for i in range(n):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if a[k, i] == 0:
            raise np.linalg.LinAlgError("singular system")
        if k != i:
            a[[i, k]] = a[[k, i]]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, n):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
    x = np.zeros(n)
    for i in range(n - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, n):
            s -= a[i, k] * x[k]
        x[i] = s / a[i, i]
    return x


def get_rotation_matrix_2d(center: Sequence[float], angle: float, scale: float) -> np.ndarray:
    """(2, 3) f64 rotation by `angle` degrees about `center` (a Point2f)."""
    cx, cy = (float(v) for v in np.asarray(center, np.float32))
    ang = angle * np.pi / 180
    alpha, beta = np.cos(ang) * scale, np.sin(ang) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert3(m: np.ndarray) -> np.ndarray:
    """`cv::invert` of a 3 x 3 f64 matrix (the cofactor rule); zero where
    singular."""
    s = [[float(v) for v in row] for row in np.asarray(m, np.float64)]
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    t = [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d,
         (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
         (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d,
         (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
         (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d,
         (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
         (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d,
         (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
         (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]
    return np.array(t, np.float64).reshape(3, 3)


def _fma(a, b, c) -> np.ndarray:
    """f32 a * b + c with one rounding (the product exact in f64)."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)
            ).astype(np.float32)


def _source_coords(m: np.ndarray, size: Tuple[int, int]):
    """f32 source (x, y) of every destination pixel of `size` = (h, w): the
    inverse matrix rounded to f32, a row's terms M1 y + M2 (M4 y + M5, M7 y
    + M8) in f32, then fused with M0 x (M3 x, M6 x), x and y divided by w."""
    M = invert3(m).astype(np.float32).reshape(-1)
    h, w = size
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    wx = _fma(M[6], x, M[7] * y + M[8])
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = _fma(M[0], x, M[1] * y + M[2]) / wx
        sy = _fma(M[3], x, M[4] * y + M[5]) / wx
    return sx, sy


def _pixels(src: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """src[yy, xx] where inside, else 0 (BORDER_CONSTANT)."""
    H, W = src.shape[:2]
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
    return np.where(ok.reshape(ok.shape + (1,) * (v.ndim - ok.ndim)), v, v.dtype.type(0))


def _index(v: np.ndarray) -> np.ndarray:
    """f32 coordinates to int64, the non-finite and the far ones outside."""
    v = np.where(np.isfinite(v), v, -2.0)
    return np.clip(v, -2.0, 1 << 30).astype(np.int64)


def warp_perspective_linear(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.warpPerspective(img, m, dsize, flags=INTER_LINEAR) of an f32
    (h, w[, c]) image, `dsize` = (w, h) as OpenCV takes it (module
    docstring)."""
    img = np.asarray(img, np.float32)
    ow, oh = dsize
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    sx, sy = _source_coords(m, (oh, ow))
    fx, fy = np.floor(sx), np.floor(sy)
    a = (sx - fx).astype(np.float32)[..., None]
    b = (sy - fy).astype(np.float32)[..., None]
    ix, iy = _index(fx), _index(fy)
    p00, p01 = _pixels(src, iy, ix), _pixels(src, iy, ix + 1)
    p10, p11 = _pixels(src, iy + 1, ix), _pixels(src, iy + 1, ix + 1)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    out = _fma(b, v1 - v0, v0)
    out = np.where(np.isfinite(out), out, np.float32(0))
    return out[:, :, 0] if squeeze else out


def warp_perspective_nearest(mask: np.ndarray, m: np.ndarray,
                             dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.warpPerspective(mask, m, dsize, flags=INTER_NEAREST) of a uint8
    (h, w) mask, BORDER_CONSTANT 0; `dsize` = (w, h)."""
    mask = np.asarray(mask, np.uint8)
    ow, oh = dsize
    sx, sy = _source_coords(m, (oh, ow))
    return _pixels(mask, _index(np.rint(sy)), _index(np.rint(sx))).astype(np.uint8)


def _reflect101(n: int, pad_lo: int, pad_hi: int) -> np.ndarray:
    idx = np.arange(-pad_lo, n + pad_hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) of an f32 (h, w[, c]) image: the
    correlation with `kernel` (kh, kw) anchored at (kh // 2, kw // 2),
    BORDER_REFLECT_101, in f64, rounded to f32."""
    img = np.asarray(img, np.float32)
    kernel = np.asarray(kernel, np.float32).astype(np.float64)
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    rows = _reflect101(h, ay, kh - 1 - ay)
    cols = _reflect101(w, ax, kw - 1 - ax)
    padded = img.astype(np.float64)[rows][:, cols]
    out = np.zeros(img.shape, np.float64)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0:
                out += kernel[i, j] * padded[i:i + h, j:j + w]
    return out.astype(np.float32)
