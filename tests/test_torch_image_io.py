"""The port's image decode and the two OpenCV calls its data path needs,
against OpenCV on this box:

- PNG (`image_io.read_image`) bit-equal to `cv2.imread(IMREAD_COLOR)` +
  BGR→RGB: gray, gray + alpha, RGB and RGBA; each of the five scanline
  filters (files of the port's `encode_png`, one filter a file); odd
  widths; image data over several IDAT chunks; files written by
  `cv2.imwrite`. The C unfilter equals its numpy version bit for bit.
  What the decoder does not support raises, naming the file and feature.
- JPEG through Pillow against cv2's decode: tolerance 0 grey levels (the
  difference measured on this box, on files written by cv2 and by Pillow at
  qualities 50-95, 4:2:0 and 4:4:4, colour and gray).
- `polygons_to_mask` (C) and `polygons_to_mask_plain` bit-equal to
  `cv2.fillPoly(LINE_8, shift 0)`: convex, concave and self-intersecting
  polygons, several parts, vertices off the image, two-point polygons.
- `rgb_to_hsv` / `hsv_to_rgb` against `cv2.cvtColor` on float32 in [0, 1]:
  S, V and RGB to 1e-5; H (degrees) to 1e-5 of its range of 360.
"""

import cv2
import numpy as np
import pytest

from devis_torch.datasets import image_io
from devis_torch.datasets.coco import polygons_to_mask, polygons_to_mask_plain
from devis_torch.datasets.transforms import hsv_to_rgb, rgb_to_hsv
from devis_torch.evaluation import _native


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _pixels(seed, h, w, ch):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, ch)).astype(np.uint8)
    img[: h // 2] = (img[: h // 2] // 32) * 32          # runs, which the filters change
    return img[:, :, 0] if ch == 1 else img


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png_of_each_filter_and_colour_type_is_cv2s(tmp_path, ftype, ch):
    img = _pixels(10 * ftype + ch, 9, 13, ch)           # odd width
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(image_io.encode_png(img, filter_type=ftype))
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def test_png_over_several_idat_chunks(tmp_path):
    img = _pixels(7, 31, 17, 3)
    data = image_io.encode_png(img, filter_type=4, idat_bytes=64)
    assert data.count(b"IDAT") > 5
    path = str(tmp_path / "multi.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(image_io.read_image(path), _cv2_rgb(path))
    np.testing.assert_array_equal(image_io.read_image(path), img)


@pytest.mark.parametrize("shape", [(7, 13, 3), (7, 13, 4), (9, 5), (1, 1, 3), (5, 33, 4)])
def test_png_written_by_cv2(tmp_path, shape):
    img = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.read_image(path), _cv2_rgb(path))


def test_c_unfilter_equals_numpy(tmp_path):
    rs = np.random.RandomState(0)
    for h, row, bpp in [(6, 15, 3), (4, 8, 4), (5, 7, 1), (3, 10, 2)]:
        raw = rs.randint(0, 256, (h, row + 1)).astype(np.uint8)
        raw[:, 0] = rs.randint(0, 5, h)
        np.testing.assert_array_equal(_native.png_unfilter(raw, h, row, bpp),
                                      image_io.png_unfilter_plain(raw, h, row, bpp))
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        _native.png_unfilter(raw, h, row, bpp)


def test_unsupported_png_raises_naming_file_and_feature(tmp_path):
    gray16 = np.random.RandomState(1).randint(0, 65535, (4, 5)).astype(np.uint16)
    path16 = str(tmp_path / "deep.png")
    cv2.imwrite(path16, gray16)
    with pytest.raises(ValueError, match="deep.png: PNG bit depth 16"):
        image_io.read_image(path16)
    data = bytearray(image_io.encode_png(_pixels(0, 4, 4, 3)))
    for byte, field in ((25, "colour type 3"), (28, "interlaced")):
        bad = bytearray(data)
        bad[byte] = 3 if byte == 25 else 1
        crc = _crc(bytes(bad[12:29]))
        bad[29:33] = crc
        path = str(tmp_path / f"bad{byte}.png")
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=f"bad{byte}.png: .*{field}"):
            image_io.read_image(path)
    path = str(tmp_path / "text.png")
    with open(path, "wb") as f:
        f.write(b"GIF89a....")
    with pytest.raises(ValueError, match="text.png: neither PNG nor JPEG"):
        image_io.read_image(path)


def _crc(b):
    import struct
    import zlib
    return struct.pack(">I", zlib.crc32(b))


@pytest.mark.parametrize("writer", ["cv2", "pillow", "pillow444", "gray"])
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_matches_cv2(tmp_path, writer, quality):
    from PIL import Image
    img = np.random.RandomState(quality).randint(0, 256, (37, 51, 3)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 0)
    path = str(tmp_path / "x.jpg")
    if writer == "cv2":
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    elif writer == "gray":
        Image.fromarray(img[:, :, 0]).save(path, quality=quality)
    else:
        Image.fromarray(img).save(path, quality=quality,
                                  subsampling=0 if writer == "pillow444" else 2)
    got = image_io.read_image(path)
    assert np.abs(got.astype(int) - _cv2_rgb(path)).max() == 0


def test_jpeg_without_pillow_raises_naming_it(tmp_path, monkeypatch):
    import builtins
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow.*ROADMAP.md queue A item 3"):
        image_io.read_image(path)


def _random_polygons(rs, h, w, off, n_parts):
    return [np.stack([rs.randint(-off, w + off, n), rs.randint(-off, h + off, n)], 1)
            for n in rs.randint(2, 9, n_parts)]


def _fill_cv2(polys, h, w):
    ref = np.zeros((h, w), np.uint8)
    cv2.fillPoly(ref, [np.asarray(p, np.int32) for p in polys], 1)
    return ref


@pytest.mark.parametrize("off", [0, 4, 40])
def test_polygon_fill_is_cv2s(off):
    rs = np.random.RandomState(off)
    for trial in range(300):
        h, w = rs.randint(1, 48, 2)
        polys = _random_polygons(rs, h, w, off, rs.randint(1, 4))
        seg = [p.astype(float).ravel().tolist() for p in polys]
        ref = _fill_cv2(polys, h, w)
        np.testing.assert_array_equal(polygons_to_mask(seg, h, w), ref, err_msg=str(seg))
        if trial < 60:
            np.testing.assert_array_equal(polygons_to_mask_plain(seg, h, w), ref)


def test_polygon_fill_named_shapes():
    h, w = 40, 50
    shapes = {
        "convex": [[5, 5, 40, 8, 30, 35, 8, 30]],
        "concave": [[5, 5, 45, 5, 45, 35, 25, 12, 5, 35]],
        "self-intersecting": [[5, 5, 45, 35, 45, 5, 5, 35]],
        "two parts": [[2, 2, 12, 2, 12, 12], [30, 20, 48, 38, 20, 38]],
        "off the image": [[-10, -5, 60, 10, 20, 70]],
        "two points": [[3, 4, 30, 25]],
        "float vertices": [[4.5, 3.49, 30.51, 8.2, 17.7, 33.5]],
    }
    for name, seg in shapes.items():
        pts = [np.round(np.asarray(p, float).reshape(-1, 2)).astype(np.int32) for p in seg]
        ref = _fill_cv2(pts, h, w)
        assert ref.any(), name
        np.testing.assert_array_equal(polygons_to_mask(seg, h, w), ref, err_msg=name)
        np.testing.assert_array_equal(polygons_to_mask_plain(seg, h, w), ref, err_msg=name)


def test_rle_segmentations_decode_in_both_count_forms():
    from devis_torch.evaluation import rle
    m = np.zeros((9, 7), np.uint8)
    m[2:6, 1:4] = 1
    enc = rle.encode(m > 0)
    np.testing.assert_array_equal(polygons_to_mask(enc, 9, 7), m)
    lst = {"size": [9, 7], "counts": [int(c) for c in rle.counts_of(enc)]}
    np.testing.assert_array_equal(polygons_to_mask(lst, 9, 7), m)


def test_hsv_both_ways_is_cv2s():
    rs = np.random.RandomState(0)
    img = rs.rand(41, 53, 3).astype(np.float32)
    img[0, :8] = 0.5                         # gray: S = 0
    img[1, :4] = [0.2, 0.2, 0.7]             # ties between channels
    img[2, :4] = 1.0
    img[3, :4] = 0.0
    hsv_ref = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    hsv = rgb_to_hsv(img)
    assert np.abs(hsv[..., 0] - hsv_ref[..., 0]).max() <= 1e-5 * 360
    assert np.abs(hsv[..., 1:] - hsv_ref[..., 1:]).max() <= 1e-5
    shifted = hsv_ref.copy()
    shifted[..., 0] = (shifted[..., 0] + 7.25) % 360
    shifted[..., 1] = np.clip(shifted[..., 1] * 1.2, 0, 1)
    for h in (shifted, (rs.rand(20, 30, 3) * [360, 1, 1]).astype(np.float32)):
        assert np.abs(hsv_to_rgb(h) - cv2.cvtColor(h, cv2.COLOR_HSV2RGB)).max() <= 1e-5
