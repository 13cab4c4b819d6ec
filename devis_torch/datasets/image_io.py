"""Image files to RGB uint8 (h, w, 3) arrays without OpenCV: the port's
counterpart of the JAX package's `cv2.imread(path, IMREAD_COLOR)` followed by
`cv2.cvtColor(..., COLOR_BGR2RGB)` (`devis_tpu/datasets/coco.py:83-86`,
`vis.py:94-97,175-179,187-191`).

- PNG: the port's own decoder. The chunks are parsed here and the image data
  inflated with `zlib`; the five scanline filters are undone in host C
  (`csrc/png.c`; `png_unfilter_plain` is its numpy version). 8-bit gray,
  gray + alpha, RGB and RGBA, not interlaced. As IMREAD_COLOR does, alpha is
  dropped and gray is repeated into the three channels. Anything else
  (another bit depth, a palette, Adam7 interlacing) raises `ValueError`
  naming the file and the feature.
- JPEG: through Pillow, imported inside the functions that use it (JPEG
  needs Pillow as the JAX package's reads need cv2); without it
  `ImportError` names Pillow. The EXIF orientation (tag 0x0112) is applied
  as IMREAD_COLOR applies it (`ImageOps.exif_transpose`).

The format is told by the file's first bytes, not by its name.
`encode_png` writes the PNG files the port's fixtures and tests need, with
any of the five filters and the image data split over several IDAT chunks;
`encode_jpeg` the JPEG files, with an EXIF orientation where asked.
"""
from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

from ..evaluation import _native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# channels of each supported PNG colour type: gray, RGB, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (h, w, 3) pixels of the PNG or JPEG file at `path`."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path)
    if data.startswith(JPEG_SIGNATURE):
        return _decode_jpeg(path)
    raise ValueError(f"{path}: neither PNG nor JPEG (first bytes {data[:8]!r})")


def _chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends without an IEND chunk")


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (h, w, 3) pixels of a PNG file's bytes (module docstring)."""
    header = None
    idat: List[bytes] = []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} (palette) is not supported"
                         if ctype == 3 else f"{name}: PNG colour type {ctype} is invalid")
    if depth != 8:
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (8 only)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if compression or filt:
        raise ValueError(f"{name}: PNG compression {compression} / filter method {filt} "
                         "is invalid")
    channels = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        pixels = _native.png_unfilter(raw, h, w * channels, channels)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return to_rgb(pixels.reshape(h, w, channels))


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(h, w, 1-4) 8-bit pixels to RGB: alpha dropped, gray repeated."""
    if pixels.shape[2] <= 2:
        return np.ascontiguousarray(np.repeat(pixels[:, :, :1], 3, axis=2))
    return np.ascontiguousarray(pixels[:, :, :3])


def png_unfilter_plain(raw: np.ndarray, height: int, row_bytes: int,
                       bpp: int) -> np.ndarray:
    """The numpy version of the C unfilter (`csrc/png.c`): filters 0-4,
    row by row, in modulo-256 arithmetic."""
    rows = np.asarray(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        ftype, src = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = src
        elif ftype == 2:
            cur = (src + prev) & 255
        elif ftype in (1, 3, 4):
            cur = np.zeros(row_bytes, np.int64)
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[i]) >> 1
                else:
                    b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 255
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _filter_row(cur: np.ndarray, prev: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """One row filtered by type `ftype` (the inverse of the unfilter)."""
    a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (a + prev) >> 1
    elif ftype == 4:
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    else:
        raise ValueError(f"PNG filter type {ftype} does not exist")
    return (cur - pred) & 255


def encode_png(pixels: np.ndarray, filter_type: int = 0, idat_bytes: int = 1 << 20,
               level: int = 6) -> bytes:
    """PNG bytes of uint8 (h, w) gray, (h, w, 2) gray + alpha, (h, w, 3) RGB
    or (h, w, 4) RGBA pixels, every row filtered by `filter_type` (0-4) and
    the compressed data cut into IDAT chunks of at most `idat_bytes`."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {pixels.dtype}")
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, ch = pixels.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = pixels.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        out.append(filter_type)
        out += _filter_row(rows[y], prev, ch, filter_type).astype(np.uint8).tobytes()
        prev = rows[y]
    data = zlib.compress(bytes(out), level)

    def chunk(ctype_: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype_ + body
                + struct.pack(">I", zlib.crc32(ctype_ + body)))

    parts = [data[i:i + idat_bytes] for i in range(0, max(len(data), 1), idat_bytes)]
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + b"".join(chunk(b"IDAT", p) for p in parts) + chunk(b"IEND", b""))


def _pillow(what: str):
    try:
        from PIL import Image, ImageOps
    except ImportError:
        raise ImportError(f"{what}: JPEG needs Pillow, which is not installed") from None
    return Image, ImageOps


def _decode_jpeg(path: str) -> np.ndarray:
    Image, ImageOps = _pillow(path)
    with Image.open(path) as im:
        im = ImageOps.exif_transpose(im)
        return np.ascontiguousarray(np.asarray(im.convert("RGB"), np.uint8))


def encode_jpeg(pixels: np.ndarray, quality: int = 90, orientation: int = 0) -> bytes:
    """JPEG bytes of uint8 (h, w, 3) RGB pixels at `quality`; an
    `orientation` of 1-8 is written as the EXIF tag 0x0112 (the pixels are
    stored as given: a reader that applies the tag transposes them)."""
    import io
    Image, _ = _pillow("encode_jpeg")
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (h, w, 3), not {pixels.dtype} "
                         f"{pixels.shape}")
    kw = {}
    if orientation:
        exif = Image.Exif()
        exif[0x0112] = int(orientation)
        kw["exif"] = exif.tobytes()
    buf = io.BytesIO()
    Image.fromarray(pixels, "RGB").save(buf, "JPEG", quality=quality, **kw)
    return buf.getvalue()
