/* The scanline filters of PNG (ISO/IEC 15948, section 9), undone on the
 * host for the port's PNG decoder (devis_torch/datasets/image_io.py), which
 * parses the chunks and inflates the image data with zlib in Python.
 *
 * Each of the `height` rows of `raw` is a filter-type byte and `row_bytes`
 * filtered bytes; `bpp` is the bytes a pixel (at least 1). Filters 0-4
 * (None, Sub, Up, Average, Paeth) are undone into `out`, row after row, in
 * modulo-256 arithmetic. `png_unfilter_plain` in image_io.py is the numpy
 * version the tests hold this to.
 *
 * Built with rle.c, resize.c and poly.c into one library by
 * devis_torch/evaluation/_native.py.
 */
#include <stdint.h>
#include <stdlib.h>

static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

/* Returns 0, or the 1-based row whose filter type is not 0-4. */
long png_unfilter(const uint8_t *raw, long height, long row_bytes, long bpp, uint8_t *out) {
  for (long y = 0; y < height; ++y) {
    const uint8_t *src = raw + y * (row_bytes + 1);
    const uint8_t ftype = src[0];
    ++src;
    uint8_t *dst = out + y * row_bytes;
    const uint8_t *up = y ? dst - row_bytes : NULL;
    switch (ftype) {
      case 0:
        for (long i = 0; i < row_bytes; ++i) dst[i] = src[i];
        break;
      case 1:
        for (long i = 0; i < row_bytes; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < row_bytes; ++i) dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (long i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
