/* OpenCV's bilinear resize (cv2.resize, INTER_LINEAR) of float32 images, on
 * the host, for the port's tracker and evaluation frames.
 *
 * OpenCV hands a float32 source of at least 2 x 2 pixels to Intel IPP, which
 * places output pixel d at source coordinate (d + 0.5) * (in / out) - 0.5 in
 * double, clamps it into the source, keeps the fraction f as float and
 * interpolates a + (b - a) * f with one rounding, along x and then along y.
 * Here b - a is a float subtraction and (double)(b - a) * f is exact in
 * double, so rounding the double sum to float gives the fused multiply-add's
 * result. devis_torch/datasets/transforms.py holds the plain numpy version;
 * the tests hold both to OpenCV bit for bit.
 *
 * Built with rle.c into one library by devis_torch/evaluation/_native.py.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

static void taps(long src, long dst, long *s0, long *s1, float *f) {
  const double scale = (double)src / (double)dst;
  for (long d = 0; d < dst; ++d) {
    const double pos = ((double)d + 0.5) * scale - 0.5;
    const double fl = floor(pos);
    long s = (long)fl;
    float fr = (float)(pos - fl);
    if (pos < 0) {
      s = 0;
      fr = 0.f;
    } else if (s >= src - 1) {
      s = src - 1;
      fr = 0.f;
    }
    s0[d] = s;
    s1[d] = s + 1 < src ? s + 1 : src - 1;
    f[d] = fr;
  }
}

static inline float lerp(float a, float b, float f) {
  return (float)((double)a + (double)(b - a) * (double)f);
}

/* The x pass into rows (h, ow, c); returns 0, or -1 without memory. */
static int x_pass(const float *src, long h, long w, long c, long ow, float *rows) {
  long *x0 = malloc(ow * sizeof(long)), *x1 = malloc(ow * sizeof(long));
  float *fx = malloc(ow * sizeof(float));
  if (!x0 || !x1 || !fx) {
    free(x0), free(x1), free(fx);
    return -1;
  }
  taps(w, ow, x0, x1, fx);
  for (long y = 0; y < h; ++y) {
    const float *in = src + y * w * c;
    float *out = rows + y * ow * c;
    for (long d = 0; d < ow; ++d)
      for (long k = 0; k < c; ++k)
        out[d * c + k] = lerp(in[x0[d] * c + k], in[x1[d] * c + k], fx[d]);
  }
  free(x0), free(x1), free(fx);
  return 0;
}

/* (h, w, c) float32 -> (oh, ow, c) float32, row-major. Returns 0, or -1
 * without memory. */
long resize_linear_f32(const float *src, long h, long w, long c, long oh, long ow, float *out) {
  float *rows = malloc(h * ow * c * sizeof(float));
  long *y0 = malloc(oh * sizeof(long)), *y1 = malloc(oh * sizeof(long));
  float *fy = malloc(oh * sizeof(float));
  long status = -1;
  if (rows && y0 && y1 && fy && x_pass(src, h, w, c, ow, rows) == 0) {
    taps(h, oh, y0, y1, fy);
    const long n = ow * c;
    for (long d = 0; d < oh; ++d) {
      const float *a = rows + y0[d] * n, *b = rows + y1[d] * n;
      float *o = out + d * n;
      for (long i = 0; i < n; ++i) o[i] = lerp(a[i], b[i], fy[d]);
    }
    status = 0;
  }
  free(rows), free(y0), free(y1), free(fy);
  return status;
}
