/* OpenCV's polygon fill (cv2.fillPoly, LINE_8, shift 0) of a uint8 mask, on
 * the host, for the port's COCO polygon segmentations.
 *
 * OpenCV collects one edge a polygon side in 16.16 fixed point, and draws
 * each side with its 8-connected line as it goes (clipped to the image by
 * clipLine). Where a side leaves the image, the edge is rebuilt from the
 * clipped line's ends: its x from them always, its y range from them where
 * the clipped line is not flat. The edges, sorted by (y0, x, dx), are then
 * scanned row by row through an active list kept in x order by a bubble
 * sort; consecutive pairs of active edges bound the spans
 * [ceil(x_left), floor(x_right)], clipped to the image. Every step here
 * repeats that order and integer arithmetic, so the mask is bit-equal to
 * OpenCV's (the tests hold it to cv2.fillPoly and to the plain Python
 * version `polygons_to_mask_plain` in devis_torch/datasets/coco.py).
 *
 * Built with rle.c, resize.c and png.c into one library by
 * devis_torch/evaluation/_native.py.
 */
#include <stdint.h>
#include <stdlib.h>

#define XY_SHIFT 16
#define XY_ONE ((int64_t)1 << XY_SHIFT)

typedef struct {
  int64_t y0, y1, x, dx;
} Edge;

static int clip_line(int64_t w, int64_t h, int64_t *x1, int64_t *y1, int64_t *x2,
                     int64_t *y2) {
  const int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return 0;
  int c1 = (*x1 < 0) + (*x1 > right) * 2 + (*y1 < 0) * 4 + (*y1 > bottom) * 8;
  int c2 = (*x2 < 0) + (*x2 > right) * 2 + (*y2 < 0) * 4 + (*y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      *x1 += (int64_t)((double)(a - *y1) * (double)(*x2 - *x1) / (double)(*y2 - *y1));
      *y1 = a;
      c1 = (*x1 < 0) + (*x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      *x2 += (int64_t)((double)(a - *y2) * (double)(*x2 - *x1) / (double)(*y2 - *y1));
      *y2 = a;
      c2 = (*x2 < 0) + (*x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        *y1 += (int64_t)((double)(a - *x1) * (double)(*y2 - *y1) / (double)(*x2 - *x1));
        *x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        *y2 += (int64_t)((double)(a - *x2) * (double)(*y2 - *y1) / (double)(*x2 - *x1));
        *x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

static int outside(int64_t w, int64_t h, int64_t x0, int64_t y0, int64_t x1, int64_t y1) {
  return x0 < 0 || x0 >= w || x1 < 0 || x1 >= w || y0 < 0 || y0 >= h || y1 < 0 || y1 >= h;
}

/* OpenCV's LineIterator, 8-connected, left to right. */
static void line8(uint8_t *img, int64_t h, int64_t w, int64_t x1, int64_t y1, int64_t x2,
                  int64_t y2) {
  if (outside(w, h, x1, y1, x2, y2) && !clip_line(w, h, &x1, &y1, &x2, &y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1, sx = 1, sy = 1;
  if (dx < 0) {
    dx = -dx, dy = -dy;
    int64_t t = x1;
    x1 = x2, x2 = t, t = y1, y1 = y2, y2 = t;
  }
  if (dy < 0) dy = -dy, sy = -1;
  const int vert = dy > dx;
  if (vert) {
    const int64_t t = dx;
    dx = dy, dy = t;
  }
  int64_t err = dx - 2 * dy, x = x1, y = y1;
  for (int64_t k = 0; k <= dx; ++k) {
    img[y * w + x] = 1;
    const int neg = err < 0;
    err += -2 * dy + (neg ? 2 * dx : 0);
    if (vert) {
      y += sy;
      if (neg) x += sx;
    } else {
      x += sx;
      if (neg) y += sy;
    }
  }
}

static int64_t tdiv(int64_t a, int64_t b) { return a / b; } /* C truncates, as C++ */

static int cmp_edges(const void *pa, const void *pb) {
  const Edge *a = pa, *b = pb;
  if (a->y0 != b->y0) return a->y0 < b->y0 ? -1 : 1;
  if (a->x != b->x) return a->x < b->x ? -1 : 1;
  if (a->dx != b->dx) return a->dx < b->dx ? -1 : 1;
  return 0;
}

static void fill_edges(uint8_t *img, int64_t h, int64_t w, Edge *edges, long total,
                       Edge **active, Edge **next) {
  if (total < 2) return;
  int64_t y_min = INT64_MAX, y_max = INT64_MIN, x_min = INT64_MAX, x_max = INT64_MIN;
  for (long i = 0; i < total; ++i) {
    const Edge *e = &edges[i];
    const int64_t x1 = e->x + (e->y1 - e->y0) * e->dx;
    if (e->y0 < y_min) y_min = e->y0;
    if (e->y1 > y_max) y_max = e->y1;
    if (e->x < x_min) x_min = e->x;
    if (e->x > x_max) x_max = e->x;
    if (x1 < x_min) x_min = x1;
    if (x1 > x_max) x_max = x1;
  }
  if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= (w << XY_SHIFT)) return;
  qsort(edges, total, sizeof(Edge), cmp_edges);
  if (y_max > h) y_max = h;
  long n_active = 0, i = 0;
  for (int64_t y = edges[0].y0; y < y_max; ++y) {
    long k = 0, n_next = 0;
    int draw = 0;
    Edge *prev = NULL;
    while (k < n_active || (i < total && edges[i].y0 == y)) {
      Edge *cur;
      if (k < n_active && active[k]->y1 == y) { /* the edge ends */
        ++k;
        continue;
      }
      if (k < n_active && (i >= total || edges[i].y0 > y || active[k]->x < edges[i].x))
        cur = active[k++];
      else if (i < total && edges[i].y0 == y)
        cur = &edges[i++];
      else
        break;
      next[n_next++] = cur;
      if (draw) {
        if (y >= 0) {
          const Edge *l = prev->x > cur->x ? cur : prev, *r = prev->x > cur->x ? prev : cur;
          int64_t x1 = (l->x + XY_ONE - 1) >> XY_SHIFT, x2 = r->x >> XY_SHIFT;
          if (x1 < w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= w) x2 = w - 1;
            for (int64_t x = x1; x <= x2; ++x) img[y * w + x] = 1;
          }
        }
        prev->x += prev->dx;
        cur->x += cur->dx;
      }
      draw ^= 1;
      prev = cur;
    }
    while (k < n_active) next[n_next++] = active[k++];
    /* bubble sort by x: adjacent swaps, as OpenCV's linked list */
    for (long pass = 0; pass < n_next; ++pass) {
      int swapped = 0;
      for (long j = 0; j + 1 < n_next; ++j)
        if (next[j]->x > next[j + 1]->x) {
          Edge *t = next[j];
          next[j] = next[j + 1], next[j + 1] = t, swapped = 1;
        }
      if (!swapped) break;
    }
    Edge **t = active;
    active = next, next = t;
    n_active = n_next;
  }
}

/* Fills the n_polys polygons (vertex counts in `counts`, (x, y) pairs in
 * `xy`) into the (h, w) mask with 1. Returns 0, or -1 without memory. */
long fill_poly(uint8_t *img, long h, long w, const int64_t *xy, const int64_t *counts,
               long n_polys) {
  long total = 0;
  for (long p = 0; p < n_polys; ++p) total += counts[p];
  Edge *edges = malloc((total + 1) * sizeof(Edge));
  Edge **lists = malloc(2 * (total + 1) * sizeof(Edge *));
  if (!edges || !lists) {
    free(edges), free(lists);
    return -1;
  }
  long n_edges = 0;
  const int64_t *v = xy;
  for (long p = 0; p < n_polys; v += 2 * counts[p], ++p) {
    const long n = counts[p];
    if (n == 0) continue;
    int64_t p0x = v[2 * (n - 1)] << XY_SHIFT, p0y = v[2 * (n - 1) + 1];
    for (long i = 0; i < n; ++i) {
      const int64_t p1x = v[2 * i] << XY_SHIFT, p1y = v[2 * i + 1];
      int64_t c0x = p0x, c0y = p0y, c1x = p1x, c1y = p1y;
      int64_t t0x = (p0x + (XY_ONE >> 1)) >> XY_SHIFT, t1x = (p1x + (XY_ONE >> 1)) >> XY_SHIFT;
      int64_t t0y = p0y, t1y = p1y;
      line8(img, h, w, t0x, t0y, t1x, t1y);
      if (outside(w, h, t0x, t0y, t1x, t1y)) {
        clip_line(w, h, &t0x, &t0y, &t1x, &t1y);
        if (t0y != t1y) c0y = t0y, c1y = t1y;
        c0x = t0x << XY_SHIFT, c1x = t1x << XY_SHIFT;
      }
      if (p0y != p1y) {
        Edge *e = &edges[n_edges++];
        e->dx = tdiv(c1x - c0x, c1y - c0y);
        if (p0y < p1y) {
          e->y0 = p0y, e->y1 = p1y;
          e->x = c0x + (p0y - c0y) * e->dx;
        } else {
          e->y0 = p1y, e->y1 = p0y;
          e->x = c1x + (p1y - c1y) * e->dx;
        }
      }
      p0x = p1x, p0y = p1y;
    }
  }
  fill_edges(img, h, w, edges, n_edges, lists, lists + total + 1);
  free(edges), free(lists);
  return 0;
}
