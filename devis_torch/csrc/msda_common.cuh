// Shared device code of the deformable-attention kernels (ms_deform_attn.cu,
// ms_deform_attn_rows.cu, ms_deform_attn_proj.cu, ms_deform_attn_taps.cu):
// the level table, type conversion, warp reductions, the bilinear tap, the
// chunked corner loads of K6 and K8 (`Chunk`, `tap_corners`) and the corner
// weights. The backward of K5, K7 and K9 is in msda_bwd.cuh.
//
// Location arithmetic uses explicit round-to-nearest intrinsics so nvcc does
// not contract it into FMAs: every kernel then computes exactly the f32
// pixel coordinates of the plain PyTorch versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#define MAX_LEVELS 16
#define SMEM_BLOCK_MAX 232448  // the most shared memory one block may take

struct Pyramid {
  int L;
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
  float inv_w[MAX_LEVELS];
  float inv_h[MAX_LEVELS];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// Sum over an aligned group of `g` lanes (a power of two up to 32). Every
// lane of the warp must call it.
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Normalized location of a tap: ref + off / size, as ref + off * (1/size).
__device__ __forceinline__ float tap_loc(float ref, float off, float inv) {
  return __fadd_rn(ref, __fmul_rn(off, inv));
}

// Pixel coordinate of a normalized location on a side of `size` pixels.
__device__ __forceinline__ float tap_px(float l, int size) {
  return __fsub_rn(__fmul_rn(l, (float)size), 0.5f);
}

// Top-left corner and bilinear fractions of the pixel point (x, y).
__device__ __forceinline__ void tap_floor(float x, float y, int& x0, int& y0, float& dx,
                                          float& dy) {
  const float x0f = floorf(x), y0f = floorf(y);
  dx = x - x0f;
  dy = y - y0f;
  x0 = (int)x0f;
  y0 = (int)y0f;
}

// Pixel geometry of a tap at normalized (lx, ly) of an (h, w) level: false
// where all four corners are outside the level (the tap contributes nothing
// and has no gradient). On the lines x = -1 and y = -1 the corners inside
// the level carry weight 0 but the location's gradient does not vanish, as
// in the plain versions and the JAX kernels.
__device__ __forceinline__ bool tap_geometry(int h, int w, float lx, float ly, int& x0, int& y0,
                                             float& dx, float& dy) {
  const float x = tap_px(lx, w), y = tap_px(ly, h);
  if (!(x >= -1.f && x < (float)w && y >= -1.f && y < (float)h)) return false;
  tap_floor(x, y, x0, y0, dx, dy);
  return true;
}

// The window rule of K2 (and of the JAX package's `_ranges_proj_kernel`): a
// tap's rows belong to a window where x > -1 and y > -1. On the lines
// x = -1 and y = -1 a tap's corners inside the level carry weight 0, so a
// forward kernel that reads K2's windows skips such a tap as K2 does.
__device__ __forceinline__ bool in_window(int h, int w, float x, float y) {
  return x > -1.f && x < (float)w && y > -1.f && y < (float)h;
}

// Bilinear sample of channel d at normalized (lx, ly) of one level, zero
// padding. `vl` points at row 0 of the level for this head; rows are
// `row` elements apart.
template <typename scalar_t>
__device__ __forceinline__ float sample_bilinear(const scalar_t* __restrict__ vl, int h, int w,
                                                 size_t row, float lx, float ly, int d) {
  int x0, y0;
  float dx, dy;
  if (!tap_geometry(h, w, lx, ly, x0, y0, dx, dy)) return 0.f;
  float acc = 0.f;
  if (y0 >= 0) {
    const scalar_t* r0 = vl + (size_t)y0 * w * row;
    if (x0 >= 0) acc += (1.f - dy) * (1.f - dx) * to_f(r0[(size_t)x0 * row + d]);
    if (x0 + 1 < w) acc += (1.f - dy) * dx * to_f(r0[(size_t)(x0 + 1) * row + d]);
  }
  if (y0 + 1 < h) {
    const scalar_t* r1 = vl + (size_t)(y0 + 1) * w * row;
    if (x0 >= 0) acc += dy * (1.f - dx) * to_f(r1[(size_t)x0 * row + d]);
    if (x0 + 1 < w) acc += dy * dx * to_f(r1[(size_t)(x0 + 1) * row + d]);
  }
  return acc;
}

// The level of tap k of a query's L*P taps: a shift where P is a power of
// two (`pshift` = log2 P, from `point_shift`), else a division.
__device__ __forceinline__ int tap_level(int k, int P, int pshift) {
  return pshift >= 0 ? k >> pshift : k / P;
}

static inline int point_shift(int P) {
  if (P < 1 || (P & (P - 1)) != 0) return -1;
  int s = 0;
  while ((1 << s) < P) ++s;
  return s;
}

// `levels` is (L, 2) host ints (h, w).
static Pyramid make_pyramid(const int* levels, int L) {
  Pyramid p;
  p.L = L;
  int s = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool live = l < L;
    p.h[l] = live ? levels[2 * l] : 1;
    p.w[l] = live ? levels[2 * l + 1] : 1;
    p.start[l] = s;
    p.inv_w[l] = 1.0f / (float)p.w[l];
    p.inv_h[l] = 1.0f / (float)p.h[l];
    if (live) s += p.h[l] * p.w[l];
  }
  return p;
}

// 16 bytes of channels as floats: 8 bf16 or 4 f32
template <typename scalar_t> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<unsigned*>(&b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// CW channels of a value row a thread reads and writes at once: 16 bytes
// (CW = Vec16<scalar_t>::N, one vector access; the row must be 16-byte
// aligned) or one channel (CW = 1, any alignment).
template <typename scalar_t, int CW>
struct Chunk {  // CW == Vec16<scalar_t>::N
  using raw_t = uint4;
  static __device__ __forceinline__ raw_t load(const scalar_t* __restrict__ p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void unpack(raw_t r, float* v) {
    Vec16<scalar_t>::unpack(r, v);
  }
  static __device__ __forceinline__ void store(scalar_t* __restrict__ p, const float* v) {
    *reinterpret_cast<uint4*>(p) = Vec16<scalar_t>::pack(v);
  }
};
template <typename scalar_t>
struct Chunk<scalar_t, 1> {
  using raw_t = scalar_t;
  static __device__ __forceinline__ raw_t load(const scalar_t* __restrict__ p, bool ok) {
    return ok ? p[0] : from_f<scalar_t>(0.f);
  }
  static __device__ __forceinline__ void unpack(raw_t r, float* v) { v[0] = to_f(r); }
  static __device__ __forceinline__ void store(scalar_t* __restrict__ p, const float* v) {
    p[0] = from_f<scalar_t>(v[0]);
  }
};

// The four corner chunks of one tap and their bilinear weights. `packed`
// is the tap's corner ((y0 + 1) << 16 | (x0 + 1)), or TAP_DEAD where all
// four corners lie outside the level; `vl` points at the thread's first
// channel in row 0 of the tap's level for the head.
#define TAP_DEAD 0xffffffffu
template <typename scalar_t, int CW>
__device__ __forceinline__ void tap_corners(const scalar_t* __restrict__ vl, int h, int w,
                                            size_t row, unsigned packed, float dx, float dy,
                                            typename Chunk<scalar_t, CW>::raw_t raw[4],
                                            float wt[4]) {
  const bool live = packed != TAP_DEAD;
  const int x0 = (int)(packed & 0xffffu) - 1, y0 = (int)(packed >> 16) - 1;
  const bool yin[2] = {live && y0 >= 0, live && y0 + 1 < h};
  const bool xin[2] = {x0 >= 0, x0 + 1 < w};
  wt[0] = (1.f - dy) * (1.f - dx);
  wt[1] = (1.f - dy) * dx;
  wt[2] = dy * (1.f - dx);
  wt[3] = dy * dx;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cy = c >> 1, cx = c & 1;
    // a corner outside the level is not read (its row index may be -1)
    raw[c] = Chunk<scalar_t, CW>::load(vl + ((long)(y0 + cy) * w + x0 + cx) * (long)row,
                                       yin[cy] && xin[cx]);
  }
}

// acc += a * (the tap's bilinear sum of its four corner chunks), in f32.
template <typename scalar_t, int CW>
__device__ __forceinline__ void tap_accumulate(float* acc, float a,
                                               const typename Chunk<scalar_t, CW>::raw_t raw[4],
                                               const float wt[4]) {
  float tap[CW], vals[CW];
#pragma unroll
  for (int v = 0; v < CW; ++v) tap[v] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Chunk<scalar_t, CW>::unpack(raw[c], vals);
#pragma unroll
    for (int v = 0; v < CW; ++v) tap[v] += wt[c] * vals[v];
  }
#pragma unroll
  for (int v = 0; v < CW; ++v) acc[v] += a * tap[v];
}

// The bilinear weight of corner c (top-left, top-right, bottom-left,
// bottom-right) at fractions (dx, dy).
__device__ __forceinline__ float corner_weight(int c, float dx, float dy) {
  return ((c >> 1) ? dy : 1.f - dy) * ((c & 1) ? dx : 1.f - dx);
}
