// Shared device code of the deformable-attention kernels (ms_deform_attn.cu,
// ms_deform_attn_rows.cu): the level table, type conversion, warp reductions
// and the bilinear tap, forward and backward.
//
// Location arithmetic uses explicit round-to-nearest intrinsics so nvcc does
// not contract it into FMAs: every kernel then computes exactly the f32
// pixel coordinates of the plain PyTorch versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LEVELS 16

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

// Backward of one live tap for channel d. `g` is the output gradient of the
// channel and `ag` = weight * g. Adds weight * corner * g onto the f32
// gradient of the value (`gl`, laid out like `vl`) with atomics, and
// accumulates this channel's share of
//   s_v = g . sample            (gradient of the weight),
//   s_x = g . d sample / d x,   s_y = g . d sample / d y   (pixel units).
// Corners outside the level read as zero and receive nothing.
template <typename scalar_t>
__device__ __forceinline__ void tap_backward(const scalar_t* __restrict__ vl,
                                             float* __restrict__ gl, int h, int w, size_t row,
                                             int x0, int y0, float dx, float dy, float g,
                                             float ag, int d, float& s_v, float& s_x,
                                             float& s_y) {
  float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
  if (y0 >= 0) {
    const size_t r0 = (size_t)y0 * w * row + d;
    if (x0 >= 0) {
      v00 = to_f(vl[r0 + (size_t)x0 * row]);
      atomicAdd(gl + r0 + (size_t)x0 * row, ag * (1.f - dy) * (1.f - dx));
    }
    if (x0 + 1 < w) {
      v01 = to_f(vl[r0 + (size_t)(x0 + 1) * row]);
      atomicAdd(gl + r0 + (size_t)(x0 + 1) * row, ag * (1.f - dy) * dx);
    }
  }
  if (y0 + 1 < h) {
    const size_t r1 = (size_t)(y0 + 1) * w * row + d;
    if (x0 >= 0) {
      v10 = to_f(vl[r1 + (size_t)x0 * row]);
      atomicAdd(gl + r1 + (size_t)x0 * row, ag * dy * (1.f - dx));
    }
    if (x0 + 1 < w) {
      v11 = to_f(vl[r1 + (size_t)(x0 + 1) * row]);
      atomicAdd(gl + r1 + (size_t)(x0 + 1) * row, ag * dy * dx);
    }
  }
  s_v += g * ((1.f - dy) * ((1.f - dx) * v00 + dx * v01) + dy * ((1.f - dx) * v10 + dx * v11));
  s_x += g * ((1.f - dy) * (v01 - v00) + dy * (v11 - v10));
  s_y += g * ((1.f - dx) * (v10 - v00) + dx * (v11 - v01));
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
