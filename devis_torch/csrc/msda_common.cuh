// Shared device code of the deformable-attention kernels (ms_deform_attn.cu,
// ms_deform_attn_rows.cu, ms_deform_attn_proj.cu, ms_deform_attn_taps.cu):
// the level table, type conversion, warp reductions, the bilinear tap, the
// chunked corner loads of K6 and K8 (`Chunk`, `tap_corners`), and the
// windowed backward block of K5 and K7 (`msda_bwd_block`, below).
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

// ---------------------------------------------------------------------------
// The windowed backward of K5 and K7: the per-tap backward of bilinear
// sampling with the value gradient summed on chip over each block's window
// and flushed once. The two kernels differ only in how a stage names its
// value frame (`frames`) and how a block's queries lie (`BwdTiles`).
//
// One block of BWD_THREADS per (frame of the queries, head, query tile,
// group of stages, channel slice), the slice's output gradient of the
// block's queries staged in shared memory as f32. A stage is one level of
// one frame slot (stage s = j * L + l); the stages are independent, and a
// launch with few query tiles splits them into `groups` to fill the card.
// For each stage:
//   1a. One thread per (query, point) computes the tap once (tap_geometry):
//       corner, fractions and weight into shared memory, and the box
//       [y0, y1] x [x0, x1] of value rows the block's live taps touch.
//   1b. A counting sort of the taps' corners by window row: row i of the box
//       in raster order is a bin where i < n = min(box area, plan.cap); each
//       corner takes its rank in its bin with an integer shared atomic, a
//       block-wide scan turns the counts into bin ends, and each corner
//       finds its place in the sorted list.
//   2.  One thread per (touched window row, 16 bytes of channels; the rows
//       listed in 1c) reads the row's channels once (the next it takes is
//       loaded meanwhile), and for
//       each corner sorted into the row adds a * weight * g to a sum in
//       registers and stores g . row for its tap; the sum is then added once
//       into grad_value with vector atomics (red.global.add.v4.f32 where
//       D % 4 == 0). Rows no corner touched are neither read nor flushed.
//   3.  Corners past the capacity (only where a stage has any): LPQ lanes a
//       query, 16 bytes of channels a lane, read them from global memory,
//       add a * weight * g where they lie with vector atomics (never
//       dropped) and reduce g . corner over the lane group.
//   4.  One thread per tap sums its corners' g . row into the weight and
//       location gradients and writes them once; where D takes several
//       slices (blocks), each slice adds its share with an f32 atomic onto
//       zeroed buffers.
// Why a sort, not an f32 accumulator in shared memory added to with
// atomics: on the H100 f32 shared-memory atomics are compare-and-swap loops,
// slower than the scalar global atomics they replace; the sort needs two
// integer shared atomics a corner, and reading each window row once in step
// 2 (not each corner, as step 3 does) cuts the value reads by the same ratio
// as the adds.
// `adds` (may be null) counts the f32 values added to grad_value: [0] by
// flushes, [1] by corners past the capacity.

#define BWD_THREADS 512
#define BWD_WARPS (BWD_THREADS / 32)
#define BWD_HEAD_BYTES 128  // the box (4 ints), the scan's warp totals (16), a flag,
                            // the count of touched rows
#define BWD_TAP_BYTES 64    // per (query, point): float4 geometry, float4 sums of its
                            // corners past the capacity, 4 u16 places; 4 sorted
                            // entries of f32 weight and u16 query; and 4 f32 dots
                            // a 16-byte channel chunk
#define BWD_DEAD 0xffffffffu
#define BWD_OVER 0xffffu    // the place of a corner past the capacity

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

// How a block's queries lie: raster runs of `qb` queries (grid_w == 0), or
// tiles of tile_h x tile_w pixels of a grid_h x grid_w query grid.
struct BwdTiles {
  int qb;
  int grid_h, grid_w, tile_h, tile_w;
  int tiles_x, n_tiles;
};

// The capacity plan: window rows (bins) a stage, channels a slice, floats a
// query's staged output gradient (the slice rounded up to 16 bytes' worth:
// pitch / Vec16::N channel chunks).
struct BwdPlan {
  int cap, slice, pitch;
};

// Query index of the block's query `ql` in tile `tile`, or -1 past the edge.
__device__ __forceinline__ int tile_query(const BwdTiles& t, int Q, int tile, int ql) {
  if (ql >= t.qb) return -1;
  if (t.grid_w == 0) {
    const int q = tile * t.qb + ql;
    return q < Q ? q : -1;
  }
  const int ty = tile / t.tiles_x, tx = tile - ty * t.tiles_x;
  const int y = ty * t.tile_h + ql / t.tile_w, x = tx * t.tile_w + ql % t.tile_w;
  return (y < t.grid_h && x < t.grid_w) ? y * t.grid_w + x : -1;
}

__device__ __forceinline__ void red_add_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ void red_add_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a), "f"(b) : "memory");
}

// Adds `n` floats of `v` (n <= VN, a multiple of VW) at `dst` with VW-wide
// atomics.
template <int VN>
__device__ __forceinline__ void red_add(float* dst, const float* v, int n, int VW) {
#pragma unroll
  for (int k = 0; k < VN; k += 4) {
    if (k >= n) break;
    if (VW == 4) {
      red_add_v4(dst + k, v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else if (VW == 2) {
      red_add_v2(dst + k, v[k], v[k + 1]);
      if (k + 2 < n) red_add_v2(dst + k + 2, v[k + 2], v[k + 3]);
    } else {
      for (int e = k; e < min(k + 4, n); ++e) atomicAdd(dst + e, v[e]);
    }
  }
}

// The bilinear weight of corner c (top-left, top-right, bottom-left,
// bottom-right) at fractions (dx, dy).
__device__ __forceinline__ float corner_weight(int c, float dx, float dy) {
  return ((c >> 1) ? dy : 1.f - dy) * ((c & 1) ? dx : 1.f - dx);
}

// In-place inclusive scan of bins[0, n) by the whole block; `wsum` holds
// BWD_WARPS ints. Ends with a barrier.
__device__ __forceinline__ void bin_scan(int* bins, int n, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int per = (n + BWD_THREADS - 1) / BWD_THREADS;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += bins[k];
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[tid >> 5] = x;
  __syncthreads();
  int run = x - local;
  for (int w = 0; w < (tid >> 5); ++w) run += wsum[w];
  for (int k = lo; k < hi; ++k) {
    run += bins[k];
    bins[k] = run;
  }
  __syncthreads();
}

static inline size_t bwd_smem_bytes(int qb, int P, const BwdPlan& plan, int vn) {
  return BWD_HEAD_BYTES + (size_t)qb * P * (BWD_TAP_BYTES + 16 * (plan.pitch / vn)) +
         (size_t)qb * plan.pitch * 4 + ((size_t)plan.cap * 8 + 15) / 16 * 16;
}

// value (F, S, M, D); loc (N, Q, M, Lx, P, 2) f32; att (N, Q, M, Lx, P) f32;
// grad_out (N, Q, M*D) -> grad_value (F, S, M, D) f32, zeroed by the caller;
// grad_loc like loc; grad_att like att. `frames(j, n)` is the value frame of
// frame slot j for the queries of frame n. VW: the flush's vector width
// (4, 2 or 1 floats; D % VW == 0). `aligned`: 16-byte channel vectors.
template <typename scalar_t, int LPQ, typename Frames>
__device__ __forceinline__ void msda_bwd_block(
    const scalar_t* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, const scalar_t* __restrict__ grad_out,
    float* __restrict__ grad_value, float* __restrict__ grad_loc, float* __restrict__ grad_att,
    unsigned long long* __restrict__ adds, int Q, int S, int M, int D, int P, int Lx,
    const Pyramid& pyr, const Frames& frames, const BwdTiles& tiles, const BwdPlan& plan,
    int groups, bool aligned, int VW) {
  using V = Vec16<scalar_t>;
  constexpr int VN = V::N;
  constexpr int NSLOT = BWD_THREADS / LPQ;  // lane groups, one query each at a time
  static_assert(BWD_WARPS == 16, "16 warps a block");
  const int n_slices = (D + plan.slice - 1) / plan.slice;
  const int per = (Lx + groups - 1) / groups;
  const int s_begin = blockIdx.x / n_slices % groups * per, s_end = min(Lx, s_begin + per);
  if (s_begin >= s_end) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_box = reinterpret_cast<int*>(smem);
  int* s_wsum = s_box + 4;
  int* s_any_over = s_box + 4 + BWD_WARPS;
  int* s_n_rows = s_any_over + 1;
  const int QBP = tiles.qb * P;
  const int nch_max = plan.pitch / VN;  // channel chunks of a slice
  float4* s_geo = reinterpret_cast<float4*>(smem + BWD_HEAD_BYTES);
  float4* s_sum = s_geo + QBP;
  float* s_ew = reinterpret_cast<float*>(s_sum + QBP);  // sorted: a * corner weight
  unsigned short* s_place = reinterpret_cast<unsigned short*>(s_ew + 4 * QBP);  // rank, place
  unsigned short* s_eq = s_place + 4 * QBP;  // sorted: the block's query
  float* s_dot = reinterpret_cast<float*>(s_eq + 4 * QBP);
  float* s_g = s_dot + (size_t)4 * QBP * nch_max;
  int* s_bin = reinterpret_cast<int*>(s_g + (size_t)tiles.qb * plan.pitch);
  int* s_rows = s_bin + plan.cap;  // the window rows some corner touched, unordered

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x % n_slices * plan.slice, dsl = min(plan.slice, D - c0);
  const int nch = (dsl + VN - 1) / VN;
  const int tile = blockIdx.x / n_slices / groups % tiles.n_tiles;
  const int nm = blockIdx.x / n_slices / groups / tiles.n_tiles;
  const int m = nm % M, n = nm / M;
  const int L = pyr.L;
  const size_t row = (size_t)M * D;
  // tap (q, s, p) of the block's (n, m) lies at tap0 + (q * M * Lx + s) * P + p
  const size_t tap0 = (((size_t)n * Q) * M + m) * Lx * P;
  // Lane group g of warp wp takes the queries `slot` + k * NSLOT in step 3.
  // The groups of one warp take queries 16 rows of the block apart, shifted
  // by 5 columns a group: neighbouring pixels' taps share corners.
  const int wp = tid >> 5, grp = (tid & 31) / LPQ, cg = tid % LPQ, cb = cg * VN;
  const int slot = grp * 16 + ((wp + 5 * grp) & 15);
  const bool lane_live = cb < dsl;

  // the output gradient of the block's queries, channels [c0, c0 + dsl), f32
  for (int k = tid; k < tiles.qb * plan.pitch; k += BWD_THREADS) {
    const int ql = k / plan.pitch, ch = k - ql * plan.pitch;
    const int q = tile_query(tiles, Q, tile, ql);
    s_g[k] = (q >= 0 && ch < dsl) ? to_f(grad_out[(((size_t)n * Q + q) * M + m) * D + c0 + ch])
                                  : 0.f;
  }
  // 4. the weight and location gradients of stage s's taps (level h x w),
  // by the thread that built the tap
  auto tap_gradients = [&](int s, int h, int w) {
    for (int i = tid; i < QBP; i += BWD_THREADS) {
      const int ql = i / P, p = i - ql * P;
      const int q = tile_query(tiles, Q, tile, ql);
      if (q < 0) continue;
      const float4 geo = s_geo[i];
      float4 t = s_sum[i];
      if (__float_as_uint(geo.w) != BWD_DEAD) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int at = s_place[4 * i + c];
          if (at == BWD_OVER) continue;  // outside the level, or summed in step 3
          float gv = 0.f;
          for (int ch = 0; ch < nch; ++ch) gv += s_dot[at * nch + ch];
          const float wx = (c >> 1) ? geo.y : 1.f - geo.y, wy = (c & 1) ? geo.x : 1.f - geo.x;
          t.x += wx * wy * gv;
          t.y += ((c & 1) ? wx : -wx) * gv;
          t.z += ((c >> 1) ? wy : -wy) * gv;
        }
      }
      const size_t k = tap0 + ((size_t)q * M * Lx + s) * P + p;
      if (n_slices == 1) {
        grad_att[k] = t.x;
        grad_loc[2 * k] = geo.z * t.y * (float)w;
        grad_loc[2 * k + 1] = geo.z * t.z * (float)h;
      } else {
        atomicAdd(grad_att + k, t.x);
        atomicAdd(grad_loc + 2 * k, geo.z * t.y * (float)w);
        atomicAdd(grad_loc + 2 * k + 1, geo.z * t.z * (float)h);
      }
    }
  };

  for (int i = tid; i < plan.cap; i += BWD_THREADS) s_bin[i] = 0;
  if (tid == 0) {
    s_box[0] = INT_MAX; s_box[1] = -1; s_box[2] = INT_MAX; s_box[3] = -1;
  }
  __syncthreads();

  unsigned long long n_flush = 0, n_over = 0;
  int n_prev = 0;  // bins of the previous stage, zeroed before this one's sort
  for (int s = s_begin; s < s_end; ++s) {
    const int l = s % L;
    const int h = pyr.h[l], w = pyr.w[l];
    const size_t level = ((size_t)frames(s / L, n) * S + pyr.start[l]) * row + (size_t)m * D;

    // 1a. the previous stage's tap gradients out; taps, and their box
    if (s > s_begin) tap_gradients(s - 1, pyr.h[(s - 1) % L], pyr.w[(s - 1) % L]);
    for (int i = tid; i < n_prev; i += BWD_THREADS) s_bin[i] = 0;
    if (tid == 0) *s_any_over = *s_n_rows = 0;
    int ymn = INT_MAX, ymx = -1, xmn = INT_MAX, xmx = -1;
    for (int i = tid; i < QBP; i += BWD_THREADS) {
      const int ql = i / P, p = i - ql * P;
      const int q = tile_query(tiles, Q, tile, ql);
      unsigned packed = BWD_DEAD;
      float dx = 0.f, dy = 0.f, a = 0.f;
      if (q >= 0) {
        const size_t k = tap0 + ((size_t)q * M * Lx + s) * P + p;
        a = att[k];
        int x0, y0;
        if (tap_geometry(h, w, loc[2 * k], loc[2 * k + 1], x0, y0, dx, dy)) {
          packed = ((unsigned)(y0 + 1) << 16) | (unsigned)(x0 + 1);
          ymn = min(ymn, max(y0, 0));
          ymx = max(ymx, min(y0 + 1, h - 1));
          xmn = min(xmn, max(x0, 0));
          xmx = max(xmx, min(x0 + 1, w - 1));
        }
      }
      s_geo[i] = make_float4(dx, dy, a, __uint_as_float(packed));
      s_sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    ymn = __reduce_min_sync(0xffffffffu, ymn);
    ymx = __reduce_max_sync(0xffffffffu, ymx);
    xmn = __reduce_min_sync(0xffffffffu, xmn);
    xmx = __reduce_max_sync(0xffffffffu, xmx);
    if ((tid & 31) == 0 && ymx >= 0) {
      atomicMin(s_box, ymn);
      atomicMax(s_box + 1, ymx);
      atomicMin(s_box + 2, xmn);
      atomicMax(s_box + 3, xmx);
    }
    __syncthreads();
    const int by0 = s_box[0], bx0 = s_box[2];
    const int bw = s_box[1] >= 0 ? s_box[3] - bx0 + 1 : 0;
    const int nst = s_box[1] >= 0 ? min((s_box[1] - by0 + 1) * bw, plan.cap) : 0;

    // 1b. count the corners of each window row; a corner's rank in its row
    for (int i = tid; i < QBP; i += BWD_THREADS) {
      const unsigned packed = __float_as_uint(s_geo[i].w);
      const int x0 = (int)(packed & 0xffffu) - 1, y0 = (int)(packed >> 16) - 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int yi = y0 + (c >> 1), xi = x0 + (c & 1);
        int rank = BWD_OVER;
        if (packed != BWD_DEAD && yi >= 0 && yi < h && xi >= 0 && xi < w) {
          const int r = (yi - by0) * bw + (xi - bx0);
          if (r < nst)
            rank = atomicAdd(s_bin + r, 1);
          else
            *s_any_over = 1;
        }
        s_place[4 * i + c] = (unsigned short)rank;
      }
    }
    __syncthreads();
    if (tid == 0) {  // every thread has read the box
      s_box[0] = INT_MAX; s_box[1] = -1; s_box[2] = INT_MAX; s_box[3] = -1;
    }
    bin_scan(s_bin, nst, s_wsum);  // bin r's corners end at s_bin[r]

    // 1c. each staged corner's place in the sorted list: its weight, query
    for (int i = tid; i < QBP; i += BWD_THREADS) {
      const float4 geo = s_geo[i];
      const unsigned packed = __float_as_uint(geo.w);
      if (packed == BWD_DEAD) continue;
      const int x0 = (int)(packed & 0xffffu) - 1, y0 = (int)(packed >> 16) - 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rank = s_place[4 * i + c];
        if (rank == BWD_OVER) continue;
        const int r = (y0 + (c >> 1) - by0) * bw + (x0 + (c & 1) - bx0);
        const int at = (r ? s_bin[r - 1] : 0) + rank;
        if (rank == 0) s_rows[atomicAdd(s_n_rows, 1)] = r;
        s_ew[at] = geo.z * corner_weight(c, geo.x, geo.y);
        s_eq[at] = (unsigned short)(i / P);
        s_place[4 * i + c] = (unsigned short)at;
      }
    }
    __syncthreads();

    // 2. each touched window row read once: its corners' dots, its sum, one
    // flush. The next item's row is loaded before this one's corners are summed.
    {
      const int n_items = *s_n_rows * nch;
      int e0 = 0, e1 = 0;
      size_t off = 0;
      uint4 raw;
      scalar_t el[VN];
      auto fetch = [&](int it) {  // item it's sorted corners, and its row's channels
        const int r = s_rows[it / nch], ch = it % nch;
        e0 = r ? s_bin[r - 1] : 0;
        e1 = s_bin[r];
        off = level + (size_t)((by0 + r / bw) * w + bx0 + r % bw) * row + c0 + ch * VN;
        if (e0 == e1) return;
        if (aligned) {
          raw = __ldg(reinterpret_cast<const uint4*>(value + off));
        } else {
#pragma unroll
          for (int v = 0; v < VN; ++v)
            el[v] = ch * VN + v < dsl ? value[off + v] : from_f<scalar_t>(0.f);
        }
      };
      if (tid < n_items) fetch(tid);
      for (int it = tid; it < n_items; it += BWD_THREADS) {
        const int ch = it % nch, b0 = e0, b1 = e1;
        const size_t at = off;
        float vals[VN], acc[VN];
        if (aligned) {
          V::unpack(raw, vals);
        } else {
#pragma unroll
          for (int v = 0; v < VN; ++v) vals[v] = to_f(el[v]);
        }
        if (it + BWD_THREADS < n_items) fetch(it + BWD_THREADS);
        if (b0 == b1) continue;
#pragma unroll
        for (int v = 0; v < VN; ++v) acc[v] = 0.f;
        for (int e = b0; e < b1; ++e) {
          const float aw = s_ew[e];
          const float4* gs = reinterpret_cast<const float4*>(s_g + s_eq[e] * plan.pitch + ch * VN);
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < VN; v += 4) {
            const float4 t = gs[v / 4];
            dot += t.x * vals[v] + t.y * vals[v + 1] + t.z * vals[v + 2] + t.w * vals[v + 3];
            acc[v] += aw * t.x;
            acc[v + 1] += aw * t.y;
            acc[v + 2] += aw * t.z;
            acc[v + 3] += aw * t.w;
          }
          s_dot[e * nch + ch] = dot;
        }
        const int nv = min(VN, dsl - ch * VN);
        red_add<VN>(grad_value + at, acc, nv, VW);
        n_flush += nv;
      }
    }

    // 3. corners past the capacity: read where they lie, added where they lie
    if (*s_any_over) {
      for (int base = 0; base < tiles.qb; base += NSLOT) {
        const int ql = base + slot;
        const int q = tile_query(tiles, Q, tile, ql);
        float g[VN];
        if (q >= 0 && lane_live) {
          const float4* gs = reinterpret_cast<const float4*>(s_g + ql * plan.pitch + cb);
#pragma unroll
          for (int v = 0; v < VN; v += 4) {
            const float4 t = gs[v / 4];
            g[v] = t.x; g[v + 1] = t.y; g[v + 2] = t.z; g[v + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int v = 0; v < VN; ++v) g[v] = 0.f;
        }
        for (int p = 0; p < P; ++p) {
          float s_v = 0.f, s_x = 0.f, s_y = 0.f;
          const int i = ql * P + p;
          const float4 geo = q >= 0 ? s_geo[i] : make_float4(0.f, 0.f, 0.f, 0.f);
          const unsigned packed = q >= 0 ? __float_as_uint(geo.w) : BWD_DEAD;
          if (packed != BWD_DEAD && lane_live) {
            const int x0 = (int)(packed & 0xffffu) - 1, y0 = (int)(packed >> 16) - 1;
            const float dx = geo.x, dy = geo.y, a = geo.z;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int yi = y0 + (c >> 1), xi = x0 + (c & 1);
              if (yi < 0 || yi >= h || xi < 0 || xi >= w || s_place[4 * i + c] != BWD_OVER)
                continue;
              const size_t off = level + (size_t)(yi * w + xi) * row + c0 + cb;
              float vals[VN];
              if (aligned) {
                V::unpack(__ldg(reinterpret_cast<const uint4*>(value + off)), vals);
              } else {
#pragma unroll
                for (int v = 0; v < VN; ++v) vals[v] = cb + v < dsl ? to_f(value[off + v]) : 0.f;
              }
              float gv = 0.f;
#pragma unroll
              for (int v = 0; v < VN; ++v) gv += g[v] * vals[v];
              const float wx = (c >> 1) ? dy : 1.f - dy, wy = (c & 1) ? dx : 1.f - dx;
              s_v += wx * wy * gv;
              s_x += ((c & 1) ? wx : -wx) * gv;
              s_y += ((c >> 1) ? wy : -wy) * gv;
              const float aw = a * wx * wy;
              float add[VN];
#pragma unroll
              for (int v = 0; v < VN; ++v) add[v] = aw * g[v];
              red_add<VN>(grad_value + off, add, min(VN, dsl - cb), aligned ? VW : 1);
              n_over += min(VN, dsl - cb);
            }
          }
          if (LPQ > 1) {
            s_v = group_sum(s_v, LPQ);
            s_x = group_sum(s_x, LPQ);
            s_y = group_sum(s_y, LPQ);
          }
          if (q >= 0 && cg == 0) s_sum[i] = make_float4(s_v, s_x, s_y, 0.f);
        }
      }
    }
    __syncthreads();
    n_prev = nst;
  }
  tap_gradients(s_end - 1, pyr.h[(s_end - 1) % L], pyr.w[(s_end - 1) % L]);
  if (adds != nullptr) {
    for (int o = 16; o > 0; o >>= 1) {
      n_flush += __shfl_xor_sync(0xffffffffu, n_flush, o);
      n_over += __shfl_xor_sync(0xffffffffu, n_over, o);
    }
    if ((tid & 31) == 0) {
      if (n_flush) atomicAdd(adds, n_flush);
      if (n_over) atomicAdd(adds + 1, n_over);
    }
  }
}

// Host side of a windowed backward launch: the query tiles (raster runs of
// `qb` queries, or with grid_w > 0 tiles of tile_h x tile_w pixels of a
// grid_h x grid_w query grid) and the plan, checked against the kernel's
// limits. Returns cudaSuccess or cudaErrorInvalidValue.
static inline int bwd_setup(int Q, int D, int P, int vn, const Pyramid& pyr, int qb, int grid_h,
                     int grid_w, int tile_h, int tile_w, int cap, int slice, int pitch,
                     int lanes, BwdTiles& t, BwdPlan& plan, size_t& smem) {
  const int bad = (int)cudaErrorInvalidValue;
  if (qb <= 0 || P <= 0 || D <= 0 || pyr.L < 1 || pyr.L > MAX_LEVELS) return bad;
  for (int l = 0; l < pyr.L; ++l)
    if (pyr.h[l] >= 0xffff || pyr.w[l] >= 0xffff) return bad;  // packed corners
  t = BwdTiles{qb, grid_h, grid_w, tile_h, tile_w, 0, (Q + qb - 1) / qb};
  if (grid_w > 0) {
    if (grid_h <= 0 || (long)grid_h * grid_w != Q || tile_h * tile_w != qb) return bad;
    t.tiles_x = (grid_w + tile_w - 1) / tile_w;
    t.n_tiles = (grid_h + tile_h - 1) / tile_h * t.tiles_x;
  }
  plan = BwdPlan{cap, slice, pitch};
  if (cap < 0 || slice < 1 || slice > D || pitch % vn != 0 || pitch < slice ||
      lanes * vn < slice || (slice < D && slice % vn != 0) || 4L * qb * P > 0xffff)
    return bad;
  smem = bwd_smem_bytes(qb, P, plan, vn);
  return smem > SMEM_BLOCK_MAX ? bad : 0;
}

// The flush's vector width: 4 or 2 floats where every row offset allows it.
static inline int bwd_flush_width(int D, const void* grad_value) {
  if ((uintptr_t)grad_value % 16 == 0 && D % 4 == 0) return 4;
  if ((uintptr_t)grad_value % 8 == 0 && D % 2 == 0) return 2;
  return 1;
}
