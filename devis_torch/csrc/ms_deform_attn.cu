// Temporal multi-scale deformable attention for Hopper (sm_90a).
//
// Three kernels, each the counterpart of a Pallas kernel of
// devis_tpu/ops/ms_deform_attn_pallas.py:
//
//   K1 msda_temporal_proj  <- _fwd_kernel_temporal_proj (encoder).
//      From the raw offset and logit projections: location math, the joint
//      softmax over current and temporal logits, frame selection by rule,
//      bilinear taps with zero padding, f32 accumulation. Locations and
//      weights never reach device memory.
//   K2 msda_tap_window     <- _ranges_proj_kernel.
//      Per (t, m, q-block, level) the first and last value row that a live
//      tap of K1 touches, from the same f32 location math.
//   K3 msda_temporal       <- _fwd_kernel_temporal (decoder).
//      The same sampling from precomputed locations and weights.
//
// Mapping (K1, K3): one warp per (t, q, m); lane d owns channel d (D <= 32).
// Every lane walks the (1 + W) * L * P taps; the four corner reads of a tap
// are 32 neighbouring channels of one value row, so each is one coalesced
// 64-byte (bf16) or 128-byte (f32) load.
//
// What bounds them: the gathers. Each (t, q, m) reads (1 + W) * L * P * 4
// rows of D channels; the value tensor of a clip (15.7 MB in bf16 at the
// YT-VIS-19 shapes) stays in the 50 MB L2, so the loads are served from L2
// and the kernels are bound by L2/L1 load throughput and latency, not by
// device-memory bytes or FLOPs. The TPU kernel's one-hot matmul form exists
// only because the TPU has no fast gather; here the gather is direct.
// Staging each q-block's value window (K2) in shared memory is the next
// step and is not taken here.
//
// Location arithmetic uses explicit round-to-nearest intrinsics so nvcc does
// not contract it into FMAs: K1 and K2 then compute exactly the f32 values
// of the plain PyTorch versions, and a K2 window covers every K1 tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LEVELS 8
#define MAX_WINDOW 16

struct Pyramid {
  int L;
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
  float inv_w[MAX_LEVELS];
  float inv_h[MAX_LEVELS];
};

struct FrameRule {
  int all;  // 1: every other frame; 0: offsets with edge reflection
  int W;
  int off[MAX_WINDOW];
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

// Absolute source frame of temporal slot j of frame t.
__device__ __forceinline__ int source_frame(const FrameRule& r, int j, int t, int T) {
  if (r.all) return j + (t <= j ? 1 : 0);
  int o = r.off[j];
  int c = t + o;
  return (c < 0 || c > T - 1) ? t - o : c;
}

// Normalized location of a tap: ref + off / size, as ref + off * (1/size).
__device__ __forceinline__ float tap_loc(float ref, float off, float inv) {
  return __fadd_rn(ref, __fmul_rn(off, inv));
}

// Bilinear sample of channel d at normalized (lx, ly) of one level, zero
// padding. `vl` points at row 0 of the level for this head; rows are
// `row` elements apart.
template <typename scalar_t>
__device__ __forceinline__ float sample_bilinear(const scalar_t* __restrict__ vl, int h, int w,
                                                 size_t row, float lx, float ly, int d) {
  float x = __fsub_rn(__fmul_rn(lx, (float)w), 0.5f);
  float y = __fsub_rn(__fmul_rn(ly, (float)h), 0.5f);
  if (!(x > -1.f && x < (float)w && y > -1.f && y < (float)h)) return 0.f;
  float x0f = floorf(x), y0f = floorf(y);
  float dx = x - x0f, dy = y - y0f;
  int x0 = (int)x0f, y0 = (int)y0f;
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

// ---------------------------------------------------------------------------
// K1: encoder temporal attention from raw projections.
//   value (T, S, M, D); ref (T, Q, L, 2) f32; c_off (T, Q, M*L*P*2);
//   t_off (T, Q, M*W*L*P*2); c_logit (T, Q, M*L*P); t_logit (T, Q, M*W*L*P)
//   -> out (T, Q, M*D). Offsets are (x, y) pairs; temporal channels are in
//   (m, j, l, p) order; the temporal reference is the level-0 reference.
template <typename scalar_t>
__global__ void msda_temporal_proj_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ ref,
    const scalar_t* __restrict__ c_off, const scalar_t* __restrict__ t_off,
    const scalar_t* __restrict__ c_logit, const scalar_t* __restrict__ t_logit,
    scalar_t* __restrict__ out, int T, int Q, int S, int M, int D, int P,
    Pyramid pyr, FrameRule rule) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)T * Q * M) return;
  const int m = (int)(warp % M);
  const long tq = warp / M;
  const int t = (int)(tq / Q);
  const int L = pyr.L, W = rule.W;
  const int nc = L * P, nt = W * L * P;
  const scalar_t* cl = c_logit + (tq * M + m) * nc;
  const scalar_t* tl = t_logit + (tq * M + m) * nt;

  float mx = -INFINITY;
  for (int i = lane; i < nc + nt; i += 32)
    mx = fmaxf(mx, i < nc ? to_f(cl[i]) : to_f(tl[i - nc]));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int i = lane; i < nc + nt; i += 32)
    sum += expf((i < nc ? to_f(cl[i]) : to_f(tl[i - nc])) - mx);
  const float inv = 1.f / warp_sum(sum);

  const float* r = ref + tq * L * 2;
  const scalar_t* co = c_off + (tq * M + m) * nc * 2;
  const scalar_t* to = t_off + (tq * M + m) * nt * 2;
  const size_t row = (size_t)M * D;
  const bool active = lane < D;
  float acc = 0.f;
  for (int j = 0; j <= W; ++j) {
    const int f = j == 0 ? t : source_frame(rule, j - 1, t, T);
    const scalar_t* vf = value + (size_t)f * S * row + (size_t)m * D;
    const scalar_t* ob = j == 0 ? co : to + (size_t)(j - 1) * L * P * 2;
    const scalar_t* lb = j == 0 ? cl : tl + (size_t)(j - 1) * L * P;
    for (int l = 0; l < L; ++l) {
      const float rx = j == 0 ? r[2 * l] : r[0];
      const float ry = j == 0 ? r[2 * l + 1] : r[1];
      const scalar_t* vl = vf + (size_t)pyr.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float a = expf(to_f(lb[k]) - mx) * inv;
        const float lx = tap_loc(rx, to_f(ob[2 * k]), pyr.inv_w[l]);
        const float ly = tap_loc(ry, to_f(ob[2 * k + 1]), pyr.inv_h[l]);
        if (active) acc += a * sample_bilinear(vl, pyr.h[l], pyr.w[l], row, lx, ly, lane);
      }
    }
  }
  if (active) out[(tq * M + m) * D + lane] = from_f<scalar_t>(acc);
}

// ---------------------------------------------------------------------------
// K2: tap windows. One block of QB threads per (t, m, q-block); thread i
// takes query q-block * QB + i. out (T, M, nqb, (1+W)*L, 2) int32 holds the
// first and last raster row (within the level) touched by a live tap, or
// (0, -1) where no tap of the block is live.
template <typename scalar_t>
__global__ void msda_tap_window_kernel(const float* __restrict__ ref,
                                       const scalar_t* __restrict__ c_off,
                                       const scalar_t* __restrict__ t_off,
                                       int* __restrict__ out, int T, int Q, int M, int P,
                                       int nqb, Pyramid pyr, int W) {
  extern __shared__ int s_win[];  // [Lf] minima then [Lf] maxima
  const int L = pyr.L, Lf = (1 + W) * L;
  const int qb = blockIdx.x % nqb;
  const int tm = blockIdx.x / nqb;
  const int m = tm % M, t = tm / M;
  for (int i = threadIdx.x; i < Lf; i += blockDim.x) {
    s_win[i] = 0x7fffffff;
    s_win[Lf + i] = -1;
  }
  __syncthreads();
  const int q = qb * blockDim.x + threadIdx.x;
  const bool live_q = q < Q;
  const long tq = (long)t * Q + (live_q ? q : 0);
  const float* r = ref + tq * L * 2;
  const int nc = L * P, nt = W * L * P;
  const scalar_t* co = c_off + (tq * M + m) * nc * 2;
  const scalar_t* to = t_off + (tq * M + m) * nt * 2;
  for (int lvl = 0; lvl < Lf; ++lvl) {
    const int j = lvl / L, l = lvl % L;
    const int h = pyr.h[l], w = pyr.w[l];
    int mn = 0x7fffffff, mxr = -1;
    if (live_q) {
      const float rx = j == 0 ? r[2 * l] : r[0];
      const float ry = j == 0 ? r[2 * l + 1] : r[1];
      const scalar_t* ob = j == 0 ? co : to + (size_t)(j - 1) * L * P * 2;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float lx = tap_loc(rx, to_f(ob[2 * k]), pyr.inv_w[l]);
        const float ly = tap_loc(ry, to_f(ob[2 * k + 1]), pyr.inv_h[l]);
        const float x = __fsub_rn(__fmul_rn(lx, (float)w), 0.5f);
        const float y = __fsub_rn(__fmul_rn(ly, (float)h), 0.5f);
        if (!(x > -1.f && x < (float)w && y > -1.f && y < (float)h)) continue;
        const int x0 = (int)floorf(x), y0 = (int)floorf(y);
        const int lo = max(y0, 0) * w + max(x0, 0);
        const int hi = min(y0 + 1, h - 1) * w + min(x0 + 1, w - 1);
        mn = min(mn, lo);
        mxr = max(mxr, hi);
      }
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mxr = __reduce_max_sync(0xffffffffu, mxr);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&s_win[lvl], mn);
      atomicMax(&s_win[Lf + lvl], mxr);
    }
  }
  __syncthreads();
  int* o = out + (size_t)blockIdx.x * Lf * 2;
  for (int i = threadIdx.x; i < Lf; i += blockDim.x) {
    const int hi = s_win[Lf + i];
    o[2 * i] = hi >= 0 ? s_win[i] : 0;
    o[2 * i + 1] = hi;
  }
}

// ---------------------------------------------------------------------------
// K3: decoder temporal attention from precomputed locations and weights.
//   value (T, S, M, D); loc (T, Q, M, Lf, P, 2) f32; att (T, Q, M, Lf, P) f32
//   -> out (T, Q, M*D). Level lvl = j * L + l reads frame slot j.
template <typename scalar_t>
__global__ void msda_temporal_kernel(const scalar_t* __restrict__ value,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ att,
                                     scalar_t* __restrict__ out, int T, int Q, int S, int M,
                                     int D, int P, Pyramid pyr, FrameRule rule) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)T * Q * M) return;
  const int m = (int)(warp % M);
  const long tq = warp / M;
  const int t = (int)(tq / Q);
  const int L = pyr.L, W = rule.W;
  const int LfP = (1 + W) * L * P;
  const float* lc = loc + (tq * M + m) * LfP * 2;
  const float* at = att + (tq * M + m) * LfP;
  const size_t row = (size_t)M * D;
  if (lane >= D) return;
  float acc = 0.f;
  for (int j = 0; j <= W; ++j) {
    const int f = j == 0 ? t : source_frame(rule, j - 1, t, T);
    const scalar_t* vf = value + (size_t)f * S * row + (size_t)m * D;
    for (int l = 0; l < L; ++l) {
      const scalar_t* vl = vf + (size_t)pyr.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = (j * L + l) * P + p;
        acc += at[k] * sample_bilinear(vl, pyr.h[l], pyr.w[l], row, lc[2 * k], lc[2 * k + 1], lane);
      }
    }
  }
  out[(tq * M + m) * D + lane] = from_f<scalar_t>(acc);
}

// ---------------------------------------------------------------------------
// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w); `offsets` the W host ints of a window rule
// (ignored when rule_all). Each returns cudaGetLastError().

static Pyramid make_pyramid(const int* levels, int L) {
  Pyramid p;
  p.L = L;
  int s = 0;
  for (int l = 0; l < L; ++l) {
    p.h[l] = levels[2 * l];
    p.w[l] = levels[2 * l + 1];
    p.start[l] = s;
    p.inv_w[l] = 1.0f / (float)p.w[l];
    p.inv_h[l] = 1.0f / (float)p.h[l];
    s += p.h[l] * p.w[l];
  }
  return p;
}

static FrameRule make_rule(int rule_all, const int* offsets, int W) {
  FrameRule r;
  r.all = rule_all;
  r.W = W;
  for (int j = 0; j < MAX_WINDOW; ++j) r.off[j] = (!rule_all && j < W) ? offsets[j] : 0;
  return r;
}

static const int kThreads = 256;

template <typename scalar_t>
static int launch_temporal_proj(void* value, void* ref, void* c_off, void* t_off, void* c_logit,
                                void* t_logit, void* out, int T, int Q, int S, int M, int D,
                                int P, const int* levels, int L, int rule_all,
                                const int* offsets, int W, void* stream) {
  long warps = (long)T * Q * M;
  int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  msda_temporal_proj_kernel<scalar_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)ref, (const scalar_t*)c_off, (const scalar_t*)t_off,
      (const scalar_t*)c_logit, (const scalar_t*)t_logit, (scalar_t*)out, T, Q, S, M, D, P,
      make_pyramid(levels, L), make_rule(rule_all, offsets, W));
  return (int)cudaGetLastError();
}

template <typename scalar_t>
static int launch_tap_window(void* ref, void* c_off, void* t_off, void* out, int T, int Q, int M,
                             int P, int q_block, const int* levels, int L, int W,
                             void* stream) {
  int nqb = (Q + q_block - 1) / q_block;
  int Lf = (1 + W) * L;
  msda_tap_window_kernel<scalar_t>
      <<<T * M * nqb, q_block, 2 * Lf * sizeof(int), (cudaStream_t)stream>>>(
          (const float*)ref, (const scalar_t*)c_off, (const scalar_t*)t_off, (int*)out, T, Q, M,
          P, nqb, make_pyramid(levels, L), W);
  return (int)cudaGetLastError();
}

template <typename scalar_t>
static int launch_temporal(void* value, void* loc, void* att, void* out, int T, int Q, int S,
                           int M, int D, int P, const int* levels, int L, int rule_all,
                           const int* offsets, int W, void* stream) {
  long warps = (long)T * Q * M;
  int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  msda_temporal_kernel<scalar_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (scalar_t*)out, T, Q, S, M,
      D, P, make_pyramid(levels, L), make_rule(rule_all, offsets, W));
  return (int)cudaGetLastError();
}

extern "C" {

int msda_temporal_proj_f32(void* value, void* ref, void* c_off, void* t_off, void* c_logit,
                           void* t_logit, void* out, int T, int Q, int S, int M, int D, int P,
                           const int* levels, int L, int rule_all, const int* offsets, int W,
                           void* stream) {
  return launch_temporal_proj<float>(value, ref, c_off, t_off, c_logit, t_logit, out, T, Q, S,
                                     M, D, P, levels, L, rule_all, offsets, W, stream);
}

int msda_temporal_proj_bf16(void* value, void* ref, void* c_off, void* t_off, void* c_logit,
                            void* t_logit, void* out, int T, int Q, int S, int M, int D, int P,
                            const int* levels, int L, int rule_all, const int* offsets, int W,
                            void* stream) {
  return launch_temporal_proj<__nv_bfloat16>(value, ref, c_off, t_off, c_logit, t_logit, out, T,
                                             Q, S, M, D, P, levels, L, rule_all, offsets, W,
                                             stream);
}

int msda_tap_window_f32(void* ref, void* c_off, void* t_off, void* out, int T, int Q, int M,
                        int P, int q_block, const int* levels, int L, int W, void* stream) {
  return launch_tap_window<float>(ref, c_off, t_off, out, T, Q, M, P, q_block, levels, L, W,
                                  stream);
}

int msda_tap_window_bf16(void* ref, void* c_off, void* t_off, void* out, int T, int Q, int M,
                         int P, int q_block, const int* levels, int L, int W, void* stream) {
  return launch_tap_window<__nv_bfloat16>(ref, c_off, t_off, out, T, Q, M, P, q_block, levels,
                                          L, W, stream);
}

int msda_temporal_f32(void* value, void* loc, void* att, void* out, int T, int Q, int S, int M,
                      int D, int P, const int* levels, int L, int rule_all, const int* offsets,
                      int W, void* stream) {
  return launch_temporal<float>(value, loc, att, out, T, Q, S, M, D, P, levels, L, rule_all,
                                offsets, W, stream);
}

int msda_temporal_bf16(void* value, void* loc, void* att, void* out, int T, int Q, int S, int M,
                       int D, int P, const int* levels, int L, int rule_all,
                       const int* offsets, int W, void* stream) {
  return launch_temporal<__nv_bfloat16>(value, loc, att, out, T, Q, S, M, D, P, levels, L,
                                        rule_all, offsets, W, stream);
}

}  // extern "C"
