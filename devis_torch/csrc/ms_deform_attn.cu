// Temporal multi-scale deformable attention for Hopper (sm_90a).
//
// Four kernels, each the counterpart of a Pallas kernel of
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
//   K5 msda_temporal_bwd   <- _bwd_kernel_rows_temporal (backward of K1, K3).
//      From the output gradient: the gradient of the per-frame value, of the
//      locations and of the weights, with the taps rebuilt in the kernel.
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
// K5 keeps the mapping of K3. Its value gradient is a scatter: every corner
// of every tap adds weight * corner * g onto the frame the rule names, with
// f32 atomics into an f32 buffer (the TPU kernel's one-hot fold of temporal
// slots onto frames is layout; here the slot's frame is addressed directly).
// The sums are therefore not bit-reproducible from run to run. The weight and
// location gradients are three warp reductions over the D channels per tap.
// What bounds it: the atomic traffic, T*Q*M*Lf*P*4*D f32 adds (3.0e9 at the
// encoder's shapes) onto a buffer that stays in L2.
//
// Location arithmetic uses explicit round-to-nearest intrinsics (see
// msda_common.cuh): K1 and K2 then compute exactly the f32 values of the
// plain PyTorch versions, and a K2 window covers every K1 tap.

#include "msda_common.cuh"

#define MAX_WINDOW 16

struct FrameRule {
  int all;  // 1: every other frame; 0: offsets with edge reflection
  int W;
  int off[MAX_WINDOW];
};

// Absolute source frame of temporal slot j of frame t.
__device__ __forceinline__ int source_frame(const FrameRule& r, int j, int t, int T) {
  if (r.all) return j + (t <= j ? 1 : 0);
  int o = r.off[j];
  int c = t + o;
  return (c < 0 || c > T - 1) ? t - o : c;
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
// K5: backward of K1 and K3 from precomputed locations and weights.
//   value (T, S, M, D); loc (T, Q, M, Lf, P, 2) f32; att (T, Q, M, Lf, P) f32;
//   grad_out (T, Q, M*D) -> grad_value (T, S, M, D) f32, zeroed by the caller;
//   grad_loc like loc; grad_att like att. A location's gradient is the pixel
//   gradient times the level size, times the tap's weight.
template <typename scalar_t>
__global__ void msda_temporal_bwd_kernel(const scalar_t* __restrict__ value,
                                         const float* __restrict__ loc,
                                         const float* __restrict__ att,
                                         const scalar_t* __restrict__ grad_out,
                                         float* __restrict__ grad_value,
                                         float* __restrict__ grad_loc,
                                         float* __restrict__ grad_att, int T, int Q, int S,
                                         int M, int D, int P, Pyramid pyr, FrameRule rule) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)T * Q * M) return;  // whole warps leave together
  const int m = (int)(warp % M);
  const long tq = warp / M;
  const int t = (int)(tq / Q);
  const int L = pyr.L, W = rule.W;
  const int LfP = (1 + W) * L * P;
  const float* lc = loc + (tq * M + m) * LfP * 2;
  const float* at = att + (tq * M + m) * LfP;
  float* glc = grad_loc + (tq * M + m) * LfP * 2;
  float* gat = grad_att + (tq * M + m) * LfP;
  const size_t row = (size_t)M * D;
  const bool active = lane < D;
  const float g = active ? to_f(grad_out[(tq * M + m) * D + lane]) : 0.f;
  for (int j = 0; j <= W; ++j) {
    const int f = j == 0 ? t : source_frame(rule, j - 1, t, T);
    const size_t frame = (size_t)f * S * row + (size_t)m * D;
    for (int l = 0; l < L; ++l) {
      const size_t level = frame + (size_t)pyr.start[l] * row;
      const int h = pyr.h[l], w = pyr.w[l];
      for (int p = 0; p < P; ++p) {
        const int k = (j * L + l) * P + p;
        const float a = at[k];
        int x0, y0;
        float dx, dy;
        float s_v = 0.f, s_x = 0.f, s_y = 0.f;
        // the tap is the same for every lane, so the warp does not diverge
        if (tap_geometry(h, w, lc[2 * k], lc[2 * k + 1], x0, y0, dx, dy) && active)
          tap_backward(value + level, grad_value + level, h, w, row, x0, y0, dx, dy, g, a * g,
                       lane, s_v, s_x, s_y);
        s_v = warp_sum(s_v);
        s_x = warp_sum(s_x);
        s_y = warp_sum(s_y);
        if (lane == 0) {
          gat[k] = s_v;
          glc[2 * k] = a * s_x * (float)w;
          glc[2 * k + 1] = a * s_y * (float)h;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w); `offsets` the W host ints of a window rule
// (ignored when rule_all). Each returns cudaGetLastError().

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

template <typename scalar_t>
static int launch_temporal_bwd(void* value, void* loc, void* att, void* grad_out,
                               void* grad_value, void* grad_loc, void* grad_att, int T, int Q,
                               int S, int M, int D, int P, const int* levels, int L,
                               int rule_all, const int* offsets, int W, void* stream) {
  long warps = (long)T * Q * M;
  int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  msda_temporal_bwd_kernel<scalar_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (const scalar_t*)grad_out,
      (float*)grad_value, (float*)grad_loc, (float*)grad_att, T, Q, S, M, D, P,
      make_pyramid(levels, L), make_rule(rule_all, offsets, W));
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

int msda_temporal_bwd_f32(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                          void* grad_loc, void* grad_att, int T, int Q, int S, int M, int D,
                          int P, const int* levels, int L, int rule_all, const int* offsets,
                          int W, void* stream) {
  return launch_temporal_bwd<float>(value, loc, att, grad_out, grad_value, grad_loc, grad_att, T,
                                    Q, S, M, D, P, levels, L, rule_all, offsets, W, stream);
}

int msda_temporal_bwd_bf16(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                           void* grad_loc, void* grad_att, int T, int Q, int S, int M, int D,
                           int P, const int* levels, int L, int rule_all, const int* offsets,
                           int W, void* stream) {
  return launch_temporal_bwd<__nv_bfloat16>(value, loc, att, grad_out, grad_value, grad_loc,
                                            grad_att, T, Q, S, M, D, P, levels, L, rule_all,
                                            offsets, W, stream);
}

}  // extern "C"
