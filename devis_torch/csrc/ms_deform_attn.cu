// Temporal multi-scale deformable attention for Hopper (sm_90a).
//
// Four kernels, each the counterpart of a Pallas kernel of
// devis_tpu/ops/ms_deform_attn_pallas.py:
//
//   K1 msda_temporal_proj  <- _fwd_kernel_temporal_proj (encoder).
//      From the raw offset and logit projections and K2's windows: location
//      math, the joint softmax over current and temporal logits, frame
//      selection by rule, bilinear taps with zero padding, f32 accumulation.
//      Locations and weights never reach device memory.
//   K2 msda_tap_window     <- _ranges_proj_kernel.
//      Per (t, m, q-block, level) the first and last value row that a live
//      tap of K1 touches, from the same f32 location math. K1's wrapper
//      launches it first.
//   K3 msda_temporal       <- _fwd_kernel_temporal (decoder).
//      The same sampling from precomputed locations and weights.
//   K5 msda_temporal_bwd_win <- _bwd_kernel_rows_temporal (backward of K1, K3).
//      From the output gradient: the gradient of the per-frame value, of the
//      locations and of the weights, with the taps rebuilt in the kernel.
//
// K1 (see its kernel below): one block per (t, m, q-block of 128 queries), the
// grid of K2. A tap's location, corners and softmax weight are computed once,
// by one thread per (query, point), not once per channel. The value rows of
// a block's window of each (frame slot, level) are staged in shared memory
// with cp.async, double-buffered, and the corners read them there. A window
// is the rows that 128 raster-ordered queries touch: at the clip's shapes
// about 1 300 rows a frame against about 8 200 corner reads, so the staged
// copy moves several times fewer bytes from L2 than reading every corner
// where it lies. What bounds it: the latency of the dependent reads (tap,
// then corner), hidden by 32 warps an SM, more than any throughput; the
// kernel lab's modes (devis_torch/ops/msda_lab.py, chip_smoke.py) measure
// the parts. The TPU kernel's one-hot matmul form exists only because the
// TPU has no fast gather, and is not taken.
//
// Mapping (K3): one warp per (t, q, m); lane d owns channel d (D <= 32).
// Every lane walks the (1 + W) * L * P taps; the four corner reads of a tap
// are 32 neighbouring channels of one value row, so each is one coalesced
// 64-byte (bf16) or 128-byte (f32) load. The decoder's 60 queries are too
// few for windows to pay: the kernel is launch-bound.
//
// K5 (`msda_bwd_block` in msda_common.cuh, shared with K7): the value
// gradient is a scatter, one add per (tap, corner, channel) onto the frame the
// rule names (the TPU kernel's one-hot fold of temporal slots onto frames is
// layout; here the slot's frame is addressed directly). Added straight into
// the f32 gradient, 3.0e9 scalar adds at the encoder's shapes kept L2's
// atomic units busy 21 times the bound. The kernel takes K1's raster blocks
// of 128 queries of one (t, m); per stage (frame slot, level) one thread per
// (query, point) computes the tap once, the block's corners are sorted by
// window row (the box of rows its taps touch: at raster references about
// 1 300 rows a frame against 8 200 corner touches), each touched row is read
// once, its adds summed in registers and flushed once with a vector atomic
// (6x fewer global adds at raster references, 2.5x at random ones), and each
// tap's weight and location gradients are gathered from its corners' dot
// products and written once. The flush's order changes from run to run: the
// sums are not bit-reproducible. What bounds it now: latency, through the
// barriers between its per-stage steps and the dependent shared-memory reads
// of the row pass, more than any throughput.
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
// K1: encoder temporal attention from raw projections, on K2's windows.
//   value (T, S, M, D); ref (T, Q, L, 2) f32; c_off (T, Q, M*L*P*2);
//   t_off (T, Q, M*W*L*P*2); c_logit (T, Q, M*L*P); t_logit (T, Q, M*W*L*P);
//   windows (T, M, nqb, Lf, 2) int32 from K2 -> out (T, Q, M*D). Offsets are
//   (x, y) pairs; temporal channels are in (m, j, l, p) order; the temporal
//   reference is the level-0 reference.
//
// One block of K1_THREADS per (t, m, q-block of K1_QB queries), K2's grid.
//   1. Four threads per query reduce its (1 + W) * L * P logits to the max
//      and the reciprocal sum of the joint softmax.
//   2. The stages (j, l), frame slot j and level l, run in order. For each,
//      the block copies value rows [first, first + n) of head m from K2's
//      window into one of two shared buffers with cp.async (n = the window's
//      length, at most the level's capacity `cap[l]`): stage s + 1 loads
//      while stage s is sampled. One thread per (query, point) computes the
//      tap once: location, softmax weight, and per corner its row in the
//      buffer (>= 0), its level row r as -2 - r where it lies outside the
//      staged rows (read from global memory, never dropped), or -1 where it
//      is outside the level; and its weight. Then LPR lanes per query, each
//      owning 16 bytes of channels, sample the corners from shared memory.
//   f32 accumulation in registers across all stages; one store per channel.
//
// MODE selects the cost-isolation variants of the kernel lab
// (benchmarks/kernel_lab.py `_kernel`); only K1_FULL runs on a model path:
//   K1_NOSTAGE   no window: every corner from global memory (= K1_FULL)
//   K1_NOLOC     fixed dummy taps and weights: no location or softmax math
//   K1_NOGATHER  no staging and no corner reads; taps and accumulation kept
//   K1_NOACC     corners read, not accumulated (their bits are OR-ed)
//   K1_COUNT     K1_FULL, counting corners read from global memory in
//                windows that fit their capacity (reads[0]) and in windows
//                that do not (reads[1])
enum { K1_FULL = 0, K1_NOSTAGE, K1_NOLOC, K1_NOGATHER, K1_NOACC, K1_COUNT, K1_MODES };

#define K1_QB 128
// 16 warps a block and two blocks an SM (at most 64 registers a thread): the
// corner reads are latency-bound, and 8 warps a block were 1.2-1.4x slower
#define K1_THREADS 512
#define K1_TPQ (K1_THREADS / K1_QB)  // threads per query in the softmax
#define K1_MAX_LF ((1 + MAX_WINDOW) * MAX_LEVELS)
// softmax max and reciprocal sum per query; (first, staged rows, length) per stage
#define K1_HEAD_BYTES (2 * K1_QB * 4 + 3 * K1_MAX_LF * 4)
#define K1_TAP_BYTES 32  // int4 rows + float4 weights per (query, point)

struct StagePlan {
  int cap[MAX_LEVELS];  // rows of a level's window that are staged
  int rows[2];          // rows of the two stage buffers (stage s uses s % 2)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy `n` rows of D channels, `src_stride` elements apart, into shared rows
// of DP channels: 16-byte cp.async where rows are 16-byte aligned, else one
// element at a time. Commits one cp.async group either way.
template <typename scalar_t>
__device__ __forceinline__ void stage_rows(scalar_t* dst, const scalar_t* __restrict__ src, int n,
                                           int D, int DP, size_t src_stride, bool aligned) {
  if (aligned) {
    const int cpr = D * (int)sizeof(scalar_t) / 16;
    for (int i = threadIdx.x; i < n * cpr; i += K1_THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(reinterpret_cast<char*>(dst + (size_t)r * DP) + c * 16,
                 reinterpret_cast<const char*>(src + r * src_stride) + c * 16);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += K1_THREADS) {
      const int r = i / D, c = i - r * D;
      dst[(size_t)r * DP + c] = src[r * src_stride + c];
    }
  }
  cp_async_commit();
}

// One corner of a tap: its buffer row, or -2 - its level row where it lies
// outside the staged rows, or -1 outside the level.
__device__ __forceinline__ void tap_corner(int yi, int xi, int h, int w, float wt, float a,
                                           int first, int nst, int& id, float& wo,
                                           int& n_global) {
  if (yi < 0 || yi >= h || xi < 0 || xi >= w) {
    id = -1;
    wo = 0.f;
    return;
  }
  const int r = yi * w + xi, rel = r - first;
  if (rel >= 0 && rel < nst) {
    id = rel;
  } else {
    id = -2 - r;
    ++n_global;
  }
  wo = a * wt;
}

// Row 0 of level s % L of head m in the frame of stage s (frame slot s / L).
template <typename scalar_t>
__device__ __forceinline__ const scalar_t* level_rows(const scalar_t* value, const Pyramid& pyr,
                                                      const FrameRule& rule, int t, int T, int S,
                                                      int M, int D, int m, int s) {
  const int f = s < pyr.L ? t : source_frame(rule, s / pyr.L - 1, t, T);
  return value + ((size_t)f * S + pyr.start[s % pyr.L]) * ((size_t)M * D) + (size_t)m * D;
}

// The raw projections a block's taps come from: frame t, head m, queries q0...
template <typename scalar_t>
struct TapSource {
  const float* ref;
  const scalar_t *c_off, *t_off, *c_logit, *t_logit;
  int t, Q, M, m, L, P, nc, nt, q0;

  // Raw inputs of tap i = (query, point) of stage s: the x and y offsets,
  // the logit, the reference's x and y. Zeros past the last query.
  __device__ __forceinline__ void load(int i, int s, float* in) const {
    const int ql = i / P, p = i - ql * P, q = q0 + ql;
    if (q >= Q) {
      in[0] = in[1] = in[2] = in[3] = in[4] = 0.f;
      return;
    }
    const int j = s / L, l = s - j * L, k = l * P + p;
    const long tq = (long)t * Q + q;
    const scalar_t* ob = j == 0 ? c_off + (tq * M + m) * nc * 2
                                : t_off + (tq * M + m) * nt * 2 + (size_t)(j - 1) * nc * 2;
    const scalar_t* lb = j == 0 ? c_logit + (tq * M + m) * nc
                                : t_logit + (tq * M + m) * nt + (size_t)(j - 1) * nc;
    const float* r = ref + tq * L * 2 + (j == 0 ? 2 * l : 0);
    in[0] = to_f(ob[2 * k]);
    in[1] = to_f(ob[2 * k + 1]);
    in[2] = to_f(lb[k]);
    in[3] = r[0];
    in[4] = r[1];
  }
};

// The level and window of one stage.
struct TapStage {
  int h, w;
  float inv_w, inv_h;
  int first, nst;  // the window's first row and the rows staged
  bool fits;       // the window is no longer than the level's capacity
};

// Tap i = (query, point) of a stage from its raw inputs: the four corners'
// rows and weights into shared memory (dead where the query or the tap is).
template <int MODE, typename scalar_t>
__device__ __forceinline__ void build_tap(int i, const float* in, const TapStage& st,
                                          const TapSource<scalar_t>& src,
                                          const float* __restrict__ s_mx,
                                          const float* __restrict__ s_inv, int4* s_id,
                                          float4* s_wt, float dummy, int& n_fit, int& n_over) {
  const int ql = i / src.P;
  int4 id = make_int4(-1, -1, -1, -1);
  float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src.q0 + ql < src.Q) {
    if (MODE == K1_NOLOC) {
      if (st.nst > 0) {
        id = make_int4(i % st.nst, (i + 1) % st.nst, (i + 2) % st.nst, (i + 3) % st.nst);
        wt = make_float4(dummy, dummy, dummy, dummy);
      }
    } else {
      const float a = expf(in[2] - s_mx[ql]) * s_inv[ql];
      const float x = tap_px(tap_loc(in[3], in[0], st.inv_w), st.w);
      const float y = tap_px(tap_loc(in[4], in[1], st.inv_h), st.h);
      if (in_window(st.h, st.w, x, y)) {
        int x0, y0;
        float dx, dy;
        tap_floor(x, y, x0, y0, dx, dy);
        int ng = 0;
        tap_corner(y0, x0, st.h, st.w, (1.f - dy) * (1.f - dx), a, st.first, st.nst, id.x, wt.x,
                   ng);
        tap_corner(y0, x0 + 1, st.h, st.w, (1.f - dy) * dx, a, st.first, st.nst, id.y, wt.y, ng);
        tap_corner(y0 + 1, x0, st.h, st.w, dy * (1.f - dx), a, st.first, st.nst, id.z, wt.z, ng);
        tap_corner(y0 + 1, x0 + 1, st.h, st.w, dy * dx, a, st.first, st.nst, id.w, wt.w, ng);
        if (st.fits)
          n_fit += ng;
        else
          n_over += ng;
      }
    }
  }
  s_id[i] = id;
  s_wt[i] = wt;
}

template <typename scalar_t, int LPR, int MODE>
__global__ void __launch_bounds__(K1_THREADS, 2) msda_temporal_proj_win_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ ref,
    const scalar_t* __restrict__ c_off, const scalar_t* __restrict__ t_off,
    const scalar_t* __restrict__ c_logit, const scalar_t* __restrict__ t_logit,
    const int* __restrict__ windows, scalar_t* __restrict__ out, int* __restrict__ reads, int T,
    int Q, int S, int M, int D, int P, int nqb, bool aligned, Pyramid pyr, FrameRule rule,
    StagePlan plan) {
  using V = Vec16<scalar_t>;
  constexpr int VN = V::N;
  constexpr int NSLOT = K1_THREADS / LPR;  // lane groups, one query each at a time
  constexpr int NQS = (K1_QB + NSLOT - 1) / NSLOT;
  static_assert(K1_TPQ == 4, "four threads per query in the softmax");
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_mx = reinterpret_cast<float*>(smem);
  float* s_inv = s_mx + K1_QB;
  int* s_win = reinterpret_cast<int*>(s_inv + K1_QB);
  int4* s_id = reinterpret_cast<int4*>(smem + K1_HEAD_BYTES);
  float4* s_wt = reinterpret_cast<float4*>(s_id + K1_QB * P);
  scalar_t* buf0 = reinterpret_cast<scalar_t*>(s_wt + K1_QB * P);
  const int DP = (D + VN - 1) / VN * VN;
  scalar_t* buf1 = buf0 + (size_t)plan.rows[0] * DP;

  const int tid = threadIdx.x;
  const int qb = blockIdx.x % nqb;
  const int tm = blockIdx.x / nqb;
  const int m = tm % M, t = tm / M;
  const int q0 = qb * K1_QB;
  const int L = pyr.L, W = rule.W, Lf = (1 + W) * L;
  const int nc = L * P, nt = W * L * P;
  const size_t row = (size_t)M * D;
  constexpr bool kStage = MODE != K1_NOSTAGE && MODE != K1_NOGATHER;

  const int* win = windows + (size_t)blockIdx.x * Lf * 2;
  for (int s = tid; s < Lf; s += K1_THREADS) {
    const int first = win[2 * s], n = max(win[2 * s + 1] - first + 1, 0);
    s_win[3 * s] = first;
    s_win[3 * s + 1] = kStage ? min(n, plan.cap[s % L]) : 0;
    s_win[3 * s + 2] = n;
  }
  if (MODE != K1_NOLOC) {
    const int ql = tid / K1_TPQ, part = tid % K1_TPQ;
    const int q = q0 + ql;
    const long tq = (long)t * Q + min(q, Q - 1);
    const scalar_t* cl = c_logit + (tq * M + m) * nc;
    const scalar_t* tl = t_logit + (tq * M + m) * nt;
    float mx = -INFINITY;
    for (int i = part; i < nc + nt; i += K1_TPQ)
      mx = fmaxf(mx, i < nc ? to_f(cl[i]) : to_f(tl[i - nc]));
    for (int o = 1; o < K1_TPQ; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int i = part; i < nc + nt; i += K1_TPQ)
      sum += expf((i < nc ? to_f(cl[i]) : to_f(tl[i - nc])) - mx);
    for (int o = 1; o < K1_TPQ; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      s_mx[ql] = mx;
      s_inv[ql] = 1.f / sum;
    }
  }
  __syncthreads();

  const int slot = tid / LPR, cg = tid % LPR;
  const bool lane_live = cg * VN < D;
  float acc[NQS][VN];
  unsigned bits[NQS][4];
#pragma unroll
  for (int k = 0; k < NQS; ++k) {
#pragma unroll
    for (int v = 0; v < VN; ++v) acc[k][v] = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) bits[k][v] = 0u;
  }
  int n_fit = 0, n_over = 0;  // corners read from global memory (K1_COUNT)
  const TapSource<scalar_t> src{ref, c_off, t_off, c_logit, t_logit, t, Q, M, m, L, P, nc, nt, q0};

  // stage s + 1's rows are copied while stage s is sampled
  if (kStage)
    stage_rows(buf0, level_rows(value, pyr, rule, t, T, S, M, D, m, 0) + (size_t)s_win[0] * row,
               s_win[1], D, DP, row, aligned);
  else
    cp_async_commit();
  for (int s = 0; s < Lf; ++s) {
    if (kStage && s + 1 < Lf)
      stage_rows((s & 1) ? buf0 : buf1,
                 level_rows(value, pyr, rule, t, T, S, M, D, m, s + 1) +
                     (size_t)s_win[3 * (s + 1)] * row,
                 s_win[3 * (s + 1) + 1], D, DP, row, aligned);
    else
      cp_async_commit();
    const int l = s % L;
    const TapStage st{pyr.h[l], pyr.w[l], pyr.inv_w[l], pyr.inv_h[l], s_win[3 * s],
                      s_win[3 * s + 1], s_win[3 * s + 2] <= plan.cap[l]};
    const float dummy = 0.25f / (float)(Lf * P);

    // taps of this stage, one thread per (query, point)
    for (int i = tid; i < K1_QB * P; i += K1_THREADS) {
      float in[5];
      if (MODE != K1_NOLOC) src.load(i, s, in);
      build_tap<MODE>(i, in, st, src, s_mx, s_inv, s_id, s_wt, dummy, n_fit, n_over);
    }
    cp_async_wait_prior();
    __syncthreads();

    // sampling: lane group `slot` takes queries slot, slot + NSLOT, ...
    const scalar_t* sb = ((s & 1) ? buf1 : buf0) + cg * VN;
    const scalar_t* gl = level_rows(value, pyr, rule, t, T, S, M, D, m, s) + cg * VN;
#pragma unroll
    for (int k = 0; k < NQS; ++k) {
      const int ql = slot + k * NSLOT;
      if (ql >= K1_QB || q0 + ql >= Q || !lane_live) continue;
      for (int p = 0; p < P; ++p) {
        const int4 id4 = s_id[ql * P + p];
        const float4 wt4 = s_wt[ql * P + p];
        const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
        const float wts[4] = {wt4.x, wt4.y, wt4.z, wt4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int id = ids[c];
          if (MODE == K1_NOGATHER) {
#pragma unroll
            for (int v = 0; v < VN; ++v) acc[k][v] += wts[c];
            continue;
          }
          if (id == -1) continue;
          uint4 raw;
          if (id >= 0) {
            raw = *reinterpret_cast<const uint4*>(sb + (size_t)id * DP);
          } else if (aligned) {
            raw = __ldg(reinterpret_cast<const uint4*>(gl + (size_t)(-2 - id) * row));
          } else {
            alignas(16) scalar_t e[VN];
            const scalar_t* g = gl + (size_t)(-2 - id) * row;
#pragma unroll
            for (int v = 0; v < VN; ++v) e[v] = cg * VN + v < D ? g[v] : from_f<scalar_t>(0.f);
            raw = *reinterpret_cast<const uint4*>(e);
          }
          if (MODE == K1_NOACC) {
            bits[k][0] |= raw.x;
            bits[k][1] |= raw.y;
            bits[k][2] |= raw.z;
            bits[k][3] |= raw.w;
            continue;
          }
          float vals[VN];
          V::unpack(raw, vals);
#pragma unroll
          for (int v = 0; v < VN; ++v) acc[k][v] += wts[c] * vals[v];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < NQS; ++k) {
    const int ql = slot + k * NSLOT;
    const int q = q0 + ql;
    if (ql >= K1_QB || q >= Q || !lane_live) continue;
    if (MODE == K1_NOACC)
      for (int v = 0; v < 4; ++v) acc[k][v] = __uint_as_float(bits[k][v]);
    scalar_t* o = out + ((size_t)t * Q + q) * row + (size_t)m * D + cg * VN;
    if (aligned) {
      *reinterpret_cast<uint4*>(o) = V::pack(acc[k]);
    } else {
      for (int v = 0; v < VN && cg * VN + v < D; ++v) o[v] = from_f<scalar_t>(acc[k][v]);
    }
  }
  if (MODE == K1_COUNT) {
    n_fit = __reduce_add_sync(0xffffffffu, n_fit);
    n_over = __reduce_add_sync(0xffffffffu, n_over);
    if ((tid & 31) == 0) {
      if (n_fit) atomicAdd(reads, n_fit);
      if (n_over) atomicAdd(reads + 1, n_over);
    }
  }
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
        const float x = tap_px(lx, w), y = tap_px(ly, h);
        if (!in_window(h, w, x, y)) continue;
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
// K5: backward of K1 and K3 from precomputed locations and weights, on the
// windowed block of msda_common.cuh.
//   value (T, S, M, D); loc (T, Q, M, Lf, P, 2) f32; att (T, Q, M, Lf, P) f32;
//   grad_out (T, Q, M*D) -> grad_value (T, S, M, D) f32, zeroed by the caller;
//   grad_loc like loc; grad_att like att; adds (2) counters or null. A
//   location's gradient is the pixel gradient times the level size, times the
//   tap's weight.

// The value frame of frame slot j for the queries of frame t.
struct SlotFrame {
  FrameRule rule;
  int T;
  __device__ __forceinline__ int operator()(int j, int t) const {
    return j == 0 ? t : source_frame(rule, j - 1, t, T);
  }
};

template <typename scalar_t, int LPQ>
__global__ void __launch_bounds__(BWD_THREADS, 2) msda_temporal_bwd_win_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, const scalar_t* __restrict__ grad_out,
    float* __restrict__ grad_value, float* __restrict__ grad_loc, float* __restrict__ grad_att,
    unsigned long long* __restrict__ adds, int T, int Q, int S, int M, int D, int P,
    Pyramid pyr, FrameRule rule, BwdTiles tiles, BwdPlan plan, int groups, bool aligned,
    int vw) {
  msda_bwd_block<scalar_t, LPQ>(value, loc, att, grad_out, grad_value, grad_loc, grad_att, adds,
                                Q, S, M, D, P, (1 + rule.W) * pyr.L, pyr, SlotFrame{rule, T},
                                tiles, plan, groups, aligned, vw);
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

// Everything a K1 launch takes, passed through the (LPR, MODE) dispatch.
struct K1Launch {
  const void *value, *ref, *c_off, *t_off, *c_logit, *t_logit, *windows;
  void* out;
  int* reads;
  int T, Q, S, M, D, P, nqb;
  bool aligned;
  Pyramid pyr;
  FrameRule rule;
  StagePlan plan;
  size_t smem;
  cudaStream_t stream;
};

template <typename scalar_t, int LPR, int MODE>
static int launch_win(const K1Launch& a) {
  auto kernel = msda_temporal_proj_win_kernel<scalar_t, LPR, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.T * a.M * a.nqb, K1_THREADS, a.smem, a.stream>>>(
      (const scalar_t*)a.value, (const float*)a.ref, (const scalar_t*)a.c_off,
      (const scalar_t*)a.t_off, (const scalar_t*)a.c_logit, (const scalar_t*)a.t_logit,
      (const int*)a.windows, (scalar_t*)a.out, a.reads, a.T, a.Q, a.S, a.M, a.D, a.P, a.nqb,
      a.aligned, a.pyr, a.rule, a.plan);
  return (int)cudaGetLastError();
}

template <typename scalar_t, int LPR>
static int launch_win_mode(const K1Launch& a, int mode) {
  switch (mode) {
    case K1_FULL: return launch_win<scalar_t, LPR, K1_FULL>(a);
    case K1_NOSTAGE: return launch_win<scalar_t, LPR, K1_NOSTAGE>(a);
    case K1_NOLOC: return launch_win<scalar_t, LPR, K1_NOLOC>(a);
    case K1_NOGATHER: return launch_win<scalar_t, LPR, K1_NOGATHER>(a);
    case K1_NOACC: return launch_win<scalar_t, LPR, K1_NOACC>(a);
    case K1_COUNT: return launch_win<scalar_t, LPR, K1_COUNT>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// `caps` holds L staging capacities (rows); stage s = j * L + l uses buffer
// s % 2, so a buffer holds the largest capacity of its stages.
template <typename scalar_t>
static int launch_temporal_proj(void* value, void* ref, void* c_off, void* t_off, void* c_logit,
                                void* t_logit, void* windows, void* out, void* reads, int T,
                                int Q, int S, int M, int D, int P, const int* caps, int mode,
                                const int* levels, int L, int rule_all, const int* offsets,
                                int W, void* stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  const int groups = (D + VN - 1) / VN;  // 16-byte channel groups of a row
  K1Launch a{value, ref, c_off, t_off, c_logit, t_logit, windows, out, (int*)reads,
             T, Q, S, M, D, P, (Q + K1_QB - 1) / K1_QB,
             (D * (int)sizeof(scalar_t)) % 16 == 0 && (uintptr_t)value % 16 == 0 &&
                 (uintptr_t)out % 16 == 0,
             make_pyramid(levels, L), make_rule(rule_all, offsets, W), StagePlan{}, 0,
             (cudaStream_t)stream};
  const int Lf = (1 + W) * L;
  a.plan.rows[0] = a.plan.rows[1] = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) a.plan.cap[l] = l < L ? max(caps[l], 0) : 0;
  for (int s = 0; s < Lf; ++s) a.plan.rows[s & 1] = max(a.plan.rows[s & 1], a.plan.cap[s % L]);
  a.smem = K1_HEAD_BYTES + (size_t)K1_QB * P * K1_TAP_BYTES +
           (size_t)(a.plan.rows[0] + a.plan.rows[1]) * groups * VN * sizeof(scalar_t);
  if (a.smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  if (groups <= 1) return launch_win_mode<scalar_t, 1>(a, mode);
  if (groups <= 2) return launch_win_mode<scalar_t, 2>(a, mode);
  if (groups <= 4) return launch_win_mode<scalar_t, 4>(a, mode);
  if constexpr (VN == 4) return launch_win_mode<scalar_t, 8>(a, mode);
  return (int)cudaErrorInvalidValue;
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

template <typename scalar_t, int LPQ>
static int launch_temporal_bwd_win(const void* value, const void* loc, const void* att,
                                   const void* grad_out, void* grad_value, void* grad_loc,
                                   void* grad_att, void* adds, int T, int Q, int S, int M, int D,
                                   int P, const Pyramid& pyr, const FrameRule& rule,
                                   const BwdTiles& t, const BwdPlan& plan, int groups,
                                   size_t smem, cudaStream_t stream) {
  auto kernel = msda_temporal_bwd_win_kernel<scalar_t, LPQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (D * (int)sizeof(scalar_t)) % 16 == 0 && (uintptr_t)value % 16 == 0 &&
                       (uintptr_t)grad_out % 16 == 0;
  const int blocks = T * M * t.n_tiles * groups * ((D + plan.slice - 1) / plan.slice);
  kernel<<<blocks, BWD_THREADS, smem, stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (const scalar_t*)grad_out,
      (float*)grad_value, (float*)grad_loc, (float*)grad_att, (unsigned long long*)adds, T, Q,
      S, M, D, P, pyr, rule, t, plan, groups, aligned, bwd_flush_width(D, grad_value));
  return (int)cudaGetLastError();
}

// Raster blocks of `qb` queries; `lanes` a query and the plan come from the
// wrapper's `bwd_plan`; `groups` splits the stages over blocks.
template <typename scalar_t>
static int launch_temporal_bwd(void* value, void* loc, void* att, void* grad_out,
                               void* grad_value, void* grad_loc, void* grad_att, void* adds,
                               int T, int Q, int S, int M, int D, int P, int qb, int cap,
                               int slice, int pitch, int lanes, int groups, const int* levels,
                               int L, int rule_all, const int* offsets, int W, void* stream) {
  const Pyramid pyr = make_pyramid(levels, L);
  const FrameRule rule = make_rule(rule_all, offsets, W);
  BwdTiles t;
  BwdPlan plan;
  size_t smem;
  const int err = bwd_setup(Q, D, P, Vec16<scalar_t>::N, pyr, qb, 0, 0, 0, 0, cap, slice,
                            pitch, lanes, t, plan, smem);
  if (err) return err;
  if (W > MAX_WINDOW || groups < 1) return (int)cudaErrorInvalidValue;
#define K5_LAUNCH(N)                                                                         \
  return launch_temporal_bwd_win<scalar_t, N>(value, loc, att, grad_out, grad_value,         \
                                              grad_loc, grad_att, adds, T, Q, S, M, D, P, pyr, \
                                              rule, t, plan, groups, smem, (cudaStream_t)stream)
  switch (lanes) {
    case 1: K5_LAUNCH(1);
    case 2: K5_LAUNCH(2);
    case 4: K5_LAUNCH(4);
    case 8: K5_LAUNCH(8);
  }
#undef K5_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" {

int msda_temporal_proj_f32(void* value, void* ref, void* c_off, void* t_off, void* c_logit,
                           void* t_logit, void* windows, void* out, void* reads, int T, int Q,
                           int S, int M, int D, int P, const int* caps, int mode,
                           const int* levels, int L, int rule_all, const int* offsets, int W,
                           void* stream) {
  return launch_temporal_proj<float>(value, ref, c_off, t_off, c_logit, t_logit, windows, out,
                                     reads, T, Q, S, M, D, P, caps, mode, levels, L, rule_all,
                                     offsets, W, stream);
}

int msda_temporal_proj_bf16(void* value, void* ref, void* c_off, void* t_off, void* c_logit,
                            void* t_logit, void* windows, void* out, void* reads, int T, int Q,
                            int S, int M, int D, int P, const int* caps, int mode,
                            const int* levels, int L, int rule_all, const int* offsets, int W,
                            void* stream) {
  return launch_temporal_proj<__nv_bfloat16>(value, ref, c_off, t_off, c_logit, t_logit, windows,
                                             out, reads, T, Q, S, M, D, P, caps, mode, levels,
                                             L, rule_all, offsets, W, stream);
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
                          void* grad_loc, void* grad_att, void* adds, int T, int Q, int S, int M,
                          int D, int P, int qb, int cap, int slice, int pitch, int lanes,
                          int groups, const int* levels, int L, int rule_all, const int* offsets,
                          int W, void* stream) {
  return launch_temporal_bwd<float>(value, loc, att, grad_out, grad_value, grad_loc, grad_att,
                                    adds, T, Q, S, M, D, P, qb, cap, slice, pitch, lanes, groups,
                                    levels, L, rule_all, offsets, W, stream);
}

int msda_temporal_bwd_bf16(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                           void* grad_loc, void* grad_att, void* adds, int T, int Q, int S, int M,
                           int D, int P, int qb, int cap, int slice, int pitch, int lanes,
                           int groups, const int* levels, int L, int rule_all,
                           const int* offsets, int W, void* stream) {
  return launch_temporal_bwd<__nv_bfloat16>(value, loc, att, grad_out, grad_value, grad_loc,
                                            grad_att, adds, T, Q, S, M, D, P, qb, cap, slice,
                                            pitch, lanes, groups, levels, L, rule_all, offsets,
                                            W, stream);
}

}  // extern "C"
