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
//   K5 msda_temporal_bwd   <- _bwd_kernel_rows_temporal (backward of K1, K3).
//      From the output gradient: the gradient of the per-frame value, of the
//      locations and of the weights, with the taps rebuilt from loc and att.
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
// K2 (see its kernel below): blocks over (t, q-block, group of heads); each
// thread reads 16 bytes of offsets of a query at a time, neighbouring
// threads neighbouring bytes, and keeps its (head, stage)'s first and last
// rows in registers until one shared-memory reduction at the end.
//
// K3 (see its kernel below): one block per (t, q, m), its taps spread over
// the block's warps, a few lanes a tap (16 bytes of channels each), several
// taps' corner reads in flight a lane. The decoder's 60 queries are too few
// for windows to pay: what bounds it is the latency of its two dependent
// reads (location, then corners), not bytes.
//
// K5 (`bwd_run` in msda_bwd.cuh, shared with K7 and K9): the value gradient
// is a scatter, one add per (tap, corner, channel) onto the frame the rule
// names (the TPU kernel's one-hot fold of temporal slots onto frames is
// layout; here the slot's frame is addressed directly). Summed with f32
// atomics, its last bits would change from run to run; so the corners are
// sorted by value row and one warp sums each row in a fixed order, as the
// JAX kernel's W^T @ g has one owner per value tile: equal inputs give equal
// bits.

// Location arithmetic uses explicit round-to-nearest intrinsics (see
// msda_common.cuh): K1 and K2 then compute exactly the f32 values of the
// plain PyTorch versions, and a K2 window covers every K1 tap.

#include "msda_bwd.cuh"

// The offsets a window rule may hold. The `all` rule reads no offsets and
// takes any number of other frames (W = T - 1: 35 in a 36-frame clip).
#define MAX_WINDOW 16

struct FrameRule {
  int all;  // 1: every other frame; 0: offsets with edge reflection
  int W;
  int off[MAX_WINDOW];
};

// A rule the kernels can take: W >= 0, and at most MAX_WINDOW offsets where
// they are read.
static inline bool rule_ok(int rule_all, int W) {
  return W >= 0 && (rule_all || W <= MAX_WINDOW);
}

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
// K1's stages (1 + W) * L, whatever the split between W and L: the header
// holds three ints a stage (272 stages: 36 frames at one level, 6 at four)
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
// K2: tap windows. out (T, M, nqb, (1+W)*L, 2) int32 holds, per (t, m,
// q-block of `qblk` queries, stage = frame slot x level), the first and last
// raster row (within the level) touched by a live tap, or (0, -1) where no
// tap of the block is live.
//
// One block per (t, q-block, group of G heads; the wrapper's
// `tap_window_plan`: all M heads at the clip's shapes). The block reads its
// offsets as memory lays them out: per query, the G heads' offsets are one
// contiguous piece of G*L*P (x, y) pairs in c_off and one of G*W*L*P pairs
// in t_off, together `vq` loads of VP pairs (16 bytes where the pieces are
// 16-byte aligned and P is a multiple of the pairs in 16 bytes, else one
// pair). Thread i takes load pos = i % span of the queries i / span,
// i / span + qpp, ...: neighbouring threads read neighbouring 16 bytes,
// K2_UNROLL loads in flight a thread, kept raw in registers until used. A
// load's pairs are of one (head, stage) for all the thread's queries, so the
// thread keeps its running first and last rows in registers and adds them
// to the block's once, at the end, with one shared atomicMin / atomicMax.
// The block's references are staged in shared memory first, once for its G
// heads. What bounds it: the bytes of the offsets (each read once) and about
// 30 instructions of f32 location and integer row arithmetic a tap, which
// take about as long as the bytes at the clip's shapes and overlap them only
// in part.
#define K2_MAX_THREADS 512  // the wrapper's `tap_window_plan` reads this
#define K2_UNROLL 4         // loads in flight a thread (8 and 16 were slower: registers)

// VP (x, y) offset pairs as they are loaded: 16 bytes kept raw in registers
// (half the registers of their floats) where VP pairs are 16 bytes, else the
// floats, element by element.
template <typename scalar_t, int VP, bool VEC = 2 * VP == Vec16<scalar_t>::N>
struct OffsetPairs {
  float v[2 * VP];
  __device__ __forceinline__ void load(const scalar_t* __restrict__ p) {
#pragma unroll
    for (int i = 0; i < 2 * VP; ++i) v[i] = to_f(p[i]);
  }
  __device__ __forceinline__ void floats(float* xy) const {
#pragma unroll
    for (int i = 0; i < 2 * VP; ++i) xy[i] = v[i];
  }
};
template <typename scalar_t, int VP>
struct OffsetPairs<scalar_t, VP, true> {
  uint4 raw;
  __device__ __forceinline__ void load(const scalar_t* __restrict__ p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void floats(float* xy) const { Vec16<scalar_t>::unpack(raw, xy); }
};

// floor(v) for |v| < 2^22, exact: v + 1.5 * 2^23 rounded down holds floor(v)
// in its low mantissa bits (an add, where a float-to-int conversion runs at a
// sixteenth of the FP32 rate).
__device__ __forceinline__ int floor_small(float v) {
  return __float_as_int(__fadd_rd(v, 12582912.f)) - 0x4B400000;
}

// The VP pairs of a load share one (head, stage): VP divides P (the
// wrapper takes one pair a load where it does not), so a thread keeps one
// level, one reference and one running first and last row.
template <typename scalar_t, int VP>
__global__ void __launch_bounds__(K2_MAX_THREADS, 2) msda_tap_window_kernel(
    const float* __restrict__ ref, const scalar_t* __restrict__ c_off,
    const scalar_t* __restrict__ t_off, int* __restrict__ out, int T, int Q, int M, int P,
    int qblk, int G, int nqb, Pyramid pyr, int W) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int L = pyr.L, Lf = (1 + W) * L, LP = L * P;
  const int ng = M / G;
  const int g = blockIdx.x % ng, tqb = blockIdx.x / ng;
  const int qb = tqb % nqb, t = tqb / nqb;
  const int q0 = qb * qblk, nq = min(qblk, Q - q0);
  float* s_ref = reinterpret_cast<float*>(k2_smem);               // [qblk][L][2]
  int* s_mn = reinterpret_cast<int*>(s_ref + (size_t)qblk * L * 2);  // [G][Lf]
  int* s_mx = s_mn + G * Lf;
  const size_t tq0 = (size_t)t * Q + q0;
  for (int i = threadIdx.x; i < nq * L * 2; i += blockDim.x) s_ref[i] = ref[tq0 * L * 2 + i];
  for (int i = threadIdx.x; i < G * Lf; i += blockDim.x) {
    s_mn[i] = INT_MAX;
    s_mx[i] = -1;
  }
  __syncthreads();

  const int nc = G * LP;                  // pairs of a query's current piece
  const int vq = (1 + W) * nc / VP;       // loads a query
  const int span = min(vq, (int)blockDim.x), qpp = blockDim.x / span;
  // one pass over the queries unless a query's loads outnumber the threads
  for (int p0 = 0; p0 < vq; p0 += span) {
    const int pos = p0 + threadIdx.x % span, ql0 = threadIdx.x / span;
    if (pos >= vq || ql0 >= qpp) continue;
    // the load's array, first element, key (head, stage), level and
    // reference level (the temporal reference is level 0's)
    int e = pos * VP, gm, st, l, lref;
    const bool cur = e < nc;
    const scalar_t* src = cur ? c_off + (tq0 * M + (size_t)g * G) * LP * 2 + (size_t)e * 2
                              : t_off + (tq0 * M + (size_t)g * G) * W * LP * 2 +
                                    (size_t)(e - nc) * 2;
    const size_t stride = (size_t)M * (cur ? 1 : W) * LP * 2;
    if (cur) {
      gm = e / LP;
      l = (e - gm * LP) / P;
      st = lref = l;
    } else {
      e -= nc;
      gm = e / (W * LP);
      const int r = e - gm * W * LP, jj = r / LP;
      l = (r - jj * LP) / P;
      st = (1 + jj) * L + l;
      lref = 0;
    }
    const int h = pyr.h[l], w = pyr.w[l];
    const float iw = pyr.inv_w[l], ih = pyr.inv_h[l];
    int mn = INT_MAX, mx = -1;
    for (int ql = ql0; ql < nq; ql += K2_UNROLL * qpp) {
      OffsetPairs<scalar_t, VP> in[K2_UNROLL];
#pragma unroll
      for (int u = 0; u < K2_UNROLL; ++u) {
        const int qq = ql + u * qpp;
        if (qq < nq) in[u].load(src + (size_t)qq * stride);
      }
#pragma unroll
      for (int u = 0; u < K2_UNROLL; ++u) {
        const int qq = ql + u * qpp;
        if (qq >= nq) break;
        float xy[2 * VP];
        in[u].floats(xy);
        const float rx = s_ref[(qq * L + lref) * 2], ry = s_ref[(qq * L + lref) * 2 + 1];
#pragma unroll
        for (int s = 0; s < VP; ++s) {
          const float x = tap_px(tap_loc(rx, xy[2 * s], iw), w);
          const float y = tap_px(tap_loc(ry, xy[2 * s + 1], ih), h);
          if (!in_window(h, w, x, y)) continue;
          const int x0 = floor_small(x), y0 = floor_small(y);
          mn = min(mn, max(y0, 0) * w + max(x0, 0));
          mx = max(mx, min(y0 + 1, h - 1) * w + min(x0 + 1, w - 1));
        }
      }
    }
    if (mx >= 0) {
      atomicMin(&s_mn[gm * Lf + st], mn);
      atomicMax(&s_mx[gm * Lf + st], mx);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Lf; i += blockDim.x) {
    const int gm = i / Lf, s = i - gm * Lf;
    int* o = out + ((((size_t)t * M + g * G + gm) * nqb + qb) * Lf + s) * 2;
    const int hi = s_mx[i];
    o[0] = hi >= 0 ? s_mn[i] : 0;
    o[1] = hi;
  }
}

// ---------------------------------------------------------------------------
// K3: decoder temporal attention from precomputed locations and weights.
//   value (T, S, M, D); loc (T, Q, M, Lf, P, 2) f32; att (T, Q, M, Lf, P) f32
//   -> out (T, Q, M*D). Level lvl = j * L + l reads frame slot j.
//
// One block of K3_WARPS warps per (t, q, m): the decoder has few queries
// (60 a clip: 480 blocks at M = 8), and one warp walking a (t, q, m)'s 96
// taps one after another waited a memory round trip a tap. Here the taps are
// spread over the block: `lpt` lanes a tap (the least power of two whose
// 16-byte chunks hold D channels: 4 for bf16 at D = 32), 32 / lpt taps a
// warp at a time, neighbouring lanes on neighbouring taps so loc and att are
// read coalesced. A lane first loads the locations and weights of K3_UNROLL
// taps, then their 4 K3_UNROLL corner chunks, all in flight together, then
// accumulates in f32. The lanes of a channel chunk are summed with shuffles,
// the warps through shared memory, and one thread a channel stores it. The
// CPU tests' mirror of this loop reads the two defines below.
#define K3_WARPS 4
#define K3_UNROLL 4

// 16 bytes of channels c0... of a value row, zeros past D (n = D - c0) or
// where the corner lies outside the level (ok false).
template <typename scalar_t>
__device__ __forceinline__ uint4 load_chunk(const scalar_t* __restrict__ p, int n, bool ok,
                                            bool aligned) {
  constexpr int VN = Vec16<scalar_t>::N;
  if (!ok || n <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));
  alignas(16) scalar_t e[VN];
#pragma unroll
  for (int v = 0; v < VN; ++v) e[v] = v < n ? p[v] : from_f<scalar_t>(0.f);
  return *reinterpret_cast<const uint4*>(e);
}

template <typename scalar_t>
__global__ void __launch_bounds__(K3_WARPS * 32) msda_temporal_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, scalar_t* __restrict__ out, int T, int Q, int S, int M, int D,
    int P, int lpt, bool aligned, Pyramid pyr, FrameRule rule) {
  using V = Vec16<scalar_t>;
  constexpr int VN = V::N;
  __shared__ float s_red[K3_WARPS][32];  // per warp its sum a channel
  const long item = blockIdx.x;          // (t * Q + q) * M + m
  const int m = (int)(item % M), t = (int)(item / M / Q);
  const int L = pyr.L, ntap = (1 + rule.W) * L * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpw = 32 / lpt, grp = lane / lpt, c0 = (lane % lpt) * VN;
  const int step = K3_WARPS * tpw;  // taps the block takes at a time
  const float2* lc = reinterpret_cast<const float2*>(loc) + item * ntap;
  const float* at = att + item * ntap;
  const size_t row = (size_t)M * D;
  const scalar_t* vm = value + (size_t)m * D + c0;
  float acc[VN];
#pragma unroll
  for (int v = 0; v < VN; ++v) acc[v] = 0.f;

  for (int k0 = warp * tpw + grp; k0 < ntap; k0 += K3_UNROLL * step) {
    float2 xy[K3_UNROLL];
    float a[K3_UNROLL];
#pragma unroll
    for (int u = 0; u < K3_UNROLL; ++u) {
      const int k = k0 + u * step;
      xy[u] = k < ntap ? lc[k] : make_float2(-4.f, -4.f);  // outside every level
      a[u] = k < ntap ? at[k] : 0.f;
    }
    uint4 raw[K3_UNROLL][4];
    float wt[K3_UNROLL][4];
#pragma unroll
    for (int u = 0; u < K3_UNROLL; ++u) {
      const int k = min(k0 + u * step, ntap - 1);
      const int s = k / P, j = s / L, l = s - j * L, h = pyr.h[l], w = pyr.w[l];
      const int f = j == 0 ? t : source_frame(rule, j - 1, t, T);
      int x0 = 0, y0 = 0;
      float dx = 0.f, dy = 0.f;
      const bool live = tap_geometry(h, w, xy[u].x, xy[u].y, x0, y0, dx, dy);
      const scalar_t* vl = vm + ((size_t)f * S + pyr.start[l]) * row;
      const bool yin[2] = {live && y0 >= 0, live && y0 + 1 < h};
      const bool xin[2] = {x0 >= 0, x0 + 1 < w};
      wt[u][0] = (1.f - dy) * (1.f - dx);
      wt[u][1] = (1.f - dy) * dx;
      wt[u][2] = dy * (1.f - dx);
      wt[u][3] = dy * dx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cy = c >> 1, cx = c & 1;
        const bool ok = yin[cy] && xin[cx];
        // a corner outside the level is not read (its row index may be -1)
        raw[u][c] = load_chunk(vl + ((long)(y0 + cy) * w + x0 + cx) * (long)row, D - c0, ok,
                               aligned);
      }
    }
#pragma unroll
    for (int u = 0; u < K3_UNROLL; ++u) {
      float tap[VN], vals[VN];
#pragma unroll
      for (int v = 0; v < VN; ++v) tap[v] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        V::unpack(raw[u][c], vals);
#pragma unroll
        for (int v = 0; v < VN; ++v) tap[v] += wt[u][c] * vals[v];
      }
#pragma unroll
      for (int v = 0; v < VN; ++v) acc[v] += a[u] * tap[v];
    }
  }
  for (int o = lpt; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < VN; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  if (grp == 0)
#pragma unroll
    for (int v = 0; v < VN; ++v)
      if (c0 + v < D) s_red[warp][c0 + v] = acc[v];
  __syncthreads();
  if (threadIdx.x < D) {
    float sum = 0.f;
    for (int i = 0; i < K3_WARPS; ++i) sum += s_red[i][threadIdx.x];
    out[item * D + threadIdx.x] = from_f<scalar_t>(sum);
  }
}

// ---------------------------------------------------------------------------
// K5: backward of K1 and K3 from precomputed locations and weights
// (msda_bwd.cuh).
//   value (T, S, M, D); loc (T, Q, M, Lf, P, 2) f32; att (T, Q, M, Lf, P) f32;
//   grad_out (T, Q, M*D) -> grad_value (T, S, M, D) in the value's type;
//   grad_loc like loc; grad_att like att. A location's gradient is the pixel
//   gradient times the level size, times the tap's weight.

// The value frame of frame slot j for the queries of frame t.
struct SlotFrame {
  FrameRule rule;
  int T;
  __device__ __forceinline__ int operator()(int j, int t) const {
    return j == 0 ? t : source_frame(rule, j - 1, t, T);
  }
};

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
  if (!rule_ok(rule_all, W) || Lf > K1_MAX_LF) return (int)cudaErrorInvalidValue;
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

// `G` heads a block, `threads` a block and `vp` pairs a load come from the
// wrapper's `tap_window_plan`; vp > 1 only where every load is 16 bytes,
// 16-byte aligned and of one (head, stage): a misaligned vector load would
// be a fault the context does not survive, so it is refused here.
template <typename scalar_t>
static int launch_tap_window(void* ref, void* c_off, void* t_off, void* out, int T, int Q, int M,
                             int P, int q_block, int G, int threads, int vp, const int* levels,
                             int L, int W, void* stream) {
  constexpr int VP16 = Vec16<scalar_t>::N / 2;
  if (G < 1 || M % G || threads < 32 || threads > K2_MAX_THREADS || threads % 32 ||
      q_block < 1 || (vp != 1 && (vp != VP16 || P % vp)) || W < 0 ||
      (1 + W) * L > K1_MAX_LF)  // the windows of K1's stages
    return (int)cudaErrorInvalidValue;
  if (vp > 1 && ((uintptr_t)c_off % 16 || (W > 0 && (uintptr_t)t_off % 16)))
    return (int)cudaErrorInvalidValue;
  const int nqb = (Q + q_block - 1) / q_block, Lf = (1 + W) * L;
  const size_t smem = ((size_t)q_block * L * 2 + 2 * (size_t)G * Lf) * 4;
  auto kernel =
      vp == 1 ? msda_tap_window_kernel<scalar_t, 1> : msda_tap_window_kernel<scalar_t, VP16>;
  if (smem > 48 * 1024) {
    if (smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<T * nqb * (M / G), threads, smem, (cudaStream_t)stream>>>(
      (const float*)ref, (const scalar_t*)c_off, (const scalar_t*)t_off, (int*)out, T, Q, M, P,
      q_block, G, nqb, make_pyramid(levels, L), W);
  return (int)cudaGetLastError();
}

template <typename scalar_t>
static int launch_temporal(void* value, void* loc, void* att, void* out, int T, int Q, int S,
                           int M, int D, int P, const int* levels, int L, int rule_all,
                           const int* offsets, int W, void* stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  if (D < 1 || D > 32 || !rule_ok(rule_all, W)) return (int)cudaErrorInvalidValue;
  int lpt = 1;  // lanes a tap
  while (lpt * VN < D) lpt <<= 1;
  const bool aligned = (D * (int)sizeof(scalar_t)) % 16 == 0 && (uintptr_t)value % 16 == 0;
  msda_temporal_kernel<scalar_t><<<T * Q * M, K3_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (scalar_t*)out, T, Q, S, M,
      D, P, lpt, aligned, make_pyramid(levels, L), make_rule(rule_all, offsets, W));
  return (int)cudaGetLastError();
}

// `lanes`, `per` and `vec` (the gather's split of D) come from the wrapper's
// `taps_plan`; scratch as `BwdScratch` says, with wts and dots of 4 floats a
// tap.
template <typename scalar_t>
static int launch_temporal_bwd(void* value, void* loc, void* att, void* grad_out,
                               void* grad_value, void* grad_loc, void* grad_att, void* keys0,
                               void* keys1, void* vals0, void* vals1, void* wts, void* dots,
                               void* begin, void* end, void* hist, void* sums, void* top, int T,
                               int Q, int S, int M, int D, int P, int lanes, int per, int vec,
                               int gpr, const int* levels, int L, int rule_all,
                               const int* offsets, int W, void* stream) {
  if (L < 1 || L > MAX_LEVELS || !rule_ok(rule_all, W)) return (int)cudaErrorInvalidValue;
  const BwdScratch s{{(unsigned*)keys0, (unsigned*)keys1}, {(unsigned*)vals0, (unsigned*)vals1},
                     (int*)begin, (int*)end, (int*)hist, (int*)sums, (int*)top};
  return bwd_run<k5_bwd, scalar_t>(
      value, (const float*)loc, (const float*)att, grad_out, grad_value, (float*)grad_loc,
      (float*)grad_att, (float*)wts, (float*)dots, s, T, T, Q, S, M, D, (1 + W) * L, P, lanes,
      per, vec, gpr, make_pyramid(levels, L), SlotFrame{make_rule(rule_all, offsets, W), T},
      (cudaStream_t)stream);
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
                        int P, int q_block, int G, int threads, int vp, const int* levels, int L,
                        int W, void* stream) {
  return launch_tap_window<float>(ref, c_off, t_off, out, T, Q, M, P, q_block, G, threads, vp,
                                  levels, L, W, stream);
}

int msda_tap_window_bf16(void* ref, void* c_off, void* t_off, void* out, int T, int Q, int M,
                         int P, int q_block, int G, int threads, int vp, const int* levels,
                         int L, int W, void* stream) {
  return launch_tap_window<__nv_bfloat16>(ref, c_off, t_off, out, T, Q, M, P, q_block, G,
                                          threads, vp, levels, L, W, stream);
}

int msda_temporal_f32(void* value, void* loc, void* att, void* out, int T, int Q, int S, int M,
                      int D, int P, const int* levels, int L, int rule_all, const int* offsets,
                      int W, void* stream) {
  return launch_temporal<float>(value, loc, att, out, T, Q, S, M, D, P, levels, L, rule_all,
                                offsets, W, stream);
}

int msda_temporal_bf16(void* value, void* loc, void* att, void* out, int T, int Q, int S, int M,
                       int D, int P, const int* levels, int L, int rule_all, const int* offsets,
                       int W, void* stream) {
  return launch_temporal<__nv_bfloat16>(value, loc, att, out, T, Q, S, M, D, P, levels, L,
                                        rule_all, offsets, W, stream);
}

int msda_temporal_bwd_f32(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                          void* grad_loc, void* grad_att, void* keys0, void* keys1, void* vals0,
                          void* vals1, void* wts, void* dots, void* begin, void* end, void* hist,
                          void* sums, void* top, int T, int Q, int S, int M, int D, int P,
                          int lanes, int per, int vec, int gpr, const int* levels, int L,
                          int rule_all, const int* offsets, int W, void* stream) {
  return launch_temporal_bwd<float>(
      value, loc, att, grad_out, grad_value, grad_loc, grad_att, keys0, keys1, vals0, vals1, wts,
      dots, begin, end, hist, sums, top, T, Q, S, M, D, P, lanes, per, vec, gpr, levels, L,
      rule_all, offsets, W, stream);
}

int msda_temporal_bwd_bf16(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                           void* grad_loc, void* grad_att, void* keys0, void* keys1, void* vals0,
                           void* vals1, void* wts, void* dots, void* begin, void* end, void* hist,
                           void* sums, void* top, int T, int Q, int S, int M, int D, int P,
                           int lanes, int per, int vec, int gpr, const int* levels, int L,
                           int rule_all, const int* offsets, int W, void* stream) {
  return launch_temporal_bwd<__nv_bfloat16>(
      value, loc, att, grad_out, grad_value, grad_loc, grad_att, keys0, keys1, vals0, vals1, wts,
      dots, begin, end, hist, sums, top, T, Q, S, M, D, P, lanes, per, vec, gpr, levels, L,
      rule_all, offsets, W, stream);
}

}  // extern "C"
