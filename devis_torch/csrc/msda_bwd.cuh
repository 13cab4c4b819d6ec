// The backward of deformable attention in a fixed order (K5, K7 and K9):
// the value gradient as a transpose and a gather, and each entry's dot,
// from which the weight and location gradients follow. Shared by
// ms_deform_attn.cu (K5), ms_deform_attn_rows.cu (K7) and
// ms_deform_attn_taps.cu (K9).
//
// The JAX kernels (`_bwd_kernel_rows_temporal`, `_bwd_kernel_rows`,
// `_bwd_kernel` in devis_tpu/ops/ms_deform_attn_pallas.py) compute the value
// gradient per value tile as W^T @ g, summed over the query tiles in grid
// order: each value row has one owner, which sums in one order, and the
// result is the same on every run. Blocks on the card run in no order, so a
// scatter of f32 atomics onto the value gradient would give other last bits
// on every run. Here every sum has an order that the inputs and the launch
// geometry fix, and every product and sum of the gather and the tap
// gradients is rounded on its own (no contraction into FMAs), so that the
// CPU mirror gives the same bits. The order: each value row takes its
// entries in entry order, group j of its `gpr` lane groups the j-th, j +
// gpr-th, ... of them.
//   1. Entries. Entry e = 4 * tap' + c is corner c of a tap, the taps of
//      one (head m, stage s, query frame n) together: the run R = (m * Lx +
//      s) * N + n, Q * P * 4 entries. An entry holds its key and its weight
//      a * bilinear weight; a corner outside its level has no dot (step 4
//      takes 0 for it). The global route's entries kernel writes
//      keys and weights, a thread a tap (K9's come given (idx, wt), a thread
//      an entry writes its key): the value row, or for the run-wise route
//      the corner's pixel in its level. (Computing them inside the run-wise
//      sort's first pass instead, from loc and att read in run order, was
//      slower on the H100 than the two kernels.)
//   2. The sort, two routes with the same result (the wrapper's
//      `bwd_route`, a rule by size):
//      - global (K9; K5 at the decoder's 10 queries; K7 at the image
//        encoder's 64 runs): the key is the value row; a stable LSD radix
//        sort of the entry indices, digits of at most 8 bits, per pass a
//        histogram per tile of BWD_TILE entries, one scan, a scatter of each
//        tile sorted in shared memory; then each row's segment [begin, end).
//        It moves about 16 bytes an entry a pass, 2 to 4 passes.
//      - run-wise (K5 and K7 elsewhere): the key is the corner's pixel in
//        its level, all a run's keys being one level of one value frame of
//        one head. Each run is sorted stably on the pixel alone, within its
//        own range of positions, a block a run and its warps over
//        contiguous parts of it (`run_sort_kernel`): in one pass where it
//        holds at most about RUN_BUCKET entries; else first split into
//        buckets of 2^lb pixels, about RUN_BUCKET entries each, then each
//        bucket placed by its low bits in a block of its own, staged in
//        shared memory. The placement gives each (run, pixel) its segment
//        in the offs table. It moves about 36 bytes an entry, one read of
//        the keys more than a radix pass, in two passes whatever the key's
//        bits; what bounds it is the latency of each warp's serial
//        placement and its scattered 8-byte writes (a warp's part of a run
//        is placed 32 entries at a time, in order).
//      Both routes give a row the same entries in the same order: the global
//      sort is stable, so a row's entries come out in entry order; runs are
//      ranges of entries, so that order is the row's segments of the runs
//      that read its frame (j, n with frames(j, n) = f), laid end to end in
//      run order.
//   3. Gather. A value row takes `gpr` groups of `lanes` lanes (a warp
//      32 / (lanes * gpr) rows; gpr from the mean entries a row), lane c of
//      a group owning chunk c (16 bytes, or one channel) of the D channels,
//      PER chunks a lane. Group j takes the row's entries j, j + gpr, ...
//      in order: w * g summed in registers, and g . row (summed over the
//      group's lanes by a fixed butterfly) stored as the entry's dot. A
//      fixed butterfly adds the groups' sums; group 0 stores the row once,
//      in the value's type (zeros where no entry falls). The run-wise
//      gather walks a row's runs in run order (their starts and running
//      lengths staged in shared memory; K7 reads one run a row) and reads
//      (entry, weight) pairs in sorted order; a block takes neighbouring
//      pixels of one head, which share rows of g. It is bound by the L2
//      traffic of a g row and a dot write a corner.
//   4. (K5, K7) One thread per tap sums its four dots into the weight and
//      location gradients.
// Equal inputs give equal bits; the sums' order differs from the plain
// versions', so the two agree to rounding. `msda_bwd_mirror` and
// `msda_taps_bwd_mirror` in ops/ms_deform_attn_cuda.py repeat these steps on
// the CPU (`taps_plan` is the gather's split of the channels;
// `_run_sort_mirror` and `run_walk_mirror` the run-wise route).
#pragma once

#include "msda_common.cuh"

#define BWD_THREADS 256      // threads of every kernel here but the top scan
#define BWD_TILE 4096        // entries a block of the sort (16 rounds of 256)
#define BWD_SCAN_TILE 4096   // ints a block of the scan (16 a thread)
#define BWD_SCAN_TOP 16384   // tile totals the one-block top scan takes (1024 x 16)
#define BWD_MAX_PER 4        // chunks of a row a lane of the gather may own
#define BWD_UNROLL 4         // entries a lane group of the gather loads before it sums
#define BWD_FULL 0xffffffffu
#define RUN_BINS 4096        // bins of one pass of the run-wise sort (a level's pixels, or a part)
#define RUN_SMEM_INTS 16384  // per-warp counters a block of the run-wise sort keeps (64 KB)
#define RUN_MAX_WARPS 16     // warps a block of the one-pass sort
#define RUN_HIGH_WARPS 16    // warps a block of the first of two passes
#define RUN_LOW_WARPS 8      // warps a block of the second
#define RUN_BUCKET 4096      // entries a bucket of a two-pass sort holds, at most on average
#define RUN_CACHE 4096       // entries of a bucket the second pass stages in shared memory
#define RUN_UNROLL 8         // entries a lane of the run-wise sort loads before it places any
#define RUN_DEAD 0xffffffffu // the local key of a corner outside its level
#define RUN_MIN_RUNS 264     // runs the wrapper asks for before it takes the run-wise route
                             // (two blocks of the first pass an SM of an H100's 132)

// The op a launch belongs to, a template argument of every kernel here: a
// profile then tells K5's, K7's and K9's kernels apart by name.
struct k5_bwd {};
struct k7_bwd {};
struct k9_bwd {};

static inline long bwd_blocks(long n, int threads) { return (n + threads - 1) / threads; }

// Step 1 for K5 and K7. loc (N, Q, M, Lx, P, 2), att (N, Q, M, Lx, P), tap
// t = (((n * Q + q) * M + m) * Lx + s) * P + p; stage s = j * L + l reads
// value frame frames(j, n). Keys index value rows (F, S, M), or with LOCAL
// (the run-wise route) the corner's pixel in its level, RUN_DEAD where
// n_rows would stand. A tap's entries lie at 4 * t' + c, t' = ((m * Lx +
// s) * NQ + n * Q + q) * P + p: the entries of one (head m, stage s, query
// frame n) lie together, a run of Q * P * 4, so that the gather's reads of
// weights and writes of dots for neighbouring value rows stay within a few
// megabytes (L2), wherever the value rows' queries lie.
template <typename Op, bool LOCAL, typename Frames>
__global__ void __launch_bounds__(BWD_THREADS) bwd_entries_kernel(
    const float* __restrict__ loc, const float* __restrict__ att, unsigned* __restrict__ keys,
    float* __restrict__ wts, long n_taps, int Q, int M, int Lx, int P, int S, unsigned n_rows,
    Pyramid pyr, Frames frames) {
  // 32-bit index arithmetic: the launcher holds 4 * n_taps below 2^31
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)n_taps) return;
  const unsigned tq = t / (unsigned)P, s = tq % (unsigned)Lx, nqm = tq / (unsigned)Lx;
  const unsigned m = nqm % (unsigned)M, nq = nqm / (unsigned)M, n = nq / (unsigned)Q;
  const unsigned NQ = (unsigned)n_taps / ((unsigned)P * Lx * M);
  const unsigned tp = ((m * Lx + s) * NQ + nq) * P + (t - tq * P);
  const int l = (int)s % pyr.L, h = pyr.h[l], w = pyr.w[l];
  const float a = att[t];
  const float2 lxy = reinterpret_cast<const float2*>(loc)[t];
  int x0, y0;
  float dx, dy;
  const bool live = tap_geometry(h, w, lxy.x, lxy.y, x0, y0, dx, dy);
  const long base = LOCAL ? 0 : (long)frames((int)s / pyr.L, (int)n) * S + pyr.start[l];
  unsigned k[4];
  float wt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yi = y0 + (c >> 1), xi = x0 + (c & 1);
    const bool in = live && yi >= 0 && yi < h && xi >= 0 && xi < w;
    k[c] = LOCAL ? (in ? (unsigned)(yi * w + xi) : RUN_DEAD)
                 : (in ? (unsigned)((base + (long)yi * w + xi) * M + m) : n_rows);
    wt[c] = in ? a * corner_weight(c, dx, dy) : 0.f;
  }
  // the caller's buffers are 16-byte aligned: a tap's four entries in one store each
  reinterpret_cast<uint4*>(keys)[tp] = make_uint4(k[0], k[1], k[2], k[3]);
  reinterpret_cast<float4*>(wts)[tp] = make_float4(wt[0], wt[1], wt[2], wt[3]);
}

// Step 4 for K5 and K7: the weight and location gradients of each tap from
// its corners' dots (0 for a corner outside its level, whose dot no step
// writes; a dead tap's gradients are 0).
template <typename Op>
__global__ void __launch_bounds__(BWD_THREADS) bwd_tap_grads_kernel(
    const float* __restrict__ loc, const float* __restrict__ att, const float* __restrict__ dots,
    float* __restrict__ grad_loc, float* __restrict__ grad_att, long n_taps, int M, int Lx,
    int P, Pyramid pyr) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)n_taps) return;
  const unsigned tq = t / (unsigned)P, s = tq % (unsigned)Lx, nqm = tq / (unsigned)Lx;
  const unsigned NQ = (unsigned)n_taps / ((unsigned)P * Lx * M);
  const unsigned tp = ((nqm % (unsigned)M * Lx + s) * NQ + nqm / (unsigned)M) * P + (t - tq * P);
  const int l = (int)s % pyr.L, h = pyr.h[l], w = pyr.w[l];
  int x0, y0;
  float dx, dy, ga = 0.f, gx = 0.f, gy = 0.f;
  if (tap_geometry(h, w, loc[2 * t], loc[2 * t + 1], x0, y0, dx, dy)) {
    float tx = 0.f, ty = 0.f, tz = 0.f;
    const float4 d4 = reinterpret_cast<const float4*>(dots)[tp];
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yi = y0 + (c >> 1), xi = x0 + (c & 1);
      const float gv = yi >= 0 && yi < h && xi >= 0 && xi < w ? dv[c] : 0.f;
      const float wy = (c >> 1) ? dy : 1.f - dy, wx = (c & 1) ? dx : 1.f - dx;
      tx = __fadd_rn(tx, __fmul_rn(__fmul_rn(wy, wx), gv));
      ty = __fadd_rn(ty, __fmul_rn((c & 1) ? wy : -wy, gv));
      tz = __fadd_rn(tz, __fmul_rn((c >> 1) ? wx : -wx, gv));
    }
    const float a = att[t];
    ga = tx;
    gx = __fmul_rn(__fmul_rn(a, ty), (float)w);
    gy = __fmul_rn(__fmul_rn(a, tz), (float)h);
  }
  grad_att[t] = ga;
  grad_loc[2 * t] = gx;
  grad_loc[2 * t + 1] = gy;
}

// Step 1 for K9: idx (B, MG, Q, L, K4) level-local raster indices, entry
// e = (((b * MG + mg) * Q + q) * L + l) * K4 + k; value head m = mg / G.
// An index outside its level gets key n_rows and grad_wt 0.
template <typename Op>
__global__ void __launch_bounds__(BWD_THREADS) taps_entries_kernel(
    const int* __restrict__ idx, unsigned* __restrict__ keys, float* __restrict__ dots,
    long n_entries, int Q, int MG, int G, int K4, int S, unsigned n_rows, Pyramid pyr) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int l = (int)(e / K4 % pyr.L);
  const long item = e / ((long)K4 * pyr.L);
  const int mg = (int)(item / Q % MG);
  const long b = item / Q / MG;
  const int i = idx[e];
  const bool in = i >= 0 && i < pyr.h[l] * pyr.w[l];
  keys[e] = in ? (unsigned)((b * S + pyr.start[l] + i) * (MG / G) + mg / G) : n_rows;
  if (!in) dots[e] = 0.f;
}

// Step 2, the global route, one pass: tile histogram of the digit (key >> shift) & (bins - 1),
// stored digit-major: hist[d * n_tiles + tile].
template <typename Op>
__global__ void __launch_bounds__(BWD_THREADS) radix_hist_kernel(
    const unsigned* __restrict__ keys, long n, int shift, int bins, int* __restrict__ hist,
    int n_tiles) {
  __shared__ int s_h[256];
  s_h[threadIdx.x] = 0;
  __syncthreads();
  const long start = (long)blockIdx.x * BWD_TILE, stop = min(n, start + BWD_TILE);
  for (long i = start + threadIdx.x; i < stop; i += BWD_THREADS)
    atomicAdd(s_h + ((keys[i] >> shift) & (bins - 1)), 1);
  __syncthreads();
  if ((int)threadIdx.x < bins) hist[(long)threadIdx.x * n_tiles + blockIdx.x] = s_h[threadIdx.x];
}

// The exclusive prefix of `local` over the block's threads in thread order,
// and the block's total. Ends with a barrier.
__device__ __forceinline__ int block_exclusive(int local, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(BWD_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int k = 0; k < nw; ++k) {
    const int v = s_warp[k];
    before += k < wp ? v : 0;
    total += v;
  }
  __syncthreads();
  return before + x - local;
}

// In-place exclusive scan of each tile of 16 * blockDim.x ints of data[0, n);
// the tile's total to sums[tile].
template <typename Op>
__global__ void scan_tiles_kernel(int* __restrict__ data, long n, int* __restrict__ sums) {
  __shared__ int s_warp[32];
  const long base = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 16;
  int v[16], local = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    v[k] = base + k < n ? data[base + k] : 0;
    local += v[k];
  }
  int total;
  int run = block_exclusive(local, s_warp, total);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (base + k < n) data[base + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

template <typename Op>
__global__ void __launch_bounds__(BWD_THREADS) scan_add_kernel(int* __restrict__ data, long n,
                                                                const int* __restrict__ sums) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) data[i] += sums[i / BWD_SCAN_TILE];
}

// Step 2, the global route, one pass: tile `blockIdx.x` places its entries, in entry order,
// at offs[d * n_tiles + tile] + their rank among the tile's entries of digit
// d. The tile is first sorted in shared memory (rounds of 256: a rank
// within the warp by __match_any_sync, a prefix over the warps' counts),
// then written out in that order, so that each digit's run of the tile goes
// to consecutive addresses. FIRST: the values are the entry indices.
template <typename Op, bool FIRST>
__global__ void __launch_bounds__(BWD_THREADS) radix_scatter_kernel(
    const unsigned* __restrict__ kin, const unsigned* __restrict__ vin,
    unsigned* __restrict__ kout, unsigned* __restrict__ vout, long n, int shift, int bins,
    const int* __restrict__ offs, int n_tiles) {
  constexpr int NW = BWD_THREADS / 32;
  static_assert(BWD_THREADS == 256, "a thread a digit of at most 8 bits");
  __shared__ unsigned s_key[BWD_TILE];
  __shared__ unsigned s_val[BWD_TILE];
  __shared__ int s_wc[NW][256];
  __shared__ int s_run[256];    // the tile's entries of each digit placed so far
  __shared__ int s_local[256];  // where each digit's run starts in the tile
  __shared__ int s_glob[256];   // where it starts in the output
  __shared__ int s_warp[32];
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const long start = (long)blockIdx.x * BWD_TILE, stop = min(n, start + BWD_TILE);
  const long last = (long)bins * n_tiles - 1;
  int count = 0;
  if (tid < bins) {
    const long at = (long)tid * n_tiles + blockIdx.x;
    s_glob[tid] = offs[at];
    count = (at < last ? offs[at + 1] : (int)n) - offs[at];
  }
  int total;
  s_local[tid] = block_exclusive(count, s_warp, total);
  s_run[tid] = 0;
  const unsigned below = (1u << lane) - 1u;
  for (long round = start; round < stop; round += BWD_THREADS) {
#pragma unroll
    for (int k = 0; k < NW; ++k) s_wc[k][tid] = 0;
    __syncthreads();
    const long i = round + tid;
    const bool live = i < stop;
    const unsigned key = live ? kin[i] : 0u;
    const unsigned val = FIRST ? (unsigned)i : (live ? vin[i] : 0u);
    const int d = live ? (int)((key >> shift) & (unsigned)(bins - 1)) : -1;
    const unsigned peers = __match_any_sync(BWD_FULL, d);
    const int rank = __popc(peers & below);
    if (live && rank == 0) s_wc[wp][d] = __popc(peers);
    __syncthreads();
    if (live) {
      int at = s_local[d] + s_run[d] + rank;
      for (int k = 0; k < wp; ++k) at += s_wc[k][d];
      s_key[at] = key;
      s_val[at] = val;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) add += s_wc[k][tid];
    s_run[tid] += add;
  }
  __syncthreads();
  for (int i = tid; i < (int)(stop - start); i += BWD_THREADS) {
    const unsigned key = s_key[i];
    const int d = (int)((key >> shift) & (unsigned)(bins - 1));
    const int at = s_glob[d] + (i - s_local[d]);
    kout[at] = key;
    vout[at] = s_val[i];
  }
}

// Step 2, the global route: the segment of each value row that has entries (begin and end
// zeroed by the caller: an empty row keeps [0, 0)).
template <typename Op>
__global__ void __launch_bounds__(BWD_THREADS) bounds_kernel(const unsigned* __restrict__ keys,
                                                              long n, unsigned n_rows,
                                                              int* __restrict__ begin,
                                                              int* __restrict__ end) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned k = keys[i];
  if (k >= n_rows) return;
  if (i == 0 || keys[i - 1] != k) begin[k] = (int)i;
  if (i == n - 1 || keys[i + 1] != k) end[k] = (int)(i + 1);
}

// Where an entry's output-gradient row lies. K5, K7 (k9 0): entry
// e = 4 * tap' + c with tap' = (((m * Lx + s) * NQ + nq) * P + p), nq =
// n * Q + q (`bwd_entries_kernel`), the row nq * M + m of g; a = P, b = NQ,
// c = Lx, d = M. K9 (k9 1): e = ((b * MG + mg) * Q + q) * a + k, the row
// (b * Q + q) * MG + mg; a = L * K4, b = MG, c = Q.
struct GRows {
  int k9, a, b, c, d;
};

__device__ __forceinline__ unsigned bwd_g_row(unsigned id, const GRows& gr) {
  // 32-bit arithmetic: entries and rows of g lie below 2^31
  if (gr.k9) {
    const unsigned item = id / (unsigned)gr.a;
    const unsigned bm = item / (unsigned)gr.c, q = item - bm * gr.c;
    return (bm / gr.b * gr.c + q) * gr.b + bm % (unsigned)gr.b;
  }
  const unsigned tq = (id >> 2) / (unsigned)gr.a;     // (m * Lx + s) * NQ + nq
  const unsigned ms = tq / (unsigned)gr.b;
  return (tq - ms * gr.b) * gr.d + ms / (unsigned)gr.c;
}

// Step 3, the global route. value (n_rows, D) rows. A warp takes 32 / (lanes * gpr) rows, a
// row `gpr` groups of `lanes` lanes; group j of a row takes the entries j,
// j + gpr, ... of its segment, BWD_UNROLL a step (all loaded before any is
// summed, the sum in entry order). The warp steps as often as its longest
// row needs.
template <typename Op, typename scalar_t, int CW, int PER>
__global__ void __launch_bounds__(BWD_THREADS) bwd_gather_kernel(
    const scalar_t* __restrict__ value, const scalar_t* __restrict__ g,
    const float* __restrict__ wts, const unsigned* __restrict__ order,
    const int* __restrict__ begin, const int* __restrict__ end, scalar_t* __restrict__ grad_value,
    float* __restrict__ dots, long n_rows, int D, int lanes, int gpr, GRows grows) {
  using C = Chunk<scalar_t, CW>;
  const int lane = threadIdx.x & 31, span = lanes * gpr;
  const long r = (((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (32 / span) + lane / span;
  if (r - lane / span >= n_rows) return;  // whole warps leave together
  const bool row_on = r < n_rows;
  const int grp = lane % span / lanes, sub = lane % lanes;
  const scalar_t* vr = value + (row_on ? r : 0) * D;
  float v[PER][CW], acc[PER][CW];
  int c0[PER];
  bool on[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    c0[k] = (sub + k * lanes) * CW;
    on[k] = c0[k] < D;
    C::unpack(C::load(vr + c0[k], row_on && on[k]), v[k]);
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[k][c] = 0.f;
  }
  const int b = row_on ? begin[r] : 0, e1 = row_on ? end[r] : 0;
  constexpr int U = BWD_UNROLL;
  int steps = (e1 - b + U * gpr - 1) / (U * gpr);
  for (int o = 16; o > 0; o >>= 1) steps = max(steps, __shfl_xor_sync(BWD_FULL, steps, o));
  for (int s = 0, e0 = b + grp; s < steps; ++s, e0 += U * gpr) {
    unsigned id[U];
    bool live[U];
    float w[U], gv[U][PER][CW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      live[u] = e0 + u * gpr < e1;
      id[u] = live[u] ? order[e0 + u * gpr] : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = live[u] ? wts[id[u]] : 0.f;
      const scalar_t* gr = g + (size_t)bwd_g_row(id[u], grows) * D;
#pragma unroll
      for (int k = 0; k < PER; ++k) C::unpack(C::load(gr + c0[k], live[u] && on[k]), gv[u][k]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          dot = __fadd_rn(dot, __fmul_rn(gv[u][k][c], v[k][c]));
          acc[k][c] = __fadd_rn(acc[k][c], __fmul_rn(w[u], gv[u][k][c]));
        }
      dot = group_sum(dot, lanes);
      if (live[u] && sub == 0) dots[id[u]] = dot;
    }
  }
  for (int o = lanes; o < span; o <<= 1)
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[k][c] += __shfl_xor_sync(BWD_FULL, acc[k][c], o);
  if (grp == 0 && row_on)
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (on[k]) C::store(grad_value + r * D + c0[k], acc[k]);
}

// ---------------------------------------------------------------------------
// The run-wise route of K5 and K7 (steps 2-3 where `bwd_route` in the
// wrapper takes it).
// Run R = ((m * J + j) * L + l) * N + n holds the entries [R * E, (R + 1) * E)
// of head m, stage s = j * L + l and query frame n; its live keys are pixels
// of level l. Each run is sorted stably on its pixels alone, within its own
// range of positions, and each (run, pixel) gets its segment [begin, end)
// there. A value row (f, pixel of level l, m) takes the segments of the runs
// that read its frame (j, n with frames(j, n) = f) in run order: the same
// entries in the same order as the row's segment of the global stable sort,
// whose order within a row is entry order, runs being ranges of entries.
// ---------------------------------------------------------------------------

// A launch's runs and the offs table, which holds, for each run, hw[l] + 1
// ints: each pixel's first position in the sorted entries, then the end of
// the run's last. The first of two passes splits a run by bucket pix >>
// lb[l]; one pass where every level has one bucket.
struct RunPlan {
  int E;                  // entries a run: Q * P * 4
  int N, J, L;            // query frames, frame slots, levels
  int two;                // two passes
  int ebits;              // bits of a run-local entry index (the first pass packs the pixel's
                          // low bits above them)
  int hw[MAX_LEVELS];     // pixels a level
  int lb[MAX_LEVELS];     // a bucket's pixels: 2^lb
  int nb[MAX_LEVELS];     // buckets a level
  int zoff[MAX_LEVELS];   // sum over l' < l of hw[l'] + 1
  int Z;                  // the sum over every level
};

// (m, j, l, n) of run R; 32-bit: runs * E < 2^31
__device__ __forceinline__ void run_coords(const RunPlan& rp, unsigned R, int& m, int& j, int& l,
                                           int& n) {
  const unsigned jl = R / (unsigned)rp.N, jj = jl / (unsigned)rp.L;
  n = (int)(R - jl * rp.N);
  l = (int)(jl - jj * rp.L);
  m = (int)(jj / (unsigned)rp.J);
  j = (int)(jj - (unsigned)m * rp.J);
}

// Where run (m, j, l, n)'s part of the offs table starts; 32-bit: the table
// holds fewer than 2^31 ints.
__device__ __forceinline__ unsigned run_table(const RunPlan& rp, int m, int j, int l, int n) {
  return ((unsigned)(m * rp.J + j) * rp.Z + rp.zoff[l]) * rp.N + n * (rp.hw[l] + 1);
}

enum { RUN_ONE = 0, RUN_HIGH, RUN_LOW };

// Step 2, the run-wise route, one segment a block, within the segment's own
// range of positions: a run (RUN_ONE, runs of at most about RUN_BUCKET
// entries: keys and weights in entry order -> (entry, weight) by pixel;
// RUN_HIGH, the first of two passes: -> (run-local entry | the pixel's low
// bits << ebits, weight) by bucket pix >> lb[l]) or a bucket of the first
// pass's output (RUN_LOW: -> (entry, weight) by the low bits; block (run,
// bucket) = blockIdx.x / nb_max, % nb_max; staged in shared memory where it
// holds at most RUN_CACHE entries). `table` gets the digits' first
// positions: the offs table, or for RUN_HIGH the bucket table (nb_max + 1
// ints a run, read by RUN_LOW as `bkt`). The block's warps split the
// segment into contiguous parts, in order. In shared memory, cnt[w * bins +
// d] is warp w's count of digit d, then where its next entry of d goes;
// cnt[NW * bins + d] the segment's count of d.
//   1. Each warp counts its part (integer shared atomics).
//   2. Over each digit, the warps' counts in warp order; over the digits, the
//      totals in digit order (a block scan): every warp's first position of
//      every digit. The digits' first positions go to the table.
//   3. Each warp walks its part in order, RUN_UNROLL rounds of 32 loaded at
//      once: a rank among the round's lanes of the same digit by
//      __match_any_sync, then the warp's counter of the digit moves on.
// No position depends on which warp or block runs first. Where the writes
// go bounds it: a run's sorted range outgrows L2 when hundreds of runs are
// in flight, so a run of more than about RUN_BUCKET entries is first split
// into buckets of about that many, and each bucket is placed within its own
// range of a few tens of kilobytes.
template <typename Op, int MODE>
__global__ void run_sort_kernel(const unsigned* __restrict__ keys, const float* __restrict__ wts,
                                const uint2* __restrict__ tmp_in, uint2* __restrict__ out,
                                int* __restrict__ table, const int* __restrict__ bkt, RunPlan rp,
                                int nb_max, int bins_max) {
  extern __shared__ int cnt[];
  __shared__ int s_warp[32];
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, NW = blockDim.x >> 5;
  const unsigned R = MODE == RUN_LOW ? blockIdx.x / (unsigned)nb_max : blockIdx.x;
  int m, j, l, n;
  run_coords(rp, R, m, j, l, n);
  const int hw = rp.hw[l], nb = rp.nb[l], lb = rp.lb[l];
  const int d_blk = MODE == RUN_LOW ? (int)(blockIdx.x - R * nb_max) : 0;
  if (MODE == RUN_LOW && d_blk >= nb) return;
  const unsigned run0 = R * (unsigned)rp.E, emask = (1u << rp.ebits) - 1u;
  unsigned s0 = run0, s1 = run0 + rp.E;  // the segment's positions, in and out
  int bins = MODE == RUN_HIGH ? nb : hw;
  if (MODE == RUN_LOW) {
    s0 = bkt[R * (nb_max + 1) + d_blk];
    s1 = bkt[R * (nb_max + 1) + d_blk + 1];
    bins = min(1 << lb, hw - (d_blk << lb));
  }
  // RUN_LOW: the segment in shared memory after the counters, where it fits
  uint2* cache = reinterpret_cast<uint2*>(cnt + ((NW + 1) * bins_max + 1) / 2 * 2);
  const bool cached = MODE == RUN_LOW && s1 - s0 <= RUN_CACHE;
  for (int i = tid; i < NW * bins; i += blockDim.x) cnt[i] = 0;
  if (cached)
    for (unsigned i = s0 + tid; i < s1; i += blockDim.x) cache[i - s0] = tmp_in[i];
  __syncthreads();
  auto src = [&](unsigned i) -> uint2 { return cached ? cache[i - s0] : tmp_in[i]; };
  const unsigned per = ((s1 - s0 + NW - 1) / NW + 31) / 32 * 32;
  const unsigned w0 = min(s1, s0 + wp * per), w1 = min(s1, w0 + per);
  int* mine = cnt + wp * bins;
  // the digit of a key (a packed entry for RUN_LOW), or -1 for a dead corner
  auto digit = [&](unsigned key) -> int {
    if (MODE == RUN_ONE) return key == RUN_DEAD ? -1 : (int)key;
    if (MODE == RUN_HIGH) return key == RUN_DEAD ? -1 : (int)(key >> lb);
    return (int)(key >> rp.ebits);
  };
  // 1. counts
  for (unsigned i0 = w0; i0 < w1; i0 += 32 * RUN_UNROLL) {
    unsigned k[RUN_UNROLL];
#pragma unroll
    for (int u = 0; u < RUN_UNROLL; ++u) {
      const unsigned i = i0 + u * 32 + lane;
      k[u] = i < w1 ? (MODE == RUN_LOW ? src(i).x : keys[i]) : RUN_DEAD;
    }
#pragma unroll
    for (int u = 0; u < RUN_UNROLL; ++u) {
      const int d = i0 + u * 32 + lane < w1 ? digit(k[u]) : -1;
      if (d >= 0) atomicAdd(mine + d, 1);
    }
  }
  __syncthreads();
  // 2. every warp's first position of every digit; the table
  const int chunk = (bins + blockDim.x - 1) / blockDim.x;
  const int k0 = min(bins, tid * chunk), k1 = min(bins, k0 + chunk);
  int local = 0;
  for (int d = k0; d < k1; ++d) {
    int run = 0;
    for (int w = 0; w < NW; ++w) {
      const int c = cnt[w * bins + d];
      cnt[w * bins + d] = run;
      run += c;
    }
    cnt[NW * bins + d] = run;
    local += run;
  }
  int total;
  int at = block_exclusive(local, s_warp, total);
  const unsigned tb = MODE == RUN_HIGH ? R * (nb_max + 1)
                                       : run_table(rp, m, j, l, n) + (d_blk << lb);
  for (int d = k0; d < k1; ++d) {
    for (int w = 0; w < NW; ++w) cnt[w * bins + d] += at;
    table[tb + d] = (int)s0 + at;
    at += cnt[NW * bins + d];
  }
  // the end of the last digit: the end of the run's live entries
  if (tid == 0 && (MODE != RUN_LOW || d_blk == nb - 1)) table[tb + bins] = (int)s0 + total;
  __syncthreads();
  // 3. placement. RUN_HIGH stages each round's RUN_UNROLL * 32 entries in
  // shared memory, bucket by bucket (each bucket's entries of the round go
  // to consecutive positions), and writes them out in that order: its
  // scattered writes cost more than the staging.
  const unsigned below = (1u << lane) - 1u;
  uint2* dst = out + s0;
  int* snap = cnt + (NW + 1) * bins_max + wp * bins;  // RUN_HIGH: mine[] as the round began
  int* stage = cnt + (2 * NW + 1) * bins_max + wp * (3 * 32 * RUN_UNROLL);
  for (unsigned i0 = w0; i0 < w1; i0 += 32 * RUN_UNROLL) {
    unsigned k[RUN_UNROLL], x[RUN_UNROLL];
    float wt[RUN_UNROLL];
    int pos[RUN_UNROLL];
    if (MODE == RUN_HIGH) {
      for (int d = lane; d < bins; d += 32) snap[d] = mine[d];
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < RUN_UNROLL; ++u) {
      const unsigned i = i0 + u * 32 + lane;
      const bool in = i < w1;
      if (MODE == RUN_LOW) {
        const uint2 p = in ? src(i) : make_uint2(0u, 0u);
        k[u] = p.x;
        x[u] = run0 + (p.x & emask);
        wt[u] = __uint_as_float(p.y);
      } else {
        k[u] = in ? keys[i] : RUN_DEAD;
        x[u] = MODE == RUN_ONE ? i : (i - run0) | ((k[u] & ((1u << lb) - 1u)) << rp.ebits);
        wt[u] = in ? wts[i] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < RUN_UNROLL; ++u) {
      const int d = i0 + u * 32 + lane < w1 ? digit(k[u]) : -1;
      const unsigned peers = __match_any_sync(BWD_FULL, d);
      const int rank = __popc(peers & below);
      pos[u] = d >= 0 ? mine[d] + rank : -1;
      __syncwarp();
      if (d >= 0 && rank == 0) mine[d] = pos[u] + __popc(peers);
      __syncwarp();
      if (MODE != RUN_HIGH && d >= 0) dst[pos[u]] = make_uint2(x[u], __float_as_uint(wt[u]));
    }
    if (MODE == RUN_HIGH) {
      // snap[d] <- the round's entries of the buckets before d, less d's
      // first position: an entry's place in the staged round is pos + snap[d]
      int placed = 0;
      for (int d0 = 0; d0 < bins; d0 += 32) {
        const int d = d0 + lane, c = d < bins ? mine[d] - snap[d] : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(BWD_FULL, incl, o);
          if (lane >= o) incl += y;
        }
        if (d < bins) snap[d] = placed + incl - c - snap[d];
        placed += __shfl_sync(BWD_FULL, incl, 31);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < RUN_UNROLL; ++u) {
        if (pos[u] < 0) continue;
        const int at = 3 * (pos[u] + snap[(int)(k[u] >> lb)]);
        stage[at] = pos[u];
        stage[at + 1] = (int)x[u];
        stage[at + 2] = __float_as_int(wt[u]);
      }
      __syncwarp();
      for (int i = lane; i < placed; i += 32)
        dst[stage[3 * i]] = make_uint2((unsigned)stage[3 * i + 1], (unsigned)stage[3 * i + 2]);
      __syncwarp();
    }
  }
}

// Warps a block of the run-wise sort takes for `bins` digits: as many as
// keep their counters within RUN_SMEM_INTS, at most `most`.
static inline int run_warps(int bins, int most) {
  int nw = most;
  while (nw > 1 && (long)nw * bins > RUN_SMEM_INTS) nw >>= 1;
  return nw;
}

template <typename Op, int MODE>
static int run_sort_launch(long blocks, int bins, const unsigned* keys, const float* wts,
                           const uint2* tmp_in, uint2* out, int* table, const int* bkt,
                           const RunPlan& rp, int nb_max, cudaStream_t stream) {
  const int nw = run_warps(bins, MODE == RUN_ONE    ? RUN_MAX_WARPS
                                 : MODE == RUN_HIGH ? RUN_HIGH_WARPS
                                                    : RUN_LOW_WARPS);
  // counters; RUN_HIGH: their snapshots and the staged rounds; RUN_LOW: the cache
  const size_t ints = MODE == RUN_HIGH ? (size_t)(2 * nw + 1) * bins + 3 * 32 * RUN_UNROLL * nw
                                       : ((size_t)(nw + 1) * bins + 1) / 2 * 2;
  const size_t smem = ints * sizeof(int) + (MODE == RUN_LOW ? RUN_CACHE * sizeof(uint2) : 0);
  auto kernel = &run_sort_kernel<Op, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, 32 * nw, smem, stream>>>(keys, wts, tmp_in, out, table, bkt, rp,
                                                      nb_max, bins);
  return (int)cudaGetLastError();
}

// Step 3 of the run-wise route. value (F, S, M, D) row r = (f * S + sp) * M
// + m, pixel pix of level l, takes, for each item j * N + n of its frame's
// list feed[feed_ptr[f], feed_ptr[f + 1]) (run order; ONE: the run (m, 0,
// l, f) alone, K7's), the segment of run ((m * J + j) * L + l) * N + n at
// its pixel. The segments, laid end to end, are the row's list: the row's
// lanes first stage each segment's start and the list's running length in
// shared memory (`max_feeds` a row), then group j of the row takes the
// list's entries j, j + gpr, ..., BWD_UNROLL a step, as bwd_gather_kernel
// takes a segment's; pairs hold (entry, weight) in the runs' sorted order.
template <typename Op, typename scalar_t, int CW, int PER, bool ONE>
__global__ void __launch_bounds__(BWD_THREADS, 4) run_gather_kernel(
    const scalar_t* __restrict__ value, const scalar_t* __restrict__ g,
    const uint2* __restrict__ pairs, const int* __restrict__ offs,
    const int* __restrict__ feed_ptr, const int* __restrict__ feed,
    scalar_t* __restrict__ grad_value, float* __restrict__ dots, unsigned n_slots, int S, int M,
    int D, int lanes, int gpr, int max_feeds, int blocked, GRows grows, RunPlan rp, Pyramid pyr) {
  extern __shared__ int lists[];
  using C = Chunk<scalar_t, CW>;
  const int lane = threadIdx.x & 31, span = lanes * gpr, rw = lane / span;
  // 32-bit rows and positions: the launcher holds the rows and the entries below 2^31
  const unsigned t = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (32 / span) + rw;
  if (t - rw >= n_slots) return;  // whole warps leave together
  // the row (f, sp, m): slot t in (f, sp, m) order, or with `blocked` in
  // (f, sp / RB, m, sp % RB) order, RB the rows a block takes
  int m, f, sp;
  if (blocked) {
    const unsigned RB = blockDim.x / span, SB = (S + RB - 1) / RB, i = t % RB, b = t / RB;
    const unsigned bm = b / (unsigned)M, sb = bm % SB;
    m = (int)(b - bm * M);
    f = (int)(bm / SB);
    sp = (int)(sb * RB + i);
  } else {
    const unsigned fs = t / (unsigned)M;
    m = (int)(t - fs * M);
    f = (int)(fs / (unsigned)S);
    sp = (int)(fs - (unsigned)f * S);
  }
  const bool row_on = t < n_slots && sp < S;
  if (!row_on) m = f = sp = 0;
  const unsigned rr = ((unsigned)f * S + sp) * M + m;
  int l = 0;
  while (l + 1 < pyr.L && sp >= pyr.start[l + 1]) ++l;
  const int pix = sp - pyr.start[l];
  const int grp = lane % span / lanes, sub = lane % lanes;
  const scalar_t* vr = value + (size_t)rr * D;
  float v[PER][CW], acc[PER][CW];
  int c0[PER];
  bool on[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    c0[k] = (sub + k * lanes) * CW;
    on[k] = c0[k] < D;
    C::unpack(C::load(vr + c0[k], row_on && on[k]), v[k]);
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[k][c] = 0.f;
  }
  int total = 0, seg0 = 0;  // ONE: the row's one segment
  int *starts = nullptr, *cum = nullptr;
  if (ONE) {
    if (row_on) {
      const unsigned ob = run_table(rp, m, 0, l, f) + pix;
      seg0 = offs[ob];
      total = offs[ob + 1] - seg0;
    }
  } else {
    starts = lists + ((threadIdx.x >> 5) * (32 / span) + rw) * (2 * max_feeds + 1);
    cum = starts + max_feeds;
    const int fb = row_on ? feed_ptr[f] : 0, nf = row_on ? feed_ptr[f + 1] - fb : 0;
    for (int k = lane % span; k < nf; k += span) {
      const int item = feed[fb + k], jj = item / rp.N, nn = item - jj * rp.N;
      const unsigned ob = run_table(rp, m, jj, l, nn) + pix;
      starts[k] = offs[ob];
      cum[k + 1] = offs[ob + 1] - starts[k];
    }
    __syncwarp();
    if (lane % span == 0) {
      cum[0] = 0;
      for (int k = 0; k < nf; ++k) cum[k + 1] += cum[k];
    }
    __syncwarp();
    total = row_on ? cum[nf] : 0;
  }
  constexpr int U = BWD_UNROLL;
  int steps = (total + U * gpr - 1) / (U * gpr);
  for (int o = 16; o > 0; o >>= 1) steps = max(steps, __shfl_xor_sync(BWD_FULL, steps, o));
  int k = 0;  // the list's segment the group's next entry lies in
  for (int s = 0, e0 = grp; s < steps; ++s, e0 += U * gpr) {
    unsigned id[U];
    bool live[U];
    float w[U], gv[U][PER][CW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = e0 + u * gpr;
      live[u] = c < total;
      int at = seg0 + c;
      if (!ONE && live[u]) {
        while (c >= cum[k + 1]) ++k;
        at = starts[k] + c - cum[k];
      }
      const uint2 p = live[u] ? pairs[at] : make_uint2(0u, 0u);
      id[u] = p.x;
      w[u] = __uint_as_float(p.y);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const scalar_t* gr = g + (size_t)bwd_g_row(id[u], grows) * D;
#pragma unroll
      for (int k2 = 0; k2 < PER; ++k2)
        C::unpack(C::load(gr + c0[k2], live[u] && on[k2]), gv[u][k2]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < PER; ++k2)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          dot = __fadd_rn(dot, __fmul_rn(gv[u][k2][c], v[k2][c]));
          acc[k2][c] = __fadd_rn(acc[k2][c], __fmul_rn(w[u], gv[u][k2][c]));
        }
      dot = group_sum(dot, lanes);
      if (live[u] && sub == 0) dots[id[u]] = dot;
    }
  }
  for (int o = lanes; o < span; o <<= 1)
#pragma unroll
    for (int k2 = 0; k2 < PER; ++k2)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[k2][c] += __shfl_xor_sync(BWD_FULL, acc[k2][c], o);
  if (grp == 0 && row_on)
#pragma unroll
    for (int k2 = 0; k2 < PER; ++k2)
      if (on[k2]) C::store(grad_value + (size_t)rr * D + c0[k2], acc[k2]);
}

// Device scratch of steps 2-4, allocated by the wrapper: keys and sorted
// entry indices twice (n entries each), begin and end (n_rows, zeroed),
// hist (256 * tiles), sums (hist's scan tiles) and top (1).
struct BwdScratch {
  unsigned *keys[2], *vals[2];
  int *begin, *end, *hist, *sums, *top;
};

// data[0, n) by its exclusive prefix sums.
template <typename Op>
static int exclusive_scan(int* data, long n, int* sums, int* top, cudaStream_t stream) {
  const long tiles = bwd_blocks(n, BWD_SCAN_TILE);
  if (tiles > BWD_SCAN_TOP) return (int)cudaErrorInvalidValue;
  scan_tiles_kernel<Op><<<(unsigned)tiles, BWD_SCAN_TILE / 16, 0, stream>>>(data, n, sums);
  scan_tiles_kernel<Op><<<1, BWD_SCAN_TOP / 16, 0, stream>>>(sums, tiles, top);
  scan_add_kernel<Op><<<(unsigned)bwd_blocks(n, BWD_THREADS), BWD_THREADS, 0, stream>>>(data, n,
                                                                                    sums);
  return (int)cudaGetLastError();
}

// Steps 2-3 of the global route on keys in s.keys[0] (n entries, keys <= n_rows): the rows of
// grad_value (n_rows, D) and the dots of every entry with a key < n_rows.
// `lanes` (a power of two), `per` and `vec` come from the wrapper's
// `taps_plan`; vec needs value, g and grad_value 16-byte aligned.
template <typename Op, typename scalar_t>
static int bwd_sort_gather(const void* value, const void* g, const float* wts, float* dots,
                           void* grad_value, long n, unsigned n_rows, int D, int lanes, int per,
                           int vec, int gpr, const GRows& grows, const BwdScratch& s,
                           cudaStream_t stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  const int bad = (int)cudaErrorInvalidValue;
  if (n < 0 || n > 0x7fffffffL || n_rows < 1 || n_rows > 0x7fffffffu || D < 1 ||
      grows.a < 1 || grows.b < 1 || grows.c < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) ||
      (per != 1 && per != 2 && per != BWD_MAX_PER) || (long)lanes * per * (vec ? VN : 1) < D ||
      gpr < 1 || (gpr & (gpr - 1)) || lanes * gpr > 32)
    return bad;
  if (vec && (D % VN || (uintptr_t)value % 16 || (uintptr_t)g % 16 || (uintptr_t)grad_value % 16))
    return bad;
  int bits = 0;
  while (bits < 32 && (n_rows >> bits) != 0u) ++bits;  // n_rows itself must fit
  const int passes = (bits + 7) / 8, dbits = (bits + passes - 1) / passes;
  const long tiles = bwd_blocks(n, BWD_TILE);
  int cur = 0;
  for (int p = 0; p < passes && n > 0; ++p) {
    const int shift = p * dbits, bins = 1 << dbits;
    radix_hist_kernel<Op><<<(unsigned)tiles, BWD_THREADS, 0, stream>>>(s.keys[cur], n, shift, bins,
                                                                    s.hist, (int)tiles);
    int err = exclusive_scan<Op>(s.hist, (long)bins * tiles, s.sums, s.top, stream);
    if (err) return err;
    if (p == 0)
      radix_scatter_kernel<Op, true><<<(unsigned)tiles, BWD_THREADS, 0, stream>>>(
          s.keys[cur], nullptr, s.keys[1 - cur], s.vals[1 - cur], n, shift, bins, s.hist,
          (int)tiles);
    else
      radix_scatter_kernel<Op, false><<<(unsigned)tiles, BWD_THREADS, 0, stream>>>(
          s.keys[cur], s.vals[cur], s.keys[1 - cur], s.vals[1 - cur], n, shift, bins, s.hist,
          (int)tiles);
    cur = 1 - cur;
  }
  if (n > 0)
    bounds_kernel<Op><<<(unsigned)bwd_blocks(n, BWD_THREADS), BWD_THREADS, 0, stream>>>(
        s.keys[cur], n, n_rows, s.begin, s.end);
  const int rows_a_warp = 32 / (lanes * gpr);
  const long blocks = bwd_blocks(((long)n_rows + rows_a_warp - 1) / rows_a_warp * 32, BWD_THREADS);
  if (blocks > 0x7fffffffL) return bad;
  auto kernel = &bwd_gather_kernel<Op, scalar_t, 1, 1>;
  if (vec)
    kernel = per == 1   ? &bwd_gather_kernel<Op, scalar_t, VN, 1>
             : per == 2 ? &bwd_gather_kernel<Op, scalar_t, VN, 2>
                        : &bwd_gather_kernel<Op, scalar_t, VN, BWD_MAX_PER>;
  else
    kernel = per == 1   ? &bwd_gather_kernel<Op, scalar_t, 1, 1>
             : per == 2 ? &bwd_gather_kernel<Op, scalar_t, 1, 2>
                        : &bwd_gather_kernel<Op, scalar_t, 1, BWD_MAX_PER>;
  kernel<<<(unsigned)blocks, BWD_THREADS, 0, stream>>>(
      (const scalar_t*)value, (const scalar_t*)g, wts, s.vals[cur], s.begin, s.end,
      (scalar_t*)grad_value, dots, (long)n_rows, D, lanes, gpr, grows);
  return (int)cudaGetLastError();
}

// Device scratch of the run-wise route, allocated by the wrapper: pairs
// (entry, weight) in the sorted order and, for a two-pass sort, tmp (a
// run-local entry and the pixel's low bits, weight) between the passes (n
// each); the offs table (RunPlan); a value frame's runs, items j * N + n in
// run order (feed_ptr F + 1 ints, feed J * N). The first pass's bucket
// table (nb_max + 1 ints a run) is BwdScratch's hist.
struct RunScratch {
  uint2 *pairs, *tmp;
  int* offs;
  const int *feed_ptr, *feed;
};

// The runs of a launch: E entries a run, N query frames, J frame slots, the
// pyramid's levels, M heads. A level's buckets hold 2^lb pixels, lb the
// largest (at most log2 RUN_BINS) with E * 2^lb / hw at most `bucket`
// entries; one pass where every level is one bucket. False where the plan
// cannot run (more than RUN_BINS buckets, a run's entry index and a
// bucket's low bits past 32 bits, tables past int32).
static inline bool make_run_plan(RunPlan& rp, const Pyramid& pyr, long E, int N, int J, int M,
                                 int bucket) {
  if (E < 1 || E > 0x7fffffffL || N < 1 || J < 1 || bucket < 1) return false;
  rp.E = (int)E;
  rp.N = N;
  rp.J = J;
  rp.L = pyr.L;
  rp.two = 0;
  rp.ebits = 1;
  while ((1L << rp.ebits) < E) ++rp.ebits;
  long z = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const int hw = l < pyr.L ? pyr.h[l] * pyr.w[l] : 1;
    const long x = (long)hw * bucket / E;
    int lb = 0;
    while ((2L << lb) <= x && (2 << lb) <= RUN_BINS) ++lb;
    rp.hw[l] = hw;
    rp.lb[l] = lb;
    rp.nb[l] = (hw + (1 << lb) - 1) >> lb;
    rp.zoff[l] = (int)z;
    if (l < pyr.L) {
      z += hw + 1;
      rp.two |= rp.nb[l] > 1;
    }
  }
  for (int l = 0; l < pyr.L; ++l)
    if (rp.nb[l] > RUN_BINS || (rp.two && rp.ebits + rp.lb[l] > 32)) return false;
  rp.Z = (int)z;
  return (long)M * J * N * z < 0x7fffffffL && (long)M * J * N * pyr.L * E < 0x7fffffffL;
}

// Steps 2-3 of the run-wise route on local keys in keys (RUN_DEAD where a
// corner lies outside its level) and weights in entry order: grad_value
// (n_rows, D) and the dots of every live entry. value (F, S, M, D).
// `max_feeds`: the most runs a value frame is read by (ONE where that is one
// run, the frame's own: K7). `s.hist`: the first pass's bucket table.
template <typename Op, typename scalar_t>
static int run_sort_gather(const void* value, const void* g, const unsigned* keys,
                           const float* wts, float* dots, void* grad_value, long n_rows, int S,
                           int M, int D, int lanes, int per, int vec, int gpr, int max_feeds,
                           bool one, int blocked, const GRows& grows, const RunPlan& rp,
                           const Pyramid& pyr, const BwdScratch& s, const RunScratch& rs,
                           cudaStream_t stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  const int bad = (int)cudaErrorInvalidValue;
  if (n_rows < 1 || n_rows > 0x7fffffffL || D < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || (per != 1 && per != 2 && per != BWD_MAX_PER) ||
      (long)lanes * per * (vec ? VN : 1) < D || gpr < 1 || (gpr & (gpr - 1)) ||
      lanes * gpr > 32 || max_feeds < 1 || !rs.pairs || !rs.offs ||
      (!one && (!rs.feed_ptr || !rs.feed)) || (rp.two && (!rs.tmp || !s.hist)))
    return bad;
  if (vec && (D % VN || (uintptr_t)value % 16 || (uintptr_t)g % 16 || (uintptr_t)grad_value % 16))
    return bad;
  const long runs = (long)M * rp.J * rp.L * rp.N;
  int hw_max = 1, nb_max = 1, low_max = 1;  // the largest level, bucket count, bucket
  for (int l = 0; l < rp.L; ++l) {
    hw_max = max(hw_max, rp.hw[l]);
    nb_max = max(nb_max, rp.nb[l]);
    low_max = max(low_max, min(1 << rp.lb[l], rp.hw[l]));
  }
  if (runs * nb_max > 0x7fffffffL) return bad;
  int err;
  if (!rp.two) {
    err = run_sort_launch<Op, RUN_ONE>(runs, hw_max, keys, wts, nullptr, rs.pairs, rs.offs,
                                       nullptr, rp, 1, stream);
  } else {
    err = run_sort_launch<Op, RUN_HIGH>(runs, nb_max, keys, wts, nullptr, rs.tmp, s.hist,
                                        nullptr, rp, nb_max, stream);
    if (err) return err;
    err = run_sort_launch<Op, RUN_LOW>(runs * nb_max, low_max, nullptr, nullptr, rs.tmp,
                                       rs.pairs, rs.offs, s.hist, rp, nb_max, stream);
  }
  if (err) return err;
  const int rows_a_warp = 32 / (lanes * gpr), rows_a_block = BWD_THREADS / 32 * rows_a_warp;
  const long slots = blocked ? n_rows / S / M * ((S + rows_a_block - 1) / rows_a_block) * M *
                                   rows_a_block
                             : n_rows;
  const long blocks = bwd_blocks((slots + rows_a_warp - 1) / rows_a_warp * 32, BWD_THREADS);
  const size_t smem = one ? 0
                          : (size_t)(BWD_THREADS / 32) * rows_a_warp * (2 * max_feeds + 1) *
                                sizeof(int);
  if (blocks > 0x7fffffffL || slots > 0x7fffffffL || smem > SMEM_BLOCK_MAX) return bad;
#define RUN_GATHER(CW, PER)                                                    \
  (one ? &run_gather_kernel<Op, scalar_t, CW, PER, true>                       \
       : &run_gather_kernel<Op, scalar_t, CW, PER, false>)
  auto kernel = RUN_GATHER(1, 1);
  if (vec)
    kernel = per == 1 ? RUN_GATHER(VN, 1) : per == 2 ? RUN_GATHER(VN, 2) : RUN_GATHER(VN, 4);
  else
    kernel = per == 1 ? RUN_GATHER(1, 1) : per == 2 ? RUN_GATHER(1, 2) : RUN_GATHER(1, 4);
#undef RUN_GATHER
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, BWD_THREADS, smem, stream>>>(
      (const scalar_t*)value, (const scalar_t*)g, rs.pairs, rs.offs, rs.feed_ptr, rs.feed,
      (scalar_t*)grad_value, dots, (unsigned)slots, S, M, D, lanes, gpr, max_feeds, blocked, grows,
      rp, pyr);
  return (int)cudaGetLastError();
}

// K5 and K7 whole: steps 1-4. The taps' layout as bwd_entries_kernel's;
// value (F, S, M, D) -> grad_value in the value's type. bucket < 0: the
// global sort (BwdScratch); else the run-wise route with buckets of about
// that many entries (0: RUN_BUCKET; RunScratch, keys and weights in
// s.keys[0] and wts); max_feeds as run_sort_gather's, 0 for K7 (one run a
// row, the frame's own).
template <typename Op, typename scalar_t, typename Frames>
static int bwd_run(const void* value, const float* loc, const float* att, const void* grad_out,
                   void* grad_value, float* grad_loc, float* grad_att, float* wts, float* dots,
                   const BwdScratch& s, const RunScratch& rs, int F, int N, int Q, int S, int M,
                   int D, int Lx, int P, int lanes, int per, int vec, int gpr, int bucket,
                   int max_feeds, const Pyramid& pyr, const Frames& frames,
                   cudaStream_t stream) {
  if (F < 1 || N < 1 || Q < 0 || S < 1 || M < 1 || Lx < 1 || P < 1 || Lx % pyr.L)
    return (int)cudaErrorInvalidValue;
  const long n_taps = (long)N * Q * M * Lx * P, n_rows = (long)F * S * M;
  if (4 * n_taps > 0x7fffffffL || n_rows >= 0x7fffffffL) return (int)cudaErrorInvalidValue;
  RunPlan rp;
  const bool runs = bucket >= 0;
  if (runs && !make_run_plan(rp, pyr, 4L * Q * P, N, Lx / pyr.L, M, bucket ? bucket : RUN_BUCKET))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)bwd_blocks(n_taps, BWD_THREADS);
  if (n_taps > 0) {
    if (runs)
      bwd_entries_kernel<Op, true><<<blocks, BWD_THREADS, 0, stream>>>(
          loc, att, s.keys[0], wts, n_taps, Q, M, Lx, P, S, (unsigned)n_rows, pyr, frames);
    else
      bwd_entries_kernel<Op, false><<<blocks, BWD_THREADS, 0, stream>>>(
          loc, att, s.keys[0], wts, n_taps, Q, M, Lx, P, S, (unsigned)n_rows, pyr, frames);
  }
  const GRows grows{0, P, N * Q, Lx, M};
  int err = runs ? run_sort_gather<Op, scalar_t>(value, grad_out, s.keys[0], wts, dots,
                                                 grad_value, n_rows, S, M, D, lanes, per, vec, gpr,
                                                 max(max_feeds, 1), max_feeds == 0,
                                                 M > 1, grows, rp, pyr, s, rs, stream)
                 : bwd_sort_gather<Op, scalar_t>(value, grad_out, wts, dots, grad_value,
                                                 4 * n_taps, (unsigned)n_rows, D, lanes, per, vec,
                                                 gpr, grows, s, stream);
  if (err) return err;
  if (n_taps > 0)
    bwd_tap_grads_kernel<Op><<<blocks, BWD_THREADS, 0, stream>>>(loc, att, dots, grad_loc,
                                                                  grad_att, n_taps, M, Lx, P, pyr);
  return (int)cudaGetLastError();
}
