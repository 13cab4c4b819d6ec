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
// on every run. Here every sum has an order that the
// inputs and the launch geometry fix, and every product and sum of steps 4
// and 5 is rounded on its own (no contraction into FMAs), so that the CPU
// mirror gives the same bits:
//   1. Entries. One thread per tap (K5, K7) writes its four corners' entries
//      at e = 4 * tap + c: the key, the value row (frame, pixel, head) the
//      corner reads, or n_rows where the tap is dead or the corner lies
//      outside its level; the weight a * bilinear weight; and dot 0 where
//      the key is n_rows. K9's entries come given (idx, wt), one thread per
//      entry writes its key.
//   2. A stable LSD radix sort of the entry indices by key, digits of at
//      most 8 bits: per pass a histogram of the digit per tile of BWD_TILE
//      entries (integer shared atomics count), one exclusive scan over
//      (digit, tile), then a scatter in which each tile places its entries in
//      entry order: rounds of 256, a rank within the warp by
//      __match_any_sync, a prefix over the warps' counts in shared memory.
//      No position depends on which block runs first.
//   3. Bounds. Each value row's segment [begin, end) of the sorted entries.
//   4. Gather. A value row takes `gpr` groups of `lanes` lanes (a warp
//      32 / (lanes * gpr) rows; gpr from the mean entries a row), lane c of
//      a group owning chunk c (16 bytes, or one channel) of the D channels,
//      PER chunks a lane. Group j takes the segment's entries j, j + gpr,
//      ... in order: w * g summed in registers, and g . row (summed over the
//      group's lanes by a fixed butterfly) stored as the entry's dot. A
//      fixed butterfly adds the groups' sums; group 0 stores the row once,
//      in the value's type (zeros where no entry falls).
//   5. (K5, K7) One thread per tap sums its four dots into the weight and
//      location gradients.
// What bounds it: the sort moves 16 bytes an entry a pass (two or three
// passes at the paths' row counts), and the gather reads a g row an entry
// (from L2 where g fits it). Equal inputs give equal bits; the sums' order
// differs from the plain versions', so the two agree to rounding.
// `msda_bwd_mirror` and `msda_taps_bwd_mirror` in ops/ms_deform_attn_cuda.py
// repeat steps 1-5 on the CPU (`taps_plan` is the gather's split of the
// channels).
#pragma once

#include "msda_common.cuh"

#define BWD_THREADS 256      // threads of every kernel here but the top scan
#define BWD_TILE 4096        // entries a block of the sort (16 rounds of 256)
#define BWD_SCAN_TILE 4096   // ints a block of the scan (16 a thread)
#define BWD_SCAN_TOP 16384   // tile totals the one-block top scan takes (1024 x 16)
#define BWD_MAX_PER 4        // chunks of a row a lane of the gather may own
#define BWD_UNROLL 4         // entries a lane group of the gather loads before it sums
#define BWD_FULL 0xffffffffu

// The op a launch belongs to, a template argument of every kernel here: a
// profile then tells K5's, K7's and K9's kernels apart by name.
struct k5_bwd {};
struct k7_bwd {};
struct k9_bwd {};

// Step 1 for K5 and K7. loc (N, Q, M, Lx, P, 2), att (N, Q, M, Lx, P), tap
// t = (((n * Q + q) * M + m) * Lx + s) * P + p; stage s = j * L + l reads
// value frame frames(j, n). Keys index value rows (F, S, M). A tap's
// entries lie at 4 * t' + c, t' = ((m * Lx + s) * NQ + n * Q + q) * P + p:
// the entries one (head, stage) gives lie together, so that the gather's
// reads of weights and writes of dots for neighbouring value rows stay
// within a few megabytes (L2), wherever the value rows' queries lie.
template <typename Op, typename Frames>
__global__ void __launch_bounds__(BWD_THREADS) bwd_entries_kernel(
    const float* __restrict__ loc, const float* __restrict__ att, unsigned* __restrict__ keys,
    float* __restrict__ wts, float* __restrict__ dots, long n_taps, int Q, int M, int Lx, int P,
    int S, unsigned n_rows, Pyramid pyr, Frames frames) {
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
  const long base = (long)frames((int)s / pyr.L, (int)n) * S + pyr.start[l];
  unsigned k[4];
  float wt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yi = y0 + (c >> 1), xi = x0 + (c & 1);
    const bool in = live && yi >= 0 && yi < h && xi >= 0 && xi < w;
    k[c] = in ? (unsigned)((base + (long)yi * w + xi) * M + m) : n_rows;
    wt[c] = in ? a * corner_weight(c, dx, dy) : 0.f;
    if (!in) dots[4 * (size_t)tp + c] = 0.f;
  }
  // the caller's buffers are 16-byte aligned: a tap's four entries in one store each
  reinterpret_cast<uint4*>(keys)[tp] = make_uint4(k[0], k[1], k[2], k[3]);
  reinterpret_cast<float4*>(wts)[tp] = make_float4(wt[0], wt[1], wt[2], wt[3]);
}

// Step 5 for K5 and K7: the weight and location gradients of each tap from
// its corners' dots (a dead tap's are 0).
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
      const float gv = dv[c];
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

// Step 2, one pass: tile histogram of the digit (key >> shift) & (bins - 1),
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

// Step 2, one pass: tile `blockIdx.x` places its entries, in entry order,
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

// Step 3: the segment of each value row that has entries (begin and end
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

// Step 4. value (n_rows, D) rows. A warp takes 32 / (lanes * gpr) rows, a
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

// Device scratch of steps 2-4, allocated by the wrapper: keys and sorted
// entry indices twice (n entries each), begin and end (n_rows, zeroed),
// hist (256 * tiles), sums (hist's scan tiles) and top (1).
struct BwdScratch {
  unsigned *keys[2], *vals[2];
  int *begin, *end, *hist, *sums, *top;
};

static inline long bwd_blocks(long n, int threads) { return (n + threads - 1) / threads; }

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

// Steps 2-4 on keys in s.keys[0] (n entries, keys <= n_rows): the rows of
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

// K5 and K7 whole: steps 1-5. The taps' layout as bwd_entries_kernel's;
// value (F, S, M, D) -> grad_value in the value's type.
template <typename Op, typename scalar_t, typename Frames>
static int bwd_run(const void* value, const float* loc, const float* att, const void* grad_out,
                   void* grad_value, float* grad_loc, float* grad_att, float* wts, float* dots,
                   const BwdScratch& s, int F, int N, int Q, int S, int M, int D, int Lx, int P,
                   int lanes, int per, int vec, int gpr, const Pyramid& pyr,
                   const Frames& frames, cudaStream_t stream) {
  if (F < 1 || N < 1 || Q < 0 || S < 1 || M < 1 || Lx < 1 || P < 1 || Lx % pyr.L)
    return (int)cudaErrorInvalidValue;
  const long n_taps = (long)N * Q * M * Lx * P, n_rows = (long)F * S * M;
  if (4 * n_taps > 0x7fffffffL || n_rows >= 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if (n_taps > 0)
    bwd_entries_kernel<Op><<<(unsigned)bwd_blocks(n_taps, BWD_THREADS), BWD_THREADS, 0, stream>>>(
        loc, att, s.keys[0], wts, dots, n_taps, Q, M, Lx, P, S, (unsigned)n_rows, pyr, frames);
  int err = bwd_sort_gather<Op, scalar_t>(value, grad_out, wts, dots, grad_value, 4 * n_taps,
                                      (unsigned)n_rows, D, lanes, per, vec, gpr,
                                      GRows{0, P, N * Q, Lx, M}, s, stream);
  if (err) return err;
  if (n_taps > 0)
    bwd_tap_grads_kernel<Op><<<(unsigned)bwd_blocks(n_taps, BWD_THREADS), BWD_THREADS, 0, stream>>>(
        loc, att, dots, grad_loc, grad_att, n_taps, M, Lx, P, pyr);
  return (int)cudaGetLastError();
}
