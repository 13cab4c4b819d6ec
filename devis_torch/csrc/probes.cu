// Probes of the card's costs for the mask head's DCNv2 kernel (K4/K10), on
// Hopper (sm_90a). Measurement only: no model path calls them.
//
// K12a tent_band <- benchmarks/bench_tent_gather.py:_tent_kernel
//   out[c, n] = sum_r sum_{j,l < ncand} tent(dy[n] + r*1e-6 - (j - lo))
//                                      * tent(dx[n] - (l - lo))
//                                      * u[c, lo + l + j*Wp + n]
//   with lo = (ncand - 1) / 2 and tent(z) = max(0, 1 - |z|): bilinear
//   sampling by enumerating an ncand x ncand band of candidate taps, as the
//   TPU kernel does without a gather. Indices are flat, so a row of width Wp
//   runs into the next one, as on the TPU.
// K12b corner_gather <- benchmarks/bench_tent_gather.py:_gather_kernel
//   The same function by floor and four corner reads at
//   idx = n + (floor(dy) + lo)*Wp + floor(dx) + 2*lo (+ Wp, + 1), the index
//   clamped into [0, N + ncand*Wp - Wp - 2].
//   Within the band it equals K12a up to the order of the sums.
// K12c mma_probe <- benchmarks/mxu_probe.py:probe
//   out (32, N) = n_dots * v^T w in bf16 with an f32 accumulator, v (K, 32)
//   and w (K, N) bf16; `grid` blocks each compute and store the same tile,
//   as each of the TPU's 912 grid steps writes the same block. Two forms:
//   `mma_probe_bf16` on warpgroup products (wgmma), `mma_probe_sync_bf16`
//   on mma.sync, the instruction K4 uses; the two rates side by side are
//   what K4's choice between them rests on.
//
// What bounds them, and what the designs do:
// - K12a: the band issues ncand^2 multiply-adds a (c, n, rep), 5.4 GFLOP
//   at C 512, N 36 864 (81 us at the 67 TFLOP/s of f32 outside the tensor
//   cores), where u and out move about 154 MB (46 us at 3.35 TB/s). Its
//   first design (a thread an n and 8 channels) loaded every operand of
//   every multiply-add again through L1, a load ceiling about 4x below the
//   FMA rate. Now register tiles: a thread owns 4 consecutive n and 8
//   channels, holds each band row's segment of 4 + ncand - 1 values a
//   channel in registers for all reps (staged a row at a time by cp.async,
//   16 bytes a copy where u's rows are whole float4s), and computes a rep's
//   ncand^2 weights of an n once for its 8 channels. A rep is 128
//   multiply-adds and about 40 other instructions a thread (weights, loop).
//   It is bound by the issue of that stream: each multiply-add reads two
//   registers that change from one to the next (a segment value and an
//   accumulator; the weight is reused), and the register-bank conflicts
//   that brings hold it near half the FMA rate. The method stays the band:
//   no sum is folded across reps.
// - K12b: the function needs u and out once (154 MB at C 512, N 36 864:
//   46 us), but the method gathers four corners a (c, n, rep): 2.72 GB of
//   f32 reads, 82 us at 128 bytes a clock an SM from shared memory at
//   1980 MHz, the method's floor. Its first design (a thread an n, 8
//   channels, scalar __ldg) spent L1 wavefronts on lines its lanes'
//   jittered corners split. Now a block walks a strip of 64 columns down the
//   rows of width Wp, for 32 channels, and keeps the ncand band rows of the
//   row it computes in a ring of ncand + 1 staged rows, each staged once
//   while the row before is computed. The rows are channel-minor: a staged
//   column holds its 32 channels in 128 bytes, so each corner's channels are
//   one 128-byte wavefront whatever the column, read as 16 bytes (4
//   channels) a lane by 8 lanes. The 16-byte chunk q of column s lies at
//   chunk q ^ (s & 7): the staging's 4-byte cp.async copies (8 columns x 4
//   channels a warp, 32-byte runs of u) then fall on 32 banks. Each (n, rep)
//   of a row has its index computed once, by one thread, into a rep table
//   (ring columns and fraction); a thread owns 4 consecutive n and 4
//   channels, and where its 4 n's corners are all staged it gathers them in
//   one straight run. A corner outside the staged rows (a tap that leaves
//   the band, or the clamp) is read from u. The rep loop runs near the
//   floor; the per-row work around it (staging, stores, the table and the
//   barriers) does not overlap with it (PERF.md, section 6). Kept: four
//   gathered corner reads a (c, n, rep). The reps stand for the nine kernel
//   taps of K4's DCNv2, whose corners differ; the reps here differ only by
//   r * 1e-6, and a design that read a corner once for all reps would
//   measure that artefact, not K4's sampler.
// - K12c: bound by tensor-core operations (989 TFLOP/s bf16 dense). The
//   wgmma form: M = 32 is below wgmma's 64 rows. Of computing out^T = w^T v
//   (m64n32k16 tiles along N) and stacking v^T to 64 rows (one m64nNk16
//   carries two dots), it takes the stack: an m64n32k16 reads 3 KB of
//   operands from shared memory for 16 clocks of tensor work (192 bytes a
//   clock, where shared memory gives 128), an m64n256k16 10 KB for 128
//   clocks (80). v^T is M-major and w N-major, both read by wgmma from
//   shared memory through the transpose bits: w in the 128-byte swizzle
//   (64 columns a swizzle atom, as TMA boxes of 64 columns write it), v in
//   the 64-byte swizzle (its rows are 32 values, 64 bytes), staged twice so
//   that rows 32-63 of A repeat rows 0-31; an odd n_dots' last dot points A's
//   second half at a tile of zeros. Rows 32-63 of the sum are added onto
//   rows 0-31 before the store. Where the K tiles fit in shared memory they
//   are loaded once by TMA; otherwise they stream through a ring of
//   MMA_STAGES stages fed by a producer warp's TMA, one mbarrier pair a
//   stage. The streamed tiles' loads can be shared by a cluster of 2 or 4
//   blocks (TMA multicast: each L2 read of a tile serves the cluster); on
//   the H100 both were slower than single blocks, whose tiles all hit L2
//   (PERF.md, section 6), so the wrapper's default is 1. A wgmma group is a
//   tile's products with no branch between them (a branch there makes ptxas
//   wait for each product). No product is hoisted or folded: every pass
//   over K issues its own wgmmas on operands read for it from shared
//   memory, so the time grows with n_dots. The mma.sync form: 8 warps (2 along D x 4 along N)
//   run m16n8k16 from shared memory, fed by ldmatrix.trans (rows padded by
//   16 bytes); each dot reloads its fragments; resident where v and w fit,
//   else 64-row K tiles through two cp.async stages for every dot.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float tent(float z) { return fmaxf(0.f, 1.f - fabsf(z)); }

// dy + r * 1e-6 with the offset rounded to f32 first, as JAX adds a Python
// float to an f32 array
__device__ __forceinline__ float rep_dy(float dy, int r) {
  return dy + __double2float_rn((double)r * 1e-6);
}

// K12a's tile, picked on the card: a thread owns TENT_RN consecutive n and
// TENT_CC channels; a block is TENT_TX threads along n (a warp) by TENT_TY
// along the channels. `tent_band_tiled` in ops/probes.py mirrors the index
// arithmetic below on the CPU.
#define TENT_RN 4
#define TENT_CC 8
#define TENT_TX 32
#define TENT_TY 2
constexpr int TENT_THREADS = TENT_TX * TENT_TY;
constexpr int TENT_TN = TENT_TX * TENT_RN;  // n a block
constexpr int TENT_TC = TENT_TY * TENT_CC;  // channels a block
static_assert(TENT_RN % 4 == 0, "a thread reads its band segments as float4");

// float4s a thread reads of a staged row: its TENT_RN + ncand - 1 band
// columns, which start up to 3 columns into the first float4 where a row is
// staged from the float4 at or below its first column (VEC); and a staged
// row's pitch, where the last thread's reads end
__host__ __device__ constexpr int tent_reads(int ncand, bool vec) {
  return (TENT_RN + ncand - 1 + (vec ? 3 : 0) + 3) / 4;
}
__host__ __device__ constexpr int tent_pitch(int ncand, bool vec) {
  return (TENT_TX - 1) * TENT_RN + 4 * tent_reads(ncand, vec);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4 bytes global -> shared, zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
// 16 bytes global -> shared, zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async16z(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's band segments of one staged row: SPAN values a channel from
// column SH of its A float4s (SH, the row's offset into its first float4,
// is a template argument so that the picks are register names)
template <int SH, int A, int SPAN, int PITCH>
__device__ __forceinline__ void tent_segments(const float* rows, float (&seg)[TENT_CC][SPAN]) {
#pragma unroll
  for (int k = 0; k < TENT_CC; ++k) {
    float raw[4 * A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float4 f = *reinterpret_cast<const float4*>(rows + k * PITCH + 4 * a);
      raw[4 * a] = f.x;
      raw[4 * a + 1] = f.y;
      raw[4 * a + 2] = f.z;
      raw[4 * a + 3] = f.w;
    }
#pragma unroll
    for (int v = 0; v < SPAN; ++v) seg[k][v] = raw[SH + v];
  }
}

// A block: TENT_TC channels x TENT_TN n. For each band row j it stages
// u[c, lo + j*Wp + n0 + t], t < TENT_TN + ncand - 1, of its channels in
// shared memory (cp.async, two slots: row j + 1 loads while row j is used):
// with VEC (u 16-byte aligned, its row length a multiple of 4) in 16-byte
// copies from the float4 at or below the row's first column, else in
// 4-byte copies from that column. A thread copies its TENT_CC rows'
// segments of TENT_RN + ncand - 1 values into registers, where they serve
// every rep: per rep it computes the ncand weights wy_j * wx_l of each of
// its n once and issues the TENT_RN * ncand multiply-adds of each channel
// from registers.
template <int NCAND, bool VEC>
__global__ void __launch_bounds__(TENT_THREADS)
    tent_band_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ dx, float* __restrict__ out, int C, int N, int Wp,
                     int reps) {
  constexpr int lo = (NCAND - 1) / 2;
  constexpr int W = TENT_TN + NCAND - 1;  // band columns of a block's row
  constexpr int SPAN = TENT_RN + NCAND - 1;  // band columns of a thread's
  constexpr int A = tent_reads(NCAND, VEC);
  constexpr int PITCH = tent_pitch(NCAND, VEC);
  __shared__ __align__(16) float sm[2][TENT_TC * PITCH];
  const int tid = threadIdx.x, tx = tid % TENT_TX, ty = tid / TENT_TX;
  const int n0 = blockIdx.x * TENT_TN, c0 = blockIdx.y * TENT_TC;
  const long NW = (long)N + (long)NCAND * Wp;

  auto stage = [&](int j, float* slot) {
    const long col0 = lo + (long)j * Wp + n0;
    if constexpr (VEC) {
      constexpr int NV = PITCH / 4;  // float4s of a staged row
      const long cola = col0 & ~3L;
      for (int e = tid; e < TENT_TC * NV; e += TENT_THREADS) {
        const int cl = e / NV, v = e - cl * NV;
        const long col = cola + 4 * v;
        const bool ok = c0 + cl < C && col < NW;
        cp_async16z(smem_addr(slot + cl * PITCH + 4 * v),
                    u + (ok ? (long)(c0 + cl) * NW + col : 0), ok);
      }
    } else {
      for (int e = tid; e < TENT_TC * W; e += TENT_THREADS) {
        const int cl = e / W, t = e - cl * W;
        const long col = col0 + t;
        const bool ok = c0 + cl < C && col < NW;
        cp_async4(smem_addr(slot + cl * PITCH + t), u + (ok ? (long)(c0 + cl) * NW + col : 0),
                  ok);
      }
    }
    cp_async_commit();
  };

  const int nb = n0 + tx * TENT_RN;
  float dyn[TENT_RN], wx[TENT_RN][NCAND];
#pragma unroll
  for (int i = 0; i < TENT_RN; ++i) {
    const bool in = nb + i < N;
    const float dxn = in ? dx[nb + i] : 0.f;
    dyn[i] = in ? dy[nb + i] : 0.f;
#pragma unroll
    for (int l = 0; l < NCAND; ++l) wx[i][l] = tent(dxn - (float)(l - lo));
  }
  float acc[TENT_CC][TENT_RN];
#pragma unroll
  for (int k = 0; k < TENT_CC; ++k)
#pragma unroll
    for (int i = 0; i < TENT_RN; ++i) acc[k][i] = 0.f;

  stage(0, sm[0]);
#pragma unroll 1
  for (int j = 0; j < NCAND; ++j) {
    if (j + 1 < NCAND) {
      stage(j + 1, sm[(j + 1) & 1]);
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    float seg[TENT_CC][SPAN];
    const float* rows = sm[j & 1] + ty * TENT_CC * PITCH + tx * TENT_RN;
    if constexpr (VEC) {
      // the row's first column within its float4 (n0 is a multiple of 4)
      switch ((int)((lo + (long)j * Wp) & 3)) {
        case 0: tent_segments<0, A, SPAN, PITCH>(rows, seg); break;
        case 1: tent_segments<1, A, SPAN, PITCH>(rows, seg); break;
        case 2: tent_segments<2, A, SPAN, PITCH>(rows, seg); break;
        default: tent_segments<3, A, SPAN, PITCH>(rows, seg); break;
      }
    } else {
      tent_segments<0, A, SPAN, PITCH>(rows, seg);
    }
    __syncthreads();  // the slot is free for row j + 2
    const float jy = (float)(j - lo);
    // three reps a pass: the next rep's weights overlap this one's
    // multiply-adds (picked on the card against 1, 2, 4 and 9)
#pragma unroll 3
    for (int r = 0; r < reps; ++r) {
      float w[TENT_RN][NCAND];
#pragma unroll
      for (int i = 0; i < TENT_RN; ++i) {
        const float wy = tent(rep_dy(dyn[i], r) - jy);
#pragma unroll
        for (int l = 0; l < NCAND; ++l) w[i][l] = wy * wx[i][l];
      }
#pragma unroll
      for (int k = 0; k < TENT_CC; ++k)
#pragma unroll
        for (int i = 0; i < TENT_RN; ++i)
#pragma unroll
          for (int l = 0; l < NCAND; ++l) acc[k][i] = fmaf(w[i][l], seg[k][i + l], acc[k][i]);
    }
  }

  // one float a store: float4 stores would tie each channel's accumulators
  // to an aligned register quad, and the register-bank conflicts of the
  // multiply-adds that follows cost more than the stores save
#pragma unroll
  for (int k = 0; k < TENT_CC; ++k) {
    if (c0 + ty * TENT_CC + k >= C) break;
    float* o = out + (long)(c0 + ty * TENT_CC + k) * N + nb;
#pragma unroll
    for (int i = 0; i < TENT_RN; ++i)
      if (nb + i < N) o[i] = acc[k][i];
  }
}

// K12b's tile: a thread owns GATHER_RN consecutive n and GATHER_CH / 32
// quads of 4 channels (q, q + 8, ... of a column's chunks); a warp is 8
// lanes along the quads by 4 n slots; a block is GATHER_WARPS warps along
// n, GATHER_CH channels; its rep table holds GATHER_RC reps at a time.
// `corner_gather_tiled` in ops/probes.py mirrors the index arithmetic below
// on the CPU.
#define GATHER_RN 4
#define GATHER_CH 32
#define GATHER_WARPS 4
#define GATHER_RC 16
constexpr int GATHER_THREADS = 32 * GATHER_WARPS;
constexpr int GATHER_CHUNKS = GATHER_CH / 4;                        // 16-byte chunks a column
constexpr int GATHER_HALVES = GATHER_CH / 32;                       // chunks a thread
constexpr int GATHER_SLOTS = 4;                                     // n slots a warp
constexpr int GATHER_TN = GATHER_WARPS * GATHER_SLOTS * GATHER_RN;  // n a block row
constexpr int GATHER_CC = 4 * GATHER_HALVES;                        // channels a thread
static_assert(GATHER_CH % 32 == 0, "8 lanes read a column's chunks");

// staged columns a row: the strip's n and the ncand - 1 that follow,
// rounded up to 8 so that a column of another row keeps its swizzle
__host__ __device__ constexpr int gather_pitch(int ncand) {
  return (GATHER_TN + ncand - 1 + 7) / 8 * 8;
}
// shared memory: the ring of ncand + 1 staged rows, the rep table, and dy
// and dx of two rows
__host__ __device__ constexpr int gather_smem(int ncand) {
  return ((ncand + 1) * gather_pitch(ncand) * GATHER_CH + 2 * GATHER_RC * GATHER_TN +
          4 * GATHER_TN) * 4;
}
// the float offset of channel chunk h of staged column s: the low 3 bits of
// the chunk XOR those of s, so that 8 lanes reading one column's 8 chunks,
// or copying 8 columns of one chunk, fall on 32 banks
__device__ __forceinline__ int gather_at(int s, int h) {
  return s * GATHER_CH + 4 * (h ^ (s & 7));
}

// A block: GATHER_CH channels of a strip of GATHER_TN columns x0 .. of the
// rows of width Wp (n = y Wp + x), rows y0 .. y0 + rows - 1. The n of row y
// read band rows y .. y + ncand - 1: u[c, (y + J) Wp + x0 + lo + t] for
// t < GATHER_TN + ncand - 1. Those rows live in a ring of R = ncand + 1
// slots of shared memory (row z in slot z mod R, column t of slot z at s =
// slot * pitch + t; zero past the array or past C): each is staged once, by
// 4-byte cp.async, while the row before the first row that reads it is
// computed, together with dy and dx of that row. For each (n, rep) of the
// row one thread computes the index once, into the rep table: the ring
// columns s0 and s1 of the corner pair's rows (-1 where a corner leaves the
// ring) and the fraction fy. Each thread then gathers its n's corners,
// GATHER_CC channels a corner, from the ring, or from u where the table
// says -1, and adds them with the weights of fy and its n's fx.
__global__ void __launch_bounds__(GATHER_THREADS)
    corner_gather_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                         const float* __restrict__ dx, float* __restrict__ out, int C, int N,
                         int Wp, int ncand, int reps, int rows) {
  extern __shared__ __align__(16) float gs[];
  const int lo = (ncand - 1) / 2, seg = GATHER_TN + ncand - 1, pitch = gather_pitch(ncand);
  const int R = ncand + 1;  // ring slots
  int2* const tab = reinterpret_cast<int2*>(gs + R * pitch * GATHER_CH);
  // dy and dx of row y at dyx + (y & 1) * 2 TN
  float* const dyx = gs + R * pitch * GATHER_CH + 2 * GATHER_RC * GATHER_TN;
  const int x0 = blockIdx.x * GATHER_TN, y0 = blockIdx.y * rows, c0 = blockIdx.z * GATHER_CH;
  const int NW = N + ncand * Wp;  // the launcher keeps it below 2^31
  const int y1 = min(y0 + rows, (N + Wp - 1) / Wp);
  const int tid = threadIdx.x;

  // row z: a warp copies 8 columns (lane & 7) of 4 channels ((lane >> 3) &
  // 3) of one chunk: 32-byte runs of u, 4 bytes a copy; with it dy and dx of
  // row yn = z - ncand + 1, the first that needs all of its rows (zero past
  // the row or N), where it is one of the block's; then commits the group
  const int tl = tid & 7, tk = (tid >> 3) & 3;
  auto stage = [&](int z) {
    const int yn = z - ncand + 1;
    const int slot = z % R;
    for (int h = tid >> 5; h < GATHER_CHUNKS; h += GATHER_WARPS) {
      const int c = c0 + 4 * h + tk;
      const float* uc = u + (long)min(c, C - 1) * NW;
      for (int t = tl; t < seg; t += 8) {
        const int col = z * Wp + x0 + lo + t, s = slot * pitch + t;
        const bool ok = c < C && col < NW;
        cp_async4(smem_addr(gs + gather_at(s, h) + tk), uc + (ok ? col : 0), ok);
      }
    }
    if (yn >= y0 && yn < y1) {
      for (int e = tid; e < 2 * GATHER_TN; e += GATHER_THREADS) {
        const int xi = e % GATHER_TN, n = yn * Wp + x0 + xi;
        const bool ok = x0 + xi < Wp && n < N;
        cp_async4(smem_addr(dyx + (yn & 1) * 2 * GATHER_TN + e),
                  (e < GATHER_TN ? dy : dx) + (ok ? n : 0), ok);
      }
    }
    cp_async_commit();
  };
  for (int z = y0; z < y0 + ncand; ++z) stage(z);

  const int warp = tid >> 5, lane = tid & 31;
  const int q = lane & 7;
  const int xl = (warp * GATHER_SLOTS + (lane >> 3)) * GATHER_RN;  // the thread's first x - x0
  const long top = NW - Wp - 2;                                     // the clamp's top
  for (int y = y0; y < y1; ++y) {
    // row y + 1's last band row, into the slot of row y - 1
    stage(y + ncand);
    cp_async_wait_prior();
    __syncthreads();  // the rows of y, its dy and dx
    const float* const dyxy = dyx + (y & 1) * 2 * GATHER_TN;  // dy of row y, then dx
    const int nb = y * Wp + x0 + xl;
    float dyn[GATHER_RN], dxn[GATHER_RN], fx[GATHER_RN];
#pragma unroll
    for (int i = 0; i < GATHER_RN; ++i) {
      dyn[i] = dyxy[xl + i];
      dxn[i] = dyxy[GATHER_TN + xl + i];
      fx[i] = dxn[i] - floorf(dxn[i]);
    }
    float acc[GATHER_RN][GATHER_CC];
#pragma unroll
    for (int i = 0; i < GATHER_RN; ++i)
#pragma unroll
      for (int k = 0; k < GATHER_CC; ++k) acc[i][k] = 0.f;

    for (int r0 = 0; r0 < reps; r0 += GATHER_RC) {
      const int rc = min(GATHER_RC, reps - r0);
      // the rep table of reps r0 .. r0 + rc - 1: entry (r - r0) * TN + x - x0
      for (int e = tid; e < rc * GATHER_TN; e += GATHER_THREADS) {
        const int xi = e % GATHER_TN, n = y * Wp + x0 + xi;
        const float dyr = rep_dy(dyxy[xi], r0 + e / GATHER_TN);
        long idx = (long)n + (long)floorf(dyxy[GATHER_TN + xi]) + 2 * lo +
                   ((long)__float2ll_rd(dyr) + lo) * Wp;
        idx = idx < 0 ? 0 : idx > top ? top : idx;
        // the corner's band row (saturated: only 0 .. ncand - 2 is staged)
        // and its column in the staged row, valid where J is staged
        const int J = (int)((unsigned)__float2int_rd(dyr) + lo);
        const unsigned t =
            (unsigned)idx - (unsigned)(y + J) * (unsigned)Wp - (unsigned)(x0 + lo);
        int ring = -1;
        if ((unsigned)J < (unsigned)(ncand - 1) && t < (unsigned)(seg - 1)) {
          const int s0 = (y + J) % R, s1 = s0 + 1 == R ? 0 : s0 + 1;
          ring = (s0 * pitch + (int)t) | ((s1 * pitch + (int)t) << 16);
        }
        tab[e] = make_int2(ring, __float_as_int(dyr - floorf(dyr)));
      }
      __syncthreads();  // the table

      // an n's corners from the ring (GATHER_CC channels a corner: 16-byte
      // reads of chunks q, q + 8, ...) or from u, and their multiply-adds, in
      // the order of the plain version
      auto corners = [&](int i, int2 ent, int r, bool staged) {
        const float fy = __int_as_float(ent.y);
        const float w00 = (1.f - fy) * (1.f - fx[i]), w01 = (1.f - fy) * fx[i];
        const float w10 = fy * (1.f - fx[i]), w11 = fy * fx[i];
        float c4[4][GATHER_CC];  // the corners (J, +0), (J, +1), (J + 1, +0), (J + 1, +1)
        if (staged) {
          const int s0 = ent.x & 0xFFFF, s1 = ent.x >> 16;
          const int at[4] = {gather_at(s0, q), gather_at(s0 + 1, q), gather_at(s1, q),
                             gather_at(s1 + 1, q)};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int hh = 0; hh < GATHER_HALVES; ++hh) {
              const float4 a = *reinterpret_cast<const float4*>(gs + at[e] + 32 * hh);
              c4[e][4 * hh] = a.x, c4[e][4 * hh + 1] = a.y;
              c4[e][4 * hh + 2] = a.z, c4[e][4 * hh + 3] = a.w;
            }
        } else {
          const float dyr = rep_dy(dyn[i], r);
          long idx = (long)(nb + i) + (long)floorf(dxn[i]) + 2 * lo +
                     ((long)__float2ll_rd(dyr) + lo) * Wp;
          idx = idx < 0 ? 0 : idx > top ? top : idx;
#pragma unroll
          for (int k = 0; k < GATHER_CC; ++k) {
            const int c = c0 + 4 * q + (k & 3) + 32 * (k >> 2);
            const float* row = u + (long)min(c, C - 1) * NW + idx;
            const bool ok = c < C;
            c4[0][k] = ok ? __ldg(row) : 0.f;
            c4[1][k] = ok ? __ldg(row + 1) : 0.f;
            c4[2][k] = ok ? __ldg(row + Wp) : 0.f;
            c4[3][k] = ok ? __ldg(row + Wp + 1) : 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < GATHER_CC; ++k) {
          float v = acc[i][k];
          v = fmaf(w00, c4[0][k], v);
          v = fmaf(w01, c4[1][k], v);
          v = fmaf(w10, c4[2][k], v);
          v = fmaf(w11, c4[3][k], v);
          acc[i][k] = v;
        }
      };
      for (int r = 0; r < rc; ++r) {
        int2 ent[GATHER_RN];
        bool all = true;
#pragma unroll
        for (int i = 0; i < GATHER_RN; ++i) {
          ent[i] = tab[r * GATHER_TN + xl + i];
          all = all && ent[i].x >= 0;
        }
        // where all of the thread's n are staged (the rule), one straight
        // run: the gathers of its n overlap
        if (all) {
#pragma unroll
          for (int i = 0; i < GATHER_RN; ++i) corners(i, ent[i], r0 + r, true);
        } else {
#pragma unroll
          for (int i = 0; i < GATHER_RN; ++i) corners(i, ent[i], r0 + r, ent[i].x >= 0);
        }
      }
      __syncthreads();  // the table is free; after the last reps, row y's slot too
    }

    // 16 bytes a channel where the thread's 4 n are whole and aligned: the 4
    // slots of a quad write 64 contiguous bytes
    const bool vec = GATHER_RN == 4 && (N | Wp) % 4 == 0 && x0 + xl + GATHER_RN <= Wp &&
                     nb + GATHER_RN <= N;
#pragma unroll
    for (int k = 0; k < GATHER_CC; ++k) {
      const int c = c0 + 4 * q + (k & 3) + 32 * (k >> 2);
      if (c >= C) continue;
      float* o = out + (long)c * N + nb;
      if (vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[0][k], acc[1 % GATHER_RN][k], acc[2 % GATHER_RN][k],
                        acc[3 % GATHER_RN][k]);
      } else {
#pragma unroll
        for (int i = 0; i < GATHER_RN; ++i)
          if (x0 + xl + i < Wp && nb + i < N) o[i] = acc[i][k];
      }
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// K12c, the mma.sync form
// ---------------------------------------------------------------------------

constexpr int MMA_D = 32;
constexpr int MMA_THREADS = 256;  // 8 warps: 2 along D (m16) x 4 along N
constexpr int KT = 64;            // rows of a streamed K tile
constexpr int VS = MMA_D + 8;     // padded row of a v tile, in bf16
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int w_stride(int N) { return N + 8; }

__host__ __device__ constexpr long stage_bytes(int rows, int N) {
  return (long)rows * (VS + w_stride(N)) * 2;
}

// NT n8 tiles a warp (N = 32 * NT); RESIDENT: v and w loaded once, else
// streamed as KT-row tiles through two stages for every dot.
template <int NT, bool RESIDENT>
__global__ void __launch_bounds__(MMA_THREADS)
    mma_probe_sync_kernel(const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int K, int n_dots) {
  constexpr int N = 32 * NT;
  constexpr int WS = w_stride(N);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * 16;
  const int nbase = (warp >> 1) * NT * 8;
  const int rows = RESIDENT ? K : KT;
  const long stage = stage_bytes(rows, N) / 2;  // in bf16

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  __nv_bfloat16* s0 = reinterpret_cast<__nv_bfloat16*>(smem);
  auto load = [&](__nv_bfloat16* sv, int k0) {
    __nv_bfloat16* sw = sv + rows * VS;
    for (int i = threadIdx.x; i < rows * (MMA_D / 8); i += MMA_THREADS) {
      const int r = i / (MMA_D / 8), ch = i % (MMA_D / 8);
      cp_async16(smem_addr(sv + r * VS + ch * 8), v + (long)(k0 + r) * MMA_D + ch * 8);
    }
    for (int i = threadIdx.x; i < rows * (N / 8); i += MMA_THREADS) {
      const int r = i / (N / 8), ch = i % (N / 8);
      cp_async16(smem_addr(sw + r * WS + ch * 8), w + (long)(k0 + r) * N + ch * 8);
    }
    cp_async_commit();
  };
  // one pass over `rows` rows of K: every k16 step reloads its fragments
  auto dot = [&](const __nv_bfloat16* sv) {
    const __nv_bfloat16* sw = sv + rows * VS;
    const int i = lane >> 3, r = lane & 7;
    for (int k = 0; k < rows; k += 16) {
      uint32_t a[4];
      ldsm_x4_t(smem_addr(sv + (k + r + (i >> 1) * 8) * VS + m0 + (i & 1) * 8), a);
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t b[4];
        ldsm_x4_t(smem_addr(sw + (k + r + (i & 1) * 8) * WS + nbase + t * 8 + (i >> 1) * 8), b);
        mma16816(acc[t], a, b[0], b[1]);
        mma16816(acc[t + 1], a, b[2], b[3]);
      }
    }
  };

  if (RESIDENT) {
    load(s0, 0);
    cp_async_wait_all();
    __syncthreads();
    for (int d = 0; d < n_dots; ++d) dot(s0);
  } else {
    const int tiles_a_dot = K / KT;
    const int total = n_dots * tiles_a_dot;
    load(s0, 0);
    for (int t = 0; t < total; ++t) {
      if (t + 1 < total)
        load(s0 + ((t + 1) & 1) * stage, ((t + 1) % tiles_a_dot) * KT);
      else
        cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
      dot(s0 + (t & 1) * stage);
      __syncthreads();
    }
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = nbase + t * 8 + 2 * q;
    *reinterpret_cast<__nv_bfloat162*>(out + (long)(m0 + g) * N + col) =
        __floats2bfloat162_rn(acc[t][0], acc[t][1]);
    *reinterpret_cast<__nv_bfloat162*>(out + (long)(m0 + g + 8) * N + col) =
        __floats2bfloat162_rn(acc[t][2], acc[t][3]);
  }
}

long mma_sync_smem(int K, int N, bool* resident) {
  const long whole = stage_bytes(K, N);
  *resident = whole <= SMEM_LIMIT;
  return *resident ? whole : 2 * stage_bytes(KT, N);
}

template <int NT>
int launch_mma_sync(const void* v, const void* w, void* out, int K, int n_dots, int grid,
                  void* stream) {
  bool resident;
  const long smem = mma_sync_smem(K, 32 * NT, &resident);
  if (!resident && K % KT != 0) return (int)cudaErrorInvalidValue;
  auto kernel = resident ? mma_probe_sync_kernel<NT, true> : mma_probe_sync_kernel<NT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, K, n_dots);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K12c, the wgmma form
// ---------------------------------------------------------------------------

// Rows of a K tile (at most; K below it makes one tile of K rows) and
// stages of the streamed ring. A tile holds two copies of v's rows (64-byte
// swizzle, 64 bytes a row each) and w's rows as N / 64 boxes of 64 columns
// (128-byte swizzle, 128 bytes a row each). `wgmma_plan` in ops/probes.py
// mirrors this layout on the CPU.
#define MMA_KT 64
#define MMA_STAGES 4
#define MMA_SMEM_DATA 230400  // 227 KB less room for the alignment and the barriers
constexpr int WG_THREADS = 160;  // a consumer warpgroup and a producer warp
__host__ __device__ constexpr int wg_tile_bytes(int rows, int NB) { return rows * 128 * (1 + NB); }

// bytes of the tiles where K fits in shared memory (all of its tiles and a
// zero tile), else of the ring and the zero tile; tiles of `rows` rows. At
// least the epilogue's exchange of rows 32-63 (8 KB for each 64 columns).
long wg_smem(int K, int NB, int rows, bool* resident) {
  const long tiles = (K + rows - 1) / rows;
  const long whole = (tiles * wg_tile_bytes(rows, NB)) + rows * 64;
  *resident = whole <= MMA_SMEM_DATA;
  const long data = *resident ? whole : (long)MMA_STAGES * wg_tile_bytes(rows, NB) + rows * 64;
  return data > 8192L * NB ? data : 8192L * NB;
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1: 128-byte, 2: 64-byte). For an
// MN-major operand the leading offset steps from one swizzle atom to the
// next along M or N, the stride offset from 8 rows of K to the next 8.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}
constexpr uint32_t SW128 = 1, SW64 = 2;

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_ACC16(d, i) WG_ACC4(d, i), WG_ACC4(d, i + 4), WG_ACC4(d, i + 8), WG_ACC4(d, i + 12)

// d (64 x 64 NB, f32) += A (64 x 16) B (16 x 64 NB), both bf16 from shared
// memory, both MN-major (transpose bits 1)
template <int NB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32 * NB], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<1>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_ACC16(d, 0), WG_ACC16(d, 16)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<2>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : WG_ACC16(d, 0), WG_ACC16(d, 16), WG_ACC16(d, 32), WG_ACC16(d, 48)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<3>(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
      : WG_ACC16(d, 0), WG_ACC16(d, 16), WG_ACC16(d, 32), WG_ACC16(d, 48), WG_ACC16(d, 64), WG_ACC16(d, 80)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<4>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123,"
        "%124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : WG_ACC16(d, 0), WG_ACC16(d, 16), WG_ACC16(d, 32), WG_ACC16(d, 48), WG_ACC16(d, 64), WG_ACC16(d, 80), WG_ACC16(d, 96), WG_ACC16(d, 112)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one arrival on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// a TMA box at column c0, row c1 of `map` into shared memory at `dst`, its
// bytes counted on `bar`; multicast to the blocks of `mask` (at the same
// offsets) where the cluster has more than one
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar, uint16_t mask, bool multicast) {
  if (multicast)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// NB 64-column boxes of w (N = 64 NB), K tiles of 16 STEPS rows (rows of
// the last tile past K read as zero). RESIDENT: every K tile is loaded
// once, into its own slot; else K tiles stream through MMA_STAGES slots for
// every pass, the producer warp's TMA multicast over the cluster. A pass is
// two dots: one m64nNk16 a 16 rows of K, rows 0-31 and 32-63 of A both v^T
// (an odd n_dots' last pass: rows 32-63 read the zero tile). The products
// of a tile are issued without a branch between them: a branch inside a
// group makes ptxas wait for each product before the next.
template <int NB, int STEPS, bool RESIDENT>
__global__ void __launch_bounds__(WG_THREADS, 2)
    mma_probe_wgmma_kernel(const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tw,
                           __nv_bfloat16* __restrict__ out, int K, int n_dots) {
  constexpr int N = 64 * NB;
  constexpr int ACC = 32 * NB;  // f32 accumulators a thread
  constexpr int ROWS = 16 * STEPS;
  constexpr uint32_t VTILE = ROWS * 64, WBOX = ROWS * 128;  // a copy of v, a box of w
  constexpr uint32_t TILE = wg_tile_bytes(ROWS, NB);
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full[MMA_STAGES], empty[MMA_STAGES];
  // the swizzles repeat every 1024 bytes: the tiles start on such a boundary
  const uint32_t raw = smem_addr(wg_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = wg_raw + (base - raw);
  const int tiles = (K + ROWS - 1) / ROWS;
  const int passes = (n_dots + 1) / 2;
  const int total = passes * tiles;
  const uint32_t zero = base + (RESIDENT ? tiles : MMA_STAGES) * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t cs = RESIDENT ? 1 : cluster_size();
  const uint32_t rank = RESIDENT ? 0 : cluster_rank();

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < MMA_STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 4 * cs);  // each consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < (int)VTILE / 16; i += WG_THREADS)
    reinterpret_cast<float4*>(gbase + (zero - base))[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the zeros are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (RESIDENT)
    __syncthreads();
  else
    cluster_sync();  // every block's barriers exist before a multicast lands

  if (warp == 4) {
    // the producer: one thread issues the TMA loads
    if (lane == 0) {
      // boxes of a tile: v twice, then w's NB boxes; box b is loaded by the
      // block of rank b % cs, for all of the cluster
      auto load = [&](uint32_t slot, int t, uint32_t bar) {
        for (int b = rank; b < 2 + NB; b += cs) {
          const bool isv = b < 2;
          tma_load(slot + (isv ? b * VTILE : 2 * VTILE + (b - 2) * WBOX), isv ? &tv : &tw,
                   isv ? 0 : 64 * (b - 2), t * ROWS, bar,
                   (uint16_t)((1u << cs) - 1), cs > 1);
        }
      };
      if (RESIDENT) {
        mbar_expect_tx(smem_addr(&full[0]), tiles * TILE);
        for (int t = 0; t < tiles; ++t) load(base + t * TILE, t, smem_addr(&full[0]));
      } else {
        for (int i = 0; i < total; ++i) {
          const int s = i % MMA_STAGES;
          // the slot's last tile released by every consumer warp of the cluster
          if (i >= MMA_STAGES) mbar_wait(smem_addr(&empty[s]), ((i / MMA_STAGES) & 1) ^ 1);
          mbar_expect_tx(smem_addr(&full[s]), TILE);
          load(base + s * TILE, i % tiles, smem_addr(&full[s]));
        }
      }
    }
    __syncwarp();
  } else {
    float acc[ACC];
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
    wg_fence_acc(acc);
    if (RESIDENT) mbar_wait(smem_addr(&full[0]), 0);
    for (int i = 0; i < total; ++i) {
      const int s = RESIDENT ? i % tiles : i % MMA_STAGES;
      if (!RESIDENT) mbar_wait(smem_addr(&full[s]), (i / MMA_STAGES) & 1);
      const bool odd = (n_dots & 1) && i / tiles == passes - 1;
      const uint32_t slot = base + s * TILE;
      // A: v's two copies (64-byte swizzle: atoms of 32 rows of A, 8 rows
      // of K in 512 bytes), or v and the zero tile; B: w's boxes (128-byte
      // swizzle: atoms of 64 columns, 8 rows of K in 1024 bytes)
      const uint32_t lbo_a = odd ? zero - slot : VTILE;
      wg_fence();
#pragma unroll
      for (int k = 0; k < STEPS; ++k)
        wgmma_ss<NB>(acc, wg_desc(slot + 1024 * k, lbo_a, 512, SW64),
                     wg_desc(slot + 2 * VTILE + 2048 * k, WBOX, 1024, SW128));
      wg_commit();
      // the products of tile i - 1 are done: its slot is released to every
      // block of the cluster (their producers refill it for all)
      wg_wait<1>();
      if (!RESIDENT && i > 0 && lane == 0)
        for (uint32_t c = 0; c < cs; ++c)
          mbar_arrive_cluster(smem_addr(&empty[(i - 1) % MMA_STAGES]), c);
    }
    wg_wait<0>();
    wg_fence_acc(acc);

    // rows 32-63 (warps 2, 3) hold the second dot of each pass: added onto
    // rows 0-31 (warps 0, 1, the same lanes) through shared memory, which
    // no load writes any more
    float* red = reinterpret_cast<float*>(gbase);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (warp >= 2) {
#pragma unroll
      for (int j = 0; j < ACC; ++j) red[((warp - 2) * ACC + j) * 32 + lane] = acc[j];
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (warp < 2) {
      const int g = lane >> 2, q = lane & 3;
      const int row = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = acc[4 * j + e] + red[(warp * ACC + 4 * j + e) * 32 + lane];
        const int col = 8 * j + 2 * q;
        *reinterpret_cast<__nv_bfloat162*>(out + (long)row * N + col) =
            __floats2bfloat162_rn(a[0], a[1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (long)(row + 8) * N + col) =
            __floats2bfloat162_rn(a[2], a[3]);
      }
    }
  }
  // no block leaves while a peer may still arrive on its barriers
  if (!RESIDENT) cluster_sync();
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// a 2-D bf16 map of `rows` x `cols` (row-major), boxes of `box_rows` rows
// x `box` columns; rows past the array read as zero
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box, int box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int STEPS>
int launch_mma_wgmma(const void* v, const void* w, void* out, int K, int n_dots, int grid,
                     int cluster, void* stream) {
  CUtensorMap tv, tw;
  if (!make_map(&tv, v, K, MMA_D, MMA_D, 16 * STEPS, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&tw, w, K, 64 * NB, 64, 16 * STEPS, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  bool resident;
  const long smem = wg_smem(K, NB, 16 * STEPS, &resident) + 1024;  // + the alignment
  auto kernel = resident ? mma_probe_wgmma_kernel<NB, STEPS, true>
                         : mma_probe_wgmma_kernel<NB, STEPS, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // streamed: clusters of `cluster` blocks, whose TMA loads are multicast
  const unsigned cs = resident ? 1 : cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tv, tw, (__nv_bfloat16*)out, K, n_dots);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// tiles of min(K, MMA_KT) rows
template <int NB>
int launch_mma_rows(const void* v, const void* w, void* out, int K, int n_dots, int grid,
                    int cluster, void* stream) {
  static_assert(MMA_KT == 64, "tiles of 16, 32, 48 or 64 rows");
  switch (K < MMA_KT ? K / 16 : 4) {
    case 1:
      return launch_mma_wgmma<NB, 1>(v, w, out, K, n_dots, grid, cluster, stream);
    case 2:
      return launch_mma_wgmma<NB, 2>(v, w, out, K, n_dots, grid, cluster, stream);
    case 3:
      return launch_mma_wgmma<NB, 3>(v, w, out, K, n_dots, grid, cluster, stream);
    default:
      return launch_mma_wgmma<NB, 4>(v, w, out, K, n_dots, grid, cluster, stream);
  }
}

}  // namespace

extern "C" {

int tent_band_f32(const void* u, const void* dy, const void* dx, void* out, int C, int N, int Wp,
                  int ncand, int reps, void* stream) {
  const dim3 grid((N + TENT_TN - 1) / TENT_TN, (C + TENT_TC - 1) / TENT_TC);
  const float* a[3] = {(const float*)u, (const float*)dy, (const float*)dx};
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte staging where u is 16-byte aligned and its rows are whole float4s
  const bool vec = (uintptr_t)u % 16 == 0 && ((long)N + (long)ncand * Wp) % 4 == 0;
#define TENT(k)                                                                        \
  case k: {                                                                            \
    auto kernel = vec ? tent_band_kernel<k, true> : tent_band_kernel<k, false>;        \
    kernel<<<grid, TENT_THREADS, 0, s>>>(a[0], a[1], a[2], (float*)out, C, N, Wp, reps); \
    break;                                                                             \
  }
  switch (ncand) {
    TENT(2) TENT(3) TENT(4) TENT(5) TENT(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TENT
  return (int)cudaGetLastError();
}

int corner_gather_f32(const void* u, const void* dy, const void* dx, void* out, int C, int N,
                      int Wp, int ncand, int reps, void* stream) {
  if (ncand < 2 || ncand > 6 || (uintptr_t)out % 16 != 0 ||
      (long)N + (long)(ncand + 1) * Wp >= (1L << 31))  // the staged rows' columns
    return (int)cudaErrorInvalidValue;
  const int smem = gather_smem(ncand);
  cudaError_t err = cudaFuncSetAttribute(corner_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corner_gather_kernel,
                                                           GATHER_THREADS, smem)) != cudaSuccess)
    return (int)err;
  // rows a block: about three waves of the blocks the SMs hold at once
  const int strips = (Wp + GATHER_TN - 1) / GATHER_TN, ctiles = (C + GATHER_CH - 1) / GATHER_CH;
  const int nrows = (N + Wp - 1) / Wp;
  const long want = 3L * sms * std::max(per_sm, 1);
  const int rows = (int)std::max(1L, ((long)nrows * strips * ctiles + want - 1) / want);
  const dim3 grid(strips, (nrows + rows - 1) / rows, ctiles);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  corner_gather_kernel<<<grid, GATHER_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)dy, (const float*)dx, (float*)out, C, N, Wp, ncand, reps,
      rows);
  return (int)cudaGetLastError();
}

// K12c's wgmma form; `cluster` (1, 2 or 4, dividing grid) blocks share the
// streamed tiles' TMA loads
int mma_probe_bf16(const void* v, const void* w, void* out, int K, int N, int n_dots, int grid,
                   int cluster, void* stream) {
  if (K % 16 != 0 || K < 16 || N % 64 != 0 || N > 256 || n_dots < 1 || grid < 1 ||
      (uintptr_t)v % 16 != 0 || (uintptr_t)w % 16 != 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4) || grid % cluster != 0)
    return (int)cudaErrorInvalidValue;
  switch (N / 64) {
    case 1:
      return launch_mma_rows<1>(v, w, out, K, n_dots, grid, cluster, stream);
    case 2:
      return launch_mma_rows<2>(v, w, out, K, n_dots, grid, cluster, stream);
    case 3:
      return launch_mma_rows<3>(v, w, out, K, n_dots, grid, cluster, stream);
    case 4:
      return launch_mma_rows<4>(v, w, out, K, n_dots, grid, cluster, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K12c's mma.sync form
int mma_probe_sync_bf16(const void* v, const void* w, void* out, int K, int N, int n_dots,
                        int grid, void* stream) {
  if (K % 16 != 0 || N % 64 != 0 || N > 256 || n_dots < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  switch (N / 32) {
    case 2:
      return launch_mma_sync<2>(v, w, out, K, n_dots, grid, stream);
    case 4:
      return launch_mma_sync<4>(v, w, out, K, n_dots, grid, stream);
    case 6:
      return launch_mma_sync<6>(v, w, out, K, n_dots, grid, stream);
    case 8:
      return launch_mma_sync<8>(v, w, out, K, n_dots, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
