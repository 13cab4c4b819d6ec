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
//   idx = n + (floor(dy) + lo)*Wp + floor(dx) + 2*lo (+ Wp, + 1).
//   Within the band it equals K12a up to the order of the sums.
// K12c mma_probe <- benchmarks/mxu_probe.py:probe
//   out (32, N) = n_dots * v^T w in bf16 with an f32 accumulator, v (K, 32)
//   and w (K, N) bf16; `grid` blocks each compute and store the same tile,
//   as each of the TPU's 912 grid steps writes the same block.
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
// - K12b: one thread per n computes a rep's 4 weights once and loops over
//   8 channels, reading u coalesced across n; the band's rows of those
//   channels stay in L1, so device memory sees u about once. It does 1.4
//   GFLOP and is bound by the throughput of its four gathered reads: that
//   rate is what the probe measures for K4's sampler.
// - K12c: 8 warps (2 along D x 4 along N) run m16n8k16 bf16 mma.sync from
//   shared memory, fed by ldmatrix.trans (rows padded by 16 bytes, so the 8
//   rows of an ldmatrix fall in 8 bank groups). The products are the same
//   in every dot, so each dot reloads its fragments with ldmatrix and every
//   ldmatrix and mma is `asm volatile`: nothing can be hoisted or folded,
//   and the time grows with n_dots. Where v and w fit in shared memory
//   (K (32 + N + 16) * 2 bytes <= 227 KB) they are loaded once; otherwise
//   (w is 256 KB at K 512 and 1.5 MB at K 3072) 64-row K tiles of both
//   stream through two cp.async stages for every dot, from L2, where the
//   operands stay resident: the L2 form of the TPU's VMEM-resident operands.
//   The time is bound by tensor-core operations (989 TFLOP/s bf16 dense).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BAND_THREADS = 256;  // along n
constexpr int BAND_CC = 8;         // channels a thread accumulates

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

__global__ void __launch_bounds__(BAND_THREADS)
    corner_gather_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                         const float* __restrict__ dx, float* __restrict__ out, int C, int N,
                         int Wp, int ncand, int reps) {
  const int lo = (ncand - 1) / 2;
  const int n = blockIdx.x * BAND_THREADS + threadIdx.x;
  const int c0 = blockIdx.y * BAND_CC;
  if (n >= N) return;
  const long NW = (long)N + (long)ncand * Wp;
  const int nc = min(BAND_CC, C - c0);
  const float dxn = dx[n], dyn = dy[n];
  float acc[BAND_CC];
#pragma unroll
  for (int c = 0; c < BAND_CC; ++c) acc[c] = 0.f;
  const float* base = u + (long)c0 * NW;
  for (int r = 0; r < reps; ++r) {
    const float dyr = rep_dy(dyn, r);
    const float jy = floorf(dyr), jx = floorf(dxn);
    const float fy = dyr - jy, fx = dxn - jx;
    // corners of a tap outside the band are clamped into the row (memory
    // safety; the probe's inputs keep every tap in the band)
    long idx = (long)n + ((long)jy + lo) * Wp + (long)jx + 2 * lo;
    idx = idx < 0 ? 0 : idx > NW - Wp - 2 ? NW - Wp - 2 : idx;
    const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
    const float w10 = fy * (1.f - fx), w11 = fy * fx;
#pragma unroll
    for (int c = 0; c < BAND_CC; ++c) {
      if (c < nc) {
        const float* row = base + c * NW + idx;
        float a = acc[c];
        a = fmaf(w00, __ldg(row), a);
        a = fmaf(w01, __ldg(row + 1), a);
        a = fmaf(w10, __ldg(row + Wp), a);
        a = fmaf(w11, __ldg(row + Wp + 1), a);
        acc[c] = a;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BAND_CC; ++c)
    if (c < nc) out[(long)(c0 + c) * N + n] = acc[c];
}

// ---------------------------------------------------------------------------
// K12c
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
    mma_probe_kernel(const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
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

long mma_smem(int K, int N, bool* resident) {
  const long whole = stage_bytes(K, N);
  *resident = whole <= SMEM_LIMIT;
  return *resident ? whole : 2 * stage_bytes(KT, N);
}

template <int NT>
int launch_mma_nt(const void* v, const void* w, void* out, int K, int n_dots, int grid,
                  void* stream) {
  bool resident;
  const long smem = mma_smem(K, 32 * NT, &resident);
  if (!resident && K % KT != 0) return (int)cudaErrorInvalidValue;
  auto kernel = resident ? mma_probe_kernel<NT, true> : mma_probe_kernel<NT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, K, n_dots);
  return (int)cudaGetLastError();
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
  const dim3 grid((N + BAND_THREADS - 1) / BAND_THREADS, (C + BAND_CC - 1) / BAND_CC);
  corner_gather_kernel<<<grid, BAND_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)dy, (const float*)dx, (float*)out, C, N, Wp, ncand, reps);
  return (int)cudaGetLastError();
}

int mma_probe_bf16(const void* v, const void* w, void* out, int K, int N, int n_dots, int grid,
                   void* stream) {
  if (K % 16 != 0 || N % 64 != 0 || N > 256 || n_dots < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  switch (N / 32) {
    case 2:
      return launch_mma_nt<2>(v, w, out, K, n_dots, grid, stream);
    case 4:
      return launch_mma_nt<4>(v, w, out, K, n_dots, grid, stream);
    case 6:
      return launch_mma_nt<6>(v, w, out, K, n_dots, grid, stream);
    case 8:
      return launch_mma_nt<8>(v, w, out, K, n_dots, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
