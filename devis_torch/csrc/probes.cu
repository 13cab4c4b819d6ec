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
// - K12a/K12b: one thread per n computes a rep's weights once (ncand^2 for
//   K12a, 4 for K12b) and loops over 8 channels, reading u coalesced across
//   n; the band's rows of those channels stay in L1, so device memory sees
//   u about once. At C 512, N 36 864 u and out move about 154 MB (46 us at
//   3.35 TB/s); K12a does 5.4 GFLOP (81 us at the 67 TFLOP/s of f32 outside
//   the tensor cores), K12b 1.4. K12a is bound by its multiply-adds and its
//   L1 reads (ncand^2 a channel a rep), K12b by the throughput of its four
//   gathered reads: that rate is what the probe measures for K4's sampler.
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

template <int NCAND>
__global__ void __launch_bounds__(BAND_THREADS)
    tent_band_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ dx, float* __restrict__ out, int C, int N, int Wp,
                     int reps) {
  constexpr int lo = (NCAND - 1) / 2;
  const int n = blockIdx.x * BAND_THREADS + threadIdx.x;
  const int c0 = blockIdx.y * BAND_CC;
  if (n >= N) return;
  const long NW = (long)N + (long)NCAND * Wp;
  const int nc = min(BAND_CC, C - c0);
  const float dxn = dx[n], dyn = dy[n];
  float wx[NCAND];
#pragma unroll
  for (int l = 0; l < NCAND; ++l) wx[l] = tent(dxn - (float)(l - lo));
  float acc[BAND_CC];
#pragma unroll
  for (int c = 0; c < BAND_CC; ++c) acc[c] = 0.f;
  const float* base = u + (long)c0 * NW + lo + n;
  for (int r = 0; r < reps; ++r) {
    const float dyr = rep_dy(dyn, r);
    float w[NCAND * NCAND];
#pragma unroll
    for (int j = 0; j < NCAND; ++j) {
      const float wy = tent(dyr - (float)(j - lo));
#pragma unroll
      for (int l = 0; l < NCAND; ++l) w[j * NCAND + l] = wy * wx[l];
    }
#pragma unroll
    for (int c = 0; c < BAND_CC; ++c) {
      if (c < nc) {
        const float* row = base + c * NW;
        float a = acc[c];
#pragma unroll
        for (int j = 0; j < NCAND; ++j)
#pragma unroll
          for (int l = 0; l < NCAND; ++l) a = fmaf(w[j * NCAND + l], __ldg(row + l + (long)j * Wp), a);
        acc[c] = a;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BAND_CC; ++c)
    if (c < nc) out[(long)(c0 + c) * N + n] = acc[c];
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
  const dim3 grid((N + BAND_THREADS - 1) / BAND_THREADS, (C + BAND_CC - 1) / BAND_CC);
  const float* a[3] = {(const float*)u, (const float*)dy, (const float*)dx};
  cudaStream_t s = (cudaStream_t)stream;
#define TENT(k)                                                                             \
  case k:                                                                                   \
    tent_band_kernel<k><<<grid, BAND_THREADS, 0, s>>>(a[0], a[1], a[2], (float*)out, C, N, \
                                                      Wp, reps);                            \
    break;
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
