// Modulated deformable convolution (DCNv2) for Hopper (sm_90a): the fused
// layer and the convolution from given fields.
//
// K4 dcn_layer <- devis_tpu/ops/deform_conv_banded.py:_banded_infield_kernel
// (with its inner loop _premix_tent_combine). One kernel computes the whole
// layer:
//   offset = conv3x3(x, w_off) + b_off           (y, x) interleaved per k
//   mod    = 2 * sigmoid(conv3x3(x, w_mod) + b_mod)
//   out(p) = bias + sum_k mod_k(p) * W_k^T bilinear(x, p + k - pad + offset_k(p))
// with zero padding outside the image.
//
// K10 deform_conv2d <- deform_conv_banded.py:_banded_kernel. The same kernel
// with GIVEN_FIELDS: the offset field (B, 2KK, H, W) and the modulation field
// (B, KK, H, W) are read from memory instead of computed, and the modulation
// is used as it is (no sigmoid). Sampling and mixing are the shared code.
//
// Both are EXACT DCNv2 at any offsets: every bilinear tap is gathered where it
// lands. The TPU kernel is inexact by design, dropping taps outside a rebased
// candidate band (deform_conv_banded.py:42-48), because the TPU has no fast
// gather; on this card the gather is direct, so no band exists.
//
// Two instantiations, chosen by the wrapper from the input's dtype:
//
// bf16 (every model path): dcn_layer_mma_kernel, on the tensor cores.
//   The layer's work is arithmetic: per pixel and kernel position a
//   3KK-wide field convolution over 9*Cin inputs and a Cin x Cout channel
//   mix (about 45 and 54 GFLOP at the mask head's six layers for 10
//   trajectories x 6 frames), against 4*Cin bilinear multiply-adds; on the
//   CUDA cores in f32 the two products set the time. Here both are implicit
//   GEMMs with bf16 operands and f32 accumulation, and what bounds the
//   kernel is the gather that builds the A operand: a block's sampling
//   steps, their 16-byte corner loads and two barriers a step, most of all on
//   the narrow, pixel-heavy layers (Cin 32 and 16 at 96x160 and more), not
//   the tensor cores (PERF.md rows 4 and 10). The design:
//   - A block owns BM = 128 output pixels of one image (8 warps: 4 along the
//     pixels x 2 along the output channels) and one tile of 16*NT output
//     channels; a Cout above 144 is split over blocks.
//   - x is read as an NHWC bf16 copy with Cin zero-padded to a multiple of
//     16 (made by the wrapper): a corner's channels are one contiguous row,
//     read with 16-byte loads.
//   - Field GEMM (K4): [BM pixels, KK*Cin_pad] im2col rows, loaded by
//     cp.async with zero fill outside the image, times the packed field
//     weights [KK*Cin_pad, 32]; bias and sigmoid in f32; the fields stay in
//     shared memory in f32.
//   - Sample, then mix: the four corners and tent x modulation weights of
//     every pixel and kernel position k (f32, once); the weighted corner
//     rows summed in f32, rounded to bf16 into the A tile, times the packed
//     mix weights [KK*Cin_pad, 16*NT]. Both GEMMs run over the depth
//     KK*Cin_pad in chunks of 64, 32 or 16 columns, which may span kernel
//     positions (the narrow, pixel-heavy layers take 3-5 steps, not 9); the
//     B chunks (weights) go through a two-slot cp.async ring, so the chunk
//     of step s+1 is in flight while step s samples.
//   - The A tile is stored swizzled (16-byte unit c of row p at
//     c ^ ((p >> (3 - lg)) & (nch - 1)), nch = 2^lg units a row): the
//     sampler's stores and ldmatrix's reads have no bank conflicts. The B
//     rows are padded by 16 bytes, which does the same for ldmatrix.trans.
//   - Epilogue: bias in f32, one rounding to bf16, a transpose through
//     shared memory, coalesced channel-first stores.
//   Tensor-core instruction: warp-level mma.sync.m16n8k16 (bf16 in, f32
//   accumulate) fed by ldmatrix. wgmma would need both operands in its
//   canonical shared-memory layouts with descriptors and a warpgroup-wide
//   asynchronous pipeline; here the A operand is produced by the same warps
//   a chunk at a time by gathering, and the per-step products are small
//   (M = 128, N <= 144, K <= 64), so the gather, not the product, sets the
//   pace. mma.sync keeps producer and consumer the same threads with two
//   barriers a step. A design choice, not a fallback: there is no other bf16
//   path.
//   Numerics: the sampled column is rounded to bf16 before the mix (the TPU
//   kernel premixes bf16 x in f32 instead); the fields are exact products of
//   bf16 values summed in f32. Distance from the f32 plain version at the
//   mask head's widths, measured on an H100: 4.2e-3 to 6.4e-3 of max|plain|,
//   most of it the output's own rounding (one bf16 step at the largest
//   value is 2^-8 to 2^-7 of it); the bf16 gate is 2e-2.
//
// f32: dcn_layer_f32_kernel, on the CUDA cores. A block owns NP = 32
//   pixels; the 3KK field channels of its pixels (a K*K*Cin dot each) go to
//   shared memory, then for each k the sampled column S_k (Cin x NP) and
//   acc[co][p] += sum_c W_k[c][co] * S_k[c][p], all in f32. The exact path
//   that the f32 gate (1e-4 of max|plain|) holds; no model path runs it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------
#define NP 32
#define THREADS 256

// x (B, Cin, H, W); weight (K, K, Cin, Cout); biases f32; out (B, Cout, H, W).
// K4 (GIVEN_FIELDS false): w_off (K, K, Cin, 2KK) and w_mod (K, K, Cin, KK)
// are the field convolutions' weights, b_off and b_mod their biases.
// K10 (GIVEN_FIELDS true): w_off is the offset field (B, 2KK, H, W), w_mod
// the modulation field (B, KK, H, W); b_off and b_mod are not read.
template <bool GIVEN_FIELDS>
__global__ void __launch_bounds__(THREADS)
dcn_layer_f32_kernel(const float* __restrict__ x, const float* __restrict__ w_off,
                     const float* __restrict__ b_off, const float* __restrict__ w_mod,
                     const float* __restrict__ b_mod, const float* __restrict__ weight,
                     const float* __restrict__ bias, float* __restrict__ out, int Cin, int H,
                     int W, int Cout, int K, int pad) {
  extern __shared__ float smem[];
  const int KK = K * K;
  const int HW = H * W;
  const int tiles = (HW + NP - 1) / NP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * NP;
  float* field = smem;                           // (3KK, NP): 2k dy, 2k+1 dx, 2KK+k mod
  float* tap_w = field + 3 * KK * NP;            // (4, NP)
  int* tap_i = (int*)(tap_w + 4 * NP);           // (4, NP)
  float* S = (float*)(tap_i + 4 * NP);           // (Cin, NP)
  float* acc = S + (size_t)Cin * NP;             // (Cout, NP)
  const float* xb = x + (size_t)b * Cin * HW;

  // 1. the fields: read (K10) or convolved (K4). A warp shares one field
  //    channel (NP == 32), so its weight loads are uniform and its x or field
  //    loads are 32 neighbouring pixels.
  for (int idx = threadIdx.x; idx < 3 * KK * NP; idx += THREADS) {
    const int p = idx % NP, ch = idx / NP;
    const int pix = p0 + p;
    float v = 0.f;
    if (GIVEN_FIELDS) {
      if (pix < HW)
        v = ch < 2 * KK ? w_off[((size_t)b * 2 * KK + ch) * HW + pix]
                        : w_mod[((size_t)b * KK + (ch - 2 * KK)) * HW + pix];
    } else if (pix < HW) {
      const int py = pix / W, px = pix % W;
      const bool is_off = ch < 2 * KK;
      const float* wt = is_off ? w_off + ch : w_mod + (ch - 2 * KK);
      const int stride = is_off ? 2 * KK : KK;
      v = is_off ? b_off[ch] : b_mod[ch - 2 * KK];
      for (int ty = 0; ty < K; ++ty) {
        const int iy = py + ty - pad;
        if (iy < 0 || iy >= H) continue;
        for (int tx = 0; tx < K; ++tx) {
          const int ix = px + tx - pad;
          if (ix < 0 || ix >= W) continue;
          const float* xp = xb + iy * W + ix;
          const float* wp = wt + (size_t)(ty * K + tx) * Cin * stride;
          for (int c = 0; c < Cin; ++c) v += xp[(size_t)c * HW] * wp[(size_t)c * stride];
        }
      }
      if (!is_off) v = 2.f / (1.f + expf(-v));
    }
    field[ch * NP + p] = v;
  }
  for (int idx = threadIdx.x; idx < Cout * NP; idx += THREADS) acc[idx] = 0.f;
  __syncthreads();

  const int p = threadIdx.x % NP;
  const int cw = threadIdx.x / NP;
  const int n_cw = THREADS / NP;
  for (int k = 0; k < KK; ++k) {
    // 2a. bilinear corners of each pixel at kernel position k
    if (threadIdx.x < NP) {
      const int pix = p0 + threadIdx.x;
      float wts[4] = {0.f, 0.f, 0.f, 0.f};
      int ids[4] = {0, 0, 0, 0};
      if (pix < HW) {
        const int py = pix / W, px = pix % W;
        const float sy = (float)(py + k / K - pad) + field[(2 * k) * NP + threadIdx.x];
        const float sx = (float)(px + k % K - pad) + field[(2 * k + 1) * NP + threadIdx.x];
        const float m = field[(2 * KK + k) * NP + threadIdx.x];
        if (sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W) {
          const float y0f = floorf(sy), x0f = floorf(sx);
          const float dy = sy - y0f, dx = sx - x0f;
          const int y0 = (int)y0f, x0 = (int)x0f;
          const float cw4[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx, dy * (1.f - dx),
                                dy * dx};
          for (int i = 0; i < 4; ++i) {
            const int yi = y0 + (i >> 1), xi = x0 + (i & 1);
            if (yi >= 0 && yi < H && xi >= 0 && xi < W) {
              wts[i] = cw4[i] * m;
              ids[i] = yi * W + xi;
            }
          }
        }
      }
      for (int i = 0; i < 4; ++i) {
        tap_w[i * NP + threadIdx.x] = wts[i];
        tap_i[i * NP + threadIdx.x] = ids[i];
      }
    }
    __syncthreads();
    // 2b. sampled column S_k[c][p]
    for (int idx = threadIdx.x; idx < Cin * NP; idx += THREADS) {
      const int pp = idx % NP, c = idx / NP;
      const float* xc = xb + (size_t)c * HW;
      float s = 0.f;
      for (int i = 0; i < 4; ++i) s += tap_w[i * NP + pp] * xc[tap_i[i * NP + pp]];
      S[c * NP + pp] = s;
    }
    __syncthreads();
    // 2c. channel mix; thread (cw, p) owns acc[co][p] for co = cw, cw + n_cw, ...
    const float* wk = weight + (size_t)k * Cin * Cout;
    for (int co = cw; co < Cout; co += n_cw) {
      float a = acc[co * NP + p];
      for (int c = 0; c < Cin; ++c) a += S[c * NP + p] * wk[(size_t)c * Cout + co];
      acc[co * NP + p] = a;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < Cout * NP; idx += THREADS) {
    const int pp = idx % NP, co = idx / NP;
    const int pix = p0 + pp;
    if (pix < HW) out[((size_t)b * Cout + co) * HW + pix] = acc[idx] + bias[co];
  }
}

static size_t f32_smem_bytes(int Cin, int Cout, int K) {
  return (size_t)(3 * K * K * NP + 8 * NP + (size_t)Cin * NP + (size_t)Cout * NP) * 4;
}

template <bool GIVEN_FIELDS>
static int launch_f32(const void* x, const void* w_off, const void* b_off, const void* w_mod,
                      const void* b_mod, const void* weight, const void* bias, void* out, int B,
                      int Cin, int H, int W, int Cout, int K, int pad, void* stream) {
  const size_t smem = f32_smem_bytes(Cin, Cout, K);
  cudaError_t err = cudaFuncSetAttribute(dcn_layer_f32_kernel<GIVEN_FIELDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * ((H * W + NP - 1) / NP);
  dcn_layer_f32_kernel<GIVEN_FIELDS><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w_off, (const float*)b_off, (const float*)w_mod,
      (const float*)b_mod, (const float*)weight, (const float*)bias, (float*)out, Cin, H, W,
      Cout, K, pad);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace mma {

constexpr int BM = 128;        // output pixels a block
constexpr int KC = 64;         // deepest chunk of channels a step
constexpr int NTHREADS = 256;  // 8 warps: 4 along the pixels x 2 along the channels
constexpr int NF = 32;         // field GEMM width: 3KK <= 27 channels, zero-padded
constexpr int NT_MAX = 9;      // n8 tiles a warp: a block's channel tile is 16 * NT

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
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

// Byte offset of 16-byte unit c of row p in an A tile with 2^lg units a row
// (lg 1..3): rows packed densely, the unit XOR-swizzled so that the eight
// rows ldmatrix reads at one unit, and the units the sampler's 8-thread
// phases store, fall in eight different 16-byte bank groups.
__device__ __forceinline__ uint32_t a_off(int p, int c, int lg) {
  const int swz = (p >> (3 - lg)) & ((1 << lg) - 1);
  return (uint32_t)(((p << lg) + (c ^ swz)) << 4);
}

// Chunk i of a depth of D channels (a multiple of 16): 64-wide chunks, then
// at most one of 32 and one of 16. Sets the first channel and returns log2
// of the 16-byte units a row (width 8 << lg).
__device__ __forceinline__ int chunk_of(int i, int D, int& c0) {
  const int n64 = D >> 6, rest = D & 63;
  if (i < n64) {
    c0 = i << 6;
    return 3;
  }
  c0 = n64 << 6;
  if (i == n64 && (rest & 32)) return 2;
  if (rest & 32) c0 += 32;
  return 1;
}

__device__ __forceinline__ int chunks_of(int D) {
  const int rest = D & 63;
  return (D >> 6) + ((rest >> 5) & 1) + ((rest >> 4) & 1);
}

// Rows [row0, row0 + rows) and columns [col0, col0 + ncols) of a row-major
// bf16 matrix with leading dimension ld -> a ring slot with rows of ncols + 8.
__device__ __forceinline__ void stage_b(__nv_bfloat16* slot, const __nv_bfloat16* src, int ld,
                                        int row0, int rows, int col0, int ncols) {
  const int units = ncols >> 3;
  for (int j = threadIdx.x; j < rows * units; j += NTHREADS) {
    const int r = j / units, u = j - r * units;
    cp_async16(smem_addr(slot + r * (ncols + 8) + u * 8),
               src + (size_t)(row0 + r) * ld + col0 + u * 8, true);
  }
}

// acc (warp rows wm*32 .. +32, columns ncol0 .. +8*NTW) += A (a chunk of 8 << lg
// channels) * B slot (rows of bstride bytes).
template <int NTW>
__device__ __forceinline__ void mma_chunk(uint32_t a_base, int lg, uint32_t b_base,
                                          int bstride, int ncol0, int wm, int lane,
                                          float (&acc)[2][NTW][4]) {
  const int nk16 = 1 << (lg - 1);
  for (int kk = 0; kk < nk16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(a_base + a_off(wm * 32 + mi * 16 + (lane & 15), 2 * kk + (lane >> 4), lg), a[mi]);
    const int mat = lane >> 3;
    const uint32_t brow = b_base + (uint32_t)((kk * 16 + (mat & 1) * 8 + (lane & 7)) * bstride);
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t b[4];
      const uint32_t addr = brow + (uint32_t)((ncol0 + j * 8 + (mat >> 1) * 8) * 2);
      if (j + 1 < NTW) {
        ldsm_x4_t(addr, b);
        mma16816(acc[0][j], a[0], b[0], b[1]);
        mma16816(acc[1][j], a[1], b[0], b[1]);
        mma16816(acc[0][j + 1], a[0], b[2], b[3]);
        mma16816(acc[1][j + 1], a[1], b[2], b[3]);
      } else {
        ldsm_x2_t(addr, b);
        mma16816(acc[0][j], a[0], b[0], b[1]);
        mma16816(acc[1][j], a[1], b[0], b[1]);
      }
    }
  }
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared memory of a block: the A tile, a two-slot B ring, the fields, the
// taps of all KK kernel positions. The epilogue reuses the A tile and the
// ring.
__host__ __device__ constexpr int a_bytes() { return BM * KC * 2; }
__host__ __device__ constexpr int ring_slot_elems(int nt) {
  return KC * ((16 * nt > NF ? 16 * nt : NF) + 8);
}
__host__ __device__ constexpr size_t smem_bytes(int nt, int KK) {
  return (size_t)a_bytes() + 2 * ring_slot_elems(nt) * 2 + (size_t)3 * KK * BM * 4 +
         (size_t)8 * KK * BM * 4;
}

// x_nhwc (B, H, W, Cin_pad) bf16; w_mix (KK, Cin_pad, Cout_pack) bf16 with
// Cout_pack = 16 * NT * (blocks along the channels); bias (Cout) f32;
// out (B, Cout, H, W) bf16.
// K4: f0 = packed field weights (KK * Cin_pad, NF) bf16, f1 = their bias
// (NF) f32 (2KK offsets, KK modulations, zeros). K10: f0 = offset field
// (B, 2KK, H, W) bf16, f1 = modulation field (B, KK, H, W) bf16.
template <int NT, bool GIVEN_FIELDS>
__global__ void __launch_bounds__(NTHREADS, 2)
dcn_layer_mma_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ f0,
                     const void* __restrict__ f1, const __nv_bfloat16* __restrict__ w_mix,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                     int Cin_pad, int H, int W, int Cout, int Cout_pack, int K, int pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = 16 * NT;
  const int KK = K * K;
  const int HW = H * W;
  const int tiles = (HW + BM - 1) / BM;
  const int n_tiles = Cout_pack / NB;
  const int nt = blockIdx.x % n_tiles;
  const int tile = (blockIdx.x / n_tiles) % tiles;
  const int b = blockIdx.x / (n_tiles * tiles);
  const int p0 = tile * BM;
  const int n0 = nt * NB;

  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + a_bytes());
  float* field = reinterpret_cast<float*>(smem + a_bytes() + 2 * ring_slot_elems(NT) * 2);
  float* tap_w = field + 3 * KK * BM;           // (KK, 4, BM)
  int* tap_i = reinterpret_cast<int*>(tap_w + 4 * KK * BM);
  const uint32_t a_base = smem_addr(A);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cin_pad;
  // Both GEMMs run over the depth D = KK * Cin_pad (kernel position or tap
  // major, channel minor), in chunks that may span positions: a 16-byte unit
  // never does, as Cin_pad is a multiple of 16.
  const int D = KK * Cin_pad;
  const int S_f = GIVEN_FIELDS ? 0 : chunks_of(D);
  const int S = S_f + chunks_of(D);
  const __nv_bfloat16* w_field = reinterpret_cast<const __nv_bfloat16*>(f0);

  // B chunk of step s into ring slot s & 1
  auto load_b = [&](int s) {
    __nv_bfloat16* slot = ring + (s & 1) * ring_slot_elems(NT);
    int c0;
    if (s < S_f) {
      const int lg = chunk_of(s, D, c0);
      stage_b(slot, w_field, NF, c0, 8 << lg, 0, NF);
    } else {
      const int lg = chunk_of(s - S_f, D, c0);
      stage_b(slot, w_mix, Cout_pack, c0, 8 << lg, n0, NB);
    }
  };

  load_b(0);
  cp_async_commit();
  int s = 0;

  if (!GIVEN_FIELDS) {
    // field GEMM: [BM, KK * Cin_pad] im2col x [KK * Cin_pad, NF]
    float facc[2][2][4] = {};
    for (; s < S_f; ++s) {
      int c0;
      const int lg = chunk_of(s, D, c0);
      for (int it = tid; it < (BM << lg); it += NTHREADS) {
        const int p = it >> lg, c = it & ((1 << lg) - 1);
        const int d = c0 + c * 8, t = d / Cin_pad;
        const int pix = p0 + p;
        const int py = pix / W + t / K - pad, px = pix % W + t % K - pad;
        const bool ok = pix < HW && py >= 0 && py < H && px >= 0 && px < W;
        const __nv_bfloat16* src =
            ok ? xb + (size_t)(py * W + px) * Cin_pad + (d - t * Cin_pad) : xb;
        cp_async16(a_base + a_off(p, c, lg), src, ok);
      }
      cp_async_commit();
      if (s + 1 < S) load_b(s + 1);
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
      mma_chunk<2>(a_base, lg, smem_addr(ring + (s & 1) * ring_slot_elems(NT)), (NF + 8) * 2,
                   wn * 16, wm, lane, facc);
      __syncthreads();
    }
    // bias, the modulation's sigmoid, f32 fields into shared memory
    const float* b_field = reinterpret_cast<const float*>(f1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = wm * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
          const int ch = wn * 16 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (ch < 3 * KK) {
            float v = facc[mi][j][e] + b_field[ch];
            if (ch >= 2 * KK) v = 2.f / (1.f + expf(-v));
            field[ch * BM + p] = v;
          }
        }
  } else {
    const __nv_bfloat16* off = reinterpret_cast<const __nv_bfloat16*>(f0);
    const __nv_bfloat16* mod = reinterpret_cast<const __nv_bfloat16*>(f1);
    for (int idx = tid; idx < 3 * KK * BM; idx += NTHREADS) {
      const int p = idx % BM, ch = idx / BM;
      const int pix = p0 + p;
      float v = 0.f;
      if (pix < HW)
        v = __bfloat162float(ch < 2 * KK ? off[((size_t)b * 2 * KK + ch) * HW + pix]
                                         : mod[((size_t)b * KK + (ch - 2 * KK)) * HW + pix]);
      field[idx] = v;
    }
  }
  __syncthreads();

  // bilinear corners and tent x modulation weights of every pixel and kernel
  // position; a dead corner has weight 0 and index 0
  for (int idx = tid; idx < KK * BM; idx += NTHREADS) {
    const int p = idx % BM, k = idx / BM;
    const int pix = p0 + p;
    float wts[4] = {0.f, 0.f, 0.f, 0.f};
    int ids[4] = {0, 0, 0, 0};
    if (pix < HW) {
      const int py = pix / W, px = pix % W;
      const float sy = (float)(py + k / K - pad) + field[(2 * k) * BM + p];
      const float sx = (float)(px + k % K - pad) + field[(2 * k + 1) * BM + p];
      const float m = field[(2 * KK + k) * BM + p];
      if (sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W) {
        const float y0f = floorf(sy), x0f = floorf(sx);
        const float dy = sy - y0f, dx = sx - x0f;
        const int y0 = (int)y0f, x0 = (int)x0f;
        const float cw4[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx, dy * (1.f - dx),
                              dy * dx};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int yi = y0 + (i >> 1), xi = x0 + (i & 1);
          if (yi >= 0 && yi < H && xi >= 0 && xi < W) {
            wts[i] = cw4[i] * m;
            ids[i] = yi * W + xi;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tap_w[(k * 4 + i) * BM + p] = wts[i];
      tap_i[(k * 4 + i) * BM + p] = ids[i];
    }
  }
  __syncthreads();

  // sample, then mix: A = bf16(sum of 4 weighted corner rows) for a chunk of
  // (kernel position, channel) columns, acc += A * the same rows of W
  float acc[2][NT][4] = {};
  for (; s < S; ++s) {
    int c0;
    const int lg = chunk_of(s - S_f, D, c0);
    if (s + 1 < S) load_b(s + 1);
    cp_async_commit();
    // thread item (pixel p, 16-byte unit c)
    for (int it = tid; it < (BM << lg); it += NTHREADS) {
      const int p = it >> lg, c = it & ((1 << lg) - 1);
      const int d = c0 + c * 8, k = d / Cin_pad;
      const __nv_bfloat16* xc = xb + (d - k * Cin_pad);
      uint4 v[4];
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = tap_w[(k * 4 + i) * BM + p];
        v[i] = __ldg(reinterpret_cast<const uint4*>(
            xc + (size_t)tap_i[(k * 4 + i) * BM + p] * Cin_pad));
      }
      float sum[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t u = reinterpret_cast<const uint32_t*>(&v[i])[e];
          lo = fmaf(w[i], bf_lo(u), lo);
          hi = fmaf(w[i], bf_hi(u), hi);
        }
        sum[2 * e] = lo;
        sum[2 * e + 1] = hi;
      }
      uint4 packed;
      packed.x = pack_bf2(sum[0], sum[1]);
      packed.y = pack_bf2(sum[2], sum[3]);
      packed.z = pack_bf2(sum[4], sum[5]);
      packed.w = pack_bf2(sum[6], sum[7]);
      *reinterpret_cast<uint4*>(smem + a_off(p, c, lg)) = packed;
    }
    cp_async_wait_prior();
    __syncthreads();
    mma_chunk<NT>(a_base, lg, smem_addr(ring + (s & 1) * ring_slot_elems(NT)), (NB + 8) * 2,
                  wn * 8 * NT, wm, lane, acc);
    __syncthreads();
  }

  // epilogue: bias, one rounding, transpose to (channel, pixel) through
  // shared memory (the A tile and the ring), coalesced channel-first stores
  __nv_bfloat16* E = A;                         // (NB, BM + 8)
  constexpr int ES = BM + 8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = wm * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = wn * 8 * NT + j * 8 + (lane & 3) * 2 + (e & 1);
        const float bv = n0 + n < Cout ? bias[n0 + n] : 0.f;
        E[n * ES + p] = __float2bfloat16(acc[mi][j][e] + bv);
      }
  __syncthreads();
  for (int idx = tid; idx < NB * BM; idx += NTHREADS) {
    const int p = idx % BM, n = idx / BM;
    const int pix = p0 + p;
    if (pix < HW && n0 + n < Cout) out[((size_t)b * Cout + n0 + n) * HW + pix] = E[n * ES + p];
  }
}

template <int NT, bool GIVEN_FIELDS>
static int launch_mma_nt(const void* x, const void* f0, const void* f1, const void* w_mix,
                         const void* bias, void* out, int B, int Cin_pad, int H, int W, int Cout,
                         int Cout_pack, int K, int pad, void* stream) {
  const size_t smem = smem_bytes(NT, K * K);
  cudaError_t err = cudaFuncSetAttribute(dcn_layer_mma_kernel<NT, GIVEN_FIELDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)B * ((H * W + BM - 1) / BM) * (Cout_pack / (16 * NT));
  dcn_layer_mma_kernel<NT, GIVEN_FIELDS><<<(unsigned)blocks, NTHREADS, smem,
                                           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, f0, f1, (const __nv_bfloat16*)w_mix, (const float*)bias,
      (__nv_bfloat16*)out, Cin_pad, H, W, Cout, Cout_pack, K, pad);
  return (int)cudaGetLastError();
}

template <bool GIVEN_FIELDS>
static int launch_mma(const void* x, const void* f0, const void* f1, const void* w_mix,
                      const void* bias, void* out, int B, int Cin_pad, int H, int W, int Cout,
                      int Cout_pack, int NT, int K, int pad, void* stream) {
  if (Cin_pad % 16 != 0 || K > 3 || NT < 1 || NT > NT_MAX || Cout_pack % (16 * NT) != 0)
    return (int)cudaErrorInvalidValue;
#define DCN_NT(n)                                                                            \
  case n:                                                                                    \
    return launch_mma_nt<n, GIVEN_FIELDS>(x, f0, f1, w_mix, bias, out, B, Cin_pad, H, W,     \
                                          Cout, Cout_pack, K, pad, stream);
  switch (NT) {
    DCN_NT(1) DCN_NT(2) DCN_NT(3) DCN_NT(4) DCN_NT(5) DCN_NT(6) DCN_NT(7) DCN_NT(8) DCN_NT(9)
  }
#undef DCN_NT
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma

extern "C" {

// Shared memory each kernel needs; the wrapper rejects a layer above the
// card's per-block limit before launching.
long dcn_layer_f32_smem_bytes(int Cin, int Cout, int K) {
  return (long)f32_smem_bytes(Cin, Cout, K);
}
long dcn_layer_mma_smem_bytes(int NT, int K) { return (long)mma::smem_bytes(NT, K * K); }

int dcn_layer_f32(void* x, void* w_off, void* b_off, void* w_mod, void* b_mod, void* weight,
                  void* bias, void* out, int B, int Cin, int H, int W, int Cout, int K, int pad,
                  void* stream) {
  return launch_f32<false>(x, w_off, b_off, w_mod, b_mod, weight, bias, out, B, Cin, H, W,
                           Cout, K, pad, stream);
}

// K10: x, the offset field, the modulation field, weight, bias -> out.
int deform_conv2d_f32(void* x, void* offset, void* mask, void* weight, void* bias, void* out,
                      int B, int Cin, int H, int W, int Cout, int K, int pad, void* stream) {
  return launch_f32<true>(x, offset, nullptr, mask, nullptr, weight, bias, out, B, Cin, H, W,
                          Cout, K, pad, stream);
}

// K4 in bf16: x_nhwc, packed field weights and bias, packed mix weights, bias -> out.
int dcn_layer_bf16(void* x_nhwc, void* w_field, void* b_field, void* w_mix, void* bias,
                   void* out, int B, int Cin_pad, int H, int W, int Cout, int Cout_pack, int NT,
                   int K, int pad, void* stream) {
  return mma::launch_mma<false>(x_nhwc, w_field, b_field, w_mix, bias, out, B, Cin_pad, H, W,
                                Cout, Cout_pack, NT, K, pad, stream);
}

// K10 in bf16: x_nhwc, the offset and modulation fields, packed mix weights, bias -> out.
int deform_conv2d_bf16(void* x_nhwc, void* offset, void* mask, void* w_mix, void* bias,
                       void* out, int B, int Cin_pad, int H, int W, int Cout, int Cout_pack,
                       int NT, int K, int pad, void* stream) {
  return mma::launch_mma<true>(x_nhwc, offset, mask, w_mix, bias, out, B, Cin_pad, H, W, Cout,
                               Cout_pack, NT, K, pad, stream);
}

}  // extern "C"
