// Modulated deformable convolution (DCNv2) for Hopper (sm_90a): the fused
// layer and the convolution from given fields, one kernel template.
//
// K4 dcn_layer <- devis_tpu/ops/deform_conv_banded.py:_banded_infield_kernel
// (with its inner loop _premix_tent_combine). One kernel computes the whole
// layer, channel-first:
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
// Design: sample, then mix. A block owns NP = 32 output pixels of one image.
//   1. the 3*K*K field channels of its pixels (a K*K*Cin dot each) go to
//      shared memory, with the modulation's sigmoid applied;
//   2. for each kernel position k: the 4 bilinear corners and weights of each
//      pixel; the sampled column S_k[c][p] (Cin x NP) in shared memory; then
//      acc[co][p] += sum_c W_k[c][co] * S_k[c][p], with acc in shared memory.
// That is B*HW*K*K*(4*Cin + Cin*Cout) multiply-adds, not 4*Cin*Cout per tap.
//
// What bounds it: the channel mix, B*HW*K*K*Cin*Cout multiply-adds (about
// 27 G at the mask head's six layers for 10 trajectories x 6 frames), run
// here on the CUDA cores in f32 with each weight read as a warp-uniform load
// from L1/L2. Moving the mix onto the tensor cores (wgmma over a pixel tile)
// is the next step and is not taken here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NP 32
#define THREADS 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x (B, Cin, H, W); weight (K, K, Cin, Cout); biases f32; out (B, Cout, H, W).
// K4 (GIVEN_FIELDS false): w_off (K, K, Cin, 2KK) and w_mod (K, K, Cin, KK)
// are the field convolutions' weights, b_off and b_mod their biases.
// K10 (GIVEN_FIELDS true): w_off is the offset field (B, 2KK, H, W), w_mod
// the modulation field (B, KK, H, W); b_off and b_mod are not read.
template <typename scalar_t, bool GIVEN_FIELDS>
__global__ void __launch_bounds__(THREADS)
dcn_layer_kernel(const scalar_t* __restrict__ x, const scalar_t* __restrict__ w_off,
                 const float* __restrict__ b_off, const scalar_t* __restrict__ w_mod,
                 const float* __restrict__ b_mod, const scalar_t* __restrict__ weight,
                 const float* __restrict__ bias, scalar_t* __restrict__ out, int Cin, int H,
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
  const scalar_t* xb = x + (size_t)b * Cin * HW;

  // 1. the fields: read (K10) or convolved (K4). A warp shares one field
  //    channel (NP == 32), so its weight loads are uniform and its x or field
  //    loads are 32 neighbouring pixels.
  for (int idx = threadIdx.x; idx < 3 * KK * NP; idx += THREADS) {
    const int p = idx % NP, ch = idx / NP;
    const int pix = p0 + p;
    float v = 0.f;
    if (GIVEN_FIELDS) {
      if (pix < HW)
        v = ch < 2 * KK ? to_f(w_off[((size_t)b * 2 * KK + ch) * HW + pix])
                        : to_f(w_mod[((size_t)b * KK + (ch - 2 * KK)) * HW + pix]);
    } else if (pix < HW) {
      const int py = pix / W, px = pix % W;
      const bool is_off = ch < 2 * KK;
      const scalar_t* wt = is_off ? w_off + ch : w_mod + (ch - 2 * KK);
      const int stride = is_off ? 2 * KK : KK;
      v = is_off ? b_off[ch] : b_mod[ch - 2 * KK];
      for (int ty = 0; ty < K; ++ty) {
        const int iy = py + ty - pad;
        if (iy < 0 || iy >= H) continue;
        for (int tx = 0; tx < K; ++tx) {
          const int ix = px + tx - pad;
          if (ix < 0 || ix >= W) continue;
          const scalar_t* xp = xb + iy * W + ix;
          const scalar_t* wp = wt + (size_t)(ty * K + tx) * Cin * stride;
          for (int c = 0; c < Cin; ++c)
            v += to_f(xp[(size_t)c * HW]) * to_f(wp[(size_t)c * stride]);
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
      const scalar_t* xc = xb + (size_t)c * HW;
      float s = 0.f;
      for (int i = 0; i < 4; ++i) s += tap_w[i * NP + pp] * to_f(xc[tap_i[i * NP + pp]]);
      S[c * NP + pp] = s;
    }
    __syncthreads();
    // 2c. channel mix; thread (cw, p) owns acc[co][p] for co = cw, cw + n_cw, ...
    const scalar_t* wk = weight + (size_t)k * Cin * Cout;
    for (int co = cw; co < Cout; co += n_cw) {
      float a = acc[co * NP + p];
      for (int c = 0; c < Cin; ++c) a += S[c * NP + p] * to_f(wk[(size_t)c * Cout + co]);
      acc[co * NP + p] = a;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < Cout * NP; idx += THREADS) {
    const int pp = idx % NP, co = idx / NP;
    const int pix = p0 + pp;
    if (pix < HW) out[((size_t)b * Cout + co) * HW + pix] = from_f<scalar_t>(acc[idx] + bias[co]);
  }
}

static size_t smem_bytes(int Cin, int Cout, int K) {
  return (size_t)(3 * K * K * NP + 8 * NP + (size_t)Cin * NP + (size_t)Cout * NP) * 4;
}

template <typename scalar_t, bool GIVEN_FIELDS>
static int launch_dcn(void* x, void* w_off, void* b_off, void* w_mod, void* b_mod, void* weight,
                      void* bias, void* out, int B, int Cin, int H, int W, int Cout, int K,
                      int pad, void* stream) {
  const size_t smem = smem_bytes(Cin, Cout, K);
  cudaError_t err = cudaFuncSetAttribute(dcn_layer_kernel<scalar_t, GIVEN_FIELDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * ((H * W + NP - 1) / NP);
  dcn_layer_kernel<scalar_t, GIVEN_FIELDS><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const scalar_t*)x, (const scalar_t*)w_off, (const float*)b_off, (const scalar_t*)w_mod,
      (const float*)b_mod, (const scalar_t*)weight, (const float*)bias, (scalar_t*)out, Cin, H,
      W, Cout, K, pad);
  return (int)cudaGetLastError();
}

extern "C" {

// Shared memory the kernel needs for these widths; the wrapper rejects a
// layer above the card's per-block limit before launching.
long dcn_layer_smem_bytes(int Cin, int Cout, int K) { return (long)smem_bytes(Cin, Cout, K); }

int dcn_layer_f32(void* x, void* w_off, void* b_off, void* w_mod, void* b_mod, void* weight,
                  void* bias, void* out, int B, int Cin, int H, int W, int Cout, int K, int pad,
                  void* stream) {
  return launch_dcn<float, false>(x, w_off, b_off, w_mod, b_mod, weight, bias, out, B, Cin, H, W, Cout,
                           K, pad, stream);
}

int dcn_layer_bf16(void* x, void* w_off, void* b_off, void* w_mod, void* b_mod, void* weight,
                   void* bias, void* out, int B, int Cin, int H, int W, int Cout, int K, int pad,
                   void* stream) {
  return launch_dcn<__nv_bfloat16, false>(x, w_off, b_off, w_mod, b_mod, weight, bias, out, B, Cin, H,
                                   W, Cout, K, pad, stream);
}

// K10: x, the offset field, the modulation field, weight, bias -> out.
int deform_conv2d_f32(void* x, void* offset, void* mask, void* weight, void* bias, void* out,
                      int B, int Cin, int H, int W, int Cout, int K, int pad, void* stream) {
  return launch_dcn<float, true>(x, offset, nullptr, mask, nullptr, weight, bias, out, B, Cin, H,
                                 W, Cout, K, pad, stream);
}

int deform_conv2d_bf16(void* x, void* offset, void* mask, void* weight, void* bias, void* out,
                       int B, int Cin, int H, int W, int Cout, int K, int pad, void* stream) {
  return launch_dcn<__nv_bfloat16, true>(x, offset, nullptr, mask, nullptr, weight, bias, out, B,
                                         Cin, H, W, Cout, K, pad, stream);
}

}  // extern "C"
