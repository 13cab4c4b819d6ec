// Backward of multi-scale deformable attention from precomputed taps, for
// Hopper (sm_90a).
//
// K9 msda_taps_bwd <- devis_tpu/ops/ms_deform_attn_pallas.py:_bwd_kernel, the
// backward of the q-major op (the image model's decoder layers with 4-d
// reference points). The caller has expanded every sampling point into its
// four bilinear entries: idx, the level-local raster index of the pixel, and
// wt = bilinear weight * validity * attention weight. From the output
// gradient g the kernel gives
//   grad_value[b, start_l + idx, m, :] += wt * g[b, q, mg, :]   per entry,
//   grad_wt[b, mg, q, l, k]             = value[b, start_l + idx, m, :] . g,
// and the chain rule through the function that made the taps turns grad_wt
// into the gradients of the locations and the attention weights.
//
// `groups` heads of idx, wt and g share one value head: mg = m * G + j reads
// and scatters to value head m (the TPU kernel's grouped value block).
//
// Its own design, not the TPU kernel's one-hot W^T . g: the TPU has no
// scatter, so it multiplies by a one-hot tile; here grad_value is a scatter
// of f32 atomicAdds into an f32 buffer the caller has zeroed (so the sums
// are not bit-reproducible from run to run), and grad_wt is a dot over the D
// channels of the entry's value row, reduced across the warp. Entries address
// pixels by plain raster index; the TPU's parity packing is layout.
//
// An entry whose index lies outside its level, and an entry of weight 0,
// scatters nothing; the first also gets grad_wt 0. A dead tap inside the
// level may receive a grad_wt: the chain rule's validity mask zeroes it.
//
// Mapping: one warp per (b, mg, q); lane d owns channels d, d + 32, ...
// What bounds it: the atomic traffic, one f32 add per live entry and channel.

#include "msda_common.cuh"

static const int kThreads = 256;

// value (B, S, M, D); idx int32 and wt f32 (B, MG, Q, L, K4); g (B, Q, MG*D)
// -> grad_value (B, S, M, D) f32, zeroed by the caller; grad_wt like wt.
template <typename scalar_t>
__global__ void msda_taps_bwd_kernel(const scalar_t* __restrict__ value,
                                     const int* __restrict__ idx, const float* __restrict__ wt,
                                     const scalar_t* __restrict__ g,
                                     float* __restrict__ grad_value,
                                     float* __restrict__ grad_wt, long warps, int Q, int S,
                                     int M, int G, int D, int K4, Pyramid pyr) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= warps) return;  // whole warps leave together
  const int MG = M * G;
  const int q = (int)(warp % Q);
  const int mg = (int)((warp / Q) % MG);
  const long b = warp / Q / MG;
  const int m = mg / G;
  const int n = pyr.L * K4;
  const int* ix = idx + warp * n;
  const float* w = wt + warp * n;
  float* gw = grad_wt + warp * n;
  const scalar_t* go = g + ((b * Q + q) * MG + mg) * D;
  const size_t row = (size_t)M * D;
  const size_t base = (size_t)b * S * row + (size_t)m * D;
  for (int l = 0; l < pyr.L; ++l) {
    const size_t level = base + (size_t)pyr.start[l] * row;
    const int hw = pyr.h[l] * pyr.w[l];
    for (int k = 0; k < K4; ++k) {
      const int e = l * K4 + k;
      const int i = ix[e];
      float dot = 0.f;
      // the entry is the same for every lane, so the warp does not diverge
      if (i >= 0 && i < hw) {
        const float we = w[e];
        const size_t at = level + (size_t)i * row;
        for (int d = lane; d < D; d += 32) {
          const float gd = to_f(go[d]);
          dot += to_f(value[at + d]) * gd;
          if (we != 0.f) atomicAdd(grad_value + at + d, we * gd);
        }
      }
      dot = warp_sum(dot);
      if (lane == 0) gw[e] = dot;
    }
  }
}

template <typename scalar_t>
static int launch_taps_bwd(void* value, void* idx, void* wt, void* g, void* grad_value,
                           void* grad_wt, int B, int Q, int S, int M, int G, int D, int K4,
                           const int* levels, int L, void* stream) {
  const long warps = (long)B * M * G * Q;
  const int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  msda_taps_bwd_kernel<scalar_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const int*)idx, (const float*)wt, (const scalar_t*)g,
      (float*)grad_value, (float*)grad_wt, warps, Q, S, M, G, D, K4, make_pyramid(levels, L));
  return (int)cudaGetLastError();
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_taps_bwd_f32(void* value, void* idx, void* wt, void* g, void* grad_value, void* grad_wt,
                      int B, int Q, int S, int M, int G, int D, int K4, const int* levels, int L,
                      void* stream) {
  return launch_taps_bwd<float>(value, idx, wt, g, grad_value, grad_wt, B, Q, S, M, G, D, K4,
                                levels, L, stream);
}

int msda_taps_bwd_bf16(void* value, void* idx, void* wt, void* g, void* grad_value,
                       void* grad_wt, int B, int Q, int S, int M, int G, int D, int K4,
                       const int* levels, int L, void* stream) {
  return launch_taps_bwd<__nv_bfloat16>(value, idx, wt, g, grad_value, grad_wt, B, Q, S, M, G, D,
                                        K4, levels, L, stream);
}

}  // extern "C"
